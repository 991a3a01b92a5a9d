"""The benchmark's configs 1 and 2 as step programs (``apps/benchmark.py``)
against the JAX package's frames of ``_time_chained``, on the CPU at 32².

Each config's frame function (``config1_frame``, ``config2_frame``) runs
through a ``StepProgram`` at step t, as the app runs it on the card (where
the program replays one CUDA graph a frame; on the CPU it renders
eagerly over the same buffers).  The JAX side builds the same world and
moves the same uniforms by ``t · (1, 1, 0)``, then runs
``render_gbuffers_path`` (config 1) or ``render_gbuffers_fused`` and
``denoise_finalize_pallas`` (config 2) with the kernels in interpret mode.
The tolerances are those of ``tests/test_torch_path_vol.py`` and
``tests/test_torch_lighting.py`` for the G-buffers (normal and albedo
equal and lighting within 1e-5 on at least 99.5% of pixels, depth within
one quantum where the normals agree, fog within 1e-6, no exhausted pixel)
and ``tests/test_torch_denoise.py`` for the denoised frame (3e-5, JAX's
chain on the port's G-buffers).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytrace_tpu.apps import benchmark as jax_benchmark
from raytrace_tpu.ops.denoise_pallas import denoise_finalize_pallas
from raytrace_tpu.ops.lighting_pallas import render_gbuffers_fused
from raytrace_tpu.ops.path_vol import render_gbuffers_path
from raytrace_tpu.ops.trace_jax import fuse_volume
from raytrace_tpu.ops.trace_pallas import build_hf_tables
from raytrace_tpu.ops.trace_vol_pallas import build_vol_tables
from raytrace_tpu.render.camera import Camera
from raytrace_tpu.utils.blue_noise import get_blue_noise_f32
from raytrace_tpu.world.generate import generate_chunk
from raytrace_tpu_torch.apps import benchmark
from raytrace_tpu_torch.constants import MAX_TRACE_STEPS
from raytrace_tpu_torch.ops.lighting import EXHAUSTED_DEPTH

SIZE = 32
T = benchmark.step_of_frame(1)  # the second timed frame's step
MIN_MATCH = 0.995


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several workers on one
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_moved(camera: dict, t: float) -> dict:
    """JAX's config uniforms from ``camera`` moved by ``t · (1, 1, 0)``."""
    cam = Camera(origin=list(camera["origin"]))
    cam.pitch = camera["pitch"]
    uni = jax_benchmark._uniforms(cam)
    return dict(uni, origin=uni["origin"] + jnp.float32(t) * jnp.asarray([1.0, 1.0, 0.0]))


def _port_frame(frame_of_step, t: float) -> dict:
    """The step program's frame at step ``t`` (after a warm frame at 0, as
    ``time_steps`` runs it), checked equal to one eager call of the frame
    function -> numpy outputs."""
    program = benchmark.StepProgram(frame_of_step, "cpu")
    assert not program.graphed
    program.run(0.0)
    got = program.run(t)
    again = frame_of_step(torch.tensor(t, dtype=torch.float32))
    assert set(got) == set(again) and all(torch.equal(got[k], again[k]) for k in got)
    return {k: v.numpy() for k, v in got.items()}


def _check_gbuffers(got: dict, want: dict) -> None:
    normal_ok = got["normal"] == want["normal"]
    albedo_ok = (got["albedo"] == want["albedo"]).all(-1)
    close = np.isclose(got["lighting"], want["lighting"], atol=1e-5, rtol=1e-5).all(-1)
    print(f"normal mismatches {int((~normal_ok).sum())}, albedo {int((~albedo_ok).sum())}, "
          f"lighting {int((~close).sum())} of {normal_ok.size}")
    assert normal_ok.mean() >= MIN_MATCH and albedo_ok.mean() >= MIN_MATCH
    assert close.mean() >= MIN_MATCH
    d = np.abs(got["depth"].astype(np.int64) - want["depth"].astype(np.int64))
    assert d[normal_ok].max() <= 1  # one quantum, 1/32 voxel
    np.testing.assert_allclose(got["fog"], want["fog"], atol=1e-6)
    assert int((got["depth"] == EXHAUSTED_DEPTH).sum()) == 0
    assert int((want["depth"] == EXHAUSTED_DEPTH).sum()) == 0


def test_config1_frame_matches_jax():
    """Config 1 (chunk (0, 0, 0) in an empty 256³ volume, b0, max_steps
    1024, volume_fast) at 32² and step t."""
    mats, mf = generate_chunk((0, 0, 0), seed=0)
    vol_m = jnp.zeros((256, 256, 256), jnp.uint32).at[128:192, 128:192, 128:192].set(mats)
    vol_f = jnp.full((256, 256, 256), 6, jnp.uint8).at[128:192, 128:192, 128:192].set(mf)
    fused = fuse_volume(vol_m, vol_f)
    gb = render_gbuffers_path(fused, build_vol_tables(fused),
                              jnp.asarray(get_blue_noise_f32()),
                              _jax_moved(benchmark.CONFIG1_CAMERA, T), SIZE, SIZE, 1024,
                              bounces=0, interpret=True)
    want = {k: np.asarray(v) for k, v in gb.items()}
    got = _port_frame(benchmark.config1_frame("cpu", SIZE, SIZE), T)
    _check_gbuffers(got, want)
    assert 0 < int((got["depth"] != 0xFFFF).sum()) < SIZE * SIZE  # the chunk and sky


def test_config2_frame_matches_jax():
    """Config 2 (the lr 0 region, b1, fused, then the denoise chain) at 32²
    and step t."""
    bn = jnp.asarray(get_blue_noise_f32())
    gb = render_gbuffers_fused(build_hf_tables(jnp.zeros(3, jnp.int32), seed=0), bn,
                               _jax_moved(benchmark.CONFIG2_CAMERA, T), SIZE, SIZE,
                               MAX_TRACE_STEPS, 0, interpret=True, bounces=1)
    want = {k: np.asarray(v) for k, v in gb.items()}
    got = _port_frame(benchmark.config2_frame("cpu", SIZE, SIZE), T)
    _check_gbuffers(got, want)
    port_gb = {k: jnp.asarray(got[k]) for k in want}
    chain = np.asarray(denoise_finalize_pallas(port_gb, bn, interpret=True))
    assert got["frame"].shape == (SIZE, SIZE, 3)
    np.testing.assert_allclose(got["frame"], chain, atol=3e-5)


def test_config2_hf_frame_runs_through_the_program():
    """Config 2 ``--tracer hf`` at 32²: the step program's frame is the
    frame function's, finite, with no primary cut."""
    got = _port_frame(benchmark.config2_frame("cpu", SIZE, SIZE, tracer="hf"), T)
    assert np.isfinite(got["frame"]).all()
    assert int((got["depth"] == EXHAUSTED_DEPTH).sum()) == 0


def test_exhausted_counter_sums_every_frame():
    """The device counter holds the sum of every frame's exhausted pixels,
    read once after the frames; a CPU program is never graphed."""
    rng = np.random.default_rng(3)
    depths = [np.where(rng.random((8, 8)) < p, EXHAUSTED_DEPTH, 100).astype(np.int32)
              for p in (0.1, 0.0, 0.5, 0.3)]
    frames = iter(depths)

    def frame_of_step(t):
        depth = torch.from_numpy(next(frames)).to(torch.uint16)
        return dict(depth=depth, t=t.clone())

    program = benchmark.StepProgram(frame_of_step, "cpu")
    steps = [benchmark.step_of_frame(i) for i in range(len(depths))]
    outs = [program.run(t) for t in steps]
    assert [float(o["t"]) for o in outs] == [float(np.float32(t)) for t in steps]
    assert program.exhausted.dtype == torch.int64 and program.exhausted.dim() == 0
    assert int(program.exhausted) == sum(int((d == EXHAUSTED_DEPTH).sum()) for d in depths)
    assert int(program.exhausted) > 0 and not program.graphed
    assert not benchmark.StepProgram(frame_of_step, "cpu", graphed=True).graphed
