"""The port's volume_fast G-buffer pass against the JAX package.

Both sides get the JAX package's fused volume and occupancy tables (carried
over with ``convert``).  On the CPU the port runs K3's plain version; the
JAX side runs ``render_gbuffers_path`` with its kernel in interpret mode, as
its own tests do.  Tolerances follow ``tests/test_torch_lighting.py``:
normal and albedo equal and lighting within 1e-5 on at least 99.5% of
pixels (the frameworks' float rounding can flip a grazing voxel), depth
within one quantum where the normals agree, fog within 1e-6, and no
exhausted pixel on either side.  The mismatch counts are printed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytrace_tpu.materials import PACKED_MATERIALS
from raytrace_tpu.ops.path_vol import render_gbuffers_path
from raytrace_tpu.ops.trace_jax import fuse_volume
from raytrace_tpu.ops.trace_vol_pallas import build_vol_tables
from raytrace_tpu.render.camera import Camera
from raytrace_tpu.utils.blue_noise import get_blue_noise_f32
from raytrace_tpu.world.chunk import minefield_from_solid
from raytrace_tpu_torch import convert
from raytrace_tpu_torch.ops import path_vol, trace_vol
from raytrace_tpu_torch.ops.lighting import EXHAUSTED_DEPTH

MIN_MATCH = 0.995


@pytest.fixture(scope="module")
def weird_world():
    """Slab + floating box + cave tunnel (tests/test_path_vol.py:38-47)."""
    solid = np.zeros((256, 256, 256), bool)
    solid[:100] = True
    solid[140:150, 120:140, 120:140] = True
    solid[90:100, 128:132, 128:132] = False
    mats = np.where(solid, np.uint32(PACKED_MATERIALS[5]), np.uint32(0))
    fused = fuse_volume(jnp.asarray(mats), minefield_from_solid(jnp.asarray(solid)))
    return fused, build_vol_tables(fused)


@pytest.fixture(scope="module")
def generated_world(full_world_volume):
    mats, mf = full_world_volume
    fused = fuse_volume(jnp.asarray(mats), jnp.asarray(mf))
    return fused, build_vol_tables(fused)


def _uniforms(origin, pitch, sun=0.6, seed=7):
    cam = Camera(origin=list(origin))
    cam.pitch = pitch
    fwd, up, right = cam.scaled_basis()
    return dict(
        origin=jnp.asarray(cam.origin, jnp.float32),
        forward=jnp.asarray(fwd, jnp.float32),
        up=jnp.asarray(up, jnp.float32),
        right=jnp.asarray(right, jnp.float32),
        sun_angle=jnp.float32(sun),
        seed=jnp.int32(seed),
        lr=jnp.zeros(3, jnp.float32),
    )


# scene, camera origin, pitch, size, bounces, max_steps
CASES = {
    "weird_32px_b0": ("weird_world", (0.0, -80.0, 40.0), -0.4, 32, 0, 4096),
    "weird_32px_b1": ("weird_world", (0.0, -80.0, 40.0), -0.4, 32, 1, 4096),
    "weird_32px_b2": ("weird_world", (0.0, -80.0, 40.0), -0.4, 32, 2, 4096),
    "cave_24px_b2": ("weird_world", (1.0, 1.0, -33.0), -0.1, 24, 2, 4096),
    "world_32px_b2": ("generated_world", (-30.0, -100.0, 60.0), -0.3, 32, 2, 2048),
}


@pytest.fixture(scope="module", params=list(CASES))
def frame_pair(request):
    scene, origin, pitch, size, bounces, steps = CASES[request.param]
    fused, tables = request.getfixturevalue(scene)
    bn = get_blue_noise_f32()
    u = _uniforms(origin, pitch)
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}
    want = render_gbuffers_path(fused, tables, jnp.asarray(bn), u, size, size, steps,
                                bounces=bounces, interpret=True)
    got = path_vol.render_gbuffers_path(
        convert.volume_from_jax(fused, "cpu"),
        convert.vol_tables_from_jax(as_np(tables), "cpu"),
        convert.blue_noise_from_jax(bn, "cpu"),
        convert.uniforms_from_jax(as_np(u), "cpu"),
        size, size, steps, bounces=bounces,
    )
    return {k: v.numpy() for k, v in got.items()}, as_np(want)


def test_normal_albedo_match(frame_pair):
    got, want = frame_pair
    normal_ok = got["normal"] == want["normal"]
    albedo_ok = (got["albedo"] == want["albedo"]).all(-1)
    print(f"normal mismatches {int((~normal_ok).sum())}, albedo mismatches "
          f"{int((~albedo_ok).sum())} of {normal_ok.size}")
    assert normal_ok.mean() >= MIN_MATCH
    assert albedo_ok.mean() >= MIN_MATCH


def test_lighting_matches(frame_pair):
    got, want = frame_pair
    close = np.isclose(got["lighting"], want["lighting"], atol=1e-5, rtol=1e-5).all(-1)
    print(f"lighting mismatches {int((~close).sum())} of {close.size}, max |err| "
          f"{float(np.abs(got['lighting'] - want['lighting']).max())}")
    assert close.mean() >= MIN_MATCH


def test_depth_fog_and_exhaustion(frame_pair):
    got, want = frame_pair
    same = got["normal"] == want["normal"]
    d = np.abs(got["depth"].astype(np.int64) - want["depth"].astype(np.int64))
    assert d[same].max() <= 1  # one quantum, 1/32 voxel
    np.testing.assert_allclose(got["fog"], want["fog"], atol=1e-6)
    assert got["depth"].dtype == np.uint16 and got["normal"].dtype == np.uint8
    assert int((got["depth"] == EXHAUSTED_DEPTH).sum()) == 0
    assert int((want["depth"] == EXHAUSTED_DEPTH).sum()) == 0
    np.testing.assert_array_equal(got["emission"], 0.0)


def test_path_budget():
    assert trace_vol.path_budget(2048, 5) == 2 * 5 * 5 * 416
    assert trace_vol.path_budget(4096, 1) == 2 * 1 * 10 * 416
    assert trace_vol.path_budget(416, 3) == 2 * 3 * 416


def test_cut_paths_report_pink(weird_world, monkeypatch):
    """A budget too small for the grazing primaries cuts them: those pixels
    get the exhausted depth and pink fog, and the frame stays finite."""
    fused, tables = weird_world
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}
    u = convert.uniforms_from_jax(as_np(_uniforms((0.0, -80.0, 12.0), -0.02)), "cpu")
    vol = convert.volume_from_jax(fused, "cpu")
    tabs = convert.vol_tables_from_jax(as_np(tables), "cpu")
    bn = convert.blue_noise_from_jax(get_blue_noise_f32(), "cpu")
    full = path_vol.render_gbuffers_path(vol, tabs, bn, u, 24, 24, 2048, bounces=2)
    assert int((full["depth"].to(torch.int32) == EXHAUSTED_DEPTH).sum()) == 0
    # Three coarse steps and bricks per path.
    monkeypatch.setattr(trace_vol, "path_budget", lambda max_steps, legs: 3)
    gb = path_vol.render_gbuffers_path(vol, tabs, bn, u, 24, 24, 2048, bounces=2)
    pink = gb["depth"].to(torch.int32) == EXHAUSTED_DEPTH
    assert pink.any() and not pink.all()
    done = ~pink
    assert torch.equal(gb["depth"][done], full["depth"][done])
    assert torch.equal(gb["fog"][pink], torch.tensor([1.0, 0.0, 1.0]).expand(int(pink.sum()), 3))
    for v in gb.values():
        assert torch.isfinite(v.to(torch.float32)).all()


def test_march_raises_off_cpu_without_kernel():
    """A tensor on a device with no kernel is refused, never run plain."""
    n = 4
    meta = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device="meta")
    args = (meta(n, 3), meta(n, 3), meta(n, 12), meta(10, dt=torch.int32), meta(4), {})
    with pytest.raises(RuntimeError, match="no kernel"):
        trace_vol.march_paths_vol(*args, 2048, 5)
