"""The port's fused G-buffer pass against the JAX package's Pallas kernel.

Both sides get the JAX package's region tables (carried over with
``convert.tables_from_jax``), so the comparison isolates the march and the
shade from the builder's last-ulp height differences.  On the CPU the port
runs the march's plain version; the JAX side runs its kernel in interpret
mode, as its own tests do.  Tolerances follow
``tests/test_lighting_fused.py``, with one allowance: normal, albedo and
lighting must agree on at least 99.5% of pixels rather than all, for
grazing voxels where the two frameworks' float rounding can flip a hit.
The mismatch counts are printed either way.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytrace_tpu.ops import lighting_pallas as jax_lighting
from raytrace_tpu.ops.trace_pallas import build_hf_tables
from raytrace_tpu.render.pipeline import FrameUniforms
from raytrace_tpu.utils.blue_noise import get_blue_noise_f32
from raytrace_tpu_torch import convert
from raytrace_tpu_torch.ops import lighting

MIN_MATCH = 0.995


def _canonical_uniforms():
    pitch = -0.3
    return FrameUniforms(
        origin=(-30.0, -100.0, 60.0),
        sun_angle=0.6,
        forward=(0.0, float(np.cos(pitch)), float(np.sin(pitch))),
        up=(0.0, -0.4 * float(np.sin(pitch)), 0.4 * float(np.cos(pitch))),
        right=(0.4, 0.0, 0.0),
    ).as_device_dict()


def _frame_pair(size, bounces):
    bn = get_blue_noise_f32()
    u = _canonical_uniforms()
    tables = build_hf_tables(jnp.zeros(3, jnp.int32), seed=0)
    want = jax_lighting.render_gbuffers_fused(
        tables, jnp.asarray(bn), u, size, size, max_steps=2048, seed=0,
        interpret=True, bounces=bounces,
    )
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}
    got = lighting.render_gbuffers_fused(
        convert.tables_from_jax(as_np(tables), "cpu"),
        convert.blue_noise_from_jax(bn, "cpu"),
        convert.uniforms_from_jax(as_np(u), "cpu"),
        size, size, max_steps=2048, seed=0, bounces=bounces,
    )
    return {k: v.numpy() for k, v in got.items()}, as_np(want)


@pytest.fixture(scope="module", params=[(64, 2), (32, 1)], ids=["64px_b2", "32px_b1"])
def frame_pair(request):
    return _frame_pair(*request.param)


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
    assert int((got["depth"] == lighting.EXHAUSTED_DEPTH).sum()) == 0
    assert int((want["depth"] == lighting.EXHAUSTED_DEPTH).sum()) == 0
    np.testing.assert_array_equal(got["emission"], 0.0)


def test_mat_code_equal():
    rng = np.random.default_rng(9)
    x, y = (rng.integers(-5000, 5000, 4096).astype(np.int32) for _ in range(2))
    z = rng.integers(-10, 250, 4096).astype(np.int32)
    want = np.asarray(jax_lighting._mat_code(*map(jnp.asarray, (x, y, z)), 0))
    got = lighting.mat_code(*map(torch.from_numpy, (x, y, z)), 0)
    np.testing.assert_array_equal(got.numpy(), want)
    lighting.check_material_codes()


def test_march_raises_off_cpu_without_kernel():
    """A tensor on a device with no kernel is refused, never run plain."""
    n = 4
    meta = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device="meta")
    args = (meta(n, 3), meta(n, 3), meta(n, dt=torch.int32), meta(8, dt=torch.int32),
            meta(8), {})
    with pytest.raises(RuntimeError, match="no kernel"):
        lighting.march_paths(*args, 16, 0, 5)


def test_sphere_trig_table_gives_the_plain_sphere_points():
    """K1 builds its sphere points from ``sphere_trig``: for every noise
    byte pair the table's sin and cos give shading.sphere_point's bits."""
    from raytrace_tpu_torch._f32 import fdiv
    from raytrace_tpu_torch.ops import shading

    k = torch.arange(256, dtype=torch.int32)
    kr, kg = k.repeat_interleave(256), k.repeat(256)
    nr, ng = (fdiv(v.to(torch.float32), 255.0) for v in (kr, kg))
    want = shading.sphere_point(nr, ng)
    trig = lighting.sphere_trig("cpu")
    assert trig.shape == (256, 2) and trig.dtype == torch.float32
    cos_t2 = torch.clamp(1.0 - 2.0 * ng, -1.0, 1.0)
    sin_t2 = torch.sqrt(torch.clamp(1.0 - cos_t2 * cos_t2, min=0.0))
    got = (trig[kr.long(), 0] * sin_t2, trig[kr.long(), 1] * sin_t2, cos_t2)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
