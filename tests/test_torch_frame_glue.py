"""The frame glue of the fused and volume_fast programs against the JAX package.

The port's ``rays.frame_rays`` (kernel R1 on the card), ``lighting.shade``
(S1) and ``path_vol.shade`` (S3) take their plain versions on the CPU; this
file holds those against the JAX package:

- R1's frame scalars: the sun and its colour against ``shading.sun_direction``
  and ``sun_color`` run under ``jax.disable_jit()`` (XLA's and PyTorch's CPU
  ``sin``/``cos`` differ in the last bit for some angles: the sun within
  2 ulp, its colour within 2e-5), ``iscal``'s ``maxh`` against
  ``lighting_pallas.py:872``'s expression, the occupancy bounds against
  ``_occupancy_world_bounds`` (integers: equal);
- the camera rays, whole, in a band and from below the region, against
  ``trace_jax.camera_rays`` within 1e-5 relative (the port's ``1/sqrt``
  against XLA's ``rsqrt``);
- the noise: every texel of the texture is an exact k/255 (``fdiv(byte(v),
  255) == v``), which the shade's rebuild of the noise from the packed noise
  word relies on, and the word's bytes give back the noise planes;
- the fused and volume_fast G-buffers at b0 and in a band against JAX's
  ``render_gbuffers_fused`` and ``render_gbuffers_path`` in interpret mode,
  with the tolerances of ``tests/test_torch_lighting.py`` and
  ``tests/test_torch_path_vol.py``;
- each wrapper refusing a tensor on a device with no kernel.

Torch runs on two threads, as in the other port tests under the suite's
workers.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytrace_tpu.materials import PACKED_MATERIALS
from raytrace_tpu.ops import lighting_pallas as jax_lighting
from raytrace_tpu.ops import path_vol as jax_path_vol
from raytrace_tpu.ops import shading as jax_shading
from raytrace_tpu.ops import trace_jax
from raytrace_tpu.ops.trace_pallas import build_hf_tables as jax_build_hf_tables
from raytrace_tpu.ops.trace_vol_pallas import build_vol_tables as jax_build_vol_tables
from raytrace_tpu.render.camera import Camera
from raytrace_tpu.utils.blue_noise import get_blue_noise_f32
from raytrace_tpu.world.chunk import minefield_from_solid
from raytrace_tpu_torch import convert
from raytrace_tpu_torch._f32 import fdiv
from raytrace_tpu_torch.ops import lighting, path_vol, rays, shading
from raytrace_tpu_torch.utils.blue_noise import get_blue_noise_f32 as port_blue_noise

MIN_MATCH = 0.995

torch.set_num_threads(2)


def _as_np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _uniforms(origin=(-30.0, -100.0, 60.0), pitch=-0.3, sun=0.6, seed=7, lr=(0, 0, 0)):
    cam = Camera(origin=list(origin))
    cam.pitch = pitch
    fwd, up, right = cam.scaled_basis()
    return dict(
        origin=jnp.asarray(cam.origin, jnp.float32), forward=jnp.asarray(fwd, jnp.float32),
        up=jnp.asarray(up, jnp.float32), right=jnp.asarray(right, jnp.float32),
        sun_angle=jnp.float32(sun), seed=jnp.int32(seed), lr=jnp.asarray(lr, jnp.float32))


def _port(u):
    return convert.uniforms_from_jax(_as_np(u), "cpu")


@pytest.fixture(scope="module")
def blue():
    bn = get_blue_noise_f32()
    return bn, convert.blue_noise_from_jax(bn, "cpu")


@pytest.fixture(scope="module")
def weird_world():
    """Slab + floating box + cave tunnel (tests/test_path_vol.py:38-47)."""
    solid = np.zeros((256, 256, 256), bool)
    solid[:100] = True
    solid[140:150, 120:140, 120:140] = True
    solid[90:100, 128:132, 128:132] = False
    mats = np.where(solid, np.uint32(PACKED_MATERIALS[5]), np.uint32(0))
    fused = trace_jax.fuse_volume(jnp.asarray(mats), minefield_from_solid(jnp.asarray(solid)))
    tables = jax_build_vol_tables(fused)
    return fused, tables, (convert.volume_from_jax(fused, "cpu"),
                           convert.vol_tables_from_jax(_as_np(tables), "cpu"))


@pytest.fixture(scope="module")
def hf_tables():
    tables = jax_build_hf_tables(jnp.zeros(3, jnp.int32), seed=0)
    return tables, convert.tables_from_jax(_as_np(tables), "cpu")


# --- R1's frame scalars ----------------------------------------------------


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def test_sun_vector_matches_jax():
    """The frame's ``sun`` (8,): sun xyz within 2 ulp, sunlight rgb within
    2e-5 (``sun_color`` multiplies the horizon's last bits by 50 near the
    horizon), 0, 0; equal at the canonical angle 0.6."""
    angles = np.concatenate([np.float32(0.6) + np.float32(0.01) * np.arange(40, dtype=np.float32),
                             np.linspace(-7.0, 7.0, 141, dtype=np.float32)])
    worst, off = 0, 0
    for a in angles:
        with jax.disable_jit():
            d = jax_shading.sun_direction(jnp, jnp.float32(a))
            want = np.array([*map(float, d), *map(float, jax_shading.sun_color(jnp, d))],
                            np.float32)
        got = shading.sun_vector(torch.tensor(a)).numpy()
        assert got.dtype == np.float32 and got.shape == (8,)
        np.testing.assert_array_equal(got[6:], 0.0)
        worst = max(worst, int(_ulps(got[:3], want[:3]).max()))
        off += not np.array_equal(got[:6], want)
        np.testing.assert_allclose(got[3:6], want[3:], rtol=0, atol=2e-5)
        if a == np.float32(0.6):
            np.testing.assert_array_equal(got[:6], want)
    print(f"sun vector: {off} of {len(angles)} angles off, sun worst {worst} ulp")
    assert worst <= 2


def test_fused_scalars_match_jax(blue, hf_tables):
    """``iscal`` = r0, lr, maxh (lighting_pallas.py:872), 0, 0, and ``fscal``
    the sun vector, at two regions."""
    _, bn_t = blue
    for lr in ((0, 0, 0), (-48, 0, 1000)):
        jt = jax_build_hf_tables(jnp.asarray(lr, jnp.int32), seed=3)
        pt = convert.tables_from_jax(_as_np(jt), "cpu")
        u = _uniforms(lr=lr)
        got = rays.frame_rays_plain(_port(u), bn_t, 16, 16, tables=pt, form="fused")
        maxh = int(jnp.max(jt["h3"] & 511).astype(jnp.int32))
        want = [*np.asarray(jt["r0"]), *lr, maxh, 0, 0]
        assert got["iscal"].dtype == torch.int32
        assert got["iscal"].tolist() == [int(v) for v in want]
        assert got["fscal"] is got["sun"]


@pytest.mark.parametrize("lr", [(0, 0, 0), (5, -3, 200), (-130, 7, -77)])
def test_occupancy_bounds_match_jax(lr):
    """``iscal`` = lr, the occupancy bounds, 0 against JAX's
    ``_occupancy_world_bounds`` on random, one-brick and empty tables, lr
    off the brick grid included (a slot that straddles the wrap)."""
    rng = np.random.default_rng(abs(hash(lr)) % 2 ** 32)
    cases = [rng.random((32, 32, 32)) < 0.01, np.zeros((32, 32, 32), bool)]
    one = np.zeros((32, 32, 32), bool)
    one[3, 31, 0] = True
    cases.append(one)
    lr_j = jnp.asarray(lr, jnp.int32)
    for any8b in cases:
        want = np.asarray(jax_path_vol._occupancy_world_bounds(jnp.asarray(any8b), lr_j))
        got = rays.frame_rays_plain(
            _port(_uniforms(lr=lr)), torch.zeros((8, 8, 4)), 4, 4,
            tables={"any8b": torch.from_numpy(any8b)}, form="volume")
        assert got["iscal"].tolist() == [*lr, *want.tolist(), 0]


# --- R1's rays and noise ----------------------------------------------------


@pytest.mark.parametrize("origin,band", [((-30.0, -100.0, 60.0), None),
                                         ((-30.0, -100.0, 60.0), (9, 14)),
                                         ((10.0, -200.0, 60.0), None),
                                         ((10.0, -200.0, 60.0), (20, 12))],
                         ids=["whole", "band", "below", "below_band"])
def test_camera_rays_match_jax(blue, hf_tables, origin, band):
    """R1's origin and direction against ``trace_jax.camera_rays`` within
    1e-5 relative; the ``below`` case (origin y < -128) starts each ray on
    the region's floor."""
    _, bn_t = blue
    u = _uniforms(origin=origin, pitch=0.3)
    w, h = 24, 40
    row0, rows = band or (0, h)
    o_j, d_j = trace_jax.camera_rays(u, w, h, row0, rows)
    got = rays.frame_rays_plain(_port(u), bn_t, w, h, row0, rows, tables=hf_tables[1],
                                form="fused")
    o_p = got["origin"].reshape(rows, w, 3).numpy()
    d_p = got["direction"].reshape(rows, w, 3).numpy()
    np.testing.assert_allclose(d_p, np.asarray(d_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(o_p, np.asarray(o_j), rtol=1e-5, atol=1e-5)
    if origin[1] < -128:
        assert not np.allclose(o_p, np.asarray(origin, np.float32))
        np.testing.assert_allclose(o_p[..., 1], -128.0, atol=1e-2)


def test_blue_noise_is_exact_k_over_255():
    """Every texel v of the texture is an exact k/255: ``fdiv(byte(v), 255)
    == v``, bit for bit.  The shade rebuilds the noise from the packed noise
    word's bytes on that account."""
    bn = torch.from_numpy(port_blue_noise())
    byte = torch.round(bn * 255.0).to(torch.int32)
    assert torch.equal(fdiv(byte.to(torch.float32), 255.0).view(torch.int32),
                       bn.view(torch.int32))
    np.testing.assert_array_equal(bn.numpy(), get_blue_noise_f32())


def test_noise_word_gives_back_the_noise_planes(blue, hf_tables):
    """The fused form's noise word holds noise1 and noise2's r, g bytes: its
    bytes as k/255 equal ``frame_noise``'s planes (a band's too)."""
    _, bn_t = blue
    u = _port(_uniforms(seed=12345))
    for row0, rows in ((0, 32), (7, 9)):
        got = rays.frame_rays_plain(u, bn_t, 32, 32, row0, rows, tables=hf_tables[1],
                                    form="fused")
        n1, n2 = rays.frame_noise(bn_t, u["seed"], 32, 32, row0, rows)
        want = [n1[..., 0], n1[..., 1], n2[..., 0], n2[..., 1]]
        for b, w in zip(lighting.noise_bytes(got["nw"]), want):
            assert torch.equal(b.reshape(rows, 32), w)


def test_frame_rays_band_equals_whole_rows(blue, hf_tables, weird_world):
    """Both forms: a band's outputs are the same rows of the whole frame's,
    bit for bit, and the scalars the whole frame's (32 columns, so no CPU
    vector tail)."""
    _, bn_t = blue
    u = _port(_uniforms(seed=3))
    for form, tables in (("fused", hf_tables[1]), ("volume", weird_world[2][1])):
        whole = rays.frame_rays_plain(u, bn_t, 32, 24, tables=tables, form=form)
        band = rays.frame_rays_plain(u, bn_t, 32, 24, 5, 11, tables=tables, form=form)
        for k, v in band.items():
            want = whole[k] if v.shape == whole[k].shape else whole[k][5 * 32:16 * 32]
            assert torch.equal(v, want), (form, k)


# --- The G-buffers against JAX ----------------------------------------------


def _assert_gbuffers_close(got, want):
    """The bounds of tests/test_torch_lighting.py and test_torch_path_vol.py."""
    normal_ok = got["normal"] == want["normal"]
    albedo_ok = (got["albedo"] == want["albedo"]).all(-1)
    close = np.isclose(got["lighting"], want["lighting"], atol=1e-5, rtol=1e-5).all(-1)
    print(f"normal {int((~normal_ok).sum())}, albedo {int((~albedo_ok).sum())}, "
          f"lighting {int((~close).sum())} mismatches of {normal_ok.size}")
    assert normal_ok.mean() >= MIN_MATCH and albedo_ok.mean() >= MIN_MATCH
    assert close.mean() >= MIN_MATCH
    d = np.abs(got["depth"].astype(np.int64) - want["depth"].astype(np.int64))
    assert d[normal_ok].max() <= 1
    np.testing.assert_allclose(got["fog"], want["fog"], atol=1e-6)
    assert got["depth"].dtype == np.uint16 and got["normal"].dtype == np.uint8
    assert int((got["depth"] == 65024).sum()) == 0 == int((want["depth"] == 65024).sum())
    np.testing.assert_array_equal(got["emission"], 0.0)
    assert (want["normal"] < 16).any() and (want["normal"] == 16).any()


# (width, height, bounces, band)
GBUFFER_CASES = {"b0_32px": (32, 32, 0, None), "b1_band_20+12": (32, 40, 1, (20, 12))}


@pytest.mark.parametrize("case", list(GBUFFER_CASES))
def test_fused_gbuffers_match_jax(blue, hf_tables, case):
    w, h, bounces, band = GBUFFER_CASES[case]
    bn, bn_t = blue
    u = _uniforms()
    row0, rows = band or (0, None)
    want = jax_lighting.render_gbuffers_fused(
        hf_tables[0], jnp.asarray(bn), u, w, h, max_steps=2048, seed=0, interpret=True,
        bounces=bounces, row0=row0, rows=rows)
    got = lighting.render_gbuffers_fused(hf_tables[1], bn_t, _port(u), w, h, 2048, 0,
                                         row0=row0, rows=rows, bounces=bounces)
    assert tuple(got["depth"].shape) == (rows or h, w)
    _assert_gbuffers_close({k: v.numpy() for k, v in got.items()}, _as_np(want))


@pytest.mark.parametrize("case", list(GBUFFER_CASES))
def test_volume_fast_gbuffers_match_jax(blue, weird_world, case):
    w, h, bounces, band = GBUFFER_CASES[case]
    bn, bn_t = blue
    fused, tables, (volume, ptables) = weird_world
    u = _uniforms(origin=(0.0, -80.0, 40.0), pitch=-0.4)
    row0, rows = band or (0, None)
    want = jax_path_vol.render_gbuffers_path(fused, tables, jnp.asarray(bn), u, w, h, 4096,
                                             row0=row0, rows=rows, bounces=bounces,
                                             interpret=True)
    got = path_vol.render_gbuffers_path(volume, ptables, bn_t, _port(u), w, h, 4096, row0,
                                        rows, bounces=bounces)
    _assert_gbuffers_close({k: v.numpy() for k, v in got.items()}, _as_np(want))


# --- The wrappers refuse a device with no kernel ------------------------------


def test_wrappers_raise_off_cpu_without_kernel():
    """A tensor on a device with no kernel is refused, never run plain."""
    meta = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device="meta")
    n = 16
    u = dict(origin=meta(3), forward=meta(3), up=meta(3), right=meta(3), sun_angle=meta(()),
             seed=meta((), dt=torch.int32), lr=meta(3))
    with pytest.raises(RuntimeError, match="no kernel"):
        rays.frame_rays(u, meta(8, 8, 4), 4, 4, tables={}, form="fused")
    with pytest.raises(RuntimeError, match="no kernel"):
        lighting.shade(meta(n, dt=torch.int32), meta(n), meta(n, 3), meta(n, dt=torch.int32),
                       meta(8), (4, 4))
    with pytest.raises(RuntimeError, match="no kernel"):
        path_vol.shade(meta(256 ** 3, dt=torch.int32), meta(n, dt=torch.int32),
                       meta(n, dt=torch.int32), meta(n, dt=torch.int32), meta(n),
                       meta(n, 3), meta(n, 12), meta(8), (4, 4), 5)
    with pytest.raises(RuntimeError, match="no kernel"):
        rays.frame_rays(u, meta(8, 8, 4), 4, 4, tables={}, form="hf")
    with pytest.raises(RuntimeError, match="no kernel"):
        rays.frame_rays(u, meta(8, 8, 4), 4, 4, tables=None, form="dda")
    with pytest.raises(ValueError, match="form"):
        rays.frame_rays(u, meta(8, 8, 4), 4, 4, tables={}, form="raster")
