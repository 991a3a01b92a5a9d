"""Row bands and the tile split of the port, on the CPU.

- **Bands against JAX**, at ``row0 != 0``: ``camera_rays``, ``frame_noise``
  and the finalize dither against ``trace_jax.camera_rays``/``frame_noise``
  and ``finalize.finalize_frame(row0=..., flip=False)``; the fused and the
  volume_fast G-buffers of a band against the JAX package's banded
  ``render_gbuffers_fused`` (interpret mode) and ``render_gbuffers_path``,
  with the tolerances of ``tests/test_torch_lighting.py`` and
  ``tests/test_torch_path_vol.py``.
- **Bands against the port's own whole frame, bit for bit**, for every
  tracer and the staged volume tracer, and the finalizing pass's row
  window against the whole chain's rows.  On the CPU this holds for a band
  whose pixel count is a multiple of 32: PyTorch's CPU ``pow`` and ``sin``
  give another last bit in the scalar tail of a vectorized loop than in
  its vector body (the CUDA ops have no such tail).  Bands with a tail
  are held to the bound ``integrate_gbuffers`` states: lighting and fog
  within 4 units in the last place, every other G-buffer equal.
- **The tile split on gloo** (``testing/ranks.render_tiled_gloo``: one
  process per rank, file store): every rank's frame equals the port's
  whole-frame ``denoise_finalize`` bit for bit, for fused and volume_fast
  at 2 ranks of 128-row bands (the one-exchange plan) and 4 ranks of
  16-row bands (the gather plan), and at one rank with no process group;
  the 4-rank fused frame matches JAX's single-device frame within
  ``compare_images``: the committed 64² golden, which
  ``tests/test_pipeline.py`` holds the JAX package's live frame to.
  ``tiles.denoise_in_turn`` (the band regions, chains and assembly run
  band after band in one process, as ``chip_smoke.py`` runs them on the
  card) gives the whole frame for both multi-band plans.
"""

import math
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytrace_tpu.ops import lighting_pallas as jax_lighting
from raytrace_tpu.ops import path_vol as jax_path_vol
from raytrace_tpu.ops import trace_jax
from raytrace_tpu.ops.finalize import finalize_frame
from raytrace_tpu.ops.trace_pallas import build_hf_tables as jax_build_hf_tables
from raytrace_tpu.ops.trace_vol_pallas import build_vol_tables as jax_build_vol_tables
from raytrace_tpu.render.pipeline import FrameUniforms as JaxUniforms
from raytrace_tpu.utils.blue_noise import get_blue_noise_f32
from raytrace_tpu_torch import convert
from raytrace_tpu_torch.ops import denoise, finalize, rays
from raytrace_tpu_torch.ops.hf_tables import build_hf_tables
from raytrace_tpu_torch.ops.trace_vol import render_gbuffers_vol
from raytrace_tpu_torch.ops.vol_tables import build_vol_tables
from raytrace_tpu_torch.ops.volume import fuse_volume
from raytrace_tpu_torch.parallel import tiles
from raytrace_tpu_torch.render.pipeline import FrameUniforms, frame_gbuffers, unpack_uniforms
from raytrace_tpu_torch.testing.golden import compare_images
from raytrace_tpu_torch.testing.ranks import render_tiled_gloo

MIN_MATCH = 0.995


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _canonical(cls, seed=0):
    pitch = -0.3
    return cls(origin=(-30.0, -100.0, 60.0), sun_angle=0.6, seed=seed,
               forward=(0.0, math.cos(pitch), math.sin(pitch)),
               up=(0.0, -0.4 * math.sin(pitch), 0.4 * math.cos(pitch)),
               right=(0.4, 0.0, 0.0))


def _as_np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def inputs():
    """The canonical view's uniforms (JAX dict, port dict) and the blue noise
    (numpy, port tensor)."""
    bn = get_blue_noise_f32()
    ju = _canonical(JaxUniforms).as_device_dict()
    return ju, unpack_uniforms(torch.from_numpy(_canonical(FrameUniforms).packed())), \
        bn, torch.from_numpy(bn)


@pytest.fixture(scope="module")
def volume_world(full_world_volume):
    """The generated region around the origin, fused, with its occupancy
    tables: the port's (volume, tables) pair."""
    mats, mf = full_world_volume
    vol = fuse_volume(torch.from_numpy(mats.astype(np.int32)), torch.from_numpy(mf))
    return vol, build_vol_tables(vol)


@pytest.fixture(scope="module")
def hf_world():
    return build_hf_tables((0, 0, 0), seed=0, device="cpu")


# --- Bands against JAX ---------------------------------------------------


def test_band_rays_noise_and_dither_match_jax(inputs):
    """A band's camera rays (within 1e-6: the port's 1/sqrt against XLA's
    rsqrt), noise planes (equal) and finalized colour with its dither rows
    (within 2e-5, as ``test_torch_denoise``) against JAX's banded ones."""
    ju, pu, bn, bn_t = inputs
    w, h, row0, rows = 48, 96, 37, 20
    o_j, d_j = trace_jax.camera_rays(ju, w, h, row0, rows)
    o_p, d_p = rays.camera_rays(pu, w, h, row0, rows)
    assert tuple(d_p.shape) == (rows, w, 3)
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(o_p.numpy(), np.asarray(o_j), rtol=1e-6, atol=1e-5)
    for got, want in zip(rays.frame_noise(bn_t, pu["seed"], w, h, row0, rows),
                         trace_jax.frame_noise(jnp.asarray(bn), ju["seed"], w, h, row0, rows)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    rng = np.random.default_rng(3)
    albedo, fog, light = (rng.random((rows, w, 3), np.float32) * s for s in (1, 0.3, 0.2))
    emission = np.zeros((rows, w, 3), np.float32)
    depth = (rng.random((rows, w)) * 65535).astype(np.uint16)
    want = finalize_frame(*map(jnp.asarray, (albedo, emission, fog, light, depth, bn)),
                          row0=row0, flip=False)
    planar = lambda a: torch.from_numpy(a).permute(2, 0, 1)
    got = finalize.finalize_planar(
        planar(albedo), planar(emission), planar(fog), planar(light),
        torch.from_numpy(depth.astype(np.float32)),
        finalize.dither_planes(bn_t, rows, w, row0))
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), np.asarray(want), atol=2e-5)


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
    assert (want["normal"] < 16).any()  # the band holds terrain


def test_fused_band_matches_jax(inputs):
    """Rows 24..40 of a 32x64 fused frame, b2, against JAX's banded
    render_gbuffers_fused with its kernel in interpret mode."""
    ju, pu, bn, bn_t = inputs
    tables = jax_build_hf_tables(jnp.zeros(3, jnp.int32), seed=0)
    want = jax_lighting.render_gbuffers_fused(
        tables, jnp.asarray(bn), ju, 32, 64, max_steps=2048, seed=0, interpret=True,
        row0=24, rows=16)
    got = frame_gbuffers(convert.tables_from_jax(_as_np(tables), "cpu"), bn_t, pu, 32, 64,
                         tracer="fused", row0=24, rows=16)
    assert tuple(got["depth"].shape) == (16, 32)
    _assert_gbuffers_close({k: v.numpy() for k, v in got.items()}, _as_np(want))


def test_volume_fast_band_matches_jax(inputs, full_world_volume):
    """Rows 24..40 of a 32x64 volume_fast frame of the generated world, b2,
    against JAX's banded render_gbuffers_path in interpret mode."""
    ju, pu, bn, bn_t = inputs
    mats, mf = full_world_volume
    fused = trace_jax.fuse_volume(jnp.asarray(mats), jnp.asarray(mf))
    tables = jax_build_vol_tables(fused)
    want = jax_path_vol.render_gbuffers_path(fused, tables, jnp.asarray(bn), ju, 32, 64,
                                             2048, row0=24, rows=16, interpret=True)
    world = (convert.volume_from_jax(fused, "cpu"),
             convert.vol_tables_from_jax(_as_np(tables), "cpu"))
    got = frame_gbuffers(world, bn_t, pu, 32, 64, tracer="volume_fast", row0=24, rows=16)
    _assert_gbuffers_close({k: v.numpy() for k, v in got.items()}, _as_np(want))


# --- Bands against the port's whole frame --------------------------------


def _same(a, b):
    wide = lambda t: t.to(torch.int32) if t.dtype == torch.uint16 else t  # no uint16 ==
    return torch.equal(wide(a), wide(b))


BANDS = [(0, 16), (16, 32), (36, 12)]  # (row0, rows) of a 16x64 frame


@pytest.mark.parametrize("tracer", ["fused", "hf", "volume_fast", "volume", "staged_volume"])
def test_bands_equal_whole_frame_rows(inputs, hf_world, volume_world, tracer):
    """Every G-buffer of each band equals the same rows of the whole
    frame's, bit for bit."""
    _, pu, _, bn_t = inputs
    if tracer == "staged_volume":
        render = lambda **band: render_gbuffers_vol(*volume_world, bn_t, pu, 16, 64, **band)
    else:
        world = {"fused": hf_world, "hf": hf_world, "volume_fast": volume_world,
                 "volume": volume_world[0]}[tracer]
        render = lambda **band: frame_gbuffers(world, bn_t, pu, 16, 64, tracer=tracer, **band)
    whole = render()
    assert (whole["normal"] < 16).any() and (whole["normal"] == 16).any()
    for row0, rows in BANDS:
        band = render(row0=row0, rows=rows)
        for key, value in whole.items():
            assert _same(band[key], value[row0:row0 + rows]), (tracer, key, row0)


# (row0, rows) of a 16x64 frame whose pixel count (16 * rows) leaves a
# 16-pixel tail after the vectorized loop's body
TAIL_BANDS = [(29, 7), (40, 5)]


@pytest.mark.parametrize("tracer", ["fused", "volume_fast"])
def test_bands_with_a_tail_within_last_bits(inputs, hf_world, volume_world, tracer):
    """A band whose pixel count is not a multiple of 32 against the same
    rows of the whole frame on the CPU: depth, normal, albedo and emission
    equal, lighting and fog within 4 units in the last place."""
    _, pu, _, bn_t = inputs
    world = hf_world if tracer == "fused" else volume_world
    whole = frame_gbuffers(world, bn_t, pu, 16, 64, tracer=tracer)
    for row0, rows in TAIL_BANDS:
        band = frame_gbuffers(world, bn_t, pu, 16, 64, tracer=tracer, row0=row0, rows=rows)
        for key, value in whole.items():
            got, want = band[key], value[row0:row0 + rows]
            if key in ("lighting", "fog"):
                print(tracer, row0, key, int((got != want).sum()), "values differ")
                np.testing.assert_array_max_ulp(got.numpy(), want.numpy(), maxulp=4)
            else:
                assert _same(got, want), (tracer, key, row0)


def test_finalize_window_equals_whole_chain_rows(inputs, hf_world):
    """The chain with its finalizing pass on a row window (the band's
    albedo, emission and fog, the dither of its image rows) gives the
    window's rows of the whole chain's frame, flipped over the window."""
    _, pu, _, bn_t = inputs
    gb = frame_gbuffers(hf_world, bn_t, pu, 32, 64)
    whole = denoise.denoise_finalize(gb, bn_t)
    for first, count in ((0, 64), (0, 16), (20, 7), (63, 1)):
        band = {k: (v[first:first + count] if k in ("albedo", "emission", "fog") else v)
                for k, v in gb.items()}
        got = denoise.denoise_finalize(band, bn_t, window=(first, count), dither_row0=first)
        assert torch.equal(got, whole.flip(0)[first:first + count].flip(0)), first
    with pytest.raises(ValueError, match="window"):
        denoise.denoise_finalize(gb, bn_t, window=(60, 8))


# --- The tile split ------------------------------------------------------

# name: (tracer, ranks, width, height, plan); ranks 0 = no process group
TILED = {
    "fused_2ranks_16x256": ("fused", 2, 16, 256, "halo"),
    "volume_fast_2ranks_16x256": ("volume_fast", 2, 16, 256, "halo"),
    "fused_4ranks_64": ("fused", 4, 64, 64, "gather"),
    "volume_fast_4ranks_64": ("volume_fast", 4, 64, 64, "gather"),
    "fused_no_group_64": ("fused", 0, 64, 64, "whole"),
}


@pytest.fixture(scope="module")
def tiled_frames(inputs, hf_world, volume_world):
    """name -> (every rank's frame, the whole-frame reference), run once."""
    _, pu, _, bn_t = inputs
    cache = {}

    def run(name):
        if name not in cache:
            tracer, ranks, w, h, _ = TILED[name]
            world = hf_world if tracer == "fused" else volume_world
            args = dict(world=world, blue_noise=bn_t, uniforms=pu, width=w, height=h,
                        tracer=tracer)
            want = denoise.denoise_finalize(frame_gbuffers(world, bn_t, pu, w, h,
                                                           tracer=tracer), bn_t)
            if ranks == 0:
                frames = [tiles.render_frame_tiled(**args)]
            else:
                with tempfile.TemporaryDirectory() as work:
                    frames = render_tiled_gloo(ranks, work, **args)
            cache[name] = (frames, want)
        return cache[name]

    return run


@pytest.mark.parametrize("name", list(TILED))
def test_tiled_frame_equals_whole_frame(tiled_frames, name):
    tracer, ranks, w, h, how = TILED[name]
    assert tiles.plan(max(ranks, 1), h // max(ranks, 1)) == how
    frames, want = tiled_frames(name)
    assert len(frames) == max(ranks, 1)
    assert tuple(want.shape) == (h, w, 3) and bool(torch.isfinite(want).all())
    for rank, frame in enumerate(frames):
        assert torch.equal(frame, want), (name, rank)


def test_tiled_frame_matches_jax_golden(tiled_frames):
    """The 4-rank fused frame against JAX's single-device 64² frame of the
    canonical view (seed 0): the committed golden."""
    frames, _ = tiled_frames("fused_4ranks_64")
    want = np.load(Path(__file__).parent / "goldens" / "terrain_frame_64.npz")["frame"]
    stats = compare_images(frames[0].numpy(), want)
    print(stats)
    assert stats["ok"], stats


@pytest.mark.parametrize("w,h,n,how", [(16, 256, 2, "halo"), (64, 64, 4, "gather")])
def test_tile_split_pieces_assemble_in_one_process(inputs, hf_world, w, h, n, how):
    """The band functions the collectives call, called band after band in
    one process (``tiles.denoise_in_turn``) on separately rendered bands:
    2 bands of 128 rows (halo plan) and 4 of 16 rows (gather plan) give the
    whole frame bit for bit."""
    _, pu, _, bn_t = inputs
    band = h // n
    gbs = [frame_gbuffers(hf_world, bn_t, pu, w, h, row0=r * band, rows=band)
           for r in range(n)]
    assert tiles.plan(n, band) == how
    above = tiles.halo_rows(gbs[0], "bottom") if how == "halo" else None
    region, first = tiles.band_region(how, 1, gbs[1], above, None, gbs)
    assert region["depth"].shape[0] == (band + tiles.ROW_HALO if how == "halo" else h)
    assert first == (tiles.ROW_HALO if how == "halo" else band)
    want = denoise.denoise_finalize(frame_gbuffers(hf_world, bn_t, pu, w, h), bn_t)
    assert torch.equal(tiles.denoise_in_turn(gbs, bn_t), want)
