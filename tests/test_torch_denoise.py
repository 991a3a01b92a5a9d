"""The port's denoise chain and finalize against the JAX package.

On the CPU the port runs its plain pass; the JAX side runs its Pallas
chain in interpret mode, and its NumPy oracles for one pass and for
finalize.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytrace_tpu.ops import denoise as jax_denoise
from raytrace_tpu.ops.denoise_pallas import denoise_finalize_pallas
from raytrace_tpu.ops.finalize import finalize_frame_np
from raytrace_tpu.utils.blue_noise import get_blue_noise_f32
from raytrace_tpu_torch.ops import denoise, finalize


def _gbuffers(h, w, seed):
    rng = np.random.default_rng(seed)
    gb = dict(
        lighting=rng.random((h, w, 3), np.float32),
        depth=(rng.random((h, w)) * 65000).astype(np.uint16),
        normal=rng.integers(0, 6, (h, w)).astype(np.uint8),
        albedo=rng.random((h, w, 3), np.float32),
        emission=rng.random((h, w, 3), np.float32) * 0.1,
        fog=rng.random((h, w, 3), np.float32),
    )
    gb["normal"][:4] = 16  # a sky band
    gb["depth"][:4] = 0xFFFF
    return gb


def _to_torch(gb):
    out = {k: torch.from_numpy(v) for k, v in gb.items() if k != "depth"}
    out["depth"] = torch.from_numpy(gb["depth"].astype(np.int32)).to(torch.uint16)
    return out


def test_denoise_finalize_matches_pallas_chain():
    gb = _gbuffers(40, 48, seed=5)
    bn = get_blue_noise_f32()
    want = np.asarray(denoise_finalize_pallas(
        {k: jnp.asarray(v) for k, v in gb.items()}, jnp.asarray(bn), interpret=True))
    got = denoise.denoise_finalize(_to_torch(gb), torch.from_numpy(bn)).numpy()
    assert got.shape == (40, 48, 3)
    np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("size", [1, 2, 16])
def test_single_pass_matches_oracle(size):
    gb = _gbuffers(32, 32, seed=0)
    t = _to_torch(gb)
    geom = denoise.geometry_plane(t["depth"], t["normal"])
    got = denoise.denoise_pass(t["lighting"].permute(2, 0, 1).contiguous(), geom, size)
    want = jax_denoise.bilateral_denoise_np(gb["lighting"], gb["depth"], gb["normal"], size)
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, atol=2e-5)


def test_finalize_matches_oracle():
    rng = np.random.default_rng(2)
    h = w = 32
    albedo = rng.random((h, w, 3), np.float32)
    emission = np.zeros((h, w, 3), np.float32)
    fog = rng.random((h, w, 3), np.float32) * 0.3
    light = rng.random((h, w, 3), np.float32) * 0.2
    depth = (rng.random((h, w)) * 65535).astype(np.uint16)
    bn = rng.random((512, 512, 4)).astype(np.float32)
    planar = lambda a: torch.from_numpy(a).permute(2, 0, 1)
    got = finalize.finalize_planar(
        planar(albedo), planar(emission), planar(fog), planar(light),
        torch.from_numpy(depth.astype(np.float32)),
        finalize.dither_planes(torch.from_numpy(bn), h, w))
    want = finalize_frame_np(albedo, emission, fog, light, depth, bn)
    # The oracle returns the frame in window orientation (flipped rows).
    np.testing.assert_allclose(got.permute(1, 2, 0).flip(0).numpy(), want, atol=2e-5)


def test_kernel_tap_table_matches_taps():
    """csrc/denoise.cu spells out ops/denoise.py _TAPS; keep them equal."""
    src = (Path(denoise.__file__).parent.parent / "csrc" / "denoise.cu").read_text()

    def table(name):
        body = re.search(name + r"\[kTaps\] = \{([^}]*)\}", src).group(1)
        return [float(v.rstrip("f")) for v in body.replace("\n", " ").split(",")
                if v.strip()]

    assert table("kTapDx") == [dx for dx, _, _ in denoise._TAPS]
    assert table("kTapDy") == [dy for _, dy, _ in denoise._TAPS]
    assert table("kTapW") == [w for _, _, w in denoise._TAPS]
    assert f"kTaps = {len(denoise._TAPS)};" in src
    assert f"kCenterWeight = {denoise._CENTER_WEIGHT}f" in src
    assert denoise._TAPS == [tuple(t) for t in jax_denoise._TAPS]


def test_pass_raises_off_cpu_without_kernel():
    light = torch.zeros(3, 8, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        denoise.denoise_pass(light, torch.zeros(8, 8, device="meta"), 1)


def test_geometry_key_unpacks_as_geometry_plane():
    """K2's working-plane key of every u16 depth and every normal < 32
    gives back the geometry plane's depth and normal exactly, and the tap
    term |dc/64 - dt/64| is |dc - dt| / 64 bit for bit."""
    depth = torch.arange(65536, dtype=torch.int32).repeat_interleave(32)
    normal = torch.arange(32, dtype=torch.int32).repeat(65536)
    geom = denoise.geometry_plane(depth.to(torch.uint16), normal.to(torch.uint8))
    dc, nc = denoise._unpack(geom)
    bits = denoise.geometry_key(geom).view(torch.int32)
    d64 = (bits & ~31).view(torch.float32)
    assert torch.equal(d64 * 64.0, dc)
    assert torch.equal((bits & 31).to(torch.float32), nc)
    assert torch.equal(nc.to(torch.int32), normal) and torch.equal(dc.to(torch.int32), depth)
    rng = np.random.default_rng(11)
    a, b = (torch.from_numpy(rng.integers(0, d64.numel(), 1 << 20)) for _ in range(2))
    got = torch.abs(d64[a] - d64[b])
    want = torch.abs(dc[a] - dc[b]) * (1.0 / 64.0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_finalize_raises_off_cpu_without_kernel():
    gb = {k: v.to("meta") for k, v in _to_torch(_gbuffers(8, 8, seed=1)).items()}
    with pytest.raises(RuntimeError, match="no kernel"):
        denoise.denoise_finalize(gb, torch.zeros(4, 4, 4, device="meta"))


def test_pass_keys_name_the_chain():
    from raytrace_tpu_torch.testing.measure import pass_keys

    assert pass_keys(denoise.DENOISE_SIZES) == ["1", "2", "4", "8", "8#2", "fin"]
