"""The port's public denoise and finalize functions against the JAX
package's of the same name (``raytrace_tpu/ops/__init__.py``):
``denoise_chain``, ``bilateral_denoise`` and ``finalize_frame``.

On the CPU the port runs its plain versions (the plain pass six times,
``finalize_frame_plain``); the JAX side runs its own functions, under
``jax.disable_jit()`` where the comparison is exact.  The inputs are made
with numpy from a seed.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu.ops as jax_ops
import raytrace_tpu_torch.ops as torch_ops
from raytrace_tpu.utils.blue_noise import get_blue_noise_f32
from raytrace_tpu_torch.ops import denoise, finalize


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _gbuffers(h, w, seed):
    """Seeded G-buffers with a sky band, sky depths and exhausted-like far
    depths, as the frame leaves them."""
    rng = np.random.default_rng(seed)
    gb = dict(
        lighting=rng.random((h, w, 3), np.float32),
        depth=(rng.random((h, w)) * 65000).astype(np.uint16),
        normal=rng.integers(0, 6, (h, w)).astype(np.uint8),
        albedo=rng.random((h, w, 3), np.float32),
        emission=rng.random((h, w, 3), np.float32) * 0.1,
        fog=rng.random((h, w, 3), np.float32),
    )
    gb["normal"][:3] = 16  # a sky band
    gb["depth"][:3] = 0xFFFF
    gb["depth"][-1, : w // 2] = 256 * 254
    return gb


def _t(a):
    if a.dtype == np.uint16:
        return torch.from_numpy(a.astype(np.int32)).to(torch.uint16)
    return torch.from_numpy(a)


def test_denoise_chain_matches_jax():
    gb = _gbuffers(40, 48, seed=5)
    want = np.asarray(jax_ops.denoise_chain(
        jnp.asarray(gb["lighting"]), jnp.asarray(gb["depth"]), jnp.asarray(gb["normal"])))
    got = torch_ops.denoise_chain(_t(gb["lighting"]), _t(gb["depth"]), _t(gb["normal"]))
    assert got.shape == (40, 48, 3) and got.dtype == torch.float32
    # The chain's tolerance of test_torch_denoise.py: the port weighs a tap
    # by |dc - dt| / 64, JAX by 4 |dc / 256 - dt / 256|, six passes deep.
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)
    # Sky pixels pass through every pass untouched.
    np.testing.assert_array_equal(got.numpy()[:3], gb["lighting"][:3])


@pytest.mark.parametrize("size", [2, 8])
def test_bilateral_denoise_matches_jax(size):
    gb = _gbuffers(32, 40, seed=size)
    want = np.asarray(jax_ops.bilateral_denoise(
        jnp.asarray(gb["lighting"]), jnp.asarray(gb["depth"]), jnp.asarray(gb["normal"]),
        size))
    got = torch_ops.bilateral_denoise(_t(gb["lighting"]), _t(gb["depth"]), _t(gb["normal"]),
                                      size)
    assert got.shape == (32, 40, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("row0", [0, 5])
@pytest.mark.parametrize("flip", [True, False])
def test_finalize_frame_matches_jax(row0, flip):
    gb = _gbuffers(24, 40, seed=3 + row0)
    bn = get_blue_noise_f32()
    args = [gb[k] for k in ("albedo", "emission", "fog", "lighting", "depth")] + [bn]
    with jax.disable_jit():
        want = np.asarray(jax_ops.finalize_frame(*map(jnp.asarray, args), row0=row0,
                                                 flip=flip))
    got = torch_ops.finalize_frame(*map(_t, args), row0=row0, flip=flip)
    assert got.shape == (24, 40, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_finalize_frame_is_the_chain_fused_finalize():
    """denoise_chain then finalize_frame is denoise_finalize (K2's last pass
    with finalize fused) bit for bit: F1 and K2 share their finalize."""
    gb = {k: _t(v) for k, v in _gbuffers(32, 32, seed=9).items()}
    bn = torch.from_numpy(get_blue_noise_f32())
    den = torch_ops.denoise_chain(gb["lighting"], gb["depth"], gb["normal"])
    got = torch_ops.finalize_frame(gb["albedo"], gb["emission"], gb["fog"], den, gb["depth"],
                                   bn)
    want = denoise.denoise_finalize(gb, bn)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_finalize_and_chain_raise_off_cpu_without_kernel():
    gb = {k: _t(v).to("meta") for k, v in _gbuffers(8, 8, seed=1).items()}
    with pytest.raises(RuntimeError, match="no kernel"):
        finalize.finalize_frame(gb["albedo"], gb["emission"], gb["fog"], gb["lighting"],
                                gb["depth"], torch.zeros(4, 4, 4, device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        denoise.denoise_chain(gb["lighting"], gb["depth"], gb["normal"])


def test_every_jax_ops_export_has_a_counterpart():
    """Each name ``raytrace_tpu/ops/__init__.py`` imports is a callable of
    ``raytrace_tpu_torch.ops``."""
    src = Path(jax_ops.__file__).read_text()
    names = [a.asname or a.name for node in ast.parse(src).body
             if isinstance(node, ast.ImportFrom) for a in node.names]
    assert {"bilateral_denoise", "denoise_chain", "finalize_frame"} <= set(names)
    missing = [n for n in names if not callable(getattr(torch_ops, n, None))]
    assert missing == []
