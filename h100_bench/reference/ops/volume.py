"""[Frozen copy of ``raytrace_tpu_torch/ops/volume.py`` for the benchmark's reference:
its plain PyTorch code only, without the kernel wrappers.]

The fused volume format.

Port of ``raytrace_tpu/ops/trace_jax.py:38-52``: ``STEP_SHIFT``,
``MATERIAL_MASK``, ``fuse_volume`` and the toroidal lookup ``_lookup``.
The resident world is one (256^3,) word per voxel in (z, y, x) texel order:
the minefield step in bits 24-31 and the packed material in the low bits.
The JAX package holds the words as uint32; the port holds the same bits in
int32 tensors.  Every word it builds is below 2^31 (a step is at most 6), so
the int32 value equals the unsigned one; a caller that widens masks first.
"""

from __future__ import annotations

import torch

from ..constants import ROOT_BLOCK_SIZE

STEP_SHIFT = 24  # minefield bits in the fused volume
MATERIAL_MASK = (1 << STEP_SHIFT) - 1
_HALF = ROOT_BLOCK_SIZE // 2
_N = ROOT_BLOCK_SIZE


def fuse_volume(materials: torch.Tensor, minefield: torch.Tensor) -> torch.Tensor:
    """Pack packed materials (int32 bits) and the u8 minefield into the
    flat fused volume (int32; int32 shifts and ors give the same bits as
    the JAX package's uint32 ones)."""
    words = materials.to(torch.int32) | (minefield.to(torch.int32) << STEP_SHIFT)
    return words.reshape(-1)


def lookup(fused_flat: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Fused words at world positions (..., 3) xyz, toroidally addressed:
    texel = floor(world + 128) mod 256."""
    t = torch.remainder(torch.floor(pos + float(_HALF)).to(torch.int32), _N)
    lin = (t[..., 2] * _N + t[..., 1]) * _N + t[..., 0]
    return fused_flat[lin.long()]
