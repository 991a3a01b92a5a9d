"""[Frozen copy of ``raytrace_tpu_torch/world/chunk.py`` for the benchmark's reference:
its plain PyTorch code only, without the kernel wrappers.]

Chunk packing: the occupancy pyramid and the "minefield" LOD grid.

Port of ``raytrace_tpu/world/chunk.py:27-83`` (``occupancy_pyramid``,
``minefield_from_solid``, ``pack_chunk``).  The minefield gives every voxel
a u8 step: 0 = solid; m >= 1 = the 2^(m-1)-aligned block around the voxel
is empty.  Chunk origins are 64-aligned in world space, so every 2^k block
(k <= 6) of a 64-aligned region lies on the global 2^k grid and the
minefield of any such region is a max-pool pyramid plus broadcasts.
"""

from __future__ import annotations

import torch

from ..constants import CHUNK_SIZE, MAX_CHUNK_LOD


def _pool2(occ: torch.Tensor) -> torch.Tensor:
    """2x2x2 any-reduce of a (Z, Y, X) bool tensor."""
    z, y, x = occ.shape
    r = occ.reshape(z // 2, 2, y // 2, 2, x // 2, 2)
    return r.any(dim=5).any(dim=3).any(dim=1)


def occupancy_pyramid(solid: torch.Tensor, levels: int = MAX_CHUNK_LOD) -> list:
    """Occupancy at block sizes 2^1 .. 2^levels: ``pyramid[k-1][bz, by, bx]``
    is True iff that 2^k block holds a solid voxel."""
    occ = solid
    pyramid = []
    for _ in range(levels):
        occ = _pool2(occ)
        pyramid.append(occ)
    return pyramid


def _upsample(occ: torch.Tensor, factor: int, out_shape) -> torch.Tensor:
    """Nearest upsample of a (Z, Y, X) bool grid by ``factor`` per axis."""
    z, y, x = occ.shape
    r = occ[:, None, :, None, :, None].expand(z, factor, y, factor, x, factor)
    return r.reshape(out_shape)


def minefield_from_solid(solid: torch.Tensor) -> torch.Tensor:
    """Per-voxel minefield (uint8) of a (Z, Y, X) solidity grid whose dims
    are multiples of ``CHUNK_SIZE`` and whose origin is 64-aligned.  An
    empty chunk fills with ``MAX_CHUNK_LOD`` (6)."""
    if any(d % CHUNK_SIZE for d in solid.shape):
        raise ValueError(f"minefield needs 64-multiple dims, got {tuple(solid.shape)}")
    pyramid = occupancy_pyramid(solid, MAX_CHUNK_LOD)
    mf = torch.full(solid.shape, MAX_CHUNK_LOD, dtype=torch.uint8, device=solid.device)
    # Smallest occupied level wins: write levels from coarse to fine.
    for level in range(MAX_CHUNK_LOD - 1, 0, -1):
        mf.masked_fill_(_upsample(pyramid[level - 1], 1 << level, solid.shape), level)
    mf.masked_fill_(solid, 0)
    return mf


def pack_chunk(solid: torch.Tensor, packed_materials: torch.Tensor):
    """(solid, packed materials) -> (materials, minefield).  Generation
    already stores air as 0, so the reference's zeroing of an all-empty
    chunk's materials needs no special case."""
    return packed_materials, minefield_from_solid(solid)
