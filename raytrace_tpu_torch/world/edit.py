"""Runtime world editing: write material boxes into the resident volume.

Port of ``raytrace_tpu/world/edit.py:48-135`` (``_texel_ix``,
``edit_fused_volume``).  An axis-aligned world box is written into the
toroidal fused volume with exact solidity (step 0 for a solid material,
step 1 for carved air), and the minefield is repaired so every tracer stays
exact: recomputed with ``minefield_from_solid`` for each affected 64-aligned
chunk that lies wholly in the window, and clamped to step 1 on the air
voxels of a chunk that straddles the window edge (its other part is not
resident; smaller steps are always correct).  The box must lie inside the
window ``[lr - 128, lr + 128)``.  Streaming regenerates a region that
leaves the window and comes back, so an edit lasts while its region stays
resident.
"""

from __future__ import annotations

import torch

from ..constants import CHUNK_SIZE, ROOT_BLOCK_SIZE
from ..materials import PACKED_MATERIALS
from ..ops.volume import MATERIAL_MASK, STEP_SHIFT, fuse_volume
from .chunk import minefield_from_solid

_N = ROOT_BLOCK_SIZE
_HALF = _N // 2


def _texel_ix(w0: int, n: int, device) -> torch.Tensor:
    """Texel indices of world coordinates [w0, w0 + n) (toroidal)."""
    return torch.remainder(torch.arange(w0, w0 + n, device=device) + _HALF, _N)


def _box_index(mins, sizes, device):
    """Advanced index of the (z, y, x) texel box with world min corner
    ``mins`` and extents ``sizes`` (both x, y, z)."""
    z = _texel_ix(mins[2], sizes[2], device)
    y = _texel_ix(mins[1], sizes[1], device)
    x = _texel_ix(mins[0], sizes[0], device)
    return z[:, None, None], y[None, :, None], x[None, None, :]


def edit_fused_volume(fused_flat: torch.Tensor, window_offset, world_min, shape,
                      material_id: int | None) -> torch.Tensor:
    """Write an axis-aligned box into the fused volume; returns the new
    fused (256^3,) int32 tensor (the input is left unchanged).

    ``world_min``/``shape``: (x, y, z) world-voxel min corner and extents.
    ``material_id``: row of the material table (solid box), or None to
    carve air.  ``window_offset``: the streamer's render offset.
    """
    world_min = tuple(int(v) for v in world_min)
    shape = tuple(int(v) for v in shape)
    if min(shape) <= 0:
        raise ValueError(f"empty edit box: shape={shape}")
    for a in range(3):
        lo, hi = window_offset[a] - _HALF, window_offset[a] + _HALF
        if world_min[a] < lo or world_min[a] + shape[a] > hi:
            raise ValueError(
                f"edit box axis {a} [{world_min[a]}, {world_min[a] + shape[a]})"
                f" outside the resident window [{lo}, {hi})"
            )
    if material_id is not None and not 0 <= material_id < len(PACKED_MATERIALS):
        raise ValueError(f"unknown material id {material_id}")

    dev = fused_flat.device
    vol3 = fused_flat.reshape(_N, _N, _N).clone()
    word = 1 << STEP_SHIFT if material_id is None else int(PACKED_MATERIALS[material_id])
    vol3[_box_index(world_min, shape, dev)] = word

    def chunk_range(a):
        c0 = (world_min[a] // CHUNK_SIZE) * CHUNK_SIZE
        c1 = ((world_min[a] + shape[a] - 1) // CHUNK_SIZE) * CHUNK_SIZE
        return range(c0, c1 + 1, CHUNK_SIZE)

    for cz in chunk_range(2):
        for cy in chunk_range(1):
            for cx in chunk_range(0):
                corner = (cx, cy, cz)
                resident = all(
                    c >= window_offset[a] - _HALF
                    and c + CHUNK_SIZE <= window_offset[a] + _HALF
                    for a, c in enumerate(corner)
                )
                cix = _box_index(corner, (CHUNK_SIZE,) * 3, dev)
                sub = vol3[cix]
                step = sub >> STEP_SHIFT
                mats = sub & MATERIAL_MASK
                if resident:
                    new = fuse_volume(mats, minefield_from_solid(step == 0)).reshape(sub.shape)
                else:
                    new = mats | (torch.clamp(step, max=1) << STEP_SHIFT)
                vol3[cix] = new
    return vol3.reshape(-1)
