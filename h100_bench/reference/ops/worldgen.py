"""[Frozen copy of ``raytrace_tpu_torch/ops/worldgen.py`` for the benchmark's reference:
its plain PyTorch code only, without the kernel wrappers.]

World generation into the resident volume: kernel G1 and its plain version.

Port of the JAX streaming data plane ``raytrace_tpu/render/streaming.py``
``_generate_and_apply`` (``:79-107``, a streamed slab) and
``_generate_region`` (``:110-134``, a teleport's region), with the
``generate_box`` (``world/generate.py:66-105``) and ``minefield_from_solid``
(``world/chunk.py:58-73``) they call.  JAX generates a box's 64-aligned
enclosure, slices the box out and rolls it into texel space; here
``generate_into`` writes each voxel's fused word straight to its texel
``(w + 128) & 255`` in the resident volume, in place: kernel G1
(``csrc/worldgen.cu``) on the card, ``generate_into_plain`` on the CPU.

Both compute one formulation, an elementwise function of a voxel's column:
a voxel is solid iff ``z < H = max(h(x, y), 0)``; a globally aligned 2^l
block (l <= 5) is occupied iff its lowest z lies below the maximum of H
over its columns, so an air voxel's minefield step is the smallest l in
1..5 with ``(z & ~(2^l - 1)) < Hmax_l``, else 6; a solid voxel carries the
packed material of its height band.  That equals ``generate_box`` over any
64-aligned enclosure of the box, sliced (``tests/test_torch_worldgen.py``).
G1's box mode, which ``world/generate.generate_box`` launches, computes it
into dense outputs; ``box_plain`` is that mode in plain PyTorch.
"""

from __future__ import annotations

import torch

from ..constants import ROOT_BLOCK_SIZE
from ..world.generate import (
    PACKED_GRASS,
    PACKED_ROCK,
    PACKED_SNOW,
    material_band,
    packed_for_band,
)
from ..world.heightmap import heightmap_grid
from ..world.noise import hash3_u32
from .volume import MATERIAL_MASK, STEP_SHIFT

_N = ROOT_BLOCK_SIZE
_HALF = _N // 2
_TILE = 32  # columns per tile side: the 32-block level of the minefield
_LEVELS = 5  # the minefield's block levels 2^1 .. 2^5
_EMPTY = _LEVELS + 1  # the step of a voxel whose 32-block is empty
_Z_BLOCK = 16  # z planes per block of the plain version's temporaries


def _box(w0, shape_xyz) -> tuple:
    w0 = tuple(int(v) for v in w0)
    shape = tuple(int(s) for s in shape_xyz)
    if len(w0) != 3 or len(shape) != 3 or not all(1 <= s <= _N for s in shape):
        raise ValueError(f"generate_into: want a box of 3 extents in 1..{_N}, got "
                         f"origin {w0}, shape {shape}")
    return w0, shape


def generate_into_plain(volume: torch.Tensor, w0, shape_xyz, seed: int = 0) -> torch.Tensor:
    """G1's plain version on ``volume``'s device: ``box_words_plain``
    stored at its toroidal offset (``store_box``)."""
    w0, shape = _box(w0, shape_xyz)
    return store_box(volume, box_words_plain(w0, shape, seed, volume.device), w0)


def box_words_plain(w0, shape_xyz, seed: int = 0, device=None) -> torch.Tensor:
    """The fused int32 words of the world box at ``w0`` with extents
    ``shape_xyz`` (x, y, z) -> (Z, Y, X) in world order: heights over the
    box's 32-aligned column tiles (``heightmap_grid``), their maxima over
    2- to 32-column blocks, then each voxel's step and material."""
    (x0, y0, z0), (sx, sy, sz) = w0, shape_xyz
    device = torch.device("cpu" if device is None else device)
    ax0, ay0 = x0 & -_TILE, y0 & -_TILE  # floor to the tile grid
    nx = ((x0 + sx + _TILE - 1) & -_TILE) - ax0
    ny = ((y0 + sy + _TILE - 1) & -_TILE) - ay0
    h = torch.clamp(heightmap_grid(ax0, ay0, (ny, nx), seed=seed, device=device), min=0)
    ox, oy = x0 - ax0, y0 - ay0
    crop = lambda m: m[oy:oy + sy, ox:ox + sx]
    maxima, m = [], h
    for level in range(1, _LEVELS + 1):
        m = m.reshape(m.shape[0] // 2, 2, m.shape[1] // 2, 2).amax(dim=(1, 3))
        r = 1 << level
        maxima.append(crop(m.repeat_interleave(r, 0).repeat_interleave(r, 1)))
    hc = crop(h)
    ar = lambda n: torch.arange(n, dtype=torch.int32, device=device)
    wx = (x0 + ar(sx))[None, None, :]
    wy = (y0 + ar(sy))[None, :, None]
    words = torch.empty((sz, sy, sx), dtype=torch.int32, device=device)
    for k in range(0, sz, _Z_BLOCK):
        z = (z0 + ar(min(_Z_BLOCK, sz - k)) + k)[:, None, None]
        solid = z < hc
        step = torch.full(solid.shape, _EMPTY, dtype=torch.int32, device=device)
        for level in range(_LEVELS, 0, -1):  # the smallest occupied level wins
            step = torch.where((z & -(1 << level)) < maxima[level - 1], level, step)
        band = material_band(z, hash3_u32(wx, wy, z, seed + 1))
        words[k:k + _Z_BLOCK] = torch.where(solid, packed_for_band(band),
                                            step << STEP_SHIFT)
    return words


def box_plain(w0, shape_xyz, seed: int = 0, device=None) -> dict:
    """G1's box mode in plain PyTorch: ``box_words_plain`` split into
    ``generate_box``'s outputs, ``materials`` (the word's low 24 bits),
    ``solid`` (step 0) and ``minefield`` (the step), each (Z, Y, X)."""
    words = box_words_plain(w0, shape_xyz, seed, device)
    step = words >> STEP_SHIFT
    return {"materials": words & MATERIAL_MASK, "solid": step == 0,
            "minefield": step.to(torch.uint8)}


def store_box(volume: torch.Tensor, words: torch.Tensor, w0) -> torch.Tensor:
    """Store (Z, Y, X) world-ordered ``words`` of the box at ``w0`` into the
    flat volume at texel ``(w + 128) mod 256`` on each axis, in place."""
    texels = [torch.remainder(torch.arange(w, w + n, device=volume.device) + _HALF, _N)
              for w, n in zip(w0, reversed(words.shape))]  # x, y, z
    volume.view(_N, _N, _N).index_put_(
        (texels[2][:, None, None], texels[1][None, :, None], texels[0][None, None, :]),
        words)
    return volume
