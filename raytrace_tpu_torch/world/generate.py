"""Terrain generation: material bands and whole voxel boxes.

Port of ``raytrace_tpu/world/generate.py:37-121`` (``material_band``,
``_packed_for_band``, ``generate_box``, ``generate_chunk``).  Generation is
an elementwise function of world coordinates: a voxel is solid below its
column height or below z = 0, and solid voxels take the packed material of
their height band.  Packed materials are uint32 bits held in int32 tensors
(all below 2^24).

``generate_box`` fills its materials a block of z planes at a time, so the
int64 temporaries of the band's unsigned modulo stay a few MB even for a
256^3 box (16.7M voxels).  The streamer generates its slabs and regions in
place with ``ops/worldgen.generate_into`` (kernel G1) instead; the chunk
cache, ``generate_world`` and the benchmark's configs call this.
"""

from __future__ import annotations

import torch

from ..constants import BAND_HIGH, BAND_LOW, BAND_MID, CHUNK_SIZE
from ..materials import PACKED_MATERIALS
from .chunk import minefield_from_solid
from .heightmap import heightmap_grid
from .noise import hash3_u32

PACKED_GRASS = int(PACKED_MATERIALS[2])
PACKED_ROCK = int(PACKED_MATERIALS[5])
PACKED_SNOW = int(PACKED_MATERIALS[6])
_Z_BLOCK = 16  # z planes per materials block


def material_band(z: torch.Tensor, rand_bits: torch.Tensor) -> torch.Tensor:
    """Material id {2, 5, 6} at height ``z`` from the voxel's hash bits.

    ``rand_bits`` holds uint32 bits (in an int32 or int64 tensor); the
    modulo is unsigned, as in JAX, through an int64 widening.
    """
    bits = rand_bits.to(torch.int64) & 0xFFFFFFFF
    r60 = (bits % (BAND_MID - BAND_LOW)).to(torch.int32)
    r80 = (bits % (BAND_HIGH - BAND_MID)).to(torch.int32)
    five = torch.full_like(r60, 5)
    mid = torch.where(r60 < z - BAND_LOW, five, torch.full_like(r60, 2))
    high = torch.where(r80 < z - BAND_MID, torch.full_like(r60, 6), five)
    return torch.where(
        z < BAND_LOW,
        torch.full_like(r60, 2),
        torch.where(z < BAND_MID, mid,
                    torch.where(z < BAND_HIGH, high, torch.full_like(r60, 6))),
    )


def packed_for_band(m: torch.Tensor) -> torch.Tensor:
    """Material id {2, 5, 6} -> packed material (int32 bits)."""
    return torch.where(
        m == 2, PACKED_GRASS, torch.where(m == 5, PACKED_ROCK, PACKED_SNOW)
    ).to(torch.int32)


def generate_box(origin, shape, seed: int = 0, device=None) -> dict:
    """Terrain of the world box at integer ``origin`` (x0, y0, z0) with
    extents ``shape`` (X, Y, Z); the box must be 64-aligned with 64-multiple
    extents, as the minefield's LOD blocks are.

    Returns ``materials`` (Z, Y, X) int32 packed materials, ``solid``
    (Z, Y, X) bool and ``minefield`` (Z, Y, X) uint8.
    """
    nx, ny, nz = (int(s) for s in shape)
    x0, y0, z0 = (int(o) for o in origin)
    heights = heightmap_grid(x0, y0, (ny, nx), seed=seed, device=device)
    ar = lambda n: torch.arange(n, dtype=torch.int32, device=device)
    wx = (x0 + ar(nx))[None, None, :]
    wy = (y0 + ar(ny))[None, :, None]
    wz = (z0 + ar(nz))[:, None, None]
    solid = (wz < heights[None]) | (wz < 0)
    materials = torch.empty((nz, ny, nx), dtype=torch.int32, device=device)
    for k in range(0, nz, _Z_BLOCK):
        z = wz[k:k + _Z_BLOCK]
        band = material_band(z, hash3_u32(wx, wy, z, seed + 1))
        materials[k:k + _Z_BLOCK] = torch.where(
            solid[k:k + _Z_BLOCK], packed_for_band(band), 0)
    return {"materials": materials, "solid": solid,
            "minefield": minefield_from_solid(solid)}


def generate_chunk(chunk_coord, seed: int = 0, device=None):
    """One 64^3 chunk -> (materials int32, minefield uint8), each (Z, Y, X)."""
    origin = tuple(int(c) * CHUNK_SIZE for c in chunk_coord)
    box = generate_box(origin, (CHUNK_SIZE,) * 3, seed=seed, device=device)
    return box["materials"], box["minefield"]
