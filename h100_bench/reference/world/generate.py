"""[Frozen copy of ``raytrace_tpu_torch/world/generate.py`` for the benchmark's reference:
its plain PyTorch code only, without the kernel wrappers.]

Terrain generation: material bands and whole voxel boxes.

Port of ``raytrace_tpu/world/generate.py:37-121`` (``material_band``,
``_packed_for_band``, ``generate_box``, ``generate_chunk``).  Generation is
an elementwise function of world coordinates: a voxel is solid below its
column height or below z = 0, and solid voxels take the packed material of
their height band.  Packed materials are uint32 bits held in int32 tensors
(all below 2^24).

``generate_box`` is the jitted JAX ``generate_box`` (with
``minefield_from_solid``, or without it for any box) as one program: on a
CUDA device one launch of kernel G1's box mode (``csrc/worldgen.cu``,
counted on ``generate_box.launches``), on the CPU its plain version
``generate_box_plain``, the op-by-op formulation of JAX's program.  Both
run on the card unless given a device, as JAX's run on its default
device.  The chunk cache's misses, ``generate_world``'s x-rows and the
benchmark's worlds call it; the streamer writes its slabs and regions in
place with ``ops/worldgen.generate_into`` (G1's slab mode) instead.
``generate_box_plain`` fills its materials a block of z planes at a time,
so the int64 temporaries of the band's unsigned modulo stay a few MB even
for a 256^3 box (16.7M voxels).
"""

from __future__ import annotations

import torch

from .._device import default_device
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


def _check_box(origin, shape, with_minefield: bool) -> tuple:
    """``origin`` and ``shape`` as int triples; the minefield's LOD blocks
    bind the box to 64-aligned origins and 64-multiple extents, without it
    any box of extents >= 1 is taken (``ValueError`` otherwise)."""
    origin = tuple(int(o) for o in origin)
    shape = tuple(int(s) for s in shape)
    if len(origin) != 3 or len(shape) != 3 or any(s < 1 for s in shape):
        raise ValueError(f"generate_box: want a 3-d origin and extents >= 1"
                         f"{f' in a {CHUNK_SIZE}-aligned box' if with_minefield else ''}, "
                         f"got origin {origin}, shape {shape}")
    if with_minefield and any(v % CHUNK_SIZE for v in origin + shape):
        raise ValueError(f"generate_box: want a {CHUNK_SIZE}-aligned origin and "
                         f"{CHUNK_SIZE}-multiple extents for the minefield, got "
                         f"origin {origin}, shape {shape}")
    return origin, shape


def generate_box_plain(origin, shape, seed: int = 0, with_minefield: bool = True, *,
                       device=None) -> dict:
    """``generate_box``'s plain version on ``device`` (the CPU when None):
    the JAX program op by op (heights, solidity, materials, then, with
    ``with_minefield``, ``minefield_from_solid``)."""
    origin, shape = _check_box(origin, shape, with_minefield)
    device = torch.device("cpu" if device is None else device)
    nx, ny, nz = shape
    x0, y0, z0 = origin
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
    out = {"materials": materials, "solid": solid}
    if with_minefield:
        out["minefield"] = minefield_from_solid(solid)
    return out
