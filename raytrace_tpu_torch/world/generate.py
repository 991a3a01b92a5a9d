"""Height-banded material ids.

Port of ``raytrace_tpu/world/generate.py:37-54`` (``material_band`` only;
volume generation waits for the volume tracers).
"""

from __future__ import annotations

import torch

from raytrace_tpu.constants import BAND_HIGH, BAND_LOW, BAND_MID


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
