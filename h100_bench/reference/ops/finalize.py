"""[Frozen copy of ``raytrace_tpu_torch/ops/finalize.py`` for the benchmark's reference:
its plain PyTorch code only, without the kernel wrappers.]

Frame finalization: composite, fog, filmic tone curve, dither.

Port of ``raytrace_tpu/ops/finalize.py`` (``finalize_frame``).  The frame
programs finalize inside K2's last pass (``csrc/denoise.cu``):
``finalize_planar`` is that pass's per-pixel math, which the plain pass in
``ops/denoise.py`` calls, and ``denoise_finalize`` does the vertical flip.
``finalize_frame`` is JAX's public function on its own: on the card kernel
F1 (``finalize_kernel`` in ``csrc/denoise.cu``), one launch with K2's own
finalize; ``finalize_frame_plain`` is the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from ..constants import LIGHTING_SCALE
from .shading import filmic_curve

FOG_SCALE = 32.0 * 128.0 * 8.0  # finalize.comp:46


def dither_planes(blue_noise: torch.Tensor, height: int, width: int, row0: int = 0):
    """(3, H, W) dither of image rows ``row0 .. row0 + height``:
    ``blue_noise[(row0 + y) % nh, x % nw, :3]`` (finalize.py:59-70)."""
    nh, nw = blue_noise.shape[0], blue_noise.shape[1]
    rows = torch.arange(row0, row0 + height, device=blue_noise.device) % nh
    cols = torch.arange(width, device=blue_noise.device) % nw
    return blue_noise[rows[:, None], cols[None, :], :3].permute(2, 0, 1)


def finalize_planar(albedo, emission, fog, lighting, depth_f, dither):
    """Final (3, H, W) colour from channel-planar inputs; ``depth_f`` is the
    u16 depth as float32 (65535 means sky)."""
    final = albedo * (lighting * LIGHTING_SCALE) + emission * 4.0
    fog_amount = torch.clamp(depth_f * (1.0 / FOG_SCALE), max=1.0)
    is_terrain = depth_f < 65535.0
    final = torch.where(is_terrain, final + (fog * 2.0 - final) * fog_amount, final)
    return filmic_curve(final) + dither * (1.0 / 128.0)


def finalize_frame_plain(albedo, emission, fog, lighting, depth, blue_noise, row0: int = 0,
                         flip: bool = True) -> torch.Tensor:
    """F1's plain PyTorch version (see ``finalize_frame``)."""
    h, w = depth.shape
    planar = lambda x: x.permute(2, 0, 1)
    final = finalize_planar(planar(albedo), planar(emission), planar(fog), planar(lighting),
                            depth.to(torch.float32), dither_planes(blue_noise, h, w, row0))
    final = final.permute(1, 2, 0)
    return final.flip(0) if flip else final
