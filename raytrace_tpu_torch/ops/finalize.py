"""Frame finalization: composite, fog, filmic tone curve, dither.

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


def finalize_frame(albedo, emission, fog, lighting, depth, blue_noise, row0: int = 0,
                   flip: bool = True) -> torch.Tensor:
    """(H, W, 3) float32 final frame in [0, ~1] (finalize.comp:33-63).

    Composites ``albedo * lighting * LIGHTING_SCALE + emission * 4``, fogs
    terrain (depth < 0xFFFF) toward ``fog * 2`` by depth, applies the
    filmic curve, adds the blue-noise dither / 128 of image rows ``row0 ..``
    and flips the frame vertically into window coordinates unless
    ``flip=False`` (the tile split flips once after assembling its bands).
    ``albedo``, ``emission``, ``fog`` and ``lighting`` are (H, W, 3) f32,
    ``depth`` (H, W) uint16, ``blue_noise`` (nh, nw, C >= 3) f32.

    CPU tensors take ``finalize_frame_plain``; CUDA tensors launch F1 on the
    current stream, one launch (``finalize_frame.launches`` counts them),
    which takes ``lighting`` contiguous or as ``denoise_chain``'s view of
    its working plane (4 floats a pixel).  Any other device raises.
    """
    dev = albedo.device
    if dev.type == "cpu":
        return finalize_frame_plain(albedo, emission, fog, lighting, depth, blue_noise, row0,
                                    flip)
    if dev.type != "cuda":
        raise RuntimeError(f"finalize_frame: no kernel for device {dev}")
    from .._build import check_launch, check_tensor, kernels

    h, w = depth.shape
    for name, t in (("albedo", albedo), ("emission", emission), ("fog", fog)):
        check_tensor(f"finalize_frame: {name}", t, torch.float32, (h, w, 3), dev)
    check_tensor("finalize_frame: depth", depth, torch.uint16, (h, w), dev)
    nh, nw, nch = blue_noise.shape
    check_tensor("finalize_frame: blue_noise", blue_noise, torch.float32, (nh, nw, nch), dev)
    lstride = lighting.stride(1)
    if (lighting.device != dev or lighting.dtype != torch.float32
            or tuple(lighting.shape) != (h, w, 3) or lstride not in (3, 4)
            or lighting.stride() != (w * lstride, lstride, 1)):
        raise ValueError(f"finalize_frame: lighting must be (h, w, 3) f32 on {dev} with 3 or "
                         f"4 floats a pixel, got {lighting.dtype} {tuple(lighting.shape)} "
                         f"strides {lighting.stride()} on {lighting.device}")
    if nch < 3:
        raise ValueError(f"finalize_frame: the noise texture has {nch} channels, want >= 3")
    frame = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    err = kernels().rt_finalize(
        albedo.data_ptr(), emission.data_ptr(), fog.data_ptr(), lighting.data_ptr(), lstride,
        depth.data_ptr(), blue_noise.data_ptr(), frame.data_ptr(), h, w, int(row0),
        int(bool(flip)), nh, nw, nch, torch.cuda.current_stream(dev).cuda_stream)
    check_launch("rt_finalize", err)
    finalize_frame.launches += 1
    return frame


finalize_frame.launches = 0
