"""Edge-aware à-trous denoiser with finalize fused into its last pass.

Port of ``raytrace_tpu/ops/denoise.py`` (``_TAPS``, ``_CENTER_WEIGHT``,
``_MAX_REACH``) and ``raytrace_tpu/ops/denoise_pallas.py`` (the chain and
``denoise_finalize_pallas``, ``:369-432``).  One pass is kernel K2,
``_make_pass_kernel`` (``:132-246``), written for Hopper in
``csrc/denoise.cu`` as one thread per output pixel; ``denoise_pass_plain``
is the same pass in plain PyTorch, as a 37-tap stencil on edge-padded
tensors.  Six passes at dilations 1, 2, 4, 8, 8, 16 make the chain; the
sixth applies finalize (``ops/finalize.py``).

The geometry plane is the packed float ``depth * 32 + normal`` of the
Pallas kernel: both parts come back exactly (values < 2^21), and each
tap's weight is ``base / (|dc - dt| / 64 + (normal equal ? 1 : 11))``.
Sky pixels (normal >= 16) pass through.  Edges clamp in every pass.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..constants import DENOISE_SIZES, NORMAL_SKY
from .finalize import dither_planes, finalize_planar

# (dx, dy, weight) taps of the dilated kernel (bilateral_denoise.comp:43-84)
# plus the center tap weight (line 41).
_CENTER_WEIGHT = 0.146634
_TAPS = (
    [(0, 1, 0.092566), (0, -1, 0.092566), (1, 0, 0.092566), (-1, 0, 0.092566)]
    + [(1, 1, 0.058434), (-1, 1, 0.058434), (-1, -1, 0.058434), (1, -1, 0.058434)]
    + [(2, 0, 0.023205), (-2, 0, 0.023205), (0, 2, 0.023205), (0, -2, 0.023205)]
    + [(2, 2, 0.003672), (-2, 2, 0.003672), (-2, -2, 0.003672), (2, -2, 0.003672)]
    + [
        (2, 1, 0.014648), (-2, 1, 0.014648), (-2, -1, 0.014648), (2, -1, 0.014648),
        (1, 2, 0.014648), (-1, 2, 0.014648), (-1, -2, 0.014648), (1, -2, 0.014648),
    ]
    + [(3, 0, 0.002289), (-3, 0, 0.002289), (0, 3, 0.002289), (0, -3, 0.002289)]
    + [
        (3, 1, 0.001445), (-3, 1, 0.001445), (-3, -1, 0.001445), (3, -1, 0.001445),
        (1, 3, 0.001445), (-1, 3, 0.001445), (-1, -3, 0.001445), (1, -3, 0.001445),
    ]
)
_MAX_REACH = 3


def _unpack(g):
    d = torch.floor(g * (1.0 / 32.0))
    return d, g - d * 32.0


def geometry_plane(depth: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Packed (H, W) f32 geometry plane ``depth_u16 * 32 + normal``."""
    return depth.to(torch.float32) * 32.0 + normal.to(torch.float32)


def denoise_pass_plain(light, geom, size: int, fin=None):
    """One pass, plain PyTorch: (3, H, W) lighting and (H, W) geometry in,
    (3, H, W) out.  ``fin = (albedo, emission, fog, blue_noise)`` (the
    first three (H, W, 3)) fuses finalize into the pass."""
    h, w = geom.shape
    pad = _MAX_REACH * size
    lp = F.pad(light[None], (pad,) * 4, mode="replicate")[0]
    gp = F.pad(geom[None, None], (pad,) * 4, mode="replicate")[0, 0]
    dc, nc = _unpack(geom)
    total_w = torch.full_like(geom, _CENTER_WEIGHT)
    acc = light * _CENTER_WEIGHT
    for dx, dy, base_w in _TAPS:
        oy, ox = pad + dy * size, pad + dx * size
        dt, nt = _unpack(gp[oy:oy + h, ox:ox + w])
        ones = torch.ones_like(nt)
        # A tensor numerator: `float / tensor` would multiply by the
        # reciprocal and round twice.
        wgt = (base_w * ones) / (
            torch.abs(dc - dt) * (1.0 / 64.0) + torch.where(nt == nc, ones, 11.0 * ones)
        )
        total_w = total_w + wgt
        acc = acc + lp[:, oy:oy + h, ox:ox + w] * wgt
    out = torch.where(nc >= NORMAL_SKY, light, acc * (1.0 / total_w))
    if fin is None:
        return out
    albedo, emission, fog, blue_noise = fin
    planar = lambda x: x.permute(2, 0, 1)
    return finalize_planar(planar(albedo), planar(emission), planar(fog), out,
                           dc, dither_planes(blue_noise, h, w))


def denoise_pass(light, geom, size: int, fin=None):
    """One pass: the plain version for CPU tensors, K2 for CUDA tensors
    (``denoise_pass.launches`` counts kernel launches).  Other devices
    raise."""
    if light.device.type == "cpu":
        return denoise_pass_plain(light, geom, size, fin)
    if light.device.type != "cuda":
        raise RuntimeError(f"denoise_pass: no kernel for device {light.device}")
    from .._build import check_launch, check_tensor, kernels

    _, h, w = light.shape
    ins = [(light, (3, h, w)), (geom, (h, w))]
    if fin is not None:
        ins += [(x, (h, w, 3)) for x in fin[:3]]
        ins += [(fin[3], (fin[3].shape[0], fin[3].shape[1], 4))]
    for t, shape in ins:
        check_tensor("denoise_pass", t, torch.float32, shape, light.device)
    out = torch.empty_like(light)
    if fin is None:
        fin_ptrs, nh, nw, nch = (None, None, None, None), 0, 0, 0
    else:
        fin_ptrs = tuple(t.data_ptr() for t in fin)
        nh, nw, nch = fin[3].shape
    stream = torch.cuda.current_stream(light.device).cuda_stream
    err = kernels().rt_denoise_pass(
        light.data_ptr(), geom.data_ptr(), out.data_ptr(), h, w, size,
        *fin_ptrs, nh, nw, nch, stream,
    )
    check_launch("rt_denoise_pass", err)
    denoise_pass.launches += 1
    return out


denoise_pass.launches = 0


def _chain(gb: dict, blue_noise: torch.Tensor, one_pass) -> torch.Tensor:
    light = gb["lighting"].permute(2, 0, 1).contiguous()
    geom = geometry_plane(gb["depth"], gb["normal"])
    fin = (gb["albedo"].contiguous(), gb["emission"].contiguous(),
           gb["fog"].contiguous(), blue_noise)
    for si, size in enumerate(DENOISE_SIZES):
        last = si + 1 == len(DENOISE_SIZES)
        light = one_pass(light, geom, size, fin if last else None)
    return light.permute(1, 2, 0).flip(0)


def denoise_finalize(gb: dict, blue_noise: torch.Tensor) -> torch.Tensor:
    """Six-pass denoise + finalize -> (H, W, 3) frame in window orientation
    (vertically flipped, finalize.comp:59)."""
    return _chain(gb, blue_noise, denoise_pass)


def denoise_finalize_plain(gb: dict, blue_noise: torch.Tensor) -> torch.Tensor:
    """``denoise_finalize`` through the plain pass on any device: the
    reference K2's chain is held against."""
    return _chain(gb, blue_noise, denoise_pass_plain)
