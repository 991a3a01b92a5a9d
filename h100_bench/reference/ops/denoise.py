"""[Frozen copy of ``raytrace_tpu_torch/ops/denoise.py`` for the benchmark's reference:
its plain PyTorch code only, without the kernel wrappers.]

Edge-aware à-trous denoiser with finalize fused into its last pass.

Port of ``raytrace_tpu/ops/denoise.py`` (``_TAPS``, ``_CENTER_WEIGHT``,
``_MAX_REACH``) and ``raytrace_tpu/ops/denoise_pallas.py`` (the chain and
``denoise_finalize_pallas``, ``:369-432``).  One pass is kernel K2,
``_make_pass_kernel`` (``:132-246``), written for Hopper in
``csrc/denoise.cu``; ``denoise_pass_plain`` is the same pass in plain
PyTorch, as a 37-tap stencil on edge-padded tensors.  Six passes at
dilations 1, 2, 4, 8, 8, 16 make the chain; the sixth applies finalize
(``ops/finalize.py``).

The geometry plane is the packed float ``depth * 32 + normal`` of the
Pallas kernel: both parts come back exactly (values < 2^21), and each
tap's weight is ``base / (|dc - dt| / 64 + (normal equal ? 1 : 11))``.
Sky pixels (normal >= 16) pass through.  Edges clamp in every pass.

On the card the chain is six launches of K2 and nothing else: the first
reads the G-buffers as the frame left them (lighting (H, W, 3), depth u16,
normal u8) and builds each pixel's geometry key (``geometry_key``: the
bits of ``depth / 64`` with the normal in the five low bits); every pass
reads and writes one working plane of ``(r, g, b, key)`` float4 per pixel;
the last writes the finalized (H, W, 3) frame, already flipped.  On the CPU
the chain runs the plain pass on channel planes.

JAX's public one-pass and six-pass functions have their counterparts in
JAX's (H, W, 3) layout: ``bilateral_denoise`` (one pass, over
``denoise_pass``) and ``denoise_chain`` (the six passes with no finalize:
six K2 launches on the card, the last writing a working plane whose light
it returns; ``ops/finalize.finalize_frame`` reads that plane in place).

The finalizing pass may finalize a window of the input's rows only
(``window=(first, count)``, its albedo, emission and fog then cover just
those rows) with the dither of image rows ``dither_row0 ..``, and flips the
window over its own rows: the tile split (``parallel/tiles.py``) denoises a
band with its neighbours' halo rows around it and finalizes the band alone.
The defaults finalize every row with the dither of rows ``0 ..``.
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
# The dilations K2 is built for (csrc/denoise.cu rt_denoise_pass).
KERNEL_SIZES = (1, 2, 4, 8, 16)


def _unpack(g):
    d = torch.floor(g * (1.0 / 32.0))
    return d, g - d * 32.0


def geometry_plane(depth: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Packed (H, W) f32 geometry plane ``depth_u16 * 32 + normal``."""
    return depth.to(torch.float32) * 32.0 + normal.to(torch.float32)


def _window(window, h: int):
    """``(first, count)`` of the rows a finalizing pass finalizes, checked."""
    first, count = (0, h) if window is None else (int(window[0]), int(window[1]))
    if not (0 <= first and 0 < count and first + count <= h):
        raise ValueError(f"finalize window {window} is not inside the {h} input rows")
    return first, count


def denoise_pass_plain(light, geom, size: int, fin=None, window=None, dither_row0=0):
    """One pass, plain PyTorch: (3, H, W) lighting and (H, W) geometry in,
    (3, H, W) out.  ``fin = (albedo, emission, fog, blue_noise)`` fuses
    finalize into the pass: the output is then the (3, count, W) colour of
    input rows ``window = (first, count)`` (default all), the first three
    of ``fin`` (count, W, 3), dithered as image rows ``dither_row0 ..``."""
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
    first, count = _window(window, h)
    rows = slice(first, first + count)
    planar = lambda x: x.permute(2, 0, 1)
    return finalize_planar(planar(albedo), planar(emission), planar(fog), out[:, rows],
                           dc[rows], dither_planes(blue_noise, count, w, dither_row0))


def denoise_finalize_plain(gb: dict, blue_noise: torch.Tensor, window=None,
                           dither_row0=0) -> torch.Tensor:
    """The chain through the plain pass on any device (``window`` and
    ``dither_row0`` as ``denoise_finalize``): the reference K2's chain is
    held against."""
    light = gb["lighting"].permute(2, 0, 1)
    geom = geometry_plane(gb["depth"], gb["normal"])
    fin = (gb["albedo"], gb["emission"], gb["fog"], blue_noise)
    for size in DENOISE_SIZES[:-1]:
        light = denoise_pass_plain(light, geom, size)
    light = denoise_pass_plain(light, geom, DENOISE_SIZES[-1], fin, window, dither_row0)
    return light.permute(1, 2, 0).flip(0)
