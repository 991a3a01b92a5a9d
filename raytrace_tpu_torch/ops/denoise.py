"""Edge-aware à-trous denoiser with finalize fused into its last pass.

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


def geometry_key(geom: torch.Tensor) -> torch.Tensor:
    """The working plane's geometry key of the packed geometry plane: the
    bits of ``depth / 64`` (exact, its seven lowest mantissa bits zero for
    ``depth < 2^17``) or'ed with the normal (< 32), as float32 bits."""
    d, nrm = _unpack(geom)
    return ((d * (1.0 / 64.0)).view(torch.int32) | nrm.to(torch.int32)).view(torch.float32)


def launch_pass(h, w, size, light=None, depth=None, normal=None, plane_in=None,
                plane_out=None, frame=None, fin=None, window=None, dither_row0=0):
    """One K2 launch on the current stream: G-buffers (``light``, ``depth``,
    ``normal``) or a working plane in, a working plane or (with ``fin``)
    the finalized frame of the input rows ``window`` (default all), flipped
    over those rows, out.  ``launch_pass.launches`` counts the launches."""
    from .._build import check_launch, kernels

    if size not in KERNEL_SIZES:
        raise ValueError(f"launch_pass: K2 takes the dilations {KERNEL_SIZES}, not {size}")
    ptr = lambda t: None if t is None else t.data_ptr()
    if fin is None:
        if window is not None:
            raise ValueError("launch_pass: a window needs the finalizing pass")
        fin_ptrs, nh, nw, nch = (None, None, None, None), 0, 0, 0
    else:
        fin_ptrs = tuple(t.data_ptr() for t in fin)
        nh, nw, nch = fin[3].shape
    first, count = _window(window, h)
    dev = (light if light is not None else plane_in).device
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels().rt_denoise_pass(
        ptr(light), ptr(depth), ptr(normal), ptr(plane_in), ptr(plane_out),
        ptr(frame), h, w, size, first, count, dither_row0, *fin_ptrs, nh, nw, nch,
        stream,
    )
    check_launch("rt_denoise_pass", err)
    launch_pass.launches += 1


launch_pass.launches = 0


def _check_fin(name, fin, rows, w, dev):
    from .._build import check_tensor

    for t in fin[:3]:
        check_tensor(name, t, torch.float32, (rows, w, 3), dev)
    check_tensor(name, fin[3], torch.float32, (fin[3].shape[0], fin[3].shape[1], 4), dev)


def denoise_pass(light, geom, size: int, fin=None, window=None, dither_row0=0):
    """One pass: (3, H, W) lighting and (H, W) geometry in, (3, H, W) out
    (with ``fin``: the finalized rows of ``window``, as
    ``denoise_pass_plain``).  The plain version for CPU tensors; for CUDA
    tensors, K2 on a working plane packed here (``launch_pass.launches``
    counts the launch).  Other devices raise."""
    if light.device.type == "cpu":
        return denoise_pass_plain(light, geom, size, fin, window, dither_row0)
    if light.device.type != "cuda":
        raise RuntimeError(f"denoise_pass: no kernel for device {light.device}")
    from .._build import check_tensor

    _, h, w = light.shape
    check_tensor("denoise_pass", light, torch.float32, (3, h, w), light.device)
    check_tensor("denoise_pass", geom, torch.float32, (h, w), light.device)
    plane = torch.stack([light[0], light[1], light[2], geometry_key(geom)], -1)
    if fin is None:
        out = torch.empty_like(plane)
        launch_pass(h, w, size, plane_in=plane, plane_out=out)
        return out[..., :3].permute(2, 0, 1).contiguous()
    first, count = _window(window, h)
    _check_fin("denoise_pass", fin, count, w, light.device)
    frame = torch.empty((count, w, 3), dtype=torch.float32, device=light.device)
    launch_pass(h, w, size, plane_in=plane, frame=frame, fin=fin, window=window,
                dither_row0=dither_row0)
    return frame.flip(0).permute(2, 0, 1)


def bilateral_denoise(lighting, depth, normal, size: int) -> torch.Tensor:
    """One pass at dilation ``size`` in JAX's layout
    (``raytrace_tpu/ops/denoise.py`` ``bilateral_denoise``): lighting (H, W,
    3) f32, depth (H, W) u16, normal (H, W) u8 (>= 16 sky: passed through)
    -> (H, W, 3).  ``denoise_pass`` on the channel planes: the plain pass on
    the CPU, one K2 launch on the card."""
    light = lighting.permute(2, 0, 1).contiguous()
    return denoise_pass(light, geometry_plane(depth, normal), size).permute(1, 2, 0)


def denoise_chain(lighting, depth, normal) -> torch.Tensor:
    """The six passes at ``DENOISE_SIZES`` with no finalize, in JAX's layout
    (``raytrace_tpu/ops/denoise.py`` ``denoise_chain``, :111-121): lighting
    (H, W, 3) f32, depth (H, W) u16, normal (H, W) u8 -> (H, W, 3) f32.

    CPU tensors take the plain pass six times.  CUDA tensors launch K2 six
    times (``launch_pass``: the first pass reads the G-buffers, each writes
    a working plane) and nothing else; the result is the (H, W, 3) light of
    the last plane, a view four floats a pixel apart (``finalize_frame``
    takes it as it is).  Other devices raise."""
    dev = lighting.device
    if dev.type == "cpu":
        return denoise_chain_plain(lighting, depth, normal)
    if dev.type != "cuda":
        raise RuntimeError(f"denoise_chain: no kernel for device {dev}")
    from .._build import check_tensor

    h, w = depth.shape
    check_tensor("denoise_chain", lighting, torch.float32, (h, w, 3), dev)
    check_tensor("denoise_chain", depth, torch.uint16, (h, w), dev)
    check_tensor("denoise_chain", normal, torch.uint8, (h, w), dev)
    planes = torch.empty((2, h, w, 4), dtype=torch.float32, device=dev)
    for si, size in enumerate(DENOISE_SIZES):
        src = dict(light=lighting, depth=depth, normal=normal) if si == 0 \
            else dict(plane_in=planes[(si - 1) % 2])
        launch_pass(h, w, size, **src, plane_out=planes[si % 2])
    return planes[(len(DENOISE_SIZES) - 1) % 2][..., :3]


def denoise_chain_plain(lighting, depth, normal) -> torch.Tensor:
    """The six plain passes on any device: the reference ``denoise_chain``'s
    K2 launches are held against."""
    light = lighting.permute(2, 0, 1)
    geom = geometry_plane(depth, normal)
    for size in DENOISE_SIZES:
        light = denoise_pass_plain(light, geom, size)
    return light.permute(1, 2, 0)


def chain_passes(gb: dict, blue_noise: torch.Tensor, window=None, dither_row0=0):
    """The chain on the card, not yet launched -> ``(frame, passes)``: the
    (count, W, 3) frame it will write (the rows of ``window``, default
    all, as ``denoise_finalize``) and one callable per pass, each launching
    that pass of K2 (``passes[0]`` reads the G-buffers, ``passes[-1]``
    writes the frame).  Run in order they make the chain; a pass run again
    recomputes the same output from the same input."""
    from functools import partial

    from .._build import check_tensor

    dev = gb["lighting"].device
    h, w = gb["depth"].shape
    check_tensor("denoise_finalize", gb["lighting"], torch.float32, (h, w, 3), dev)
    check_tensor("denoise_finalize", gb["depth"], torch.uint16, (h, w), dev)
    check_tensor("denoise_finalize", gb["normal"], torch.uint8, (h, w), dev)
    fin = (gb["albedo"], gb["emission"], gb["fog"], blue_noise)
    first, count = _window(window, h)
    _check_fin("denoise_finalize", fin, count, w, dev)
    planes = torch.empty((2, h, w, 4), dtype=torch.float32, device=dev)
    frame = torch.empty((count, w, 3), dtype=torch.float32, device=dev)
    last = len(DENOISE_SIZES) - 1
    passes = []
    for si, size in enumerate(DENOISE_SIZES):
        src = dict(light=gb["lighting"], depth=gb["depth"], normal=gb["normal"]) \
            if si == 0 else dict(plane_in=planes[(si - 1) % 2])
        dst = dict(frame=frame, fin=fin, window=window, dither_row0=dither_row0) \
            if si == last else dict(plane_out=planes[si % 2])
        passes.append(partial(launch_pass, h, w, size, **src, **dst))
    return frame, passes


def denoise_finalize(gb: dict, blue_noise: torch.Tensor, *, window=None,
                     dither_row0=0) -> torch.Tensor:
    """Six-pass denoise + finalize -> (H, W, 3) frame in window orientation
    (vertically flipped, finalize.comp:59).  ``gb``'s lighting, depth and
    normal are denoised whole; ``window = (first, count)`` (default all
    rows) picks the rows finalized, which ``gb``'s albedo, emission and fog
    cover, dithered as image rows ``dither_row0 ..``: the result is then
    (count, W, 3), flipped over those rows.  CPU tensors take the plain
    chain; CUDA tensors launch K2 once per pass and allocate the two working
    planes and the frame, nothing else.  Other devices raise.  The
    counterpart of JAX's ``denoise_finalize_pallas``, whose third parameter
    (``interpret``) has none, so ``window`` and ``dither_row0`` are
    keyword-only."""
    dev = gb["lighting"].device
    if dev.type == "cpu":
        return denoise_finalize_plain(gb, blue_noise, window, dither_row0)
    if dev.type != "cuda":
        raise RuntimeError(f"denoise_finalize: no kernel for device {dev}")
    frame, passes = chain_passes(gb, blue_noise, window, dither_row0)
    for one_pass in passes:
        one_pass()
    return frame


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
