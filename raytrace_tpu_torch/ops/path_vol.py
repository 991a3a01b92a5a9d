"""The volume_fast G-buffer pass: every pixel's whole path through the
resident volume, then a planar shade.

Port of ``raytrace_tpu/ops/path_vol.py`` (``render_gbuffers_path``,
``:313-714``): the rays, the planar invariants from the frame noise
(jittered sun directions and unit-sphere points, ``:373-392``) and the
occupancy escape scalars (``:438-440``), which ``rays.frame_rays`` makes
(kernel R1 on the card); the path march (kernel K3 and its plain version,
``ops/trace_vol.py``; the meta word is laid out there); and the final
planar pass (``:605-714``, kernel S3 on the card, ``shade_plain`` its
plain version): albedo from the hit voxels' linear indices, sky, sun, the
second bounce, depth with the 0xFFFF sky sentinel, fog, and the pink
exhausted case.  The TPU round schedule (``PATH_LEVELS``, ``DEFAULT_CAP``,
slotted views, state trimming, row gathers) has no counterpart: each path
has its own budget (``trace_vol.path_budget``).
"""

from __future__ import annotations

import torch

from ..constants import LIGHTING_SCALE, MAX_TRACE_STEPS, NORMAL_SKY, ROOT_BLOCK_SIZE
from .._f32 import fdiv
from . import shading
from .lighting import EXHAUSTED_DEPTH, GBUFFER_KEYS, gbuffers_like
from .rays import INV_WIDTH, frame_rays
from .trace_vol import (
    DIF1_NORMAL_SHIFT,
    LEG_SHIFT,
    PRIM_NORMAL_SHIFT,
    SKY_SHIFT,
    march_paths_vol,
)
from .volume import MATERIAL_MASK


def legs_of(bounces: int) -> int:
    return {0: 1, 1: 3, 2: 5}[bounces]


def render_gbuffers_path(fused_flat: torch.Tensor, tables: dict,
                         blue_noise: torch.Tensor, uniforms: dict, width: int,
                         height: int, max_steps: int = MAX_TRACE_STEPS,
                         row0: int = 0, rows: int | None = None, *,
                         bounces: int = 2, census=None) -> dict:
    """G-buffers of one frame of the resident volume ``fused_flat`` (fused
    (256^3,) int32) with its ``build_vol_tables`` tables, or of the frame's image
    rows ``row0 .. row0 + rows`` (a band of the tile split): the frame's
    rays (R1), every pixel's path (K3), then the shade (S3); three launches
    on the card.

    ``uniforms`` holds tensors origin, forward, up, right (3,) f32,
    sun_angle () f32, seed () int32 and lr (3,) f32, all on one device.
    Returns lighting, albedo, emission and fog (rows, W, 3) f32, depth
    (rows, W) uint16 and normal (rows, W) uint8; a band's equal the same
    rows of the whole frame's bit for bit (on CPU tensors when
    ``width * rows`` and ``width * height`` are multiples of 32: see
    ``integrate.integrate_gbuffers``).  JAX's TPU knobs after ``rows``
    (``interpret``, the round schedule's ``cap``, ``rounds`` and
    ``levels``, ``tile_rows``, ``resolve``, ``safety``, ``safety_R``) have
    no counterpart (each path has its own budget, ``trace_vol.path_budget``),
    so ``bounces`` is keyword-only.  ``census``: K3's, as
    ``trace_vol.march_paths_vol`` takes it.
    """
    legs = legs_of(bounces)
    frame = march_inputs(tables, blue_noise, uniforms, width, height, row0, rows)
    marched = march_paths_vol(*frame["march"], max_steps, legs, census)
    return shade(fused_flat, *marched, legs=legs, **frame["shade"])


def march_inputs(tables: dict, blue_noise: torch.Tensor, uniforms: dict,
                 width: int, height: int, row0: int = 0,
                 rows: int | None = None) -> dict:
    """The march's inputs for one frame (or its rows ``row0 .. row0 +
    rows``) and what the shade reads besides, from ``rays.frame_rays``
    (R1 on the card).

    ``march``: the positional arguments of ``march_paths_vol`` up to the
    budget: origin and direction (N, 3) f32, the invariants (N, 12) f32
    (sd1, sp1, sd2, sp2), iscal (10,) int32 = lr xyz, occupancy bounds,
    pad; fscal (4,) f32 = camera origin xyz, pad; and the tables.
    ``shade``: keyword arguments of ``shade`` other than the march's
    outputs and the volume.
    """
    rows = height if rows is None else rows
    f = frame_rays(uniforms, blue_noise, width, height, row0, rows, tables=tables,
                   form="volume")
    return {
        "march": (f["origin"], f["direction"], f["inv"], f["iscal"], f["fscal"], tables),
        "shade": dict(direction=f["direction"], inv=f["inv"], sun=f["sun"],
                      shape=(rows, width)),
    }


def albedo_at(volume: torch.Tensor, lin: torch.Tensor, valid: torch.Tensor):
    """Albedo (r, g, b) of the packed material at linear texel ``lin``,
    0 where not ``valid``."""
    word = volume[torch.where(valid, lin, 0).long()]
    packed = torch.where(valid, word & MATERIAL_MASK, 0)
    return torch.stack([fdiv(((packed >> sh) & 0x7F).to(torch.float32), 127.0)
                        for sh in (14, 7, 0)], -1)


def shade_plain(volume, meta, prim_lin, dif1_lin, prim_dist, direction, inv, sun, shape,
                legs: int) -> dict:
    """S3's plain PyTorch version (see ``shade``)."""
    meta, prim_lin, dif1_lin, prim_dist = (
        t.reshape(shape) for t in (meta, prim_lin, dif1_lin, prim_dist))
    ray_dir = direction.reshape(*shape, 3)
    inv = inv.reshape(*shape, INV_WIDTH)
    sunlight = (sun[3], sun[4], sun[5])
    sun = (sun[0], sun[1], sun[2])
    leg = (meta >> LEG_SHIFT) & 7
    sky_bit = [((meta >> (SKY_SHIFT + k)) & 1) == 1 for k in range(5)]
    prim_air = sky_bit[0]
    pn = (meta >> PRIM_NORMAL_SHIFT) & 7
    hit1 = prim_lin >= 0
    prim_exhausted = (leg == 0) & ~prim_air & ~hit1
    sunlight_vec = torch.stack(sunlight)

    def sky(d, include_sun):
        rgb = shading.sample_sky(d, sun, sunlight, include_sun)
        return torch.stack(torch.broadcast_tensors(*rgb), -1)

    def bounce(sp, normal_id):
        return shading.diffuse_from_sphere(
            (inv[..., sp], inv[..., sp + 1], inv[..., sp + 2]), normal_id)

    zero = torch.zeros((), dtype=torch.float32, device=meta.device)
    light_hit = torch.zeros(ray_dir.shape, dtype=torch.float32, device=meta.device)
    if legs >= 3:
        light_hit = (torch.where(sky_bit[1][..., None], sunlight_vec, zero)
                     + torch.where(sky_bit[2][..., None], sky(bounce(3, pn), True), zero))
    if legs >= 5:
        dn = (meta >> DIF1_NORMAL_SHIFT) & 7
        light2 = (torch.where(sky_bit[3][..., None], sunlight_vec, zero)
                  + torch.where(sky_bit[4][..., None], sky(bounce(9, dn), True), zero))
        light2 = light2 * albedo_at(volume, dif1_lin, dif1_lin >= 0)
        light_hit = light_hit + torch.where(sky_bit[2][..., None], zero, light2)
    rd = (ray_dir[..., 0], ray_dir[..., 1], ray_dir[..., 2])
    light = torch.where(hit1[..., None], light_hit, sky(rd, True))

    depth = torch.where(
        prim_air, 0xFFFF,
        torch.clamp(prim_dist * 32.0, max=float(0xFFFF)).to(torch.int32))
    depth = torch.where(prim_exhausted, EXHAUSTED_DEPTH, depth)
    # Exhausted pixels fog to pink (1, 0, 1), the REPORT_ERROR colour, made
    # on the device (a host copy would wait for the queued work).
    pink = (torch.arange(3, device=meta.device) != 1).to(torch.float32)
    fog = torch.where(prim_exhausted[..., None], pink, sky(rd, False) / 2.0)
    albedo = torch.where(hit1[..., None], albedo_at(volume, prim_lin, hit1), 1.0)
    return {
        "lighting": light / LIGHTING_SCALE,
        "depth": depth.to(torch.uint16),
        "normal": torch.where(prim_air, NORMAL_SKY, pn).to(torch.uint8),
        "albedo": albedo,
        "emission": torch.zeros_like(light),
        "fog": fog,
    }


def shade(volume, meta, prim_lin, dif1_lin, prim_dist, direction, inv, sun, shape,
          legs: int) -> dict:
    """The final planar pass (path_vol.py:605-714): albedo from the hit
    voxels, sky, sun, the second bounce, depth with the 0xFFFF sky
    sentinel, fog and the pink exhausted case.

    ``meta``, ``prim_lin``, ``dif1_lin`` and ``prim_dist`` are the march's
    (N,) outputs for the (rows, W) ``shape`` of pixels, ``direction`` (N, 3)
    f32 their primary rays, ``inv`` (N, 12) f32 their invariants and ``sun``
    (8,) f32 the frame's sun and sunlight (``march_inputs``); ``volume`` the
    fused (256^3,) int32 volume; ``legs`` 1, 3 or 5.  Returns the six
    G-buffers of ``render_gbuffers_path``.

    CPU tensors take ``shade_plain``; CUDA tensors launch S3
    (``csrc/shade.cu``) on the current stream, and ``shade.launches`` counts
    those launches.  Any other device raises.
    """
    if meta.device.type == "cpu":
        return shade_plain(volume, meta, prim_lin, dif1_lin, prim_dist, direction, inv, sun,
                           shape, legs)
    if meta.device.type != "cuda":
        raise RuntimeError(f"shade: no kernel for device {meta.device}")
    if legs not in (1, 3, 5):
        raise ValueError(f"shade: legs {legs} is not 1, 3 or 5")
    from .._build import check_launch, check_tensor, kernels

    dev = meta.device
    n = shape[0] * shape[1]
    ins = [meta, prim_lin, dif1_lin, prim_dist, direction, inv, sun, volume]
    want = [(torch.int32, (n,))] * 3 + [
        (torch.float32, (n,)), (torch.float32, (n, 3)), (torch.float32, (n, INV_WIDTH)),
        (torch.float32, (8,)), (torch.int32, (ROOT_BLOCK_SIZE ** 3,))]
    for t, (dtype, shp) in zip(ins, want):
        check_tensor("shade", t, dtype, shp, dev)
    out = gbuffers_like(shape, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels().rt_shade_vol(
        *(t.data_ptr() for t in ins), *(out[k].data_ptr() for k in GBUFFER_KEYS), n, legs,
        stream,
    )
    check_launch("rt_shade_vol", err)
    shade.launches += 1
    return out


shade.launches = 0
