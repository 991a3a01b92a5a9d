"""[Frozen copy of ``raytrace_tpu_torch/ops/rays.py`` for the benchmark's reference:
its plain PyTorch code only, without the kernel wrappers.]

Primary camera rays, per-frame blue-noise planes, and the front of the
frame programs.

Port of ``raytrace_tpu/ops/trace_jax.py:55-56`` (``_normalize``, here
``normalize``),
``:168-191`` (``camera_rays``, including the ``below`` clause) and
``:220-265`` (``frame_noise``).  The JAX roll + tile of the noise texture
is the same modular lookup written as one gather, so the per-frame offset
can stay a device tensor and no value syncs to the host.  Both take a band
of image rows (``row0``, ``rows``; the tile split, ``parallel/tiles.py``):
a band's values equal the same rows of the whole frame bit for bit.

``frame_rays`` is the front of the frame programs in one call: the rays,
the noise the march reads, the sun and (but for the exact DDA) the march's
scalars
(``raytrace_tpu/ops/lighting_pallas.py:846-899``,
``raytrace_tpu/ops/path_vol.py:366-392, 437-440`` and, for the staged
frames, ``raytrace_tpu/ops/trace_jax.py:289-298`` with the tracers'
scalars, ``trace_pallas.py:573-577`` and ``trace_vol_pallas.py:906-914``,
which XLA fuses inside the jitted programs).  On the card it is kernel R1 (``csrc/frame_rays.cu``),
one launch; ``frame_rays_plain`` is the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from ..constants import ROOT_BLOCK_SIZE
from .._f32 import fdiv
from ..world.generate import PACKED_GRASS, PACKED_ROCK, PACKED_SNOW
from . import shading
from .vol_tables import occupancy_world_bounds

_HALF = ROOT_BLOCK_SIZE // 2


def normalize(x, y, z):
    """Unit vector of (x, y, z) tensors, ``v / sqrt(max(|v|^2, 1e-20))``."""
    inv = 1.0 / torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-20))
    return x * inv, y * inv, z * inv


def camera_rays(uniforms: dict, width: int, height: int, row0: int = 0,
                rows: int | None = None):
    """Per-pixel primary ray origins and directions, each (rows, W, 3) f32,
    for image rows ``row0 .. row0 + rows`` (default: the whole frame).

    ``uniforms`` holds (3,) float32 tensors ``origin``, ``forward``, ``up``
    and ``right`` (up/right already scaled by the 0.4 FOV factor).  Screen
    ``y`` stays relative to the full ``height``.
    """
    dev = uniforms["origin"].device
    rows = height if rows is None else rows
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    # row0 + i is an exact float32 integer, so a band's rows divide as the
    # whole frame's do.
    py = torch.arange(row0, row0 + rows, dtype=torch.float32, device=dev)[:, None]
    sx = fdiv(px, float(width)) * 2.0 - 1.0
    sy = fdiv(py, float(height)) * 2.0 - 1.0
    f, r, u = uniforms["forward"], uniforms["right"], uniforms["up"]
    d = [f[k] + sx * r[k] + sy * u[k] for k in range(3)]
    ray_dir = torch.stack(normalize(*d), -1)
    o = uniforms["origin"]
    origin = o.expand(rows, width, 3)
    below = -o[1] > _HALF
    space = -o[1] - _HALF
    t = space / ray_dir[..., 1] + 1e-4
    origin = torch.where(below, origin + t[..., None] * ray_dir, origin)
    return origin.contiguous(), ray_dir


def frame_noise(blue_noise: torch.Tensor, seed: torch.Tensor, width: int,
                height: int, row0: int = 0, rows: int | None = None):
    """Per-pixel noise planes (noise1, noise2), each (rows, W, C) f32, for
    image rows ``row0 .. row0 + rows`` (default: the whole frame).

    ``noise1[y, x] = blue_noise[(y + oy) % nh, (x + ox) % nw]`` with the
    per-frame offset read from the texture at ``seed``; ``noise2`` is
    shifted by two more texels on both axes (trace_jax.py:220-265).
    """
    nh, nw = blue_noise.shape[0], blue_noise.shape[1]
    dev = blue_noise.device
    seed = seed.to(torch.int32)
    # A (1,) index: indexing with 0-d tensors would read them on the host.
    at = (seed // nw % nh * nw + seed % nw).reshape(1).long()
    texel = blue_noise.reshape(nh * nw, -1)[at][0]
    off_x = torch.floor(texel[0] * 255.0 + 0.5).to(torch.int64)
    off_y = torch.floor(texel[1] * 255.0 + 0.5).to(torch.int64)
    rows = height if rows is None else rows
    ys = torch.arange(row0, row0 + rows, device=dev)
    xs = torch.arange(width, device=dev)

    def plane(shift):
        rows = torch.remainder(ys + off_y + shift, nh)
        cols = torch.remainder(xs + off_x + shift, nw)
        return blue_noise[rows[:, None], cols[None, :]]

    return plane(0), plane(2)


FORMS = ("fused", "volume", "hf", "dda")
INV_WIDTH = 12  # volume_fast's per-pixel invariants: sd1, sp1, sd2, sp2
# K4's packed material words of the grass, rock and snow bands.
BAND_WORDS = (PACKED_GRASS, PACKED_ROCK, PACKED_SNOW)


def _byte(img):
    return torch.round(img * 255.0).to(torch.int32)


def frame_rays_plain(uniforms: dict, blue_noise: torch.Tensor, width: int, height: int,
                     row0: int = 0, rows: int | None = None, *, tables: dict | None,
                     form: str) -> dict:
    """R1's plain PyTorch version (see ``frame_rays``)."""
    rows = height if rows is None else rows
    n = width * rows
    dev = blue_noise.device
    origin, direction = camera_rays(uniforms, width, height, row0, rows)
    noise1, noise2 = frame_noise(blue_noise, uniforms["seed"], width, height, row0, rows)
    sun = shading.sun_vector(uniforms["sun_angle"])
    lri = uniforms["lr"].to(torch.int32)
    out = dict(origin=origin.reshape(n, 3), direction=direction.reshape(n, 3), sun=sun)
    if form != "volume":
        out["nw"] = (_byte(noise1[..., 0]) | (_byte(noise1[..., 1]) << 8)
                     | (_byte(noise2[..., 0]) << 16) | (_byte(noise2[..., 1]) << 24)).reshape(n)
        if form == "dda":
            return out
        if form == "hf":
            words = torch.tensor(BAND_WORDS, dtype=torch.int32, device=dev)
            out["iscal"] = torch.cat([tables["r0"], lri, words])
            return out
        # Region-wide max column height for the sky-escape rule, from the
        # pyramid's 8-block level, so it keeps the +1 margin.
        maxh = (tables["h3"] & 511).max()
        out["iscal"] = torch.cat([tables["r0"], lri, maxh.reshape(1),
                                  torch.zeros(2, dtype=torch.int32, device=dev)]).to(torch.int32)
        out["fscal"] = sun
        return out
    inv = []
    for noise in (noise1, noise2):
        nr, ng = noise[..., 0], noise[..., 1]
        inv += normalize(sun[0] + nr * 0.05, sun[1] + ng * 0.05, torch.zeros_like(nr) + sun[2])
        inv += shading.sphere_point(nr, ng)
    out["inv"] = torch.stack(inv, -1).reshape(n, INV_WIDTH)
    out["iscal"] = torch.cat([lri, occupancy_world_bounds(tables["any8b"], lri),
                              torch.zeros(1, dtype=torch.int32, device=dev)])
    out["fscal"] = torch.cat([uniforms["origin"].to(torch.float32),
                              torch.zeros(1, dtype=torch.float32, device=dev)])
    return out
