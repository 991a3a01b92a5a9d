"""The staged lighting pass: primary, sun and diffuse rays traced leg by leg
through a tracer callable, then the G-buffers.

Port of ``raytrace_tpu/ops/trace_jax.py:268-389`` (``integrate_gbuffers``),
the whole frame of the two staged tracers: ``tracer="hf"``
(``ops/trace_hf.py``, kernel K4) and ``tracer="volume"`` (the exact DDA,
``ops/trace_dda.py``).  ``trace(origin, direction, active=None)`` returns
the hit dict both tracers build with ``hit_result``.  The sun and diffuse
rays of a bounce go to the tracer as one doubled batch, so a frame makes
``1 + bounces`` trace calls.
"""

from __future__ import annotations

import torch

from .._f32 import fdiv
from ..constants import LIGHTING_SCALE, NORMAL_SKY
from . import shading
from .lighting import EXHAUSTED_DEPTH
from .rays import camera_rays, frame_noise, normalize


def length(v: torch.Tensor) -> torch.Tensor:
    """``|v|`` over the last axis of a (..., 3) tensor, summed x, y, z.

    The root is taken in float64 and rounded once to float32, which is the
    correctly rounded float32 root on every device: PyTorch's vectorized CPU
    ``sqrt`` is an ulp off it for some inputs, where XLA's and CUDA's are not.
    """
    n2 = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return torch.sqrt(n2.to(torch.float64)).to(torch.float32)


def flat_rays(origin, direction, active):
    """(N, 3) f32 origin and direction and (N,) bool active (or None) of a
    batch of rays of any leading shape, contiguous, as the kernels take
    them."""
    o = origin.reshape(-1, 3).to(torch.float32).contiguous()
    d = direction.reshape(-1, 3).to(torch.float32).contiguous()
    a = None if active is None else active.reshape(-1).to(torch.bool).contiguous()
    return o, d, a


def hit_result(origin, pos, normal, air, packed, exhausted, nudge=None) -> dict:
    """A tracer's hit dict (``trace_jax.py:144-165``, ``trace_pallas.py:682-706``).

    ``pos`` (..., 3) is where each ray stopped, ``normal`` its entry-face
    id, ``air`` whether it reached sky, ``packed`` the packed material of
    its hit voxel (0 for none).  Returns ``position`` nudged 0.001 off the
    face (only where ``nudge`` is True, when it is given), ``normal``,
    ``air``, ``albedo`` (..., 3), ``distance`` (before the nudge) and
    ``exhausted``.
    """
    nx, ny, nz = shading.face_normal_vector(normal)
    albedo = torch.stack([fdiv(((packed >> sh) & 0x7F).to(torch.float32), 127.0)
                          for sh in (14, 7, 0)], -1)
    step = 0.001 if nudge is None else torch.where(nudge, 0.001, 0.0)[..., None]
    return {
        "position": pos + step * torch.stack([nx, ny, nz], -1),
        "normal": normal,
        "air": air,
        "albedo": albedo,
        "distance": length(origin - pos),
        "exhausted": exhausted,
    }


def integrate_gbuffers(trace, blue_noise: torch.Tensor, uniforms: dict,
                       width: int, height: int, bounces: int = 2, row0: int = 0,
                       rows: int | None = None) -> dict:
    """The full lighting pass producing the six G-buffers, of the whole
    frame or of its image rows ``row0 .. row0 + rows`` (a band of the tile
    split; ``trace_jax.py:268-297``).

    ``uniforms`` holds tensors origin, forward, up, right (3,) f32,
    sun_angle () f32, seed () int32 and lr (3,) f32.  ``bounces``: 0 =
    primary rays only (sky lighting), 1 = sun + one diffuse bounce, 2 = the
    full path.  Returns lighting, albedo, emission and fog (rows, W, 3) f32,
    depth (rows, W) uint16 and normal (rows, W) uint8.

    A band's G-buffers equal the same rows of the whole frame's bit for bit
    on CUDA tensors.  On CPU tensors they do when ``width * rows`` and
    ``width * height`` are multiples of 32: PyTorch's CPU ``pow`` and
    ``sin`` can give another last bit in the scalar tail of a vectorized
    loop than in its body, so otherwise a band's lighting and fog may differ
    by up to 4 units in the last place; depth, normal, albedo and emission
    stay equal.  The fused and volume_fast passes share this.
    """
    origin, ray_dir = camera_rays(uniforms, width, height, row0, rows)
    sun = shading.sun_direction(uniforms["sun_angle"])
    sunlight = shading.sun_color(sun)
    sun_vec, sunlight_vec = torch.stack(sun), torch.stack(sunlight)
    noise1, noise2 = frame_noise(blue_noise, uniforms["seed"], width, height, row0, rows)
    zero = torch.zeros((), dtype=torch.float32, device=ray_dir.device)

    def sky(d, include_sun):
        rgb = shading.sample_sky((d[..., 0], d[..., 1], d[..., 2]), sun, sunlight,
                                 include_sun)
        return torch.stack(torch.broadcast_tensors(*rgb), -1)

    def sun_dir_from(noise):
        d = sun_vec + torch.stack(
            [noise[..., 0], noise[..., 1], torch.zeros_like(noise[..., 0])], -1) * 0.05
        return torch.stack(normalize(d[..., 0], d[..., 1], d[..., 2]), -1)

    def diffuse(noise, normal_id):
        return torch.stack(
            shading.diffuse_direction(noise[..., 0], noise[..., 1], normal_id), -1)

    def trace_pair(from_pos, sun_d, dif_d, active):
        """The sun and diffuse rays of one bounce as one doubled batch;
        ``active`` marks the pixels whose bounce rays exist at all."""
        r = trace(torch.cat([from_pos, from_pos]), torch.cat([sun_d, dif_d]),
                  torch.cat([active, active]))
        n = from_pos.shape[0]
        half = lambda lo, hi: {k: (v[lo:hi] if v.dim() else v) for k, v in r.items()}
        return half(0, n), half(n, 2 * n)

    primary = trace(origin, ray_dir)
    hit_mask = ~primary["air"]

    light_hit = torch.zeros(origin.shape, dtype=torch.float32, device=origin.device)
    if bounces >= 1:
        d1 = diffuse(noise1, primary["normal"])
        sun1, dif1 = trace_pair(primary["position"], sun_dir_from(noise1), d1, hit_mask)
        light_hit = (torch.where(sun1["air"][..., None], sunlight_vec, zero)
                     + torch.where(dif1["air"][..., None], sky(d1, True), zero))
    if bounces >= 2:
        d2 = diffuse(noise2, dif1["normal"])
        sun2, dif2 = trace_pair(dif1["position"], sun_dir_from(noise2), d2,
                                hit_mask & ~dif1["air"])
        light2 = (torch.where(sun2["air"][..., None], sunlight_vec, zero)
                  + torch.where(dif2["air"][..., None], sky(d2, True), zero))
        light2 = light2 * dif1["albedo"]
        light_hit = light_hit + torch.where(dif1["air"][..., None], zero, light2)

    light = torch.where(hit_mask[..., None], light_hit, sky(ray_dir, True))
    dist = length(uniforms["origin"] - primary["position"])
    depth = torch.where(
        primary["air"], 0xFFFF,
        torch.clamp(dist * 32.0, max=float(0xFFFF)).to(torch.int32))
    # Rays that exhausted their budget: pink fog (the REPORT_ERROR colour,
    # made on the device) and the near-max depth that fogs to it.
    exhausted = primary["exhausted"]
    pink = (torch.arange(3, device=ray_dir.device) != 1).to(torch.float32)
    fog = torch.where(exhausted[..., None], pink, fdiv(sky(ray_dir, False), 2.0))
    depth = torch.where(exhausted, EXHAUSTED_DEPTH, depth)
    return {
        "lighting": fdiv(light, LIGHTING_SCALE),
        "depth": depth.to(torch.uint16),
        "normal": torch.where(primary["air"], NORMAL_SKY, primary["normal"]).to(torch.uint8),
        "albedo": torch.where(hit_mask[..., None], primary["albedo"], 1.0),
        "emission": torch.zeros_like(light),
        "fog": fog,
    }
