"""NumPy golden-reference path tracer.

The port's copy of ``raytrace_tpu/testing/reference_tracer.py``
(``trace_rays_np``, ``render_gbuffers_np``): NumPy and the port's own
``constants`` and ``testing/shading_np.py``, nothing of the JAX package,
and the same results bit for bit.

An independent, host-side implementation of the exact tracer semantics
(reference: shaders/glsl/raytrace.comp) used to validate the on-device
tracers (the port's exact DDA, ``ops/trace_dda.py``).  Vectorized over
rays for speed but stepwise-faithful: each iteration advances every active
ray to its next minefield-aligned boundary, exactly like the GLSL DDA loop
(raytrace.comp:82-183).

All math is float32 to match device arithmetic; tests compare within small
tolerances and allow rare borderline-pixel flips.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    LIGHTING_SCALE,
    MAX_TRACE_STEPS,
    NORMAL_SKY,
    ROOT_BLOCK_SIZE,
)
from . import shading_np as shading

_HALF = ROOT_BLOCK_SIZE // 2  # 128


def _texel(pos: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """World position -> toroidal volume texel indices (z, y, x).

    texel = floor(mod(pos + 128, 256)); both volume samplers resolve to this
    (raytrace.comp:106,150-153 with the NEAREST samplers of
    render_data.rs:66-101).
    """
    t = np.floor(np.mod(pos + np.float32(_HALF), np.float32(ROOT_BLOCK_SIZE))).astype(
        np.int64
    )
    t = np.clip(t, 0, ROOT_BLOCK_SIZE - 1)
    return t[..., 2], t[..., 1], t[..., 0]


def trace_rays_np(
    materials: np.ndarray,
    minefield: np.ndarray,
    origin: np.ndarray,
    direction: np.ndarray,
    lr: np.ndarray,
    max_steps: int = MAX_TRACE_STEPS,
) -> dict[str, np.ndarray]:
    """Trace N rays against the toroidal world volume.

    Args:
      materials: (256,256,256) u32 packed materials, (Z, Y, X).
      minefield: (256,256,256) u8 LOD step grid.
      origin / direction: (..., 3) float32 world-space rays (xyz order).
      lr: (3,) render offset = center of the currently-loaded region.
      max_steps: DDA iteration cap (reference: 2048, raytrace.comp:109).

    Returns dict with position (..., 3), normal (int32 face id), air (bool),
    albedo (..., 3), distance — semantics of HitResult (raytrace.comp:62-69).
    """
    origin = origin.astype(np.float32)
    dirn = direction.astype(np.float32)
    dirn = dirn / np.maximum(
        np.linalg.norm(dirn, axis=-1, keepdims=True).astype(np.float32), 1e-20
    )
    lr = np.asarray(lr, np.float32)

    with np.errstate(divide="ignore"):
        length_per_axis = np.float32(1.0) / np.abs(dirn)
    normals = np.where(
        dirn > 0,
        np.array([1, 3, 5], np.int32),
        np.array([0, 2, 4], np.int32),
    )
    muls = np.where(dirn > 0, np.float32(-1.0), np.float32(1.0))

    pos = origin.copy()
    shape = pos.shape[:-1]
    normal = np.zeros(shape, np.int32)
    air = np.zeros(shape, bool)
    done = np.zeros(shape, bool)
    hit_packed = np.zeros(shape, np.uint32)

    tz, ty, tx = _texel(pos)
    cur_step = minefield[tz, ty, tx].astype(np.int32)
    step_size = ((1 << cur_step) // 2).astype(np.float32)

    for _ in range(max_steps):
        if done.all():
            break
        active = ~done
        # Distance along the ray to the next step_size-aligned boundary per
        # axis (raytrace.comp:119); mod by zero (inside a solid voxel at
        # start) is defined as 0 here -> epsilon-only creep, matching the
        # reference's observed behavior.
        shifted = (pos + np.float32(_HALF)) * muls
        ss = step_size[..., None]
        with np.errstate(invalid="ignore"):
            m = np.where(ss > 0, np.mod(shifted, np.where(ss > 0, ss, 1.0)), 0.0)
        l = (np.float32(1e-4) + m) * length_per_axis

        lx, ly, lz = l[..., 0], l[..., 1], l[..., 2]
        # Exact GLSL comparison tree (raytrace.comp:120-136).
        use_x = (lx < ly) & (lx < lz)
        use_y = ~(lx < ly) & (ly < lz)
        axis = np.where(use_x, 0, np.where(use_y, 1, 2))
        lmin = np.where(use_x, lx, np.where(use_y, ly, lz)).astype(np.float32)
        # Done lanes carry whatever stale boundary distances they ended on
        # (possibly inf from a zero direction component); step them 0 so the
        # multiply below never computes inf * 0 = NaN.
        lmin = np.where(active & np.isfinite(lmin), lmin, np.float32(0.0))

        step_vec = dirn * lmin[..., None]
        pos = np.where(active[..., None], pos + step_vec, pos)
        normal = np.where(active, np.take_along_axis(normals, axis[..., None], -1)[..., 0], normal)

        tz, ty, tx = _texel(pos)
        cur_step = minefield[tz, ty, tx].astype(np.int32)

        out_of_bounds = (np.abs(pos - lr) >= np.float32(_HALF)).any(axis=-1)
        hit = cur_step <= 0

        new_air = active & out_of_bounds
        new_hit = active & ~out_of_bounds & hit
        air = air | new_air
        hit_packed = np.where(new_hit, materials[tz, ty, tx], hit_packed)
        done = done | new_air | new_hit

        step_size = np.where(
            done, step_size, ((1 << cur_step) // 2).astype(np.float32)
        )

    distance = np.linalg.norm(origin - pos, axis=-1).astype(np.float32)

    # Post-loop nudge off the hit face (raytrace.comp:166-180), applied
    # unconditionally using the final normal id.
    nx, ny, nz = shading.face_normal_vector(normal)
    pos = pos + np.float32(0.001) * np.stack([nx, ny, nz], axis=-1).astype(np.float32)

    p = hit_packed
    albedo = np.stack(
        [
            ((p >> 14) & 0x7F).astype(np.float32) / 127.0,
            ((p >> 7) & 0x7F).astype(np.float32) / 127.0,
            (p & 0x7F).astype(np.float32) / 127.0,
        ],
        axis=-1,
    )
    return {
        "position": pos,
        "normal": normal,
        "air": air,
        "albedo": albedo,
        "distance": distance,
        "exhausted": ~done,
    }


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-20).astype(
        np.float32
    )


def render_gbuffers_np(
    materials: np.ndarray,
    minefield: np.ndarray,
    *,
    origin,
    forward,
    up,
    right,
    sun_angle: float,
    seed: int,
    blue_noise: np.ndarray,
    lr,
    width: int,
    height: int,
    max_steps: int = MAX_TRACE_STEPS,
) -> dict[str, np.ndarray]:
    """Full per-pixel G-buffer + lighting pass (raytrace.comp main, :290-400).

    ``up``/``right`` must already carry the 0.4 FOV scale
    (pipeline.rs:198-199).  Blue-noise addressing is per-pixel (see
    ops/rays.py for the documented divergence from the reference's
    workgroup-granular noise offsets).

    Returns dict of (H, W[, 3]) arrays: lighting, depth_u16, normal_u8,
    albedo, emission, fog.
    """
    origin = np.asarray(origin, np.float32)
    forward = np.asarray(forward, np.float32)
    up = np.asarray(up, np.float32)
    right = np.asarray(right, np.float32)
    lr = np.asarray(lr, np.float32)
    noise_tex = blue_noise.astype(np.float32) / 255.0

    py, px = np.mgrid[0:height, 0:width]
    sx = (px.astype(np.float32) / np.float32(width)) * 2.0 - 1.0
    sy = (py.astype(np.float32) / np.float32(height)) * 2.0 - 1.0

    ray_dir = _normalize(
        forward[None, None]
        + sx[..., None] * right[None, None]
        + sy[..., None] * up[None, None]
    )

    ray_start = np.broadcast_to(origin, ray_dir.shape).astype(np.float32).copy()
    # Clamp camera starts below the -Y boundary (raytrace.comp:312-315).
    if -origin[1] > _HALF:
        space = np.float32(-origin[1] - _HALF)
        with np.errstate(divide="ignore"):
            t = space / ray_dir[..., 1] + np.float32(1e-4)
        # Rays exactly parallel to the boundary (dir.y == 0) get t = inf and
        # can never enter the volume; advance them 0 instead of computing
        # inf * 0 = NaN — they still resolve as out-of-bounds sky, exactly
        # like the reference's divergent lanes.
        t = np.where(np.isfinite(t), t, np.float32(0.0))
        ray_start = ray_start + t[..., None] * ray_dir

    sun = shading.sun_direction(np.float32(sun_angle))
    sun_np = np.array(sun, np.float32)
    sunlight = shading.sun_color(sun)
    sunlight_np = np.array(sunlight, np.float32)

    # Per-frame noise offset from the seed texel (raytrace.comp:298-304),
    # then per-pixel translation.
    sx_i = seed % blue_noise.shape[1]
    sy_i = (seed // blue_noise.shape[1]) % blue_noise.shape[0]
    # Round, matching ops/rays.py (ulp-robust offset quantization).
    off = np.floor(noise_tex[sy_i, sx_i, :2] * 255.0 + 0.5).astype(np.int64)
    n1y = (py + off[1]) % blue_noise.shape[0]
    n1x = (px + off[0]) % blue_noise.shape[1]
    noise1 = noise_tex[n1y, n1x]  # (H, W, 4)
    noise2 = noise_tex[(n1y + 2) % blue_noise.shape[0], (n1x + 2) % blue_noise.shape[1]]

    def trace(o, d):
        return trace_rays_np(materials, minefield, o, d, lr, max_steps)

    def trace_sun(hit_pos, noise):
        d = sun_np[None, None] + np.stack(
            [noise[..., 0], noise[..., 1], np.zeros_like(noise[..., 0])], -1
        ) * np.float32(0.05)
        return trace(hit_pos, _normalize(d))

    def sky(d, include_sun):
        r, g, b = shading.sample_sky(
            (d[..., 0], d[..., 1], d[..., 2]),
            sun,
            sunlight,
            include_sun,
        )
        return np.stack(np.broadcast_arrays(r, g, b), -1).astype(np.float32)

    primary = trace(ray_start, ray_dir)

    light = np.zeros(ray_dir.shape, np.float32)
    sky_primary = sky(ray_dir, True)
    hit_mask = ~primary["air"]

    # Bounce 1 from the primary hit.
    sun1 = trace_sun(primary["position"], noise1)
    light_hit = np.where(sun1["air"][..., None], sunlight_np[None, None], 0.0)

    d1 = np.stack(
        shading.diffuse_direction(noise1[..., 0], noise1[..., 1], primary["normal"]),
        -1,
    ).astype(np.float32)
    dif1 = trace(primary["position"], d1)
    light_hit = light_hit + np.where(dif1["air"][..., None], sky(d1, True), 0.0)

    # Bounce 2 from the first diffuse hit.
    sun2 = trace_sun(dif1["position"], noise2)
    light2 = np.where(sun2["air"][..., None], sunlight_np[None, None], 0.0)
    d2 = np.stack(
        shading.diffuse_direction(noise2[..., 0], noise2[..., 1], dif1["normal"]),
        -1,
    ).astype(np.float32)
    dif2 = trace(dif1["position"], d2)
    light2 = light2 + np.where(dif2["air"][..., None], sky(d2, True), 0.0)
    light2 = light2 * dif1["albedo"]
    light_hit = light_hit + np.where(dif1["air"][..., None], 0.0, light2)

    light = np.where(hit_mask[..., None], light_hit, sky_primary)

    depth = np.where(
        primary["air"],
        np.uint32(0xFFFF),
        np.minimum(
            np.linalg.norm(origin[None, None] - primary["position"], axis=-1) * 32.0,
            np.float32(0xFFFF),
        ).astype(np.uint32),
    ).astype(np.uint16)

    fog = sky(ray_dir, False) / 2.0
    # Error-limiter parity (raytrace.comp:387-400): exhausted rays turn the
    # fog buffer pink with near-max depth.
    exhausted = primary["exhausted"][..., None]
    fog = np.where(exhausted, np.array([1.0, 0.0, 1.0], np.float32), fog)
    depth = np.where(primary["exhausted"], np.uint16(256 * 254), depth)

    return {
        "lighting": light / np.float32(LIGHTING_SCALE),
        "depth": depth,
        "normal": np.where(
            primary["air"], np.int32(NORMAL_SKY), primary["normal"]
        ).astype(np.uint8),
        "albedo": np.where(hit_mask[..., None], primary["albedo"], 1.0).astype(
            np.float32
        ),
        "emission": np.zeros_like(light),
        "fog": fog.astype(np.float32),
    }
