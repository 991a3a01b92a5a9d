"""Sky, sun and bounce math in NumPy, for the reference tracer.

The port's own NumPy copy of the ``xp``-generic
``raytrace_tpu/ops/shading.py`` (``sun_direction``, ``sun_color``,
``sample_sky``, ``sphere_point``, ``diffuse_from_sphere``,
``diffuse_direction``, ``face_normal_vector``) with ``xp = numpy``: the same
operations in the same order, so ``testing/reference_tracer.py`` computes
what the JAX package's NumPy tracer does bit for bit.  The port's
``ops/shading.py`` is the PyTorch version of the same formulas.  Vector
quantities are separate x/y/z arrays.
"""

from __future__ import annotations

import numpy as np

SUN_MAIN_COLOR = (0.9647 * 2.0, 0.7843 * 2.0, 0.8824 * 2.0)
SUN_SUNSET_COLOR = (0.7412 * 2.0, 0.2157 * 2.0, 0.1686 * 2.0)
SKY_BRIGHT_COLOR = (0.5294, 0.8275, 0.9647)
SKY_DARK_COLOR = (0.0863, 0.1294, 0.2196)


def sun_direction(sun_angle):
    """Unnormalized-then-normalized sun vector (raytrace.comp:317)."""
    sx = np.cos(sun_angle) * 0.5 + (sun_angle - 0.5) * 0.5
    sy = np.sin(sun_angle)
    sz = np.cos(sun_angle)
    norm = np.sqrt(sx * sx + sy * sy + sz * sz)
    return sx / norm, sy / norm, sz / norm


def _mix(a, b, t):
    return a + (b - a) * t


def sun_color(sun_dir):
    """Sunlight color from sun elevation (raytrace.comp:259-269)."""
    sx, sy, sz = sun_dir
    horizon = np.sqrt(sx * sx + sy * sy)
    sun_amount = np.minimum(1.0 - horizon, 0.02) * 50.0
    out = []
    for main, sunset in zip(SUN_MAIN_COLOR, SUN_SUNSET_COLOR):
        day = _mix(sunset, main, sun_amount)
        night = _mix(sunset, 0.0, sun_amount * 2.0)
        out.append(np.where(sz >= 0.0, day, night))
    return tuple(out)


def sample_sky(direction, sun_dir, sunlight, include_sun):
    """Procedural sky dome radiance (raytrace.comp:271-288); ``direction``
    normalized, ``include_sun`` a bool or a bool array."""
    dx, dy, dz = direction
    sx, sy, sz = sun_dir
    lr, lg, lb = sunlight

    sunlight_amount = np.clip((lr + lg + lb) * 0.2 - 0.02, 0.0, 1.0)
    horizon = np.sqrt(dx * dx + dy * dy) ** _mix(40.0, 10.0, sunlight_amount)
    dist = np.sqrt((sx - dx) ** 2 + (sy - dy) ** 2 + (sz - dz) ** 2)
    sun_amount = 1.0 - 0.5 * dist
    sun_halo_amount = np.maximum(sun_amount, 0.0) ** _mix(5.0, 1.0, sunlight_amount)
    bright_amount = np.minimum(horizon + sun_halo_amount * 0.5, 1.0)
    glow = np.maximum(sun_amount, 0.0) ** 5.0 * 0.5
    disk = np.logical_and(sun_amount > 0.98, include_sun)
    out = []
    for dark, bright, sun in zip(SKY_DARK_COLOR, SKY_BRIGHT_COLOR, (lr, lg, lb)):
        c = _mix(dark, bright, bright_amount * np.maximum(sunlight_amount, 0.1))
        c = c + sun * glow
        c = c + np.where(disk, sun, 0.0)
        out.append(c)
    return tuple(out)


def sphere_point(noise_r, noise_g):
    """Random unit-sphere point from two noise values (raytrace.comp:189-203)."""
    pi = 3.141592653589793
    theta1 = pi * 2.0 * noise_r
    cos_t2 = np.clip(1.0 - 2.0 * noise_g, -1.0, 1.0)
    sin_t2 = np.sqrt(np.maximum(1.0 - cos_t2 * cos_t2, 0.0))
    return np.sin(theta1) * sin_t2, np.cos(theta1) * sin_t2, cos_t2


def diffuse_from_sphere(sp, normal_id):
    """Sphere point + the hit face's outward normal, normalized
    (raytrace.comp:204-212); a sum that cancels gives the normal itself."""
    nx, ny, nz = face_normal_vector(normal_id)
    dx = sp[0] + nx
    dy = sp[1] + ny
    dz = sp[2] + nz
    norm = np.sqrt(dx * dx + dy * dy + dz * dz)
    degenerate = norm < 1e-6
    norm = np.maximum(norm, 1e-20)
    return (
        np.where(degenerate, nx, dx / norm),
        np.where(degenerate, ny, dy / norm),
        np.where(degenerate, nz, dz / norm),
    )


def diffuse_direction(noise_r, noise_g, normal_id):
    """Cosine-ish bounce direction (raytrace.comp:189-212)."""
    return diffuse_from_sphere(sphere_point(noise_r, noise_g), normal_id)


def face_normal_vector(normal_id):
    """Face id -> outward unit normal (raytrace.comp:230-244): 0/1 = -/+X
    face hit, 2/3 = -/+Y, 4/5 = -/+Z; even ids give the +axis normal."""
    sign = np.where(normal_id % 2 == 0, 1.0, -1.0)
    axis = normal_id // 2
    nx = np.where(axis == 0, sign, 0.0)
    ny = np.where(axis == 1, sign, 0.0)
    nz = np.where(axis == 2, sign, 0.0)
    return nx, ny, nz
