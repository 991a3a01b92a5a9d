"""[Frozen copy of ``raytrace_tpu_torch/ops/shading.py`` for the benchmark's reference:
its plain PyTorch code only, without the kernel wrappers.]

Sky, sun and tone-mapping math on float32 tensors.

Port of ``raytrace_tpu/ops/shading.py`` (all of it).  The JAX module takes
an array-module argument; these take tensors, and every Python constant is
a float32 operand as in JAX's weak typing.  Vectors are (x, y, z) tuples of
tensors.  ``csrc/shading.cuh`` spells out the same ``sun_direction``,
``sun_color``, ``sample_sky``, ``sphere_point`` and ``diffuse_from_sphere``
for the kernels K1, R1, S1 and S3 (``face_normal_vector`` is
``heightfield.cuh``'s ``face_normal``).  ``sun_vector`` packs a frame's sun
and sunlight as those kernels read them, and ``sphere_trig`` tabulates the
sphere points' sin and cos for them.
"""

from __future__ import annotations

import torch

from .._f32 import fdiv

SUN_MAIN_COLOR = (0.9647 * 2.0, 0.7843 * 2.0, 0.8824 * 2.0)
SUN_SUNSET_COLOR = (0.7412 * 2.0, 0.2157 * 2.0, 0.1686 * 2.0)
SKY_BRIGHT_COLOR = (0.5294, 0.8275, 0.9647)
SKY_DARK_COLOR = (0.0863, 0.1294, 0.2196)
TWO_PI = 3.141592653589793 * 2.0


def sun_direction(sun_angle: torch.Tensor):
    """Normalized sun vector from a 0-d float32 angle."""
    sx = torch.cos(sun_angle) * 0.5 + (sun_angle - 0.5) * 0.5
    sy = torch.sin(sun_angle)
    sz = torch.cos(sun_angle)
    norm = torch.sqrt(sx * sx + sy * sy + sz * sz)
    return sx / norm, sy / norm, sz / norm


def sun_vector(sun_angle: torch.Tensor) -> torch.Tensor:
    """(8,) f32: the sun direction xyz and the sunlight rgb of a 0-d angle,
    then 0, 0 (the frame's ``sun``, which K1 reads as its ``fscal``)."""
    sun = sun_direction(sun_angle)
    zero = torch.zeros((), dtype=torch.float32, device=sun_angle.device)
    return torch.stack([*sun, *sun_color(sun), zero, zero])


_SPHERE_TRIG: dict = {}


def sphere_trig(device) -> torch.Tensor:
    """(256, 2) f32: sin and cos of the sphere point's angle ``2 pi k / 255``
    for each noise byte ``k``, computed once per device by the operations
    ``sphere_point`` runs on it.  The kernels read them from this table."""
    key = str(torch.device(device))
    if key not in _SPHERE_TRIG:
        nr = fdiv(torch.arange(256, dtype=torch.float32, device=device), 255.0)
        theta = TWO_PI * nr
        _SPHERE_TRIG[key] = torch.stack([torch.sin(theta), torch.cos(theta)], -1).contiguous()
    return _SPHERE_TRIG[key]


def _mix(a, b, t):
    return a + (b - a) * t


def sun_color(sun_dir):
    """Sunlight color from sun elevation (0-d tensors in, 0-d out)."""
    sx, sy, sz = sun_dir
    horizon = torch.sqrt(sx * sx + sy * sy)
    sun_amount = torch.clamp(1.0 - horizon, max=0.02) * 50.0
    out = []
    for main, sunset in zip(SUN_MAIN_COLOR, SUN_SUNSET_COLOR):
        day = _mix(sunset, main, sun_amount)
        night = _mix(sunset, 0.0, sun_amount * 2.0)
        out.append(torch.where(sz >= 0.0, day, night))
    return tuple(out)


def sample_sky(direction, sun_dir, sunlight, include_sun: bool):
    """Procedural sky dome radiance for normalized directions."""
    dx, dy, dz = direction
    sx, sy, sz = sun_dir
    lr, lg, lb = sunlight
    sunlight_amount = torch.clamp((lr + lg + lb) * 0.2 - 0.02, 0.0, 1.0)
    horizon = torch.pow(torch.sqrt(dx * dx + dy * dy), _mix(40.0, 10.0, sunlight_amount))
    dist = torch.sqrt(
        torch.pow(sx - dx, 2) + torch.pow(sy - dy, 2) + torch.pow(sz - dz, 2)
    )
    sun_amount = 1.0 - 0.5 * dist
    halo_base = torch.clamp(sun_amount, min=0.0)
    sun_halo_amount = torch.pow(halo_base, _mix(5.0, 1.0, sunlight_amount))
    bright_amount = torch.clamp(horizon + sun_halo_amount * 0.5, max=1.0)
    glow = torch.pow(halo_base, 5.0) * 0.5
    disk = sun_amount > 0.98
    if not include_sun:
        disk = torch.zeros_like(disk)
    out = []
    for dark, bright, sun in zip(SKY_DARK_COLOR, SKY_BRIGHT_COLOR, (lr, lg, lb)):
        c = _mix(dark, bright, bright_amount * torch.clamp(sunlight_amount, min=0.1))
        c = c + sun * glow
        c = c + torch.where(disk, sun, torch.zeros_like(sun))
        out.append(c)
    return tuple(out)


def filmic_curve(x: torch.Tensor) -> torch.Tensor:
    """Piecewise filmic tone curve (finalize.comp:21-31)."""
    seg1 = x * x
    seg2 = x * 0.6 - 0.09
    seg3 = 1.0 - 0.219512195116 * (x - 2.5) * (x - 2.5)
    return torch.where(
        x < 0.3, seg1,
        torch.where(x < 1.13333, seg2,
                    torch.where(x < 2.5, seg3, torch.ones_like(x))),
    )


def sphere_point(noise_r: torch.Tensor, noise_g: torch.Tensor):
    """Unit-sphere point from two noise values (raytrace.comp:189-203)."""
    theta1 = TWO_PI * noise_r
    cos_t2 = torch.clamp(1.0 - 2.0 * noise_g, -1.0, 1.0)
    sin_t2 = torch.sqrt(torch.clamp(1.0 - cos_t2 * cos_t2, min=0.0))
    return torch.sin(theta1) * sin_t2, torch.cos(theta1) * sin_t2, cos_t2


def face_normal_vector(normal_id: torch.Tensor):
    """Face id -> outward unit normal; ids 0/1 -/+X, 2/3 -/+Y, 4/5 -/+Z."""
    one = torch.ones(normal_id.shape, dtype=torch.float32, device=normal_id.device)
    zero = torch.zeros_like(one)
    sign = torch.where(normal_id % 2 == 0, one, -one)
    axis = normal_id // 2
    return (
        torch.where(axis == 0, sign, zero),
        torch.where(axis == 1, sign, zero),
        torch.where(axis == 2, sign, zero),
    )


def diffuse_from_sphere(sp, normal_id: torch.Tensor):
    """Sphere point + face normal, normalized.  Keeps the JAX package's
    degenerate guard (``shading.py:101-124``): where the sum cancels to
    zero the direction is the face normal itself."""
    nx, ny, nz = face_normal_vector(normal_id)
    dx = sp[0] + nx
    dy = sp[1] + ny
    dz = sp[2] + nz
    norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    degenerate = norm < 1e-6
    norm = torch.clamp(norm, min=1e-20)
    return (
        torch.where(degenerate, nx, dx / norm),
        torch.where(degenerate, ny, dy / norm),
        torch.where(degenerate, nz, dz / norm),
    )


def diffuse_direction(noise_r, noise_g, normal_id):
    """Cosine-ish bounce direction (raytrace.comp:189-212)."""
    return diffuse_from_sphere(sphere_point(noise_r, noise_g), normal_id)

