"""[Frozen copy of ``raytrace_tpu_torch/world/noise.py`` for the benchmark's reference:
its plain PyTorch code only, without the kernel wrappers.]

Procedural noise on int32/float32 tensors.

Port of ``raytrace_tpu/world/noise.py`` (all of it): ``_mix``, ``_hash2``,
``hash3_u32``, ``_grad_dot``, ``perlin2``, ``basic_multi`` (``:35-148``),
which the world lattice reads, and the rest of the public noise API
(``:151-350``): ``worley2``, ``mountain_noise`` (the v1 composite),
``perlin2_grad``, ``basic_multi_lowgrad``, ``mountain_noise2`` (the
analytic mountain function the lattice tables) and
``mountain_noise2_grid``.  The integer hashes are bit-exact with the JAX
package: tensors stay int32 and rely on two's-complement wrap, and every
Python constant is reduced to int32 range before it meets a tensor
(``seed * 1440662683`` overflows otherwise).  Divisions by a constant go
through ``_f32.fdiv`` (a true float32 division on every device).
"""

from __future__ import annotations

import torch

from .._device import default_device
from .._f32 import fdiv

DEFAULT_OCTAVES = 6
DEFAULT_FREQUENCY = 2.0
DEFAULT_LACUNARITY = 2.0943951023931953  # pi * 2 / 3
DEFAULT_PERSISTENCE = 0.5
SLOPE_OCTAVES = 2

_HA = 374761393
_HB = 668265263
_HZ = -1262997521
_HSEED = 1440662683
_HMIX = 1274126177


def i32(v: int) -> int:
    """A Python int wrapped to the signed 32-bit range."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _seed_term(seed: int) -> int:
    return i32(i32(seed) * _HSEED)


def _mix(h: torch.Tensor) -> torch.Tensor:
    """Avalanche mix of a lattice-linear pre-hash (int32, wrapping)."""
    h = (h ^ (h >> 13)) * _HMIX
    return h ^ (h >> 16)


def _hash2(xi: torch.Tensor, yi: torch.Tensor, seed: int) -> torch.Tensor:
    """Counter-based 2D lattice hash -> int32."""
    return _mix(xi * _HA + yi * _HB + _seed_term(seed))


def hash3_u32(xi, yi, zi, seed: int) -> torch.Tensor:
    """Counter-based 3D hash; the uint32 result is held in an int32 tensor
    (same bits).  Callers that need unsigned arithmetic widen with
    ``.to(torch.int64) & 0xFFFFFFFF``."""
    h = (
        xi.to(torch.int32) * _HA
        + yi.to(torch.int32) * _HB
        + zi.to(torch.int32) * _HZ
    )
    h = h + _seed_term(seed)
    h = (h ^ (h >> 13)) * _HMIX
    return h ^ (h >> 16)


def _grad_dot(hash_val, dx, dy):
    """Dot of the hashed corner gradient with the offset vector."""
    h = hash_val & 7
    zero = torch.zeros_like(dx)
    u = torch.where(h < 6, torch.where((h & 1) == 0, dx, -dx), zero)
    v = torch.where(
        h < 4,
        torch.where((h & 2) == 0, dy, -dy),
        torch.where(h >= 6, torch.where((h & 1) == 0, dy, -dy), zero),
    )
    return u + v


def perlin2(x: torch.Tensor, y: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """2D gradient noise in [-1, 1], float32."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    xi = x0.to(torch.int32)
    yi = y0.to(torch.int32)
    xf = x - x0
    yf = y - y0
    u = xf * xf * xf * (xf * (xf * 6.0 - 15.0) + 10.0)
    v = yf * yf * yf * (yf * (yf * 6.0 - 15.0) + 10.0)
    hb = xi * _HA + yi * _HB + _seed_term(seed)
    n00 = _grad_dot(_mix(hb), xf, yf)
    n10 = _grad_dot(_mix(hb + _HA), xf - 1.0, yf)
    n01 = _grad_dot(_mix(hb + _HB), xf, yf - 1.0)
    n11 = _grad_dot(_mix(hb + (_HA + _HB)), xf - 1.0, yf - 1.0)
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    n = nx0 + v * (nx1 - nx0)
    return n * 1.4142135623730951


def basic_multi(
    x: torch.Tensor,
    y: torch.Tensor,
    seed: int = 0,
    octaves: int = DEFAULT_OCTAVES,
    frequency: float = DEFAULT_FREQUENCY,
    lacunarity: float = DEFAULT_LACUNARITY,
    persistence: float = DEFAULT_PERSISTENCE,
) -> torch.Tensor:
    """Heterogeneous multifractal over per-octave-seeded Perlin sources."""
    px = x * frequency
    py = y * frequency
    result = perlin2(px, py, seed)
    amp = 1.0
    for octave in range(1, octaves):
        px = px * lacunarity
        py = py * lacunarity
        amp *= persistence
        signal = perlin2(px, py, seed + octave) * amp
        result = result + signal * result
    return result


def worley2(x: torch.Tensor, y: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """2D Worley (cellular) F1 distance noise minus 1, in [-1, ~0.4]: the
    range-enabled, zero-displacement Worley of the v1 mountain noise."""
    xi = torch.floor(x).to(torch.int32)
    yi = torch.floor(y).to(torch.int32)
    best = torch.full(torch.broadcast_shapes(x.shape, y.shape), float("inf"),
                      dtype=torch.float32, device=x.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            cx = xi + dx
            cy = yi + dy
            hx = _hash2(cx, cy, seed)
            hy = _hash2(cx, cy, seed + 0x3779B9)
            fx = cx.to(torch.float32) + fdiv((hx & 0xFFFF).to(torch.float32), 65536.0)
            fy = cy.to(torch.float32) + fdiv((hy & 0xFFFF).to(torch.float32), 65536.0)
            d = torch.sqrt((fx - x) ** 2 + (fy - y) ** 2)
            best = torch.minimum(best, d)
    return best - 1.0


def _map_from_range(v, lo: float, hi: float):
    return torch.clamp(fdiv(v - lo, hi - lo), 0.0, 1.0)


def _map_to_range(v, lo: float, hi: float):
    return torch.clamp(v * (hi - lo) + lo, 0.0, 1.0)


def mountain_noise(x: torch.Tensor, y: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """The v1 Worley + gradient-noise mountain composite; the terrain uses
    ``mountain_noise2``, as the JAX package's does."""
    base = worley2(x, y, seed) + 1.0
    detail = worley2(x * 4.0, y * 4.0, seed) + 1.0
    detail = _map_to_range(detail, 0.73, 1.0)
    detail = detail * _map_from_range(base, 0.34, 0.79)
    base = _map_from_range(base, 0.4, 1.0)
    base = fdiv(base + detail, 2.0)
    base = base ** 2.2
    rustle = perlin2(x * 0.8, y * 0.8, seed + 7) + 0.5
    rustle = _map_to_range(_map_from_range(rustle, 0.15, 1.0), 0.15, 1.0)
    rustle = rustle ** 2.0
    return base * rustle


def _grad_vec(hash_val):
    """(gx, gy) of the hashed corner gradient (see ``_grad_dot``)."""
    h = hash_val & 7
    one = torch.ones(h.shape, dtype=torch.float32, device=h.device)
    zero = torch.zeros_like(one)
    gx = torch.where(h < 6, torch.where((h & 1) == 0, one, -one), zero)
    gy = torch.where(
        h < 4,
        torch.where((h & 2) == 0, one, -one),
        torch.where(h >= 6, torch.where((h & 1) == 0, one, -one), zero),
    )
    return gx, gy


def perlin2_grad(x: torch.Tensor, y: torch.Tensor, seed: int = 0):
    """(value, d/dx, d/dy) of ``perlin2``: the analytic derivative."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    xi = x0.to(torch.int32)
    yi = y0.to(torch.int32)
    xf = x - x0
    yf = y - y0
    u = xf * xf * xf * (xf * (xf * 6.0 - 15.0) + 10.0)
    v = yf * yf * yf * (yf * (yf * 6.0 - 15.0) + 10.0)
    du = 30.0 * xf * xf * (xf * (xf - 2.0) + 1.0)
    dv = 30.0 * yf * yf * (yf * (yf - 2.0) + 1.0)
    hb = xi * _HA + yi * _HB + _seed_term(seed)
    corners = []
    for ox, oy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        gx, gy = _grad_vec(_mix(hb + (ox * _HA + oy * _HB)))
        corners.append((gx * (xf - ox) + gy * (yf - oy), gx, gy))
    (n00, g00x, g00y), (n10, g10x, g10y), (n01, g01x, g01y), (n11, g11x, g11y) = corners

    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    val = nx0 + v * (nx1 - nx0)

    dnx0_dx = g00x + du * (n10 - n00) + u * (g10x - g00x)
    dnx1_dx = g01x + du * (n11 - n01) + u * (g11x - g01x)
    d_dx = dnx0_dx + v * (dnx1_dx - dnx0_dx)

    dnx0_dy = g00y + u * (g10y - g00y)
    dnx1_dy = g01y + u * (g11y - g01y)
    d_dy = dnx0_dy + v * (dnx1_dy - dnx0_dy) + dv * (nx1 - nx0)

    s = 1.4142135623730951
    return val * s, d_dx * s, d_dy * s


def basic_multi_lowgrad(x, y, seed: int = 0, octaves: int = 2,
                        frequency: float = DEFAULT_FREQUENCY,
                        lacunarity: float = DEFAULT_LACUNARITY,
                        persistence: float = DEFAULT_PERSISTENCE):
    """(value, ddx, ddy) of the first ``octaves`` of the multifractal, the
    gradient with respect to the input coordinate (before the frequency)."""
    px = x * frequency
    py = y * frequency
    r, rx, ry = perlin2_grad(px, py, seed)
    rx = rx * frequency
    ry = ry * frequency
    amp = 1.0
    freq = frequency
    for octave in range(1, octaves):
        px = px * lacunarity
        py = py * lacunarity
        amp *= persistence
        freq *= lacunarity
        p, pxg, pyg = perlin2_grad(px, py, seed + octave)
        s = amp * p
        sx = amp * pxg * freq
        sy = amp * pyg * freq
        new_r = r + s * r
        rx, ry = rx * (1.0 + s) + r * sx, ry * (1.0 + s) + r * sy
        r = new_r
    return r, rx, ry


def _fbm01(x, y, seed: int):
    """BasicMulti mapped to ~[0, 1]."""
    return basic_multi(x, y, seed) * 0.5 + 0.5


def mountain_noise2(x: torch.Tensor, y: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Slope-eroded mountain noise in ~[0, 1]: the central-difference slope
    (d = 0.2) of the low-octave partial field (``SLOPE_OCTAVES``) erodes
    the base, sharpened with a 2.6 power; a negative eroded value maps to
    0."""
    d = 0.2

    def fbm01_low(a, b):
        return basic_multi(a, b, seed, octaves=SLOPE_OCTAVES) * 0.5 + 0.5

    left = fbm01_low(x - d, y)
    right = fbm01_low(x + d, y)
    up = fbm01_low(x, y - d)
    down = fbm01_low(x, y + d)
    dx = fdiv(right - left, d * 2.0)
    dy = fdiv(down - up, d * 2.0)
    slope = torch.sqrt(dx * dx + dy * dy)
    base = _fbm01(x, y, seed)
    eroded = base + (1.0 - slope) * 0.7
    return torch.where(eroded >= 0.0, fdiv(torch.abs(eroded), 1.5) ** 2.6,
                       torch.zeros_like(eroded))


def mountain_noise2_grid(origin_x: int, origin_y: int, shape, seed: int = 0,
                         device=None) -> torch.Tensor:
    """``mountain_noise2`` on the integer grid of world columns
    ``(origin_x + x, origin_y + y)`` -> (Y, X) float32, on ``device`` (the
    current CUDA device when None; with no GPU it raises)."""
    device = default_device(device, "mountain_noise2_grid")
    ny, nx = shape
    gx = origin_x + torch.arange(nx, dtype=torch.int32, device=device)[None, :]
    gy = origin_y + torch.arange(ny, dtype=torch.int32, device=device)[:, None]
    return mountain_noise2(gx.to(torch.float32).expand(ny, nx),
                           gy.to(torch.float32).expand(ny, nx), seed)
