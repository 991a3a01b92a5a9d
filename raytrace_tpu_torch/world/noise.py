"""Procedural noise on int32/float32 tensors.

Port of ``raytrace_tpu/world/noise.py:35-148`` (``_mix``, ``_hash2``,
``hash3_u32``, ``_grad_dot``, ``perlin2``, ``basic_multi``).  The integer
hashes are bit-exact with the JAX package: tensors stay int32 and rely on
two's-complement wrap, and every Python constant is reduced to int32 range
before it meets a tensor (``seed * 1440662683`` overflows otherwise).
"""

from __future__ import annotations

import torch

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
