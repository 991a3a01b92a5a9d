"""[Frozen copy of ``raytrace_tpu_torch/world/heightmap.py`` for the benchmark's reference:
its plain PyTorch code only, without the kernel wrappers.]

Terrain heights from the quantized world lattice.

Port of ``raytrace_tpu/world/heightmap.py:57-247``: ``lattice_fields_q``,
``dequant_lattice``, ``height_from_lattice``, ``height_at`` (one column
from its four lattice corners), ``heightmap_grid`` and
``generate_heightmap`` (a chunk's 64 x 64 heights).  The
quantized lattice words are bit-exact with JAX; a column height can differ
by one in rare columns through the last ulp of the float chain, which the
+1 margin of the region pyramid absorbs (see ``ops/hf_tables.py``).
"""

from __future__ import annotations

import torch

from ..constants import (
    CHUNK_SIZE,
    WORLDGEN_HEIGHT_MUL,
    WORLDGEN_HEIGHT_OFFSET,
    WORLDGEN_SCALE,
)
from .._device import default_device
from .._f32 import fdiv
from ..precision import store
from .noise import (
    DEFAULT_LACUNARITY,
    DEFAULT_OCTAVES,
    DEFAULT_PERSISTENCE,
    SLOPE_OCTAVES,
    basic_multi,
    perlin2,
)

LATTICE_SPACING = 8
BASE_OCTAVES_TABLED = 5
R_LO, R_STEP = -4.0, 2.0**-13
E_LO, E_STEP = -2.0, 2.0**-14

_G = LATTICE_SPACING
_K = BASE_OCTAVES_TABLED
# Single source for the float32 constants of height_from_lattice (the CUDA
# kernel spells the same values out).
TOP_FREQ = float(DEFAULT_LACUNARITY) ** _K * 2.0
TOP_AMP = float(DEFAULT_PERSISTENCE) ** _K
HEIGHT_SCALE = WORLDGEN_SCALE * WORLDGEN_HEIGHT_MUL


def lattice_fields_q(wx: torch.Tensor, wy: torch.Tensor, seed: int = 0):
    """Quantized lattice fields at integer world coords -> (r16, e16) int32."""
    fx = fdiv(wx.to(torch.float32), WORLDGEN_SCALE)
    fy = fdiv(wy.to(torch.float32), WORLDGEN_SCALE)
    r = basic_multi(fx, fy, seed, octaves=_K)

    d = 0.2
    two_d = float(torch.tensor(d, dtype=torch.float32) * 2.0)

    def f01(a, b):
        return basic_multi(a, b, seed, octaves=SLOPE_OCTAVES) * 0.5 + 0.5

    dx = fdiv(f01(fx + d, fy) - f01(fx - d, fy), two_d)
    dy = fdiv(f01(fx, fy + d) - f01(fx, fy - d), two_d)
    slope = torch.sqrt(dx * dx + dy * dy)
    e = (1.0 - slope) * 0.7
    r16 = torch.clamp(torch.round((r - R_LO) / R_STEP), 0, 65535).to(torch.int32)
    e16 = torch.clamp(torch.round((e - E_LO) / E_STEP), 0, 65535).to(torch.int32)
    return r16, e16


def dequant_lattice(r16: torch.Tensor, e16: torch.Tensor):
    """16-bit lattice words -> float32 fields (exact: k * 2^-n)."""
    r = R_LO + r16.to(torch.float32) * R_STEP
    e = E_LO + e16.to(torch.float32) * E_STEP
    return r, e


def height_from_lattice(r, e, fx, fy, seed: int = 0) -> torch.Tensor:
    """Analytic top octave + erosion + scaling -> int32 column height."""
    q, amp = 1.0, TOP_AMP
    px, py = fx * TOP_FREQ, fy * TOP_FREQ
    for k in range(_K, DEFAULT_OCTAVES):
        q = q * (1.0 + perlin2(px, py, seed + k) * amp)
        px, py = px * DEFAULT_LACUNARITY, py * DEFAULT_LACUNARITY
        amp *= DEFAULT_PERSISTENCE
    base = r * q * 0.5 + 0.5
    eroded = base + e
    n = torch.where(
        eroded >= 0.0,
        torch.pow(fdiv(torch.abs(eroded), 1.5), 2.6),
        torch.zeros_like(eroded),
    )
    h = store(n * HEIGHT_SCALE + WORLDGEN_HEIGHT_OFFSET)
    return torch.floor(h).to(torch.int32)


def height_at(x: torch.Tensor, y: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """World terrain height of integer world columns (x, y) -> int32
    (float coordinates are floored): the four lattice corners, the bilinear
    blend and the analytic top octave, per column.  ``heightmap_grid``
    evaluates each lattice point of a grid once instead."""
    if x.dtype.is_floating_point:
        x, y = torch.floor(x), torch.floor(y)
    xi, yi = x.to(torch.int32), y.to(torch.int32)
    gx0 = (xi >> 3) << 3  # arithmetic shift: floor division for negatives
    gy0 = (yi >> 3) << 3
    tx = (xi & 7).to(torch.float32) * (1.0 / _G)
    ty = (yi & 7).to(torch.float32) * (1.0 / _G)
    (r00, e00), (r10, e10), (r01, e01), (r11, e11) = (
        dequant_lattice(*lattice_fields_q(gx0 + ox * _G, gy0 + oy * _G, seed))
        for oy in (0, 1) for ox in (0, 1))

    def bil(v00, v10, v01, v11):
        top = v00 + tx * (v10 - v00)
        bot = v01 + tx * (v11 - v01)
        return top + ty * (bot - top)

    fx = fdiv(xi.to(torch.float32), WORLDGEN_SCALE)
    fy = fdiv(yi.to(torch.float32), WORLDGEN_SCALE)
    return height_from_lattice(bil(r00, r10, r01, r11), bil(e00, e10, e01, e11), fx, fy,
                               seed)


def heightmap_grid(origin_x: int, origin_y: int, shape=(CHUNK_SIZE, CHUNK_SIZE),
                   seed: int = 0, device=None) -> torch.Tensor:
    """Heights over an integer grid -> (Y, X) int32, ``[y, x]`` is world
    column ``(origin_x + x, origin_y + y)``, on ``device`` (the current
    CUDA device when None; with no GPU it raises).

    Each covered lattice point is evaluated once; per column only the
    bilinear blend and the analytic top octave run.  The corner gather by
    cell index equals the JAX ``repeat`` + ``dynamic_slice`` expansion.
    """
    device = default_device(device, "heightmap_grid")
    ny, nx = shape
    gx0 = (origin_x >> 3) << 3
    gy0 = (origin_y >> 3) << 3
    nlx = nx // _G + 2
    nly = ny // _G + 2
    ar = lambda n: torch.arange(n, dtype=torch.int32, device=device)
    lx = (gx0 + ar(nlx + 1) * _G)[None, :].expand(nly + 1, nlx + 1)
    ly = (gy0 + ar(nly + 1) * _G)[:, None].expand(nly + 1, nlx + 1)
    r, e = dequant_lattice(*lattice_fields_q(lx, ly, seed))

    gx = origin_x + ar(nx)[None, :].expand(ny, nx)
    gy = origin_y + ar(ny)[:, None].expand(ny, nx)
    cx = ((gx >> 3) - (gx0 >> 3)).long()
    cy = ((gy >> 3) - (gy0 >> 3)).long()
    tx = (gx & 7).to(torch.float32) * (1.0 / _G)
    ty = (gy & 7).to(torch.float32) * (1.0 / _G)

    def bil(v):
        v00, v10 = v[cy, cx], v[cy, cx + 1]
        v01, v11 = v[cy + 1, cx], v[cy + 1, cx + 1]
        top = v00 + tx * (v10 - v00)
        bot = v01 + tx * (v11 - v01)
        return top + ty * (bot - top)

    fx = fdiv(gx.to(torch.float32), WORLDGEN_SCALE)
    fy = fdiv(gy.to(torch.float32), WORLDGEN_SCALE)
    return height_from_lattice(bil(r), bil(e), fx, fy, seed)
