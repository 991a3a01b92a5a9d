"""[Frozen copy of ``raytrace_tpu_torch/ops/hf_tables.py`` for the benchmark's reference:
its plain PyTorch code only, without the kernel wrappers.]

Region tables of the heightfield marches: column-height pyramid and
lattice-corner words, and what a march reads from them.

Port of ``raytrace_tpu/ops/trace_pallas.py:60-133`` (``build_hf_tables``)
and ``:172-200`` (``_height_from_corners``).  ``build_hf_tables`` builds a
region's tables with kernel T1 (``csrc/hf_tables.cu``) on the card, from
an ``lr`` that lies in device memory (the packed frame uniforms inside the
fused frame program's CUDA graph, as JAX's ``_rffp_impl`` rebuilds them
inside its one dispatch), and with its plain version
(``build_hf_tables_plain``, then ``column_heights``) on the CPU.  With a
``key`` saying what its buffers hold, a build of the region they already
hold does nothing (T1 returns at entry), so the fused program's T1 works
only when ``lr`` moves.  Tables
are flat (1024,) int32 tensors, one word per 8x8-column block at ``by * 32
+ bx``; the JAX package holds the same words as (8, 128).  ``classify``,
``bdist`` and ``step_reciprocal`` are the steps both heightfield marches
(K1 in ``ops/lighting.py``, K4 in ``ops/trace_hf.py``) share, as their
kernels share ``csrc/heightfield.cuh``.  ``column_heights`` tabulates every
column's exact height for K1, which reads it instead of evaluating
``height_from_corners`` at each fine step.
"""

from __future__ import annotations

import torch

from ..constants import ROOT_BLOCK_SIZE, WORLDGEN_SCALE
from .._device import default_device
from .._f32 import fdiv
from ..world.heightmap import (
    LATTICE_SPACING,
    dequant_lattice,
    height_from_lattice,
    heightmap_grid,
    lattice_fields_q,
)

_HALF = ROOT_BLOCK_SIZE // 2
_EPS = 1e-4
TABLE_KEYS = ("hsub", "h3", "cA", "cB", "cC", "cD")


# The launch of T1 (csrc/hf_tables.cu): blocks (x, y) of STRIP_THREADS
# threads, one a strip of 32 x 8 columns, in clusters of four (a 32 x 32
# tile); G1's blocks are the same strips.  For the launch floor.
T1_BLOCKS, STRIP_THREADS = (256, 1), 256

# Each table's dtype and shape; "hcol" only where the column table is asked for.


def build_hf_tables_plain(lr, seed: int = 0, device=None) -> dict:
    """T1's plain version: the tables for the region centred at integer
    ``lr`` (x, y, z), a host sequence, on ``device`` (the CPU when None).

    Returns ``h3`` (8/16/32-block maxima, +1 margin, packed 9 bits each),
    ``hsub`` (four 4-block deltas, one byte each), ``cA``..``cD`` (the
    block's lattice-corner words ``r16 | e16 << 16``) and ``r0`` (2,) int32,
    the region origin ``lr[:2] - 128``.
    """
    device = torch.device("cpu" if device is None else device)
    r0x, r0y = int(lr[0]) - _HALF, int(lr[1]) - _HALF
    n = ROOT_BLOCK_SIZE
    h = heightmap_grid(r0x, r0y, (n, n), seed=seed, device=device)
    hs = torch.clamp(h, min=0) + 1

    def pool(x, k):
        m = n >> k
        return x.reshape(m, 1 << k, m, 1 << k).amax(dim=(1, 3))

    h2, h3v, h4v, h5v = pool(hs, 2), pool(hs, 3), pool(hs, 4), pool(hs, 5)
    up = lambda x, r: x.repeat_interleave(r, 0).repeat_interleave(r, 1)
    h3 = h3v | (up(h4v, 2) << 9) | (up(h5v, 4) << 18)

    sub = h2.reshape(32, 2, 32, 2).permute(0, 2, 1, 3)
    delta = torch.clamp(h3v[:, :, None, None] - sub, 0, 255)
    hsub = (delta[..., 0, 0] | (delta[..., 0, 1] << 8)
            | (delta[..., 1, 0] << 16) | (delta[..., 1, 1] << 24))

    nl = n // LATTICE_SPACING
    k = torch.arange(nl + 1, dtype=torch.int32, device=device) * LATTICE_SPACING
    lx = (r0x + k)[None, :].expand(nl + 1, nl + 1)
    ly = (r0y + k)[:, None].expand(nl + 1, nl + 1)
    r16, e16 = lattice_fields_q(lx, ly, seed)
    w = r16 | (e16 << 16)
    tables = {
        "cA": w[:nl, :nl], "cB": w[:nl, 1:], "cC": w[1:, :nl], "cD": w[1:, 1:],
        "hsub": hsub, "h3": h3,
    }
    tables = {k: v.to(torch.int32).contiguous().reshape(-1) for k, v in tables.items()}
    tables["r0"] = torch.tensor([r0x, r0y], dtype=torch.int32, device=device)
    return tables


def column_heights(tables: dict, seed: int = 0) -> torch.Tensor:
    """The region's column table: ``max(height_from_corners, 0)`` of each of
    its 256 x 256 columns, (65536,) int16 at ``ry * 256 + rx``.

    K1 reads a fine step's column height from it instead of evaluating the
    lattice words.  It is ``height_from_corners`` over the tables' own
    corner words, not ``heightmap_grid``, whose last ulp may differ.
    """
    n = ROOT_BLOCK_SIZE
    r0 = tables["r0"]  # on the device: no wait for it
    rx = torch.arange(n, dtype=torch.int32, device=r0.device)[None, :].expand(n, n)
    ry = torch.arange(n, dtype=torch.int32, device=r0.device)[:, None].expand(n, n)
    i3 = ((ry >> 3) * 32 + (rx >> 3)).long()
    h = height_from_corners(tables["cA"][i3], tables["cB"][i3], tables["cC"][i3],
                            tables["cD"][i3], rx + r0[0], ry + r0[1], seed)
    return torch.clamp(h, min=0).to(torch.int16).reshape(-1)


def with_column_heights(tables: dict, seed: int = 0) -> dict:
    """``tables`` with the column table beside them, under ``hcol``: the
    region's tables as the fused march (K1) reads them."""
    return dict(tables, hcol=column_heights(tables, seed))


def height_from_corners(ca, cb, cc, cd, xi, yi, seed: int):
    """Exact column height from the block's four lattice-corner words."""
    tx = (xi & 7).to(torch.float32) * (1.0 / LATTICE_SPACING)
    ty = (yi & 7).to(torch.float32) * (1.0 / LATTICE_SPACING)

    def dq(word):
        return dequant_lattice(word & 0xFFFF, (word >> 16) & 0xFFFF)

    (r00, e00), (r10, e10), (r01, e01), (r11, e11) = dq(ca), dq(cb), dq(cc), dq(cd)

    def bil(v00, v10, v01, v11):
        top = v00 + tx * (v10 - v00)
        bot = v01 + tx * (v11 - v01)
        return top + ty * (bot - top)

    fx = fdiv(xi.to(torch.float32), WORLDGEN_SCALE)
    fy = fdiv(yi.to(torch.float32), WORLDGEN_SCALE)
    return height_from_lattice(bil(r00, r10, r01, r11), bil(e00, e10, e01, e11),
                               fx, fy, seed)


def classify(tables: dict, px, py, pz, rising, r0x: int, r0y: int, seed: int) -> dict:
    """The tables' verdict at each position (``trace_pallas.py:365-410``).

    Returns the voxel ``xi``, ``yi``, ``zi`` (int32), the safe ``step``
    (32, 16 or 8 from the packed pyramid word, else 4 from the 4-block
    refinement, else 0: march the column), ``fine`` (step 0) and the
    column height ``hcol`` (clamped at 0).  ``rising`` rays (dz >= 0)
    compare the voxel itself with the block maxima, not the aligned slab
    floor.
    """
    xi = torch.floor(px).to(torch.int32)
    yi = torch.floor(py).to(torch.int32)
    zi = torch.floor(pz).to(torch.int32)
    rx = torch.clamp(xi - r0x, 0, ROOT_BLOCK_SIZE - 1)
    ry = torch.clamp(yi - r0y, 0, ROOT_BLOCK_SIZE - 1)
    i3 = ((ry >> 3) * 32 + (rx >> 3)).long()
    w = tables["h3"][i3]
    h8 = w & 511
    z32 = torch.where(rising, zi, zi & ~31)
    z16 = torch.where(rising, zi, zi & ~15)
    z8 = torch.where(rising, zi, zi & ~7)
    z4 = torch.where(rising, zi, zi & ~3)
    zero = torch.zeros_like(zi)
    step = torch.where(
        z32 >= ((w >> 18) & 511), 32,
        torch.where(z16 >= ((w >> 9) & 511), 16, torch.where(z8 >= h8, 8, zero)),
    )
    quad = (((ry >> 2) & 1) << 1) | ((rx >> 2) & 1)
    delta = (tables["hsub"][i3] >> (quad << 3)) & 255
    step = torch.where((step == 0) & (z4 >= h8 - delta), 4, step)
    hcol = torch.clamp(
        height_from_corners(tables["cA"][i3], tables["cB"][i3], tables["cC"][i3],
                            tables["cD"][i3], xi, yi, seed),
        min=0,
    )
    return dict(xi=xi, yi=yi, zi=zi, step=step, fine=step == 0, hcol=hcol)


def step_reciprocal(step: torch.Tensor) -> torch.Tensor:
    """The exact float32 reciprocal of a pyramid step (1 for the fine step 0)."""
    return torch.where(
        step == 32, 1 / 32,
        torch.where(step == 16, 1 / 16,
                    torch.where(step == 8, 1 / 8,
                                torch.where(step == 4, 1 / 4, 1.0)))).to(torch.float32)


def bdist(p, mul, lp, step_f, inv_step):
    """Distance along the ray to the next boundary of the ``step_f`` grid,
    ``(eps + mod((p + 128) * mul, step_f)) * lp`` (``trace_pallas.py:251-254``).
    The floor modulo is ``shifted - floor(shifted * inv_step) * step_f``: for a
    power-of-two step both products are exact and the difference is rounded
    once from the exact value, as ``jnp.mod``'s is."""
    shifted = (p + float(_HALF)) * mul
    m = shifted - torch.floor(shifted * inv_step) * step_f
    return (_EPS + m) * lp
