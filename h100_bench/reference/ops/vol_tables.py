"""[Frozen copy of ``raytrace_tpu_torch/ops/vol_tables.py`` for the benchmark's reference:
its plain PyTorch code only, without the kernel wrappers.]

Occupancy tables of the volume_fast march: the brick pyramid.

Port of ``raytrace_tpu/ops/trace_vol_pallas.py:86-246``: ``_pack_bits32``,
``_pack_pyramid``, ``_brick_major``, ``_detail_rows``, ``build_vol_tables``,
``update_vol_tables`` and ``_occupancy_world_bounds``.  ``build_vol_tables``
and ``update_vol_tables`` run kernel O1 (``csrc/vol_tables.cu``) on a CUDA
volume, in place into given buffers (``out=``), and their plain versions
(``build_vol_tables_plain``, ``update_vol_tables_plain``, plain PyTorch as
the JAX versions are plain XLA) on a CPU volume.  Solidity is minefield
step == 0.

Keys and shapes are the JAX package's:
  ``any8``/``all8`` (8, 128) int32: bit ``b & 31`` of word ``b >> 5`` is the
      any/all-solid flag of 8^3 brick ``b = ((tz>>3)*32 + (ty>>3))*32 + (tx>>3)``;
  ``any_hi`` (2, 128) int32: row 0 the 4096 16-level any bits, row 1 the 512
      32-level bits (lanes 0-15) and the 64 64-level bits (lanes 64-65);
  ``detail`` (32768, 16) int32: per brick, bit ``v & 31`` of word ``v >> 5``
      is voxel ``v = (lz<<6)|(ly<<3)|lx``;
  ``any8b``/``all8b`` (32, 32, 32) bool, indexed (bz, by, bx).
"""

from __future__ import annotations

import torch

from ..constants import ROOT_BLOCK_SIZE, SLICE_SIZE
from ..world.chunk import _pool2
from .volume import STEP_SHIFT

_N = ROOT_BLOCK_SIZE
_HALF = _N // 2
NB = _N // 8  # bricks per side
NUM_BRICKS = NB ** 3
DETAIL_WORDS = 512 // 32
TABLE_KEYS = ("any8", "all8", "any_hi", "detail", "any8b", "all8b")
# Each table's dtype and shape.


def pack_bits32(bits_flat: torch.Tensor) -> torch.Tensor:
    """Flat bool (32*k,) -> int32 (k,), bit i in word i >> 5."""
    b = bits_flat.reshape(-1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=b.device)
    w = (b << shifts).sum(dim=1)
    # uint32 -> int32 with wrap-around (the high bit becomes the sign).
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def _any(x: torch.Tensor, dims) -> torch.Tensor:
    for d in sorted(dims, reverse=True):
        x = x.any(dim=d)
    return x


def _all(x: torch.Tensor, dims) -> torch.Tensor:
    for d in sorted(dims, reverse=True):
        x = x.all(dim=d)
    return x


def pack_pyramid(any8b: torch.Tensor, all8b: torch.Tensor):
    """(32, 32, 32) brick any/all bools -> packed any8, all8, any_hi."""
    t_any8 = pack_bits32(any8b.reshape(-1)).reshape(8, 128)
    t_all8 = pack_bits32(all8b.reshape(-1)).reshape(8, 128)
    any16 = _pool2(any8b)
    any32 = _pool2(any16)
    any64 = _pool2(any32)
    hi = torch.zeros((2, 128), dtype=torch.int32, device=any8b.device)
    hi[0] = pack_bits32(any16.reshape(-1))
    hi[1, :16] = pack_bits32(any32.reshape(-1))
    hi[1, 64:66] = pack_bits32(any64.reshape(-1))
    return t_any8, t_all8, hi


def brick_major(x3: torch.Tensor) -> torch.Tensor:
    """(Z, Y, X), dims multiples of 8 -> (bricks, 512) rows ordered
    (bz, by, bx), voxel ``(lz<<6)|(ly<<3)|lx`` within a row."""
    z, y, x = x3.shape
    return (x3.reshape(z // 8, 8, y // 8, 8, x // 8, 8)
            .permute(0, 2, 4, 1, 3, 5).reshape(-1, 512))


def detail_rows(solid3: torch.Tensor) -> torch.Tensor:
    """Per-brick voxel-solidity rows, 16 int32 words per brick."""
    return pack_bits32(brick_major(solid3).reshape(-1)).reshape(-1, DETAIL_WORDS)


def _solid(words: torch.Tensor) -> torch.Tensor:
    return (words >> STEP_SHIFT) == 0


def build_vol_tables_plain(fused_flat: torch.Tensor) -> dict:
    """O1's plain version of a full build."""
    solid = _solid(fused_flat.reshape(_N, _N, _N))
    bricks = solid.reshape(NB, 8, NB, 8, NB, 8)
    any8b = _any(bricks, (1, 3, 5))
    all8b = _all(bricks, (1, 3, 5))
    t_any8, t_all8, hi = pack_pyramid(any8b, all8b)
    return {"any8": t_any8, "all8": t_all8, "any_hi": hi,
            "detail": detail_rows(solid), "any8b": any8b, "all8b": all8b}


def occupancy_world_bounds(any8b: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
    """World bounds of all occupied bricks: (6,) int32
    ``[xmin, xmax, ymin, ymax, zmin, zmax]``, min inclusive, max exclusive,
    inside the window ``[lr - 128, lr + 128)``; ``lr`` is a (3,) integer
    tensor.

    Texel slot ``bt`` starts at world ``lr - 128 + ((8*bt - lr) mod 256)``;
    when ``lr`` is not brick-aligned the slot straddling the wrap gives both
    of its world pieces.  An empty volume gives an inverted box (min > max),
    which the march reads as "every ray is sky".
    """
    occ = [_any(any8b, (0, 1)), _any(any8b, (0, 2)), _any(any8b, (1, 2))]  # x y z
    lr = lr.to(torch.int32)
    starts = torch.arange(NB, dtype=torch.int32, device=any8b.device) * 8
    big = 1 << 30
    out = []
    for axis in range(3):
        lo_w = lr[axis] - _HALF
        w0 = torch.remainder(starts - lr[axis], _N) + lo_w
        end = torch.minimum(w0 + 8, lo_w + _N)
        rem = w0 + 8 - (lo_w + _N)
        ob = occ[axis]
        mn = torch.where(ob, w0, big).min()
        mx = torch.where(ob, end, -big).max()
        wrapped = ob & (rem > 0)
        mn = torch.where(wrapped.any(), torch.minimum(mn, lo_w), mn)
        mx = torch.maximum(mx, torch.where(wrapped, lo_w + rem, -big).max())
        out += [mn, mx]
    return torch.stack(out).to(torch.int32)
