"""The lane-use census of the march kernels K3, K3s, K4 and D1.

A warp runs a loop iteration while any of its 32 lanes has work; its lane
use is the share of its lane-iterations that made a move::

    lane_use = moves / (32 * warp_iterations)

``moves`` come from the kernel's plain version, which counts each path's or
ray's moves, or (D1) from the kernel's own census.  ``warp_iterations``
come from the kernel's census counter (each warp adds its loop iterations
once, at exit; a window of whole rays, as K3s walks a batch without a
mask, counts as its longest ray's, and so does D1's warp of 32 rays in
index order) or, for one thread per index with 32 consecutive indices to
a warp, from the moves themselves: such a warp runs as long as its
longest index (``static_warp_iterations``).
"""

from __future__ import annotations

import torch

WARP = 32


def static_warp_iterations(moves: torch.Tensor) -> int:
    """Iterations of the warps of one thread per index, 32 consecutive
    indices to a warp: the sum over warps of the warp's most moves (the
    last warp may hold fewer indices)."""
    m = moves.reshape(-1).to(torch.int64)
    m = torch.cat([m, m.new_zeros(-m.numel() % WARP)])
    return int(m.reshape(-1, WARP).amax(1).sum()) if m.numel() else 0


def lane_use(moves: int, warp_iterations: int) -> float:
    """The share of lane-iterations that made a move (0 when no warp
    iterated)."""
    return moves / (WARP * warp_iterations) if warp_iterations else 0.0
