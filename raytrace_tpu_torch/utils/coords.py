"""Host-side 3D coordinate and block-copy helpers.

A copy of ``raytrace_tpu/utils/coords.py``, whose package imports JAX.

The reference implements a family of clipped 3D copy/fill routines as scalar
loops (reference: src/util.rs:381-663, `copy_3d`/`copy_3d_auto_clip`/
`copy_3d_bounded_auto_clip`/`fill_slice_3d_auto_clip`).  Here they are numpy
slice assignments: the "loop" is a single strided memcpy, which is what the
single host core of a TPU VM needs.  Data-plane copies that feed the device
volume use these only on the disk-cache path; the generate-on-device path
never touches them.

Array convention everywhere in this framework: C-order ``(Z, Y, X)`` with X
minor, which is byte-identical to the reference's ``x + y*S + z*S*S`` linear
layout (reference: src/util.rs:232-247).
"""

from __future__ import annotations

import numpy as np

Coord3 = tuple[int, int, int]


def to_linear_3d(coord: Coord3, stride: int) -> int:
    """x + y*stride + z*stride^2 (reference: src/util.rs:236-239)."""
    x, y, z = coord
    return x + y * stride + z * stride * stride


def from_linear_3d(index: int, stride: int) -> Coord3:
    """Inverse of :func:`to_linear_3d` (reference: src/util.rs:241-247)."""
    return (index % stride, index // stride % stride, index // (stride * stride))


def _clip_ranges(
    size: Coord3, src_start: Coord3, src_shape: Coord3, dst_start: Coord3, dst_shape: Coord3
):
    """Compute the overlapping copy extents after clipping to both arrays.

    Matches the semantics of reference src/util.rs:440-512 (auto-clip both
    negative offsets and overruns on every axis).
    """
    out = []
    for axis in range(3):
        n = size[axis]
        s0, d0 = src_start[axis], dst_start[axis]
        # Clip the start of the range.
        lo = max(0, -s0, -d0)
        # Clip the end of the range.
        hi = min(n, src_shape[axis] - s0, dst_shape[axis] - d0)
        if hi <= lo:
            return None
        out.append((s0 + lo, d0 + lo, hi - lo))
    return out


def copy_3d_clipped(
    src: np.ndarray,
    dst: np.ndarray,
    size: Coord3,
    src_start: Coord3 = (0, 0, 0),
    dst_start: Coord3 = (0, 0, 0),
) -> None:
    """Copy a clipped 3D block between (Z, Y, X) arrays, in place.

    ``size``/``src_start``/``dst_start`` are given in (x, y, z) order to match
    the reference call sites (reference: src/util.rs:513-604
    `copy_3d_bounded_auto_clip`); they are applied to the trailing-first axes
    of the numpy arrays.
    """
    src_shape = (src.shape[2], src.shape[1], src.shape[0])
    dst_shape = (dst.shape[2], dst.shape[1], dst.shape[0])
    ranges = _clip_ranges(size, src_start, src_shape, dst_start, dst_shape)
    if ranges is None:
        return
    (sx, dx, nx), (sy, dy, ny), (sz, dz, nz) = ranges
    dst[dz : dz + nz, dy : dy + ny, dx : dx + nx] = src[
        sz : sz + nz, sy : sy + ny, sx : sx + nx
    ]


def fill_3d_clipped(
    dst: np.ndarray,
    value,
    size: Coord3,
    dst_start: Coord3 = (0, 0, 0),
) -> None:
    """Fill a clipped 3D block of a (Z, Y, X) array with a constant.

    Equivalent of reference src/util.rs:605-663 `fill_slice_3d[_auto_clip]`.
    """
    dst_shape = (dst.shape[2], dst.shape[1], dst.shape[0])
    ranges = _clip_ranges(size, (0, 0, 0), size, dst_start, dst_shape)
    if ranges is None:
        return
    (_, dx, nx), (_, dy, ny), (_, dz, nz) = ranges
    dst[dz : dz + nz, dy : dy + ny, dx : dx + nx] = value
