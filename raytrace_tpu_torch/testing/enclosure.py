"""The streaming data plane in the JAX package's formulation, which the
port ran until kernel G1: each box generated over its 64-aligned enclosure
with ``world.generate.generate_box``, sliced out, and rolled into texel
space (``raytrace_tpu/render/streaming.py:79-134``, ``_generate_and_apply``
and ``_generate_region``).  ``tests/test_torch_worldgen.py`` and
``chip_smoke.py`` hold ``ops/worldgen.generate_into`` against it word for
word."""

from __future__ import annotations

import torch

from ..constants import CHUNK_SIZE, ROOT_BLOCK_SIZE, SLICE_SIZE
from ..ops.volume import fuse_volume
from ..render.streaming import _store_slab
from ..world.generate import generate_box

_N = ROOT_BLOCK_SIZE


def fused_box(origin, shape, seed: int, device) -> torch.Tensor:
    """The fused (Z, Y, X) words of a 64-aligned box with 64-multiple
    extents."""
    box = generate_box(origin, shape, seed=seed, device=device)
    return fuse_volume(box["materials"], box["minefield"]).reshape(
        shape[2], shape[1], shape[0])


def generate_and_apply(volume, w0, ns, axis: int, shape_xyz, seed: int) -> None:
    """Generate a world slab and write it at its toroidal offset, in place.

    The slab's world box is not 64-aligned and the minefield's LOD blocks
    are globally 64-aligned, so terrain is generated for the 64-aligned
    enclosure (slab origins are 16-aligned: at most 48 voxels of lead) and
    the slab is sliced out of it.
    """
    aligned0 = [v - v % CHUNK_SIZE for v in w0]
    enclosure = tuple(
        -(-(s + CHUNK_SIZE - SLICE_SIZE) // CHUNK_SIZE) * CHUNK_SIZE for s in shape_xyz)
    fused = fused_box(aligned0, enclosure, seed, volume.device)
    start = [w0[2] - aligned0[2], w0[1] - aligned0[1], w0[0] - aligned0[0]]
    slab = fused[start[0]:start[0] + shape_xyz[2], start[1]:start[1] + shape_xyz[1],
                 start[2]:start[2] + shape_xyz[0]]
    _store_slab(volume, slab, ns, axis)


def generate_region(origin_chunks, ns, seed: int, device) -> torch.Tensor:
    """A full 256^3 region at slice-granular world offset, in texel order.

    ``w0 = origin * 64 + ns * 16`` is not chunk-aligned when ``ns != 0``, so
    terrain comes from the 64-aligned 320^3 enclosure, is sliced, then
    rolled into texel space.
    """
    w0 = [o * CHUNK_SIZE + n * SLICE_SIZE for o, n in zip(origin_chunks, ns)]
    aligned0 = [v - v % CHUNK_SIZE for v in w0]
    enc = _N + CHUNK_SIZE
    fused = fused_box(aligned0, (enc,) * 3, seed, device)
    s = [w - a for w, a in zip(w0, aligned0)]
    region = fused[s[2]:s[2] + _N, s[1]:s[1] + _N, s[0]:s[0] + _N]
    t = [n * SLICE_SIZE for n in ns]
    return torch.roll(region, (t[2], t[1], t[0]), (0, 1, 2)).reshape(-1)


# Streamed boxes of a resident volume, (label, region origin in chunks
# (o = -2 mod 4 on each axis, as the streamer keeps it), ns, axis, seed):
# a slab (axis 0-2) in each direction of each axis, off-axis slice counts
# whose texel ranges wrap (ns 15 among them), world offsets near +-2^20,
# then a teleport's region (axis None) and the initial region.
STREAM_CASES = [
    ("x_up", (2, -2, -2), (0, 0, 0), 0, 0),
    ("x_down", (-6, -2, -2), (15, 3, 0), 0, 7),
    ("y_up", (-2, 2, -2), (3, 0, 5), 1, 0),
    ("y_down", (-2, -6, -2), (0, 15, 9), 1, 7),
    ("z_up", (-2, -2, 2), (7, 9, 0), 2, 0),
    ("z_down", (-2, -2, -6), (1, 0, 15), 2, 7),
    ("wrap_ns15", (-2, 2, -2), (15, 0, 15), 1, 0),
    ("x_up_2e20", (16382, -2, -2), (2, 0, 0), 0, 7),
    ("y_down_minus_2e20", (-16386, -6, -2), (0, 4, 3), 1, 0),
    ("region_teleport", (6, -2, -10), (3, 0, 11), None, 0),
    ("region_initialize", (-2, -2, -2), (0, 0, 0), None, 7),
]


def stream_box(origin_chunks, ns, axis):
    """The world box (w0, shape, both x, y, z) of a STREAM_CASES entry."""
    w0 = tuple(o * CHUNK_SIZE + n * SLICE_SIZE for o, n in zip(origin_chunks, ns))
    shape = [_N] * 3
    if axis is not None:
        shape[axis] = SLICE_SIZE
    return w0, tuple(shape)


def stream_old(volume, origin_chunks, ns, axis, seed: int) -> torch.Tensor:
    """A STREAM_CASES entry through the old path: the slab written into
    ``volume`` in place, or the region (a new tensor) -> the volume."""
    if axis is None:
        return generate_region(origin_chunks, ns, seed, volume.device)
    w0, shape = stream_box(origin_chunks, ns, axis)
    generate_and_apply(volume, w0, ns, axis, shape, seed)
    return volume
