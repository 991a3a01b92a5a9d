"""Streaming control: which 256-column region the frame renders.

Port of the control logic of ``raytrace_tpu/render/streaming.py``
(``Position``, ``SliceRequest``: ``:43-76``; the request methods,
``setup_next_request`` and ``get_render_offset``: ``:234-346``; ``teleport``'s
position arithmetic: ``:189-210``).  One slice request per frame moves the
region 16 voxels along the axis of largest camera drift; the render offset
``lr`` is all the heightfield path reads.

The JAX streamer also keeps a 256^3 voxel volume, generated at
``initialize`` and patched with a 16-voxel slab on every move.  Nothing on
the heightfield path reads it, so the port has no data plane yet (it comes
with the volume tracers): ``setup_next_request`` only advances
``gpu_position``.
"""

from __future__ import annotations

import dataclasses

from raytrace_tpu.constants import (
    CHUNK_SIZE,
    ROOT_BLOCK_SIZE,
    ROOT_CHUNK_SIZE,
    SLICE_SIZE,
    SLICES_PER_ROOT,
)

AXIS_X, AXIS_Y, AXIS_Z = 0, 1, 2
_HALF_CHUNKS = ROOT_CHUNK_SIZE // 2


@dataclasses.dataclass
class Position:
    """Region origin (chunks) + loaded-slice counts (terrain_upload.rs:22-47)."""

    origin: tuple[int, int, int] = (-_HALF_CHUNKS, -_HALF_CHUNKS, -_HALF_CHUNKS)
    num_loaded_slices: tuple[int, int, int] = (0, 0, 0)

    def render_offset(self) -> tuple[int, int, int]:
        return tuple(
            (o + _HALF_CHUNKS) * CHUNK_SIZE + n * SLICE_SIZE
            for o, n in zip(self.origin, self.num_loaded_slices)
        )


@dataclasses.dataclass
class SliceRequest:
    origin: tuple[int, int, int]  # region origin in chunks to load from
    num_slices: tuple[int, int, int]
    axis: int
    new_position: Position


class TerrainStreamer:
    """Region position bookkeeping, one slice move per request."""

    def __init__(self):
        self.cpu_position = Position()
        self.gpu_position = Position()
        self.request_queue: list[SliceRequest] = []

    def teleport(self, center) -> None:
        """Recenter the region on a world position, quantized to the slice
        grid, keeping the o = -2 (mod 4) chunk invariant of the origin."""
        origin, ns = [], []
        for c in center:
            total16 = int(round(float(c) / SLICE_SIZE))
            k, n = divmod(total16, SLICES_PER_ROOT)
            origin.append(-_HALF_CHUNKS + (ROOT_BLOCK_SIZE // CHUNK_SIZE) * k)
            ns.append(n)
        pos = Position(tuple(origin), tuple(ns))
        self.cpu_position = pos
        self.gpu_position = pos
        self.request_queue.clear()

    def request_increase(self, axis: int) -> None:
        old = Position(self.cpu_position.origin, self.cpu_position.num_loaded_slices)
        ns = list(self.cpu_position.num_loaded_slices)
        org = list(self.cpu_position.origin)
        ns[axis] += 1
        if ns[axis] == SLICES_PER_ROOT:
            ns[axis] = 0
            org[axis] += ROOT_BLOCK_SIZE // CHUNK_SIZE
        self.cpu_position = Position(tuple(org), tuple(ns))
        load_origin = list(old.origin)
        load_origin[axis] += ROOT_CHUNK_SIZE
        self.request_queue.append(
            SliceRequest(
                tuple(load_origin), old.num_loaded_slices, axis, self.cpu_position
            )
        )

    def request_decrease(self, axis: int) -> None:
        ns = list(self.cpu_position.num_loaded_slices)
        org = list(self.cpu_position.origin)
        if ns[axis] == 0:
            ns[axis] = SLICES_PER_ROOT
            org[axis] -= ROOT_BLOCK_SIZE // CHUNK_SIZE
        ns[axis] -= 1
        self.cpu_position = Position(tuple(org), tuple(ns))
        self.request_queue.append(
            SliceRequest(
                self.cpu_position.origin,
                self.cpu_position.num_loaded_slices,
                axis,
                self.cpu_position,
            )
        )

    def request_move_towards(self, desired_center) -> None:
        """Queue at most one slice move toward the target (x, then y, then
        z priority, terrain_upload.rs:351-367)."""
        current = self.cpu_position.render_offset()
        delta = [int(d) - c for d, c in zip(desired_center, current)]
        for axis in (AXIS_X, AXIS_Y, AXIS_Z):
            if delta[axis] > SLICE_SIZE:
                self.request_increase(axis)
                return
            if -delta[axis] > SLICE_SIZE:
                self.request_decrease(axis)
                return

    def setup_next_request(self) -> bool:
        """Apply one queued slice move; True if one ran.  Only the position
        advances: the voxel data plane waits for the volume tracers."""
        if not self.request_queue:
            return False
        self.gpu_position = self.request_queue.pop(0).new_position
        return True

    def get_render_offset(self) -> tuple[int, int, int]:
        return self.gpu_position.render_offset()
