"""Terrain streaming: which 256-voxel region is resident, and its voxels.

Port of ``raytrace_tpu/render/streaming.py``: ``Position``, ``SliceRequest``
and ``_slab_world_box`` (``:43-76``), the device data plane
``_generate_and_apply`` (``:79-107``), ``_generate_region`` (``:110-134``)
and ``_store_slab`` (``:349-363``), and ``TerrainStreamer``'s
``initialize`` (device source and a supplied volume, ``:155-187``),
``teleport`` (``:189-214``), ``edit_box`` (``:216-231``), the request
methods, ``setup_next_request`` with its slab log (``:234-311``),
``drain_slab_log`` (``:313-320``) and ``get_render_offset``, with both
sources of voxels: ``source="device"`` generates a slab, a teleport's
region or the initial region in place in the resident volume
(``ops/worldgen.generate_into``: kernel G1 on the card, one launch with no
host wait, where JAX runs one jitted program), ``source="cache"`` reads the
chunks of ``storage`` (a ``world.storage.ChunkStorage``, which generates a
missing chunk and stores it), assembles the region (``initialize``,
``:167-187``) or the slab (``_apply_from_cache``, ``:322-343``) on the host
with ``native.copy3d``, and copies it to the device once.  One slice
request per frame moves the region 16 voxels along the axis of largest
camera drift.

The resident volume is a fused (256^3,) int32 tensor in (z, y, x) texel
order; world voxel ``w`` lives at texel ``(w + 128) mod 256``.  It exists
once ``initialize`` has run (the volume tracers); until then the streamer
only tracks positions, which is all the heightfield path reads.  The
streamer owns its volume (``initialize`` copies a supplied one) and
writes every later change into the same storage: slabs, a teleport's
region, an edit and a later ``initialize``, so a consumer that holds the
tensor (the frame program's buffer) sees them without a copy.  The slab
log tells a consumer of derived tables which slabs changed.  As in JAX,
``teleport`` needs the device source (``:200``), and with the heightfield
tracers, which never initialize a volume, no chunk is read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import default_device
from ..constants import (
    CHUNK_SIZE,
    ROOT_BLOCK_SIZE,
    ROOT_CHUNK_SIZE,
    SLICE_SIZE,
    SLICES_PER_ROOT,
)
from .. import native
from ..ops.volume import fuse_volume
from ..ops.worldgen import generate_into

AXIS_X, AXIS_Y, AXIS_Z = 0, 1, 2
_HALF_CHUNKS = ROOT_CHUNK_SIZE // 2
_N = ROOT_BLOCK_SIZE
_SLAB_LOG_MAX = 64  # entries before the log gives up and asks for a rebuild


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


def _slab_world_box(req: SliceRequest):
    """World box (origin xyz, shape xyz) covered by a slice request."""
    w0 = tuple(
        o * CHUNK_SIZE + n * SLICE_SIZE for o, n in zip(req.origin, req.num_slices)
    )
    shape = [ROOT_BLOCK_SIZE] * 3
    shape[req.axis] = SLICE_SIZE
    return w0, tuple(shape)


def _generate_region(volume, origin_chunks, ns, seed: int) -> None:
    """A full 256^3 region at slice-granular world offset ``w0 = origin *
    64 + ns * 16``, generated in place into ``volume``: world voxel ``w``
    lands at texel ``(w + 128) & 255``, where JAX's roll of its 320^3
    enclosure puts it (the origin keeps ``o = -2 (mod 4)`` chunks)."""
    w0 = [o * CHUNK_SIZE + n * SLICE_SIZE for o, n in zip(origin_chunks, ns)]
    generate_into(volume, w0, (_N,) * 3, seed)


def _store_slab(volume, slab, ns, axis: int) -> None:
    """Roll a world-ordered (z, y, x) slab into texel space and store it in
    the flat volume, in place.  The texel offset is ``ns * 16`` on every
    axis; the off-axis extents are the full 256 and wrap toroidally."""
    vol3 = volume.view(_N, _N, _N)
    t = [n * SLICE_SIZE for n in ns]
    shifts, dims = [], []
    for arr_axis, xyz_axis in ((0, 2), (1, 1), (2, 0)):
        if xyz_axis != axis:
            shifts.append(t[xyz_axis])
            dims.append(arr_axis)
    vol3.narrow(2 - axis, t[axis], slab.shape[2 - axis]).copy_(
        torch.roll(slab, shifts, dims))


def _assemble_from_cache(storage, w0, shape_xyz) -> torch.Tensor:
    """The fused (z, y, x) world box at chunk-aligned or slice-aligned
    ``w0`` with extents ``shape_xyz``, assembled on the host from the
    chunks of ``storage`` that overlap it (reference
    terrain_upload.rs:84-204)."""
    zyx = (shape_xyz[2], shape_xyz[1], shape_xyz[0])
    mats = np.zeros(zyx, np.int32)
    mf = np.zeros(zyx, np.uint8)
    c0 = [v // CHUNK_SIZE for v in w0]
    c1 = [-(-(v + s) // CHUNK_SIZE) for v, s in zip(w0, shape_xyz)]
    for cz in range(c0[2], c1[2]):
        for cy in range(c0[1], c1[1]):
            for cx in range(c0[0], c1[0]):
                m, f = storage.borrow_packed_chunk_data((cx, cy, cz))
                dst = (cx * CHUNK_SIZE - w0[0], cy * CHUNK_SIZE - w0[1],
                       cz * CHUNK_SIZE - w0[2])
                native.copy3d(m, mats, (CHUNK_SIZE,) * 3, dst_start=dst)
                native.copy3d(f, mf, (CHUNK_SIZE,) * 3, dst_start=dst)
    return fuse_volume(torch.from_numpy(mats), torch.from_numpy(mf)).reshape(zyx)


class TerrainStreamer:
    """Region position bookkeeping and, once initialized, the resident
    fused volume, streamed one slice per request.  ``device``: where the
    volume lives; "cuda" (the default, as ``Pipeline``'s) raises when no GPU
    is present, "cpu" keeps it on the host.  ``source``: "device" generates
    the voxels on ``device``; "cache" reads them from ``storage``, a
    ``ChunkStorage``."""

    def __init__(self, seed: int = 0, source: str = "device", storage=None, *,
                 device="cuda"):
        if source not in ("device", "cache"):
            raise ValueError(f"unknown terrain source {source!r}")
        if source == "cache" and storage is None:
            raise ValueError("source='cache' needs a ChunkStorage (storage=...)")
        self.seed = seed
        self.source = source
        self.storage = storage
        self.device = default_device(device, "TerrainStreamer")
        self.cpu_position = Position()
        self.gpu_position = Position()
        self.request_queue: list[SliceRequest] = []
        self.volume = None  # fused (256^3,) int32 once initialized
        # Slab writes since the last drain ((arr_axis, texel_start) each),
        # or None when the whole volume changed and derived tables must be
        # rebuilt.
        self._slab_log: list[tuple[int, int]] | None = None

    def initialize(self, volume=None) -> torch.Tensor:
        """Generate (or, from the cache, load) the initial 4^3-chunk region,
        or take a private copy of a supplied fused volume (256^3 words in
        any integer dtype holding the uint32 bits), into the streamer's
        volume: new storage the first time, the same storage after."""
        origin = tuple(c * CHUNK_SIZE for c in self.cpu_position.origin)
        if self.volume is None:
            self.volume = torch.empty(_N ** 3, dtype=torch.int32, device=self.device)
        if isinstance(volume, torch.Tensor):
            self.volume.copy_(volume.reshape(-1).to(self.device, torch.int32))
        elif volume is not None:
            words = np.asarray(volume).astype(np.uint32).reshape(-1).view(np.int32)
            self.volume.copy_(torch.from_numpy(words))
        elif self.source == "cache":
            region = _assemble_from_cache(self.storage, origin, (ROOT_BLOCK_SIZE,) * 3)
            self.volume.copy_(region.reshape(-1))
        else:
            generate_into(self.volume, origin, (ROOT_BLOCK_SIZE,) * 3, self.seed)
        self._slab_log = None
        return self.volume

    def teleport(self, center) -> None:
        """Recenter the region on a world position, quantized to the slice
        grid, keeping the o = -2 (mod 4) chunk invariant of the origin, and
        regenerate the resident volume there, in place, if there is one.
        Needs the device source, as in JAX."""
        if self.source != "device":
            raise ValueError("teleport needs the device source (source='device')")
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
        if self.volume is not None:
            _generate_region(self.volume, pos.origin, ns, self.seed)
            self._slab_log = None

    def edit_box(self, world_min, shape, material_id=None) -> None:
        """Write an axis-aligned world box into the resident volume: solid
        ``material_id``, or carved air when None (``world/edit.py``), in
        place.  Derived tables must then be rebuilt."""
        from ..world.edit import edit_fused_volume

        if self.volume is None:
            raise RuntimeError("edit_box needs a resident volume (initialize first)")
        self.volume.copy_(edit_fused_volume(
            self.volume, self.gpu_position.render_offset(), world_min, shape,
            material_id,
        ))
        self._slab_log = None

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
        """Apply one queued slice move; True if one ran.  With a resident
        volume, the slab is generated in place (or assembled from the
        cache and written), and logged."""
        if not self.request_queue:
            return False
        req = self.request_queue.pop(0)
        if self.volume is not None:
            w0, shape = _slab_world_box(req)
            if self.source == "cache":
                self._apply_from_cache(req, w0, shape)
            else:
                # At texel (w + 128) & 255: ns * 16 on each axis, where the
                # region origin's o = -2 (mod 4) chunks put texel 0.
                generate_into(self.volume, w0, shape, self.seed)
            if self._slab_log is not None:
                # The volume is (z, y, x): array axis 2 - axis.
                self._slab_log.append(
                    (2 - req.axis, req.num_slices[req.axis] * SLICE_SIZE))
                if len(self._slab_log) > _SLAB_LOG_MAX:
                    self._slab_log = None
        self.gpu_position = req.new_position
        return True

    def drain_slab_log(self):
        """The slab writes since the last drain, as (arr_axis, texel_start)
        pairs, or None when the whole volume was replaced (consumers must
        rebuild derived tables).  Draining arms the log either way."""
        log = self._slab_log
        self._slab_log = []
        return log

    def _apply_from_cache(self, req: SliceRequest, w0, shape) -> None:
        """Assemble the slab from cached chunks on the host, copy it to the
        device once and store it at its toroidal offset."""
        slab = _assemble_from_cache(self.storage, w0, shape)
        _store_slab(self.volume, slab.to(self.device), req.num_slices, req.axis)

    def get_render_offset(self) -> tuple[int, int, int]:
        return self.gpu_position.render_offset()
