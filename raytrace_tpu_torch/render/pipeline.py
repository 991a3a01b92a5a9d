"""Frame pipeline: streaming, uniforms, and the frame program.

Port of ``raytrace_tpu/render/pipeline.py``: ``FrameUniforms`` (``:37-60``),
the frame program (``_render_frame_impl``, ``:92-149``, packed as
``_rffp_impl``, ``:198-238``) and ``Pipeline`` (``:252-487``, with the
debug-only ``_validate_frame`` and the terrain ``source``/``storage`` of
``:261-262, 300``) for every tracer of the JAX package:

- ``fused``: the region's heightfield tables (rebuilt inside the frame
  program from each frame's ``lr``, by kernel T1 on the card), the path
  march K1 and its shade.
- ``hf``: the same tables (rebuilt by T1 between frames whenever the
  region offset ``lr`` changes), traced leg by leg through the staged tracer K4
  (``ops/trace_hf.py``) and the staged lighting pass (``ops/integrate.py``).
- ``volume_fast``: the streamed resident volume (slabs and teleports
  generated in place by kernel G1) and its occupancy tables (updated in
  place per streamed slab, rebuilt in place after initialize, teleport or
  an edit, by kernel O1), the path march K3 and its shade.
- ``volume``: the streamed resident volume itself, traced leg by leg by the
  exact DDA (``ops/trace_dda.py``, kernel D1: the reference).

Then the denoise chain K2 with finalize fused into its last pass.
``render_frame`` takes JAX's arguments (a uniforms dict, ``with_gbuffers``)
and returns what JAX's returns; ``render_frame_packed`` is the same frame
from the packed (16,) uniform vector, what the frame program replays.  One
packed uniform vector is uploaded per frame.  ``Pipeline.draw_frame``
renders every tracer through a frame program (``frame_graph.FrameProgram``:
on the card one CUDA graph replay a frame, the counterpart of JAX's jitted
``_rffp_impl``), and ``validate`` frames eagerly.  Everything runs on the
pipeline's ``device``: CUDA tensors go through the kernels, CPU tensors
through their plain versions.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .._device import default_device
from ..constants import (
    BLUE_NOISE_SIZE,
    DEFAULT_HEIGHT,
    DEFAULT_WIDTH,
    MAX_TRACE_STEPS,
)
from ..ops.denoise import denoise_finalize
from ..ops.hf_tables import build_hf_tables
from ..ops.lighting import EXHAUSTED_DEPTH, render_gbuffers_fused
from ..ops.path_vol import render_gbuffers_path
from ..ops.trace_dda import render_gbuffers
from ..ops.trace_hf import render_gbuffers_hf
from ..ops.vol_tables import build_vol_tables, update_vol_tables
from ..utils import perf
from ..utils.blue_noise import get_blue_noise_f32
from .camera import Camera
from .streaming import TerrainStreamer

TRACERS = ("fused", "hf", "volume", "volume_fast")
# The tracers that render the streamed resident volume (the others derive
# the world from its heightfield and cannot show a preloaded or edited one).
VOLUME_TRACERS = ("volume", "volume_fast")


@dataclasses.dataclass
class FrameUniforms:
    """Per-frame uniform state (reference structs.rs:5-31 + pipeline.rs:195-227)."""

    sun_angle: float = 0.0
    seed: int = 0
    origin: tuple = (0.0, 0.0, 0.0)
    forward: tuple = (0.0, 1.0, 0.0)
    up: tuple = (0.0, 0.0, 0.4)
    right: tuple = (0.4, 0.0, 0.0)
    # The reference's reprojection fields (structs.rs:17-24): draw_frame
    # keeps them, as JAX's does; no frame reads them.
    old_origin: tuple = (0.0, 0.0, 0.0)
    old_transform: tuple = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
    lr: tuple = (0, 0, 0)

    def as_device_dict(self, device=None) -> dict:
        """JAX's seven uniforms as tensors on ``device`` (the current CUDA
        device when None; with no GPU it raises): origin, forward, up, right
        and lr (3,) f32, sun_angle () f32 and seed () int32, what
        ``render_frame`` and the G-buffer passes take."""
        dev = default_device(device, "FrameUniforms.as_device_dict")
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        return dict(origin=f32(self.origin), forward=f32(self.forward), up=f32(self.up),
                    right=f32(self.right), sun_angle=f32(self.sun_angle),
                    seed=torch.tensor(self.seed, dtype=torch.int32, device=dev),
                    lr=f32(self.lr))

    def packed(self) -> np.ndarray:
        """(16,) f32: origin 0:3, forward 3:6, up 6:9, right 9:12, sun 12,
        seed 13, lr.x 14, lr.z 15 (lr.y is always 0: the streamer never
        recenters along Y, pipeline.rs:175-179)."""
        if self.lr[1] != 0:
            raise ValueError(f"packed uniforms need lr.y == 0, got {self.lr}")
        return np.array(
            [*self.origin, *self.forward, *self.up, *self.right, self.sun_angle,
             float(self.seed), float(self.lr[0]), float(self.lr[2])],
            np.float32,
        )


def unpack_uniforms(packed: torch.Tensor) -> dict:
    """The uniforms dict from the packed (16,) f32 vector, on its device."""
    zero = torch.zeros((), dtype=torch.float32, device=packed.device)
    return dict(
        origin=packed[0:3], forward=packed[3:6], up=packed[6:9],
        right=packed[9:12], sun_angle=packed[12],
        seed=packed[13].to(torch.int32),
        lr=torch.stack([packed[14], zero, packed[15]]),
    )


def render_frame(world, blue_noise: torch.Tensor, uniforms: dict,
                 width: int = DEFAULT_WIDTH, height: int = DEFAULT_HEIGHT,
                 max_steps: int = MAX_TRACE_STEPS, with_gbuffers: bool = False,
                 tracer: str = "volume", seed: int = 0, bounces: int = 2):
    """One frame -> the (H, W, 3) frame, or ``(frame, gbuffers)`` with
    ``with_gbuffers``: JAX's ``render_frame`` (``_render_frame_impl``), the
    G-buffer pass of ``tracer`` and then the denoise chain with finalize.

    ``uniforms`` is JAX's dict (``FrameUniforms.as_device_dict``): tensors
    origin, forward, up, right and lr (3,) f32, sun_angle () f32 and seed
    () int32 on ``blue_noise``'s device; every component of ``lr`` is read,
    as JAX reads it.  ``world`` is the ``build_hf_tables`` dict for
    ``tracer="fused"`` and ``"hf"`` (for "fused" on the card, with the
    column table: ``with_column_heights``), the (fused volume,
    ``build_vol_tables`` dict) pair for ``"volume_fast"`` and the fused
    volume for ``"volume"``.  ``tracer`` defaults to the exact DDA, as
    JAX's does.
    """
    gb = frame_gbuffers(world, blue_noise, uniforms, width, height, max_steps, seed,
                        bounces, tracer)
    frame = denoise_finalize(gb, blue_noise)
    return (frame, gb) if with_gbuffers else frame


def render_frame_packed(world, blue_noise: torch.Tensor, packed: torch.Tensor,
                        width: int, height: int, max_steps: int = MAX_TRACE_STEPS,
                        seed: int = 0, bounces: int = 2, tracer: str = "volume",
                        census=None):
    """``render_frame`` of the packed (16,) f32 uniforms (``unpack_uniforms``:
    lr.y is 0) -> ``(frame (H, W, 3), gbuffers)``: the counterpart of JAX's
    packed frame program (``_rffp_impl``), what the frame program runs and
    its CUDA graph replays.  ``census``: the march's counters, as
    ``frame_gbuffers`` takes them."""
    gb = frame_gbuffers(world, blue_noise, unpack_uniforms(packed), width, height,
                        max_steps, seed, bounces, tracer, census=census)
    return denoise_finalize(gb, blue_noise), gb


def frame_gbuffers(world, blue_noise: torch.Tensor, uniforms: dict, width: int,
                   height: int, max_steps: int = MAX_TRACE_STEPS, seed: int = 0,
                   bounces: int = 2, tracer: str = "fused", row0: int = 0,
                   rows: int | None = None, *, census=None) -> dict:
    """The G-buffer pass of ``tracer`` (``world`` as for ``render_frame``)
    for the whole frame or its image rows ``row0 .. row0 + rows``.
    ``census``: a (2,) int64 tensor of the march's counters (warp
    iterations, moves) that the path marches K1 ("fused") and K3
    ("volume_fast") add to on the card, or None; the other tracers take
    none."""
    kw = dict(row0=row0, rows=rows, bounces=bounces)
    if tracer == "fused":
        return render_gbuffers_fused(world, blue_noise, uniforms, width, height,
                                     max_steps, seed, census=census, **kw)
    if tracer == "volume_fast":
        volume, tables = world
        return render_gbuffers_path(volume, tables, blue_noise, uniforms, width,
                                    height, max_steps, census=census, **kw)
    if census is not None:
        raise ValueError(f"census: only the fused and volume_fast marches count, "
                         f"not {tracer!r}")
    if tracer == "hf":
        return render_gbuffers_hf(world, blue_noise, uniforms, width, height,
                                  max_steps, seed, **kw)
    if tracer == "volume":
        return render_gbuffers(world, blue_noise, uniforms, width, height,
                               max_steps, **kw)
    raise ValueError(f"unknown tracer {tracer!r}; expected one of {TRACERS}")


class Pipeline:
    """Stateful frame loop: streaming + uniforms + the frame program."""

    def __init__(
        self,
        width: int = DEFAULT_WIDTH,
        height: int = DEFAULT_HEIGHT,
        seed: int = 0,
        max_steps: int = MAX_TRACE_STEPS,
        source: str = "device",
        storage=None,
        tracer: str | None = None,
        preloaded_volume=None,
        validate: bool | None = None,
        bounces: int = 2,
        *,
        device="cuda",
    ):
        """``tracer``: "fused" (the whole-path heightfield march of the
        generated world), "hf" (the same world traced leg by leg by the
        staged heightfield tracer), "volume_fast" (the brick-pyramid march
        of whatever the streamed volume holds: generated, preloaded or
        edited content) or "volume" (the exact DDA through that volume:
        the reference); None picks "volume_fast" when
        ``preloaded_volume`` is given, else "fused", as the JAX package
        does.  ``preloaded_volume``: a fused (256^3,) volume (uint32 bits
        in any integer dtype) for the streamer to start from instead of
        generating one; only the volume tracers render it (with "fused" or
        "hf" the streamer holds and streams it, as JAX's does, and the
        frame is the heightfield's).  ``device`` (after JAX's parameters):
        "cuda" runs the kernels and raises when no GPU is present; "cpu"
        runs the plain versions.
        ``validate``: after every frame, report non-finite frame or
        lighting values and the pixels whose primary ray exhausted its
        budget (the JAX package's debug-build checks); it waits for each
        frame, so it is for debugging only.  None reads the
        ``RAYTRACE_TPU_VALIDATE`` environment variable ("1" turns it on), as
        the JAX package does.  ``source`` and ``storage``: where the
        streamed volume's voxels come from (``TerrainStreamer``): "device"
        generates them, "cache" reads the chunks of ``storage``, a
        ``ChunkStorage``; only the volume tracers read voxels."""
        if tracer is None:
            tracer = "volume_fast" if preloaded_volume is not None else "fused"
        if tracer not in TRACERS:
            raise ValueError(f"unknown tracer {tracer!r}")
        self.device = default_device(device, "Pipeline")
        self.width = width
        self.height = height
        self.max_steps = max_steps
        self.seed = seed
        self.tracer = tracer
        self.bounces = bounces
        if validate is None:
            validate = bool(int(os.environ.get("RAYTRACE_TPU_VALIDATE", "0")))
        self.validate = validate
        self.uniforms = FrameUniforms()
        self.streamer = TerrainStreamer(seed=seed, source=source, storage=storage,
                                        device=self.device)
        # The heightfield tracers read no volume: their streamer holds one
        # only when given one.
        if tracer in VOLUME_TRACERS or preloaded_volume is not None:
            self.streamer.initialize(volume=preloaded_volume)
        self.blue_noise = torch.from_numpy(get_blue_noise_f32()).to(self.device)
        self._tables = None
        self._tables_lr = None
        self._vol_tables = None
        # One frame program per (tracer, width, height, max_steps, seed,
        # bounces), as the JAX package keeps one jitted program per statics.
        self._programs = {}
        # G-buffers of the last frame drawn (depth, normal, ... on device);
        # a graphed frame's are its program's, valid until the next frame.
        self.gbuffers = None

    def teleport(self, camera: Camera) -> None:
        """Recenter the region on the camera, then drain residual drift."""
        self.streamer.teleport((camera.origin[0], 0.0, camera.origin[2]))
        self.converge_streaming(
            (camera.origin[0], 0, camera.origin[2]), max_moves=8
        )

    def edit_box(self, world_min, shape, material_id=None) -> None:
        """Write a solid material box (or carve air with
        ``material_id=None``) into the resident volume at world voxel
        ``world_min`` with extents ``shape`` (x, y, z); the occupancy
        tables rebuild on the next frame.  The heightfield tracers derive
        their tables from worldgen and cannot show edits, so they raise."""
        if self.tracer not in VOLUME_TRACERS:
            raise ValueError(
                f"tracer={self.tracer!r} renders from worldgen-derived "
                "heightfields and cannot display volume edits; use "
                "tracer='volume_fast'"
            )
        self.streamer.edit_box(world_min, shape, material_id)

    def converge_streaming(self, target, max_moves: int = 32) -> None:
        """Repeat draw_frame's one-slice streaming step until no request is
        pending (at most ``max_moves``)."""
        for _ in range(max_moves):
            self.streamer.request_move_towards(target)
            if not self.streamer.setup_next_request():
                break

    def fill_uniforms(self, camera: Camera, sun_angle: float,
                      bump_seed: bool = True) -> None:
        """The per-frame uniform fill draw_frame performs (pipeline.rs:198-210)."""
        forward, up, right = camera.scaled_basis()
        u = self.uniforms
        u.origin = tuple(camera.origin)
        u.forward, u.up, u.right = forward, up, right
        if bump_seed:
            u.seed = (u.seed + 1) % BLUE_NOISE_SIZE
        u.sun_angle = sun_angle
        u.lr = self.streamer.get_render_offset()

    def tables(self) -> dict:
        """Region tables for the current offset, rebuilt when it moved (one
        T1 launch on the card, no wait for the host): what "hf" and
        ``validate`` frames read, as JAX's ``draw_frame`` builds them
        outside its frame program.  For the fused tracer with the column
        table K1 reads beside them (``hcol``); the CPU's plain march
        evaluates its heights, but builds the table all the same, so that a
        CPU pipeline holds the tables the card's does.  A graphed fused
        frame builds its own (``frame_program``); these are then its
        buffers, as long as the offset stays."""
        lr = self.uniforms.lr
        if self._tables_lr != lr:
            self._tables = build_hf_tables(lr, seed=self.seed, device=self.device,
                                           hcol=self.tracer == "fused")
            self._tables_lr = lr
        return self._tables

    def vol_tables(self) -> dict:
        """Occupancy tables of the resident volume: updated for each slab
        streamed in since the last call, rebuilt when the whole volume
        changed (initialize, teleport, edit), in place in the pipeline's
        buffers (the frame program's once it exists: kernel O1 on the card,
        no table copied into the program)."""
        log = self.streamer.drain_slab_log()
        volume = self.streamer.volume
        if self._vol_tables is None:
            self._vol_tables = build_vol_tables(volume)
        elif log is None:
            build_vol_tables(volume, out=self._vol_tables)
        else:
            for arr_axis, t0 in log:
                update_vol_tables(self._vol_tables, volume, t0, arr_axis,
                                  out=self._vol_tables)
        return self._vol_tables

    def world(self):
        """What the frame program reads for this pipeline's tracer."""
        if self.tracer in ("fused", "hf"):
            return self.tables()
        if self.tracer == "volume":
            return self.streamer.volume
        return self.streamer.volume, self.vol_tables()

    def draw_frame(self, camera: Camera, sun_angle: float) -> torch.Tensor:
        """One frame: stream one slice toward the camera, then render.
        Returns the (H, W, 3) f32 frame on the device without waiting
        for it: a tensor of its own, which later frames leave as it is.

        With ``validate`` off, every tracer goes through the frame program
        of this configuration (``frame_program``: on the card one CUDA
        graph replay); ``self.gbuffers`` are then the program's,
        overwritten by the next frame.  ``validate`` frames run
        ``render_frame_packed`` eagerly.  Then the uniforms' ``old_origin``
        and ``old_transform`` take this frame's camera, as in JAX.

        While a ``torch.profiler`` session records, the frame records its
        spans (``utils.perf.SPANS``): ``draw_frame``, the whole call;
        inside it ``stream``, the streaming step (with ``slices``, the
        slices it applied: 0 or 1), and on the frame program's path
        ``world``, ``frame_program()``, and ``replay``, the program's run
        (with the march's counts, ``FrameProgram.COUNTERS``, where the
        program counts).  The uniforms' fill and upload are the root's own
        time."""
        spans = perf.SPANS
        traced = spans.open_frame()
        if traced:
            spans.open("stream")
        self.streamer.request_move_towards((camera.origin[0], 0, camera.origin[2]))
        moved = self.streamer.setup_next_request()
        if traced:
            spans.close(slices=int(moved))
        self.fill_uniforms(camera, sun_angle)
        packed = torch.from_numpy(self.uniforms.packed())
        if self.device.type == "cuda":
            # Pinned and asynchronous: the host does not wait for the
            # previous frame before queuing this one.
            packed = packed.pin_memory()
        if not self.validate:
            if traced:
                spans.open("world")
            program = self.frame_program()
            if traced:
                spans.close()
                spans.open("replay", program.counters, program.COUNTERS)
            frame, self.gbuffers = program.run(packed)
            if traced:
                spans.close()
        else:
            frame, self.gbuffers = render_frame_packed(
                self.world(), self.blue_noise, packed.to(self.device, non_blocking=True),
                self.width, self.height, self.max_steps, self.seed, self.bounces,
                self.tracer,
            )
            self._validate_frame(frame, self.gbuffers)
        # Post-submit reprojection bookkeeping (pipeline.rs:214-227), as JAX's.
        u = self.uniforms
        u.old_origin = u.origin
        u.old_transform = _invert3(tuple(zip(*(u.right, u.up, u.forward))))
        if traced:
            spans.close()
        return frame

    def frame_program(self):
        """The frame program of this configuration: built on the current
        world at first use, else refreshed with it.  The pipeline then
        keeps its world in those buffers (its region tables, and the
        streamed volume with, on volume_fast, its occupancy tables), so
        that a frame with no region move, slab or edit copies nothing and a
        streamed slab lands in place in the volume the graph reads.  The fused program
        takes no world: it rebuilds its tables from each frame's packed
        ``lr``, and the pipeline's tables are its buffers."""
        from .frame_graph import FrameProgram

        key = (self.tracer, self.width, self.height, self.max_steps, self.seed,
               self.bounces)
        world = None if self.tracer == "fused" else self.world()
        program = self._programs.get(key)
        if program is None:
            program = self._programs[key] = FrameProgram(world, self.blue_noise, *key)
        elif world is not None:
            program.refresh(world)
        if self.tracer == "volume_fast":
            self.streamer.volume, self._vol_tables = program.world
        elif self.tracer == "volume":
            self.streamer.volume = program.world
        else:
            # Fused: what the program's next run builds in stream order.
            self._tables, self._tables_lr = program.world, self.uniforms.lr
        return program

    def _validate_frame(self, frame, gb) -> dict:
        """Debug checks of one frame, with one wait for the device: count
        non-finite frame values, primary rays that exhausted the step budget
        (pink pixels) and non-finite lighting values; print each that is
        not 0 and return all three."""
        counts = torch.stack([
            (~torch.isfinite(frame)).sum(),
            (gb["depth"].to(torch.int32) == EXHAUSTED_DEPTH).sum(),
            (~torch.isfinite(gb["lighting"])).sum(),
        ]).tolist()
        bad, exhausted, bad_light = counts
        if bad:
            print(f"[validate] {bad} non-finite frame values")
        if exhausted:
            print(f"[validate] {exhausted} rays hit the {self.max_steps}-step "
                  "limiter (pink error pixels)")
        if bad_light:
            print("[validate] non-finite lighting buffer values")
        return dict(nonfinite=bad, exhausted=exhausted, nonfinite_lighting=bad_light)


def _invert3(m):
    """Inverse of a 3x3 matrix given as rows; plain python floats."""
    a = np.array(m, np.float64)
    return tuple(tuple(row) for row in np.linalg.inv(a).astype(np.float32))
