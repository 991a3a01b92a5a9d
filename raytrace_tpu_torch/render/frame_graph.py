"""The frame as one replay: a CUDA graph over static buffers.

The counterpart of the JAX package's frame program: ``_rffp_impl``
(``raytrace_tpu/render/pipeline.py:198-238``, the interactive fast path:
one packed upload, one dispatch) together with the jit cache that keeps one
compiled program per static configuration (``_jit_cache``/``_lazy_jit``,
``:159-168``).  Where XLA compiles the frame into one program, PyTorch runs
it op by op, each op costing the host more than the card spends on most of
them; a ``torch.cuda.CUDAGraph`` captured once replays the whole frame (the
frame's rays R1, the G-buffer kernels, the shade S1 or S3, or on "hf" and
"volume" the leg batches P1 and the shade S2, and the six K2 passes) with
one call.

A ``FrameProgram`` holds one configuration (tracer, width, height,
max_steps, seed, bounces) and its static buffers on the pipeline's device:

- inputs: the packed (16,) f32 uniforms, the blue-noise texture and, for
  "hf", "volume_fast" and "volume", the world ``render_frame_packed`` reads (the
  ``build_hf_tables`` dict; the fused (256^3,) volume and the
  ``build_vol_tables`` dict, which the streamer (G1) and the pipeline (O1)
  then write in place; the fused volume alone, which the streamer writes
  in place);
- the region tables of "fused" (``h3``, ``hsub``, ``cA``..``cD``, ``r0``
  and the column table ``hcol``), which the program owns and builds at the
  start of every frame from the ``lr`` in the packed uniforms
  (``build_hf_tables(packed, out=..., key=...)``: kernel T1 inside the
  graph), as JAX's ``_rffp_impl`` rebuilds them inside its one dispatch,
  so a slice crossing or a teleport changes nothing but the uniforms; the
  program's ``key`` (int32 (4,): lr.x, lr.y, seed, valid) says which
  region they hold, and T1 builds only when ``lr`` moved;
- outputs: the frame and the G-buffers;
- on the card, for "fused" and "volume_fast", the march's counters
  (``counters``, (2,) int64: ``COUNTERS``), which K1 or K3 adds to in
  every frame (their census, taken as each warp exits:
  ``lighting.march_paths``, ``trace_vol.march_paths_vol``).

The program takes the tensors of the world it is built with as its input
buffers, without a copy, and ``refresh`` copies a later world into them
(the tensors whose storage differs); a world given to the program is the
program's from then on.  ``run(packed)`` copies the uniforms in and
replays.  The first ``run`` is the warm-up that ``torch.cuda.graphs``
asks for: it renders that frame eagerly on a side stream (building the
kernel library at first use, outside the capture), then captures the
graph; every later ``run`` replays it (``CapturedCall``, which the
benchmark's step programs share).  On a CPU program ``run`` renders
the same function eagerly over the same buffers (the key skips the fused
tables' plain build while ``lr`` stays, as it skips T1's on the card).

``run`` returns a fresh frame (one copy after the replay) and the static
G-buffers, which the next ``run`` overwrites.  A replay adds the capture's
launches to each kernel wrapper's counter.  Nothing here falls back: a
capture or replay that fails raises, and so does the capture of a frame
that reads a value on the host.
"""

from __future__ import annotations

import gc

import torch

from ..constants import MAX_TRACE_STEPS
from ..ops import (
    denoise, finalize, hf_tables, integrate, lighting, path_vol, rays, trace_dda, trace_hf,
    trace_vol, vol_tables, worldgen)
from ..world import generate
from .pipeline import TRACERS, render_frame_packed

# Every kernel wrapper's launch counter.
COUNTED = (hf_tables.build_hf_tables, rays.frame_rays, lighting.march_paths, lighting.shade,
           denoise.launch_pass, trace_vol.march_paths_vol, path_vol.shade,
           trace_vol.march_rays_vol, trace_hf.march_rays_hf, trace_dda.march_rays_dda,
           integrate.leg_batch, integrate.shade_staged, worldgen.generate_into,
           generate.generate_box,
           vol_tables.build_vol_tables, vol_tables.update_vol_tables,
           finalize.finalize_frame)


def _tensors(tree) -> list:
    """The tensors of nested tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    if not isinstance(tree, (dict, tuple, list)):
        items = ()
    return [t for item in items for t in _tensors(item)]


class CapturedCall:
    """``fn()`` on a CUDA device as one captured graph.

    ``capture()`` is the warm-up that ``torch.cuda.graphs`` asks for: it
    runs ``fn`` eagerly on a side stream (building the kernel library at
    first use, outside the capture) and returns that run's outputs, then
    captures ``fn`` into a ``torch.cuda.CUDAGraph`` whose outputs are
    ``outputs``.  ``replay()`` runs the graph and returns ``outputs``,
    which the next replay overwrites.  The kernel wrappers count their
    launches in Python, which a replay does not run: the capture's counts
    are taken off again and added back on every replay (``launches``), so
    a counter still says how often its kernel ran.  A capture or replay
    that fails raises.
    """

    def __init__(self, fn, device: torch.device):
        self.fn = fn
        self.device = device
        self.graph = None
        self.outputs = None
        self.launches = ()  # (wrapper, launches) of one replay

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def capture(self):
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm = self.fn()
        current.wait_stream(side)
        for t in _tensors(warm):
            t.record_stream(current)
        before = [wrapper.launches for wrapper in COUNTED]
        graph = torch.cuda.CUDAGraph()
        # An earlier program's graph left in a dead reference cycle must not
        # be destroyed mid-capture (its reset is not permitted while a stream
        # captures, and invalidates the capture): collect such cycles first,
        # and keep the cyclic collector off until the capture ends.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self.outputs = self.fn()
        finally:
            if collecting:
                gc.enable()
            counts = [w.launches - n for w, n in zip(COUNTED, before)]
            for wrapper, n in zip(COUNTED, before):
                wrapper.launches = n
        self.launches = tuple((w, n) for w, n in zip(COUNTED, counts) if n)
        self.graph = graph
        return warm

    def replay(self):
        self.graph.replay()
        for wrapper, n in self.launches:
            wrapper.launches += n
        return self.outputs


def _leaves(world) -> list:
    """The world's tensors in a fixed order: a table dict by key, the
    volume alone, or the volume and then its tables."""
    if isinstance(world, torch.Tensor):
        return [world]
    if isinstance(world, dict):
        return [world[k] for k in sorted(world)]
    volume, tables = world
    return [volume, *_leaves(tables)]


def _layout(world) -> list:
    """The world's keys, shapes, dtypes and devices, in ``_leaves``' order."""
    if isinstance(world, torch.Tensor):
        keys = ["volume"]
    else:
        keys = sorted(world) if isinstance(world, dict) else ["volume", *sorted(world[1])]
    return [(k, tuple(t.shape), t.dtype, t.device) for k, t in zip(keys, _leaves(world))]


class FrameProgram:
    """One frame configuration's static buffers and, on the card, its
    captured graph (see the module docstring).  ``world`` is None for
    "fused", whose program builds its own tables."""

    # The words of ``counters``, in order: the march's warp loop iterations
    # and its moves, summed over the frames the program ran.
    COUNTERS = ("warp_iterations", "moves")

    def __init__(self, world, blue_noise: torch.Tensor, tracer: str, width: int,
                 height: int, max_steps: int = MAX_TRACE_STEPS, seed: int = 0,
                 bounces: int = 2):
        if tracer not in TRACERS:
            raise ValueError(f"unknown tracer {tracer!r}; expected one of {TRACERS}")
        if (world is None) != (tracer == "fused"):
            raise ValueError("FrameProgram: the fused program builds its own region "
                             "tables from the packed lr (world=None); the others take "
                             "their world")
        self.config = (width, height, max_steps, seed, bounces, tracer)
        self.device = blue_noise.device
        self.key = None  # what the fused tables hold: nothing yet (valid 0)
        if tracer == "fused":
            world = hf_tables.empty_tables(self.device, hcol=True)
            self.key = torch.zeros(4, dtype=torch.int32, device=self.device)
        if tracer == "volume_fast":
            self.world = (world[0], dict(world[1]))
        else:
            self.world = world if tracer == "volume" else dict(world)
        self._layout = _layout(self.world)
        self.blue_noise = blue_noise
        self.packed = torch.zeros(16, dtype=torch.float32, device=self.device)
        self.counters = None
        if tracer in ("fused", "volume_fast") and self.device.type == "cuda":
            self.counters = torch.zeros(len(self.COUNTERS), dtype=torch.int64,
                                        device=self.device)
        self.call = CapturedCall(self._render, self.device)

    def refresh(self, world) -> None:
        """Copy each tensor of ``world`` whose storage differs from the
        program's into it; raise if a key, shape, dtype or device changed,
        or if the program builds its own world ("fused")."""
        if self.config[-1] == "fused":
            raise ValueError("FrameProgram.refresh: the fused program rebuilds its "
                             "tables from each frame's packed lr")
        if _layout(world) != self._layout:
            raise ValueError("FrameProgram.refresh: the world's layout changed: "
                             f"{_layout(world)} != {self._layout}")
        for dst, src in zip(_leaves(self.world), _leaves(world)):
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)

    def _render(self):
        if self.config[-1] == "fused":
            self._build_tables()
        return render_frame_packed(self.world, self.blue_noise, self.packed, *self.config,
                                   census=self.counters)

    def _build_tables(self) -> None:
        """The fused tables of the packed uniforms' ``lr``, in place: on the
        card T1 reads ``lr`` and the key on the device (inside the graph)
        and builds only when they differ; on the CPU the host compares.
        Only this call writes the fused buffers: any other writer must set
        ``self.key[3] = 0`` (not valid), or the next frame may keep what it
        wrote."""
        hf_tables.build_hf_tables(self.packed, self.config[3], out=self.world, hcol=True,
                                  key=self.key)

    def run(self, packed: torch.Tensor):
        """One frame of the packed (16,) f32 uniforms ``packed`` (on the
        host, pinned for an asynchronous upload, or on the device) ->
        ``(frame, gbuffers)``: the frame a fresh tensor, the G-buffers the
        program's, valid until the next ``run``."""
        self.packed.copy_(packed, non_blocking=True)
        if self.device.type == "cpu":
            return self._render()
        if not self.call.captured:
            return self.call.capture()
        frame, gbuffers = self.call.replay()
        return frame.clone(), gbuffers
