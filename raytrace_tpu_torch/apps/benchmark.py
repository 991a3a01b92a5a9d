"""Benchmark suite reproducing the BASELINE measurement configs 1-5.

Port of ``raytrace_tpu/apps/benchmark.py:82-296``.  Each config prints one
JSON line (``_emit``):

  1. one loaded chunk, 512x512, primary rays only (bounces=0): Mrays/s
  2. the generated world, 1920x1080, one diffuse bounce: Mrays/s
  3. a 60-frame flythrough with streaming, at bounces 2 and 1: ms/frame
  4. batch dataset capture of 30 views at 512²: views/s
  5. the tile split at 3840x2160, bounces 2, over every rank: Mrays/s

Configs 1 and 2 run their frame of step ``t`` (``config1_frame``,
``config2_frame``) through a ``StepProgram``, the counterpart of JAX's
jitted ``_time_chained``: one CUDA graph replay a frame with ``t`` in a
static device buffer (``graphed: true``), config 1 ``--tracer volume``
(the exact DDA, D1) too.

Every line carries ``exhausted_px``, the count of timed pixels whose
primary ray was cut by its step budget (depth == ``EXHAUSTED_DEPTH``):
configs 1-3 sum each timed frame's count on the device and read it once
at the end, config 4 counts over the views, config 5 over every timed
frame and every rank.  A number whose ``exhausted_px`` is not 0 rendered
error pixels instead of doing the work.  Trains are timed on the host
clock between ``torch.cuda.synchronize()`` calls (``value``,
``ms_per_frame``), with the device ms from CUDA events beside them
(``device_ms_per_frame``).

Config 5 renders through ``parallel.tiles.render_frame_tiled`` over the
default process group: one rank on one GPU, or N under
``torchrun --nproc_per_node N``, each rank on ``cuda:LOCAL_RANK`` (NCCL);
only rank 0 prints.

Usage: python -m raytrace_tpu_torch.apps.benchmark [--configs 1,2,3,4,5]
[--tracer fused|hf|volume|volume_fast]   (needs a CUDA GPU)
On N GPUs: torchrun --standalone --nproc_per_node N -m
raytrace_tpu_torch.apps.benchmark --configs 5 --tracer fused
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import deque

import torch
import torch.distributed as dist

from ..constants import MAX_TRACE_STEPS
from ..ops.denoise import denoise_finalize
from ..ops.hf_tables import build_hf_tables
from ..ops.lighting import EXHAUSTED_DEPTH, render_gbuffers_fused
from ..ops.path_vol import render_gbuffers_path
from ..ops.trace_dda import render_gbuffers
from ..ops.trace_hf import render_gbuffers_hf
from ..ops.vol_tables import build_vol_tables
from ..ops.volume import fuse_volume
from ..parallel import tiles
from ..render.camera import Camera
from ..render.frame_graph import CapturedCall
from ..render.pipeline import Pipeline, frame_gbuffers
from ..utils.blue_noise import get_blue_noise_f32
from ..world.generate import generate_box, generate_chunk
from . import capture

TRAIN = 20  # timed frames of configs 1-2


def _device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA GPU")
    return torch.device("cuda")


def exhausted_px(depth: torch.Tensor) -> torch.Tensor:
    """The count (a 0-d int64 tensor on depth's device) of pixels whose
    primary ray was cut by its budget."""
    return (depth.to(torch.int32) == EXHAUSTED_DEPTH).sum()


def _emit(name, value, unit, extra=None, show=True) -> dict:
    rec = {"config": name, "value": round(value, 2), "unit": unit}
    if extra:
        rec.update(extra)
    if show:
        print(json.dumps(rec), flush=True)
    return rec


def _uniforms(cam: Camera, dev, sun_angle=0.6, seed=7, lr=(0, 0, 0)) -> dict:
    fwd, up, right = cam.scaled_basis()
    vec = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    return dict(origin=vec(cam.origin), forward=vec(fwd), up=vec(up), right=vec(right),
                sun_angle=vec(sun_angle), seed=torch.tensor(seed, dtype=torch.int32, device=dev),
                lr=vec([float(v) for v in lr]))


class StepProgram:
    """The counterpart of JAX's ``_time_chained``
    (``raytrace_tpu/apps/benchmark.py:35-58``), which jits a config's frame
    of step ``t``: one frame function run as one program a frame.

    ``frame_of_step(t)`` takes the step as a 0-d float32 tensor on
    ``device`` and returns a dict of the frame's outputs with the primary
    ``depth``.  The program holds ``t`` in a static buffer and adds each
    frame's count of exhausted pixels to a static device counter,
    ``exhausted``.  With ``graphed`` on a CUDA device the first ``run``
    renders eagerly (the warm-up) and captures the frame and the counter's
    add as one CUDA graph (``frame_graph.CapturedCall``); every later
    ``run`` writes ``t`` into the buffer (a ``fill_``: no host sync) and
    replays.  Otherwise (the CPU, or ``graphed`` False: the eager twin a
    graphed program is held to) every ``run`` renders eagerly over the same
    buffers.
    """

    def __init__(self, frame_of_step, device, graphed: bool = True):
        self.frame_of_step = frame_of_step
        self.device = torch.device(device)
        self.graphed = graphed and self.device.type == "cuda"
        self.t = torch.zeros((), dtype=torch.float32, device=self.device)
        self.exhausted = torch.zeros((), dtype=torch.int64, device=self.device)
        self.call = CapturedCall(self._frame, self.device)

    def _frame(self) -> dict:
        out = self.frame_of_step(self.t)
        self.exhausted += exhausted_px(out["depth"])
        return out

    def run(self, t: float) -> dict:
        """The frame at step ``t`` -> its outputs (a graph's own, valid
        until the next ``run``)."""
        self.t.fill_(t)
        if not self.graphed:
            return self._frame()
        if not self.call.captured:
            return self.call.capture()
        return self.call.replay()


def step_of_frame(i: int) -> float:
    """The step of timed frame ``i`` (JAX's ``_time_chained``)."""
    return 0.001 + 0.03 * i


def time_steps(program: StepProgram, n: int = TRAIN) -> dict:
    """Time ``n`` frames of ``program`` enqueued back to back with one
    synchronize at the end, after one warm frame at step 0 (on the card,
    the capture).  -> host ms/frame, device ms/frame (CUDA events),
    ``exhausted_px`` over the timed frames (the device counter, read once
    after the train) and ``graphed``."""
    program.run(0.0)
    torch.cuda.synchronize()
    program.exhausted.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(n):
        program.run(step_of_frame(i))
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    return dict(ms_per_frame=host_ms, device_ms_per_frame=start.elapsed_time(end) / n,
                exhausted_px=int(program.exhausted), graphed=program.graphed)


CONFIG1_CAMERA = dict(origin=[32.0, -40.0, 60.0], pitch=-0.5)
CONFIG2_CAMERA = dict(origin=[-30.0, -100.0, 60.0], pitch=-0.3)
STEP = (1.0, 1.0, 0.0)  # the camera's move per unit of the step t


def single_chunk_volume(dev) -> torch.Tensor:
    """Config 1's world: chunk (0, 0, 0) at texels 128:192 of an empty
    256^3 volume (air, minefield 6), fused."""
    mats, mf = generate_chunk((0, 0, 0), seed=0, device=dev)
    vol_m = torch.zeros((256, 256, 256), dtype=torch.int32, device=dev)
    vol_f = torch.full((256, 256, 256), 6, dtype=torch.uint8, device=dev)
    vol_m[128:192, 128:192, 128:192] = mats
    vol_f[128:192, 128:192, 128:192] = mf
    return fuse_volume(vol_m, vol_f)


def _moved(camera: dict, dev):
    """The uniforms of ``camera`` moved ``t · STEP``, as a function of a
    0-d step tensor (or a float)."""
    uni = _uniforms(Camera(**camera), dev)
    step = torch.tensor(STEP, device=dev)
    return lambda t: dict(uni, origin=uni["origin"] + t * step)


def config1_frame(dev, width: int = 512, height: int = 512, tracer="volume_fast"):
    """Config 1's frame of step ``t`` (JAX ``config1_single_chunk``'s
    ``gb``): the G-buffers at b0, max_steps 1024, of ``single_chunk_volume``
    from ``CONFIG1_CAMERA`` moved ``t · STEP``, by the volume_fast path (K3,
    over tables built once here) or with ``tracer="volume"`` the exact DDA
    it is held to."""
    fused = single_chunk_volume(dev)
    bn = torch.from_numpy(get_blue_noise_f32()).to(dev)
    moved = _moved(CONFIG1_CAMERA, dev)
    if tracer == "volume":
        return lambda t: render_gbuffers(fused, bn, moved(t), width, height, 1024, bounces=0)
    tables = build_vol_tables(fused)
    return lambda t: render_gbuffers_path(fused, tables, bn, moved(t), width, height, 1024,
                                          bounces=0)


def config2_frame(dev, width: int = 1920, height: int = 1080, tracer="fused"):
    """Config 2's frame of step ``t`` (JAX ``config2_world_1080p``'s
    ``frame``): the G-buffers at b1 of the lr 0 region from
    ``CONFIG2_CAMERA`` moved ``t · STEP``, by ``fused`` (K1) or ``hf`` (K4),
    and the denoised ``frame`` (K2).  The tables are built once here (for
    ``fused`` with the column table K1 reads), as JAX's config 2 builds
    them once outside its frame."""
    tables = build_hf_tables((0, 0, 0), seed=0, device=dev, hcol=tracer == "fused")
    bn = torch.from_numpy(get_blue_noise_f32()).to(dev)
    moved = _moved(CONFIG2_CAMERA, dev)
    render = render_gbuffers_fused if tracer == "fused" else render_gbuffers_hf

    def frame_of_step(t):
        gb = render(tables, bn, moved(t), width, height, MAX_TRACE_STEPS, 0, bounces=1)
        return dict(gb, frame=denoise_finalize(gb, bn))

    return frame_of_step


def config1_single_chunk(tracer="volume_fast"):
    """512x512 primary-only over one generated chunk at texels 128:192 of
    an empty 256^3 volume: the volume_fast path (K3), or with
    ``tracer="volume"`` the exact DDA (R1, D1, S2), as one CUDA graph a
    frame."""
    dev = _device()
    tracer = "volume" if tracer == "volume" else "volume_fast"
    program = StepProgram(config1_frame(dev, 512, 512, tracer), dev)
    res = time_steps(program)
    return _emit("1_single_chunk_primary", 512 * 512 / res["ms_per_frame"] / 1e3,
                 "Mrays/s", {**res, "tracer": tracer})


def config2_world_1080p(tracer="fused"):
    """1920x1080, bounces=1 (3 rays a pixel) of the generated world:
    ``fused`` (K1) or ``hf`` (K4), then the denoise chain (K2), as one CUDA
    graph a frame."""
    dev = _device()
    tracer = "fused" if tracer == "fused" else "hf"
    res = time_steps(StepProgram(config2_frame(dev, 1920, 1080, tracer), dev))
    rays = 1920 * 1080 * 3  # primary + sun + diffuse
    return _emit("2_world_1080p_1bounce", rays / res["ms_per_frame"] / 1e3, "Mrays/s",
                 {**res, "tracer": tracer})


def config3_flythrough(tracer="fused", frames=60, bounces=2, _name=None):
    """``frames`` frames of ``Pipeline.draw_frame`` at 1024², flying +1.2 x
    a frame (a slice crossing about every 13 frames), enqueued back to back
    with two frames held in flight and one synchronize at the end."""
    dev = _device()
    pipeline = Pipeline(width=1024, height=1024, tracer=tracer, bounces=bounces)
    cam = Camera(origin=[-30.0, -100.0, 60.0], pitch=-0.1)
    for _ in range(4):  # first launches and the initial streaming
        pipeline.draw_frame(cam, 0.6)
    torch.cuda.synchronize()
    exhausted = torch.zeros((), dtype=torch.int64, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    inflight = deque()
    t0 = time.perf_counter()
    start.record()
    for _ in range(frames):
        cam.origin[0] += 1.2
        inflight.append(pipeline.draw_frame(cam, 0.6))
        exhausted += exhausted_px(pipeline.gbuffers["depth"])
        if len(inflight) > 2:
            inflight.popleft()
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / frames
    return _emit(
        _name or "3_flythrough_streaming", host_ms, "ms/frame",
        dict(fps=round(1e3 / host_ms, 2), bounces=bounces, tracer=pipeline.tracer,
             ms_per_frame=host_ms, device_ms_per_frame=start.elapsed_time(end) / frames,
             exhausted_px=int(exhausted), lr=list(pipeline.uniforms.lr)),
    )


def config3_flythrough_both(tracer="fused", frames=60):
    """Config 3 at bounces 2 (5 rays a pixel) and at the interactive
    preset, bounces 1 (3 rays a pixel)."""
    full = config3_flythrough(tracer, frames, bounces=2)
    interactive = config3_flythrough(tracer, frames, bounces=1,
                                     _name="3_flythrough_interactive")
    return full, interactive


def config4_capture(tracer="fused", views=30, fmt="dat"):
    """``capture.run`` of ``views`` views at 512², written to a temporary
    directory with the manifest, through the capture app's own pipeline
    (``fused``; ``tracer`` is not read, as in JAX)."""
    dev = _device()
    pipeline = Pipeline(width=512, height=512, max_steps=2048)
    exhausted = torch.zeros((), dtype=torch.int64, device=dev)
    draw = pipeline.draw_frame

    def counted(camera, sun_angle):
        nonlocal exhausted
        frame = draw(camera, sun_angle)
        exhausted += exhausted_px(pipeline.gbuffers["depth"])
        return frame

    pipeline.draw_frame = counted
    with tempfile.TemporaryDirectory() as td:
        n, dt = capture.run(out_dir=td, width=512, height=512, limit=views, save=True,
                            pipeline=pipeline, fmt=fmt)
    rate = n / dt
    return _emit("4_batch_capture", rate, "views/s",
                 {"est_10k_views_min": round(10000 / rate / 60, 1), "format": fmt,
                  "views_timed": n, "seconds": dt, "exhausted_px": int(exhausted)})


CONFIG5_SIZE = (3840, 2160)
CONFIG5_FRAMES = 3  # timed, after one warm frame


def _tile_device() -> torch.device:
    """The card of this rank: under ``torchrun`` (``WORLD_SIZE`` > 1)
    ``cuda:LOCAL_RANK``, in an NCCL default group set up here unless the
    caller set one up; otherwise the current card."""
    dev = _device()
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev)
    elif dist.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def config5_world(tracer: str, dev):
    """Config 5's world on ``dev`` (JAX ``benchmark.py:241-258``): the lr 0
    region's heightfield tables for ``fused`` (with K1's column table, built
    once here as config 2 does) and ``hf``; the generated 256³ box around
    the origin, fused, for ``volume``, with its occupancy tables for
    ``volume_fast``."""
    if tracer in ("fused", "hf"):
        return build_hf_tables((0, 0, 0), seed=0, device=dev, hcol=tracer == "fused")
    box = generate_box((-128,) * 3, (256,) * 3, seed=0, device=dev)
    fused = fuse_volume(box["materials"], box["minefield"])
    return (fused, build_vol_tables(fused)) if tracer == "volume_fast" else fused


def config5_tiled_4k(tracer="fused"):
    """3840x2160 at bounces 2 (5 rays a pixel) through the tile split over
    the default group's ranks, from the bench camera: one warm frame, then
    ``CONFIG5_FRAMES`` timed ones (JAX ``benchmark.py:241-286``).
    Each rank renders its band and counts its exhausted pixels; the count
    is summed over the ranks.  ``parity``: the warm tiled frame equals, on
    every rank, the frame that rank renders whole by itself (the tracer's
    G-buffers, then ``denoise_finalize``), bit for bit."""
    dev = _tile_device()
    world = config5_world(tracer, dev)
    bn = torch.from_numpy(get_blue_noise_f32()).to(dev)
    uni = _uniforms(Camera(origin=[-30.0, -100.0, 60.0], pitch=-0.3), dev)
    w, h = CONFIG5_SIZE
    frames = CONFIG5_FRAMES
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0

    def frame():
        gb = tiles.band_gbuffers(world, bn, uni, w, h, None, MAX_TRACE_STEPS, tracer)
        return tiles.denoise_tiled(gb, bn, h), exhausted_px(gb["depth"])

    whole = denoise_finalize(frame_gbuffers(world, bn, uni, w, h, MAX_TRACE_STEPS,
                                            tracer=tracer), bn)
    parity = torch.tensor(int(torch.equal(frame()[0], whole)), device=dev)
    del whole
    if ranks > 1:
        dist.all_reduce(parity, op=dist.ReduceOp.MIN)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    counts = [frame()[1] for _ in range(frames)]
    end.record()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / frames
    exhausted = torch.stack(counts).sum()
    if ranks > 1:
        dist.all_reduce(exhausted)
    rec = dict(devices=ranks, ms=dt * 1e3, device_ms_per_frame=start.elapsed_time(end) / frames,
               exhausted_px=int(exhausted), parity=bool(parity), tracer=tracer,
               size=[w, h], frames_timed=frames, plan=tiles.plan(ranks, h // ranks))
    return _emit("5_tiled_4k", w * h * 5 / dt / 1e6, "Mrays/s", rec, show=rank == 0)


CONFIGS = {
    "1": config1_single_chunk,
    "2": config2_world_1080p,
    "3": config3_flythrough_both,
    "4": config4_capture,
    "5": config5_tiled_4k,
}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--configs", default="1,2,3,4")
    ap.add_argument("--tracer", default="fused")
    ns = ap.parse_args()
    for c in ns.configs.split(","):
        CONFIGS[c.strip()](tracer=ns.tracer)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
