"""Benchmark suite reproducing the BASELINE measurement configs 1-4.

Port of ``raytrace_tpu/apps/benchmark.py:82-238``.  Each config prints one
JSON line (``_emit``):

  1. one loaded chunk, 512x512, primary rays only (bounces=0): Mrays/s
  2. the generated world, 1920x1080, one diffuse bounce: Mrays/s
  3. a 60-frame flythrough with streaming, at bounces 2 and 1: ms/frame
  4. batch dataset capture of 30 views at 512²: views/s

Every line carries ``exhausted_px``, the count of timed pixels whose
primary ray was cut by its step budget (depth == ``EXHAUSTED_DEPTH``):
configs 1-2 count it on every timed frame, config 3 sums each frame's
count on the device and reads it once at the end, config 4 counts over the
views.  A number whose ``exhausted_px`` is not 0 rendered error pixels
instead of doing the work.  Trains are timed on the host clock between
``torch.cuda.synchronize()`` calls (``value``, ``ms_per_frame``), with the
device ms from CUDA events beside them (``device_ms_per_frame``).

Config 5 (tile-split 4K over all devices, JAX ``:241-296``) needs
``parallel/tiles.py`` and the row bands, which the port does not have yet,
so ``CONFIGS`` leaves it out.

Usage: python -m raytrace_tpu_torch.apps.benchmark [--configs 1,2,3,4]
[--tracer fused|hf|volume|volume_fast]   (needs a CUDA GPU)
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from collections import deque

import torch

from ..constants import MAX_TRACE_STEPS
from ..ops.denoise import denoise_finalize
from ..ops.hf_tables import build_hf_tables, with_column_heights
from ..ops.lighting import EXHAUSTED_DEPTH, render_gbuffers_fused
from ..ops.path_vol import render_gbuffers_path
from ..ops.trace_dda import render_gbuffers
from ..ops.trace_hf import render_gbuffers_hf
from ..ops.vol_tables import build_vol_tables
from ..ops.volume import fuse_volume
from ..render.camera import Camera
from ..render.pipeline import Pipeline
from ..utils.blue_noise import get_blue_noise_f32
from ..world.generate import generate_chunk
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


def _emit(name, value, unit, extra=None) -> dict:
    rec = {"config": name, "value": round(value, 2), "unit": unit}
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)
    return rec


def _uniforms(cam: Camera, dev, sun_angle=0.6, seed=7, lr=(0, 0, 0)) -> dict:
    fwd, up, right = cam.scaled_basis()
    vec = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    return dict(origin=vec(cam.origin), forward=vec(fwd), up=vec(up), right=vec(right),
                sun_angle=vec(sun_angle), seed=torch.tensor(seed, dtype=torch.int32, device=dev),
                lr=vec([float(v) for v in lr]))


def _time_train(depth_of_step, n: int) -> dict:
    """Time ``n`` frames enqueued back to back with one synchronize at the
    end, after one warm frame.  ``depth_of_step(t)`` enqueues the frame at
    step ``t`` and returns its primary depth, counted after the train.
    -> host ms/frame, device ms/frame (CUDA events), exhausted_px."""
    depth_of_step(0.0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    depths = []
    t0 = time.perf_counter()
    start.record()
    for i in range(n):
        depths.append(depth_of_step(0.001 + 0.03 * i))
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    exhausted = int(sum(exhausted_px(d) for d in depths))
    return dict(ms_per_frame=host_ms, device_ms_per_frame=start.elapsed_time(end) / n,
                exhausted_px=exhausted)


CONFIG1_CAMERA = dict(origin=[32.0, -40.0, 60.0], pitch=-0.5)


def single_chunk_volume(dev) -> torch.Tensor:
    """Config 1's world: chunk (0, 0, 0) at texels 128:192 of an empty
    256^3 volume (air, minefield 6), fused."""
    mats, mf = generate_chunk((0, 0, 0), seed=0, device=dev)
    vol_m = torch.zeros((256, 256, 256), dtype=torch.int32, device=dev)
    vol_f = torch.full((256, 256, 256), 6, dtype=torch.uint8, device=dev)
    vol_m[128:192, 128:192, 128:192] = mats
    vol_f[128:192, 128:192, 128:192] = mf
    return fuse_volume(vol_m, vol_f)


def config1_single_chunk(tracer="volume_fast"):
    """512x512 primary-only over one generated chunk at texels 128:192 of
    an empty 256^3 volume: the volume_fast path (K3), or with
    ``tracer="volume"`` the exact DDA it is held to."""
    dev = _device()
    fused = single_chunk_volume(dev)
    bn = torch.from_numpy(get_blue_noise_f32()).to(dev)
    uni = _uniforms(Camera(**CONFIG1_CAMERA), dev)
    step = torch.tensor([1.0, 1.0, 0.0], device=dev)
    moved = lambda t: dict(uni, origin=uni["origin"] + t * step)
    if tracer == "volume":
        gb = lambda t: render_gbuffers(fused, bn, moved(t), 512, 512, 1024, bounces=0)
    else:
        tables = build_vol_tables(fused)
        gb = lambda t: render_gbuffers_path(fused, tables, bn, moved(t), 512, 512, 1024,
                                            bounces=0)
    res = _time_train(lambda t: gb(t)["depth"], TRAIN)
    return _emit("1_single_chunk_primary", 512 * 512 / res["ms_per_frame"] / 1e3,
                 "Mrays/s", {**res, "tracer": "volume" if tracer == "volume" else
                             "volume_fast"})


def config2_world_1080p(tracer="fused"):
    """1920x1080, bounces=1 (3 rays a pixel) of the generated world:
    ``fused`` (K1) or ``hf`` (K4), then the denoise chain (K2)."""
    dev = _device()
    tables = build_hf_tables((0, 0, 0), seed=0, device=dev)
    if tracer == "fused":
        # The column table K1 reads, built once here: bare tables would
        # have render_gbuffers_fused build it in every timed frame.
        tables = with_column_heights(tables, 0)
    bn = torch.from_numpy(get_blue_noise_f32()).to(dev)
    uni = _uniforms(Camera(origin=[-30.0, -100.0, 60.0], pitch=-0.3), dev)
    step = torch.tensor([1.0, 1.0, 0.0], device=dev)
    render = render_gbuffers_fused if tracer == "fused" else render_gbuffers_hf

    def depth_of_step(t):
        u = dict(uni, origin=uni["origin"] + t * step)
        gb = render(tables, bn, u, 1920, 1080, MAX_TRACE_STEPS, 0, bounces=1)
        denoise_finalize(gb, bn)
        return gb["depth"]

    res = _time_train(depth_of_step, TRAIN)
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


CONFIGS = {
    "1": config1_single_chunk,
    "2": config2_world_1080p,
    "3": config3_flythrough_both,
    "4": config4_capture,
}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--configs", default="1,2,3,4")
    ap.add_argument("--tracer", default="fused")
    ns = ap.parse_args()
    for c in ns.configs.split(","):
        CONFIGS[c.strip()](tracer=ns.tracer)


if __name__ == "__main__":
    main()
