"""Batch dataset capture: render many parameterized views to disk.

Port of ``raytrace_tpu/apps/capture.py:32-175``.  Reference:
capture_training_data.py, a 5 positions x 7 headings x 5 sun angles sweep
that relaunched the whole binary per configuration.  Here one process and
one pipeline render every view back to back: ``teleport`` on each new
position, the frame quantized to uint8 on the device, saved as raw
``.dat`` bytes or PNG with a manifest (BASELINE config 4).

The readback runs K=4 views deep, as in JAX: each view's bytes are copied
into a pinned host buffer with ``non_blocking=True`` and a CUDA event is
recorded after the copy; ``sink`` waits on that event before it reads the
bytes, so the host never reads a buffer the copy has not filled.  Encoding
and writing run on a thread pool.  The clock starts after view 0 (which
carries the first launches and builds).

Usage: python -m raytrace_tpu_torch.apps.capture [--out DIR] [--size WxH]
       [--limit N] [--format dat|png|png-fast]   (needs a CUDA GPU)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..render.camera import Camera
from ..render.pipeline import Pipeline
from ..testing.golden import save_png
from ..utils.perf import StatTracker

# The reference sweep grid (capture_training_data.py:19-38).
POSITIONS = [
    (-30.0, -128.0, 100.0),
    (200.0, -50.0, 80.0),
    (-150.0, 60.0, 120.0),
    (40.0, 180.0, 60.0),
    (-80.0, -40.0, 140.0),
]
NUM_HEADINGS = 7
SUN_ANGLES = [0.2, 0.6, 1.0, 1.4, 1.8]
DEPTH = 4  # views in flight before the oldest is read back


def sweep_configs():
    for pos in POSITIONS:
        for i in range(NUM_HEADINGS):
            heading = 2.0 * math.pi * i / NUM_HEADINGS
            for sun in SUN_ANGLES:
                yield dict(origin=pos, heading=heading, pitch=-0.3, sun_angle=sun)


def quantize(frame: torch.Tensor) -> torch.Tensor:
    """The (H, W, 3) uint8 view of a [0, 1] frame, on its device (as JAX's
    ``clip(frame * 255, 0, 255).astype(uint8)``: truncation)."""
    return torch.clamp(frame * 255.0, 0, 255).to(torch.uint8)


def _start_readback(frame_u8: torch.Tensor):
    """Start the copy of a view's bytes to the host -> (host tensor, event
    recorded after the copy, or None on the CPU)."""
    if frame_u8.device.type != "cuda":
        return frame_u8, None
    host = torch.empty(frame_u8.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(frame_u8, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def run(out_dir="capture", width=512, height=512, limit=None, max_steps=2048,
        save=True, pipeline=None, fmt="dat"):
    """Render the sweep (its first ``limit`` views) -> (views timed,
    seconds).  ``pipeline``: an optional pre-built ``Pipeline`` (tests
    inject a cheap one); else one is built on the card.

    ``fmt``: "dat" (default) writes the raw uint8 RGB bytes, with shape and
    dtype in the manifest; "png-fast" writes PNGs at zlib level 1, "png" at
    level 6.  Where encoding, not rendering, bounds the sweep, the format is
    the throughput knob.
    """
    configs = list(sweep_configs())
    if limit:
        configs = configs[:limit]
    if fmt == "dat":
        def write(path, arr):
            arr.tofile(path)
    elif fmt in ("png", "png-fast"):
        level = 1 if fmt == "png-fast" else 6

        def write(path, arr):
            save_png(path, arr, compress_level=level)
    else:
        raise ValueError(f"unknown capture format {fmt!r}")
    ext = "dat" if fmt == "dat" else "png"
    out = Path(out_dir)
    if save:
        out.mkdir(parents=True, exist_ok=True)
    if pipeline is None:
        pipeline = Pipeline(width=width, height=height, max_steps=max_steps)
    tracker = StatTracker(len(configs), "views")
    manifest = []
    last_origin = None

    def draw(cfg):
        nonlocal last_origin
        cam = Camera(origin=list(cfg["origin"]), heading=cfg["heading"],
                     pitch=cfg["pitch"])
        if cfg["origin"] != last_origin:
            # Recenter the region on the new viewpoint (the reference sweep
            # relaunched the process per position for the same effect).
            pipeline.teleport(cam)
            last_origin = cfg["origin"]
        return quantize(pipeline.draw_frame(cam, cfg["sun_angle"]))

    pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 4))
    futures = []

    def sink(i, cfg, host, ready):
        if ready is not None:
            ready.synchronize()  # the copy into ``host`` is done
        arr = host.numpy()
        if save:
            name = f"view_{i:05d}.{ext}"
            futures.append(pool.submit(write, out / name, arr))
            entry = {**cfg, "file": name}
            if fmt == "dat":
                entry["shape"] = list(arr.shape)
                entry["dtype"] = str(arr.dtype)
            manifest.append(entry)
        tracker.advance()
        print(f"\r{tracker.status()}   ", end="", flush=True)

    pending = deque()
    t_start = t0 = time.monotonic()
    try:
        for i, cfg in enumerate(configs):
            host, ready = _start_readback(draw(cfg))
            pending.append((i, cfg, host, ready))
            if i == 0:
                # Steady-state clock: view 0 carries the first launches.
                if ready is not None:
                    ready.synchronize()
                t0 = time.monotonic()
            while len(pending) > DEPTH:
                sink(*pending.popleft())
        while pending:
            sink(*pending.popleft())
        for f in futures:
            f.result()  # propagate encode/write failures
    finally:
        pool.shutdown()
    print()
    if save:
        (out / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if len(configs) >= 2:
        # t0 starts after view 0's readback: n-1 views were timed.
        return len(configs) - 1, time.monotonic() - t0
    # A single view has no steady-state window: whole-run timing.
    return len(configs), time.monotonic() - t_start


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="capture")
    ap.add_argument("--size", default="512x512")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument(
        "--format", default="dat", choices=("dat", "png", "png-fast"),
        help="dat = raw u8 RGB (reference-sweep parity, cheapest); "
        "png-fast = zlib level 1; png = level 6",
    )
    ns = ap.parse_args()
    w, h = map(int, ns.size.split("x"))
    n, dt = run(ns.out, w, h, ns.limit, fmt=ns.format)
    print(f"{n} views in {dt:.1f}s ({n / dt:.2f} views/s)")


if __name__ == "__main__":
    main()
