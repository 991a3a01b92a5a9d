"""Per-stage frame timing: where does a frame's time go?

Port of ``raytrace_tpu/apps/stage_times.py:39-157``, timed with CUDA events
around ``frames`` calls of each stage instead of a jitted ``fori_loop``:

- the G-buffer pass: ``fused`` is K1 and its shade
  (``render_gbuffers_fused``), ``hf`` is K4 leg by leg and the staged
  lighting pass (``render_gbuffers_hf``);
- the denoise chain on fixed G-buffers (``denoise_chain``: six launches
  of K2), then finalize on its output (``finalize_frame``: one launch of
  F1), each apart as JAX times them (``:120-137``), and the chain with
  finalize fused into its last pass as the frame runs it
  (``denoise_finalize``);
- the whole frame (``render_frame_packed``), and the Mrays/s it implies.

Each call varies the camera, sun and seed by its index, as in JAX.  The
JAX app's ``--unified`` and ``--caps`` select TPU round schedules of its
Pallas kernels that the port does not have (the Hopper kernels march each
path whole), so they are left out.

Usage: python -m raytrace_tpu_torch.apps.stage_times [--tracer fused|hf]
[--frames N]   (needs a CUDA GPU)
"""

from __future__ import annotations

import argparse

import torch

from ..constants import DEFAULT_HEIGHT, DEFAULT_WIDTH
from ..ops.denoise import denoise_chain, denoise_finalize
from ..ops.finalize import finalize_frame
from ..ops.lighting import render_gbuffers_fused
from ..ops.trace_hf import render_gbuffers_hf
from ..render.camera import Camera
from ..render.pipeline import Pipeline, render_frame_packed, unpack_uniforms

TRACERS = ("fused", "hf")
# Per call i the packed uniforms move by i times this: origin += 0.03 in x
# and y, sun += 0.01, seed += 1 (JAX's ``vary``).
_VARY = [0.03, 0.03] + [0.0] * 10 + [0.01, 1.0, 0.0, 0.0]


def _time(fn, n: int, label: str) -> float:
    """Mean device ms of ``fn(i)`` for i in 0..n-1, after one warm call,
    from CUDA events around the train."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    print(f"{label:44s} {ms:8.3f} ms")
    return ms


def run(tracer: str = "fused", frames: int = 10, width: int = DEFAULT_WIDTH,
        height: int = DEFAULT_HEIGHT) -> dict:
    """Time the stages of ``tracer``'s frame -> ms of each and Mrays/s."""
    if tracer not in TRACERS:
        raise ValueError(f"stage_times times {TRACERS}, not {tracer!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("stage_times needs a CUDA GPU")
    pipeline = Pipeline(width=width, height=height, tracer=tracer)
    cam = Camera(origin=[-30.0, -100.0, 60.0], pitch=-0.3)
    for _ in range(6):
        pipeline.draw_frame(cam, 0.6)
    torch.cuda.synchronize()
    world = pipeline.tables()
    bn = pipeline.blue_noise
    packed = torch.from_numpy(pipeline.uniforms.packed()).to(pipeline.device)
    vary = torch.tensor(_VARY, dtype=torch.float32, device=pipeline.device)
    gbuffers = render_gbuffers_fused if tracer == "fused" else render_gbuffers_hf
    args = (width, height, pipeline.max_steps, pipeline.seed)

    def gb_fn(i):
        return gbuffers(world, bn, unpack_uniforms(packed + i * vary), *args,
                        bounces=pipeline.bounces)

    t_gb = _time(gb_fn, frames, f"gbuffers ({tracer})")
    gb0 = gb_fn(0)
    t_chain = _time(lambda i: denoise_chain(gb0["lighting"], gb0["depth"], gb0["normal"]),
                    frames, "denoise chain (6 passes)")
    den0 = denoise_chain(gb0["lighting"], gb0["depth"], gb0["normal"])
    t_fin = _time(lambda i: finalize_frame(gb0["albedo"], gb0["emission"], gb0["fog"], den0,
                                           gb0["depth"], bn), frames, "finalize")
    t_dn = _time(lambda i: denoise_finalize(gb0, bn), frames,
                 "denoise chain, finalize fused (6 passes)")
    t_full = _time(lambda i: render_frame_packed(world, bn, packed + i * vary, *args,
                                                 pipeline.bounces, tracer),
                   frames, "full frame (render_frame)")
    print(f"{'sum of stages':44s} {t_gb + t_dn:8.3f} ms (full {t_full:.3f})")
    rays = width * height * (1 + 2 * pipeline.bounces)
    mrays = rays / (t_full * 1e-3) / 1e6
    print(f"{'implied throughput':44s} {mrays:8.1f} Mrays/s")
    return dict(tracer=tracer, width=width, height=height, frames=frames,
                gbuffers_ms=t_gb, chain_ms=t_chain, finalize_ms=t_fin, denoise_ms=t_dn,
                frame_ms=t_full, mrays_per_s=mrays)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tracer", default="fused", choices=TRACERS)
    ap.add_argument("--frames", type=int, default=10)
    ns = ap.parse_args()
    run(ns.tracer, ns.frames)


if __name__ == "__main__":
    main()
