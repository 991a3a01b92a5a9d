"""K1, K2, K3 and K3s alone on the card, at the fused and volume_fast
paths' views.

Drives ``Pipeline(tracer="fused")`` and ``Pipeline(tracer="volume_fast")``
at the bench camera (origin (-30,-100,60), pitch -0.3, sun 0.6), bounces
2, then times, from ``torch.profiler`` (the kernel alone, mean over
``--reps`` calls):

- K1 (``march_paths_kernel``) on the frame's march inputs, beside the
  wrapper's call (CUDA events); K1's order (longest first, its 32 longest
  alone) is ``apps/march_lanes.py``'s;
- K2 (``denoise_pass_kernel``) per pass of the chain (dilations 1, 2, 4, 8,
  8, 16 with finalize: keys "1" ... "8#2", "fin"; ``measure.denoise_pass_ms``,
  as ``chip_smoke.py`` times them) on the frame's own G-buffers and on
  random ones (numpy seed 7), beside the chain's call (CUDA events);
- K3 (``march_paths_vol_kernel``) on the volume_fast frame's march inputs,
  beside the wrapper's call, and K3s (``trace_rays_vol_kernel``) on each
  trace batch of the staged volume frame at the same view (where the
  checkout has K3s).

It prints one JSON line with the card's name and power limit.  It uses only
the wrappers' calls and ``denoise.chain_passes``, so it also runs in a
checkout of an earlier commit that has them, to compare its kernels with
these (copy this file, ``testing/measure.py`` and ``testing/gbuffers.py``
into it).

Usage: python -m raytrace_tpu_torch.apps.kernel_times [--reps 10]
[--part fused|volume|all]   (needs a CUDA GPU)
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import denoise, integrate, lighting, path_vol, trace_vol
from ..render.camera import Camera
from ..render.pipeline import Pipeline, unpack_uniforms
from ..testing.gbuffers import random_gbuffers
from ..testing.measure import call_ms, card, denoise_pass_ms, kernel_ms


def _pipeline(size: int, tracer: str) -> tuple:
    """The pipeline at the bench camera after one frame, and its uniforms."""
    pipe = Pipeline(width=size, height=size, tracer=tracer)
    cam = Camera(origin=[-30.0, -100.0, 60.0])
    cam.pitch = -0.3
    pipe.teleport(cam)
    pipe.converge_streaming((cam.origin[0], 0, cam.origin[2]), max_moves=32)
    pipe.draw_frame(cam, 0.6)
    return pipe, unpack_uniforms(torch.from_numpy(pipe.uniforms.packed()).to(pipe.device))


def run(reps: int = 10, size: int = 1024, part: str = "all") -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel times need a CUDA GPU")
    res = dict(card=card(), size=size)
    if part in ("fused", "all"):
        res.update(_fused(reps, size))
    if part in ("volume", "all"):
        res.update(_volume(reps, size))
    print(json.dumps(res), flush=True)
    return res


def _fused(reps: int, size: int) -> dict:
    pipe, uniforms = _pipeline(size, "fused")
    march = lighting.march_inputs(pipe.tables(), pipe.blue_noise, uniforms, size, size)["march"]
    budget = (pipe.max_steps, pipe.seed, 1 + 2 * pipe.bounces)
    k1 = lambda: lighting.march_paths(*march, *budget)
    res = dict(k1=dict(
        call_ms=call_ms(k1, reps), kernel_ms=kernel_ms(k1, reps, "march_paths_kernel")))
    gbs = dict(main=pipe.gbuffers, random=random_gbuffers(size, size, 7, pipe.device))
    for key, gb in gbs.items():
        per_pass = denoise_pass_ms(gb, pipe.blue_noise, reps)
        res[f"k2_{key}"] = dict(
            chain_ms=call_ms(lambda: denoise.denoise_finalize(gb, pipe.blue_noise), reps),
            pass_ms=per_pass, passes_ms=sum(per_pass.values()))
    return res


def _volume(reps: int, size: int) -> dict:
    pipe, uniforms = _pipeline(size, "volume_fast")
    volume, tables = pipe.world()
    march = path_vol.march_inputs(tables, pipe.blue_noise, uniforms, size, size)["march"]
    k3 = lambda: trace_vol.march_paths_vol(*march, pipe.max_steps, path_vol.legs_of(pipe.bounces))
    res = dict(k3=dict(call_ms=call_ms(k3, reps),
                       kernel_ms=kernel_ms(k3, reps, "march_paths_vol_kernel")))
    if hasattr(trace_vol, "trace_rays_vol"):
        batches = []

        def trace(o, d, active=None):
            batches.append((o, d, active))
            return trace_vol.trace_rays_vol(tables, volume, o, d, uniforms["lr"],
                                            pipe.max_steps, active=active)

        integrate.integrate_gbuffers(trace, pipe.blue_noise, uniforms, size, size, pipe.bounces)
        per_batch = [kernel_ms(lambda: trace_vol.trace_rays_vol(
            tables, volume, o, d, uniforms["lr"], pipe.max_steps, active=a), reps,
            "trace_rays_vol_kernel") for o, d, a in batches]
        res["k3s"] = dict(kernel_ms=per_batch, frame_kernel_ms=sum(per_batch))
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--part", choices=("fused", "volume", "all"), default="all")
    args = ap.parse_args()
    run(args.reps, args.size, args.part)


if __name__ == "__main__":
    main()
