"""K1 and K2 alone on the card, at the fused path's view.

Drives ``Pipeline(tracer="fused")`` at the bench camera (origin
(-30,-100,60), pitch -0.3, sun 0.6), bounces 2, then times, from
``torch.profiler`` (the kernel alone, mean over ``--reps`` calls):

- K1 (``march_paths_kernel``) on the frame's march inputs, beside the
  wrapper's call (CUDA events); K1's order (longest first, its 32 longest
  alone) is ``apps/march_lanes.py``'s;
- K2 (``denoise_pass_kernel``) per pass of the chain (dilations 1, 2, 4, 8,
  8, 16 with finalize: keys "1" ... "8#2", "fin"; ``measure.denoise_pass_ms``,
  as ``chip_smoke.py`` times them) on the frame's own G-buffers and on
  random ones (numpy seed 7), beside the chain's call (CUDA events).

It prints one JSON line with the card's name and power limit.  It uses only
the wrappers' calls and ``denoise.chain_passes``, so it also runs in a
checkout of an earlier commit that has them, to compare its kernels with
these (copy this file, ``testing/measure.py`` and ``testing/gbuffers.py``
into it).

Usage: python -m raytrace_tpu_torch.apps.kernel_times [--reps 10]
(needs a CUDA GPU)
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import denoise, lighting
from ..render.camera import Camera
from ..render.pipeline import Pipeline, unpack_uniforms
from ..testing.gbuffers import random_gbuffers
from ..testing.measure import call_ms, card, denoise_pass_ms, kernel_ms


def run(reps: int = 10, size: int = 1024) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel times need a CUDA GPU")
    pipe = Pipeline(width=size, height=size, tracer="fused")
    cam = Camera(origin=[-30.0, -100.0, 60.0])
    cam.pitch = -0.3
    pipe.teleport(cam)
    pipe.converge_streaming((cam.origin[0], 0, cam.origin[2]), max_moves=32)
    pipe.draw_frame(cam, 0.6)
    uniforms = unpack_uniforms(torch.from_numpy(pipe.uniforms.packed()).to(pipe.device))
    march = lighting.march_inputs(pipe.tables(), pipe.blue_noise, uniforms, size, size)["march"]
    budget = (pipe.max_steps, pipe.seed, 1 + 2 * pipe.bounces)
    k1 = lambda: lighting.march_paths(*march, *budget)
    res = dict(card=card(), size=size, k1=dict(
        call_ms=call_ms(k1, reps), kernel_ms=kernel_ms(k1, reps, "march_paths_kernel")))
    gbs = dict(main=pipe.gbuffers, random=random_gbuffers(size, size, 7, pipe.device))
    for key, gb in gbs.items():
        per_pass = denoise_pass_ms(gb, pipe.blue_noise, reps)
        res[f"k2_{key}"] = dict(
            chain_ms=call_ms(lambda: denoise.denoise_finalize(gb, pipe.blue_noise), reps),
            pass_ms=per_pass, passes_ms=sum(per_pass.values()))
    print(json.dumps(res), flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--size", type=int, default=1024)
    args = ap.parse_args()
    run(args.reps, args.size)


if __name__ == "__main__":
    main()
