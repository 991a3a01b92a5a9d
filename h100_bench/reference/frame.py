"""The reference's world and frame, worked out from the seed and the
frame's packed uniforms.

The configuration's ``tracer`` names the module of ``tracers/`` that
builds the world and marches and shades the G-buffers.  Then the six
denoise passes with finalize fused into the last.  Every float the stages
store (the terrain heights, the march's hit distances, the G-buffers,
each pass's light, the frame) goes through ``precision.store``, which the
control rounds lower.
"""

from __future__ import annotations

import importlib
from pathlib import Path

import numpy as np
import torch

from .blue_noise import get_blue_noise_f32
from .constants import DENOISE_SIZES
from .ops.denoise import denoise_pass_plain, geometry_plane
from .precision import store

TRACERS = tuple(sorted(p.stem for p in (Path(__file__).parent / "tracers").glob("*.py")
                       if not p.stem.startswith("_")))
FLOAT_GBUFFERS = ("lighting", "albedo", "emission", "fog")


def _tracer(name: str):
    if name not in TRACERS:
        raise ValueError(f"the reference has no tracer {name!r}; it has {TRACERS}")
    return importlib.import_module(f"{__package__}.tracers.{name}")


def blue_noise(device) -> torch.Tensor:
    """The (512, 512, 4) f32 blue-noise texture on ``device``."""
    return torch.from_numpy(get_blue_noise_f32()).to(device)


def uniforms(packed, device) -> dict:
    """The uniforms dict of the packed (16,) f32 vector (origin 0:3,
    forward 3:6, up 6:9, right 9:12, sun 12, seed 13, lr.x 14, lr.z 15;
    lr.y is 0)."""
    p = torch.as_tensor(np.asarray(packed, np.float32)).to(device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return dict(origin=p[0:3], forward=p[3:6], up=p[6:9], right=p[9:12],
                sun_angle=p[12], seed=p[13].to(torch.int32),
                lr=torch.stack([p[14], zero, p[15]]))


def lr_of(packed) -> tuple:
    """The region offset (x, y, z) ints of the packed uniforms."""
    p = np.asarray(packed, np.float32)
    return int(p[14]), 0, int(p[15])


def world(tracer: str, seed: int, lr, device) -> dict:
    """The world ``tracer`` renders at region offset ``lr``, as named
    tensors (``tracers/<tracer>.py``)."""
    return _tracer(tracer).world(seed, lr, device)


def gbuffers(tracer: str, world_: dict, noise: torch.Tensor, uni: dict, width: int,
             height: int, max_steps: int, seed: int, bounces: int, row0: int = 0,
             rows: int | None = None) -> dict:
    """The six G-buffers of image rows ``row0 .. row0 + rows`` (default:
    the whole frame), the floats stored."""
    gb = _tracer(tracer).gbuffers(world_, noise, uni, width, height, max_steps, seed,
                                  bounces, row0, rows)
    return {k: store(v) if k in FLOAT_GBUFFERS else v for k, v in gb.items()}


def finish(gb: dict, noise: torch.Tensor) -> torch.Tensor:
    """The (H, W, 3) frame, flipped over its rows: the six denoise passes
    over ``gb``, finalize fused into the last."""
    light = gb["lighting"].permute(2, 0, 1)
    geom = geometry_plane(gb["depth"], gb["normal"])
    for size in DENOISE_SIZES[:-1]:
        light = store(denoise_pass_plain(light, geom, size))
    fin = (gb["albedo"], gb["emission"], gb["fog"], noise)
    light = denoise_pass_plain(light, geom, DENOISE_SIZES[-1], fin)
    return store(light.permute(1, 2, 0).flip(0))
