"""The decision of ``correct``: the checked frames against the reference.

For each frame the window copied (``window.Snapshots``), the reference
(``reference/``) works the world out again from the seed and the frame's
region offset, renders the frame's G-buffers from its packed uniforms,
denoises and finalizes them, and four numbers are read (the largest over
the checked frames):

- ``world_words_wrong``: words of the world the frame program read that
  differ from the reference's: the region tables with the column table
  ("fused"), or the streamed volume with its occupancy tables
  ("volume_fast");
- ``gbuffer_words_wrong``: depth and normal values that differ;
- ``gbuffer_gap``: the largest absolute difference of the float
  G-buffers (lighting, albedo, emission, fog);
- ``frame_gap``: the largest absolute difference of the finished frame.

Each has its limit in the configuration's file (``limits``); PERF.md gives
the readings each was set from.  The reference runs once the window has
closed and the program's state is freed, one checked frame at a time.
"""

from __future__ import annotations

import torch

from .reference import frame as ref

NUMBERS = ("world_words_wrong", "gbuffer_words_wrong", "gbuffer_gap", "frame_gap")


def words_wrong(got: dict, want: dict) -> int:
    """Words of ``got`` that differ from ``want``; a key or shape that
    differs counts every word of the tensor."""
    wrong = 0
    for k in sorted(set(got) | set(want)):
        a, b = got.get(k), want.get(k)
        if a is None or b is None or a.shape != b.shape:
            wrong += (a if b is None else b).numel()
        else:
            wrong += int((a.to(torch.int64) != b.to(torch.int64)).sum())
    return wrong


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest absolute difference (inf where one side is not finite
    or the shapes differ)."""
    if got.shape != want.shape:
        return float("inf")
    d = (got.to(torch.float64) - want.to(torch.float64)).abs()
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    return float(d.max()) if d.numel() else 0.0


def readings(tracer: str, world_seed: int, max_steps: int, bounces: int, snap: dict,
             device) -> dict:
    """The four numbers of one checked frame ``snap`` against the reference
    on ``device``.  ``snap`` holds the ``frame`` (H, W, 3), flipped as the
    window shows it, the ``world``, the ``gbuffers`` and the ``packed``
    uniforms."""
    noise = ref.blue_noise(device)
    want_world = ref.world(tracer, world_seed, ref.lr_of(snap["packed"]), device)
    height, width = snap["frame"].shape[:2]
    want = ref.gbuffers(tracer, want_world, noise, ref.uniforms(snap["packed"], device),
                        width, height, max_steps, world_seed, bounces)
    got = snap["gbuffers"]
    out = dict(
        world_words_wrong=words_wrong(snap["world"], want_world),
        gbuffer_words_wrong=words_wrong({key: got[key] for key in ("depth", "normal")},
                                        {key: want[key] for key in ("depth", "normal")}),
        gbuffer_gap=max(gap(got[key], want[key]) for key in ref.FLOAT_GBUFFERS),
    )
    del want_world
    out["frame_gap"] = gap(snap["frame"], ref.finish(want, noise))
    return out


def compare(config: dict, bounces: int, snaps: list, device) -> dict:
    """``{number: largest reading over snaps}`` (empty when no frame was
    checked)."""
    worst = {}
    for snap in snaps:
        got = readings(config["tracer"], config["world_seed"], config["max_steps"], bounces,
                       snap, device)
        for k, v in got.items():
            worst[k] = max(worst.get(k, v), v)
    return worst


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, ``{number: {"value", "limit"}}``): correct when a frame
    was checked and no number is over its limit."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS if k in values}
    ok = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
