"""The lanes of the march kernels K1, K3, K3s and K4, measured on the card.

K3 (``csrc/trace_vol.cu``), K3s (``csrc/trace_rays_vol.cu``) and K4
(``csrc/trace_hf.cu``) run persistent lanes that take new work from a
counter (``csrc/lanes.cuh``); each source hard-codes in its ``refill_now``
when the idle lanes of a warp take new items:

  (i)   only when all 32 lanes are idle;
  (ii)  whenever any lane is idle;
  (iii) when at least 16 lanes are idle.

K1 (``csrc/lighting.cu``) runs one thread per pixel: its lanes tied with
the refill rules (PERF.md section 5).

The app drives K1 at the fused path's view, K3 at the volume_fast path's
view, K3s on each batch of the staged volume frame at that view and K4 on
each batch of the hf path's frame (the primaries, then each bounce's sun +
diffuse pair), at the bench camera (origin (-30,-100,60), pitch -0.3, sun
0.6), bounces 2, and prints one JSON line per part:

- ``rule``: the kernel library built once per rule, from copies of
  ``csrc/`` (under ``build/``) whose ``refill_now`` bodies are replaced,
  K3 and K4 timed in turns (i ii iii, then iii ii i, ...): each call's
  device time from CUDA events (the wrapper's whole call) and the kernel's
  alone from ``torch.profiler``, the lane-use census (``testing/census.py``,
  moves from the plain versions), and the check that every output equals
  the shipped library's;
- ``order``: the shipped library, K1, K3 and K4, on the same items in their
  index order, longest first (by the plain version's moves), and the 32
  longest alone: how much of a kernel's time is the latency of its longest
  items;
- ``split``: K1 alone on the same pixels with its paths cut after 1, 3 and
  5 legs, beside the plain version's moves and fine steps (column-height
  reads) for each: where K1's time goes between the primary and the bounce
  legs;
- ``k3s``: K3s on the shipped refill rule iii and on rules i and ii
  (``VARIANTS``, each a library built from a copy of ``csrc/`` whose
  ``refill_now`` body is replaced), timed alone per batch in turns, with
  its census (for the unmasked batch, whose rays are walked whole, the most
  loop iterations of a lane in each window) and the check that every output
  equals the shipped library's; then each on the same rays longest first
  (by the plain version's moves) and on the 32 longest alone (their most
  moves, and the microseconds per move of that lone warp).  A parent
  checkout's K3s is timed alone with ``apps/kernel_times.py``.

Usage: python -m raytrace_tpu_torch.apps.march_lanes [--rounds 2]
[--reps 10] [--size 1024] [--part all|rule|order|split|k3s]
(needs a CUDA GPU)
"""

from __future__ import annotations

import argparse
import json
import re
import shutil

import torch

from .. import _build
from ..ops import integrate, lighting, path_vol, trace_hf, trace_vol
from ..render.camera import Camera
from ..render.pipeline import Pipeline, unpack_uniforms
from ..testing.census import lane_use, static_warp_iterations
from ..testing.measure import call_ms, card, kernel_ms, same

RULES = {"i": "idle == 0xffffffffu", "ii": "idle != 0u", "iii": "__popc(idle) >= 16"}
_BODY = re.compile(r"(bool refill_now\(unsigned idle\) \{\s*return )[^;]*;")
_KERNEL = {"k1": "march_paths_kernel", "k3": "march_paths_vol_kernel",
           "k3s": "trace_rays_vol_kernel", "k4": "trace_hf_kernel"}
_K3S = "trace_rays_vol.cu"


def _rule(rule: str):
    return lambda text: _BODY.subn(lambda m: m.group(1) + RULES[rule] + ";", text)


# K3s's variants: variant -> the edit of its source (the shipped kernel
# refills on rule iii).
VARIANTS = {"shipped": None, "rule_i": _rule("i"), "rule_ii": _rule("ii")}


def _library(tag: str, edits: dict):
    """The kernel library built from a copy of ``csrc/`` under
    ``build/<tag>`` with ``edits`` (source file -> edit, each of which must
    change its source once)."""
    csrc = _build.BUILD_DIR / tag / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build._CSRC, csrc)
    for name, edit in edits.items():
        src = csrc / name
        text, count = edit(src.read_text())
        if count != 1:
            raise RuntimeError(f"{name}: the {tag} edit does not apply")
        src.write_text(text)
    shipped = _build._CSRC
    _build._CSRC, _build._lib = csrc, None
    try:
        return _build.kernels()
    finally:
        _build._CSRC = shipped


def _rule_library(rule: str):
    """The kernel library built with ``rule`` in K3's and K4's refill_now."""
    return _library(f"refill_{rule}", {name: _rule(rule)
                                       for name in ("trace_vol.cu", "trace_hf.cu")})


def _camera() -> Camera:
    cam = Camera(origin=[-30.0, -100.0, 60.0])
    cam.pitch = -0.3
    return cam


def _k1_items(size: int):
    """K1's call at the fused path's view -> (call(items, census, legs),
    moves per path, work(legs): the plain version's moves and fine steps per
    path, its paths cut after ``legs`` legs)."""
    pipe = Pipeline(width=size, height=size, tracer="fused")
    cam = _camera()
    pipe.teleport(cam)
    pipe.converge_streaming((cam.origin[0], 0, cam.origin[2]), max_moves=32)
    pipe.draw_frame(cam, 0.6)
    uniforms = unpack_uniforms(torch.from_numpy(pipe.uniforms.packed()).to(pipe.device))
    origin, direction, nw, *rest = lighting.march_inputs(
        pipe.tables(), pipe.blue_noise, uniforms, size, size)["march"]
    legs = 1 + 2 * pipe.bounces
    work = lighting.march_paths_plain(origin, direction, nw, *rest, pipe.max_steps,
                                      pipe.seed, legs)[2]

    def call(items=None, census=None, legs=legs):
        o, d, w = ((origin, direction, nw) if items is None else
                   (origin[items].contiguous(), direction[items].contiguous(),
                    nw[items].contiguous()))
        return lighting.march_paths(o, d, w, *rest, pipe.max_steps, pipe.seed, legs,
                                    census=census)

    def work_of(legs):
        return lighting.march_paths_plain(origin, direction, nw, *rest, pipe.max_steps,
                                          pipe.seed, legs)[2]

    return call, work[:, 0], work_of


def _k3_items(size: int):
    """K3's call at the volume_fast path's view -> (call(items, census),
    moves per path)."""
    pipe = Pipeline(width=size, height=size, tracer="volume_fast")
    cam = _camera()
    pipe.teleport(cam)
    pipe.draw_frame(cam, 0.6)
    uniforms = unpack_uniforms(torch.from_numpy(pipe.uniforms.packed()).to(pipe.device))
    origin, direction, inv, *rest = path_vol.march_inputs(
        pipe.vol_tables(), pipe.blue_noise, uniforms, size, size)["march"]
    legs = path_vol.legs_of(pipe.bounces)
    moves = trace_vol.march_paths_vol_plain(origin, direction, inv, *rest, pipe.max_steps,
                                            legs)[-1]

    def call(items=None, census=None):
        o, d, v = ((origin, direction, inv) if items is None else
                   (origin[items].contiguous(), direction[items].contiguous(),
                    inv[items].contiguous()))
        return trace_vol.march_paths_vol(o, d, v, *rest, pipe.max_steps, legs, census=census)

    return call, moves


def _k4_items(size: int):
    """K4's calls on the batches of the hf path's frame -> [(call(items,
    census), moves per ray)], primaries first."""
    pipe = Pipeline(width=size, height=size, tracer="hf")
    cam = _camera()
    pipe.teleport(cam)
    pipe.converge_streaming((cam.origin[0], 0, cam.origin[2]), max_moves=32)
    pipe.draw_frame(cam, 0.6)
    uniforms = unpack_uniforms(torch.from_numpy(pipe.uniforms.packed()).to(pipe.device))
    tables = pipe.tables()
    batches = []

    def trace(o, d, active=None):
        batches.append((o.reshape(-1, 3), d.reshape(-1, 3),
                        None if active is None else active.reshape(-1)))
        caps = () if active is None else trace_hf.COMPACT_CAPS
        return trace_hf.trace_rays_hf(tables, o, d, uniforms["lr"], pipe.max_steps,
                                      pipe.seed, caps=caps, active=active)

    integrate.integrate_gbuffers(trace, pipe.blue_noise, uniforms, size, size,
                                 bounces=pipe.bounces)
    out = []
    for o, d, active in batches:
        caps = () if active is None else trace_hf.COMPACT_CAPS
        args = (tables, o, d, uniforms["lr"], pipe.max_steps, pipe.seed, caps, active)
        moves = trace_hf.trace_rays_hf_plain(*args)["work"][..., 0]

        def call(items=None, census=None, o=o, d=d, active=active, caps=caps):
            if items is not None:
                o, d = o[items].contiguous(), d[items].contiguous()
                active = None if active is None else active[items].contiguous()
            return trace_hf.trace_rays_hf(tables, o, d, uniforms["lr"], pipe.max_steps,
                                          pipe.seed, caps=caps, active=active,
                                          census=census)

        out.append((call, moves))
    return out


def _k3s_items(size: int):
    """K3s's calls on the batches of the staged volume frame at the
    volume_fast path's view -> [(call(items, census), moves per ray)],
    primaries first."""
    pipe = Pipeline(width=size, height=size, tracer="volume_fast")
    cam = _camera()
    pipe.teleport(cam)
    pipe.draw_frame(cam, 0.6)
    uniforms = unpack_uniforms(torch.from_numpy(pipe.uniforms.packed()).to(pipe.device))
    volume, tables = pipe.world()
    batches = []

    def trace(o, d, active=None):
        batches.append((o.reshape(-1, 3), d.reshape(-1, 3),
                        None if active is None else active.reshape(-1)))
        return trace_vol.trace_rays_vol(tables, volume, o, d, uniforms["lr"], pipe.max_steps,
                                        active=active)

    integrate.integrate_gbuffers(trace, pipe.blue_noise, uniforms, size, size,
                                 bounces=pipe.bounces)
    out = []
    for o, d, active in batches:
        moves = trace_vol.trace_rays_vol_plain(tables, volume, o, d, uniforms["lr"],
                                               pipe.max_steps, active=active)["moves"]

        def call(items=None, census=None, o=o, d=d, active=active):
            if items is not None:
                o, d = o[items].contiguous(), d[items].contiguous()
                active = None if active is None else active[items].contiguous()
            return trace_vol.trace_rays_vol(tables, volume, o, d, uniforms["lr"],
                                            pipe.max_steps, active=active, census=census)

        out.append((call, moves))
    return out


def _flat(out) -> list:
    return list(out.values()) if isinstance(out, dict) else list(out)


def _in_turns(names, rounds: int) -> list:
    """``names`` in turns: forward, then backward, ``rounds`` times."""
    names = list(names)
    return [n for k in range(rounds) for n in (names if k % 2 == 0 else reversed(names))]


def _kernel(name: str) -> str:
    return _KERNEL[name.split("_")[0]]


def _rule_part(label, size, items, rounds, reps) -> dict:
    want = {name: _flat(call()) for name, (call, _) in items.items()}
    shipped = _build.kernels()
    libs = {rule: _rule_library(rule) for rule in RULES}
    timed = [name for name in items if name != "k1"]  # K1 has no refill rule
    res = {rule: {name: dict(call_ms=[], kernel_ms=[]) for name in timed} for rule in RULES}
    for rule in _in_turns(RULES, rounds):
        _build._lib = libs[rule]
        for name in timed:
            call, moves = items[name]
            r = res[rule][name]
            if "lane_use" not in r:
                # K3's census also counts its moves (census[1]); K4's is one word.
                census = torch.zeros(2 if name == "k3" else 1, dtype=torch.int64,
                                     device="cuda")
                if not all(same(a, b) for a, b in zip(_flat(call(census=census)), want[name])):
                    raise RuntimeError(f"rule {rule}: {name} differs from the shipped kernel")
                total, iters = int(moves.sum(dtype=torch.int64)), int(census[0])
                r.update(warp_iterations=iters, lane_use=lane_use(total, iters))
            r["call_ms"].append(call_ms(call, reps))
            r["kernel_ms"].append(kernel_ms(call, reps, _kernel(name)))
    _build._lib = shipped
    for rule in RULES:
        print(json.dumps(dict(part="rule", rule=rule, expr=RULES[rule], card=label, size=size,
                              **res[rule])), flush=True)
    return res


def _order_part(label, size, items, reps) -> dict:
    orders = {}
    for name, (call, moves) in items.items():
        longest = torch.argsort(moves.reshape(-1), descending=True)
        kernel = _kernel(name)
        orders[name] = dict(
            longest_moves=int(moves.max()),
            index_order_ms=kernel_ms(call, reps, kernel),
            longest_first_ms=kernel_ms(lambda: call(longest), reps, kernel),
            longest_32_alone_ms=kernel_ms(lambda: call(longest[:32]), reps, kernel))
    print(json.dumps(dict(part="order", card=label, size=size, **orders)), flush=True)
    return orders


def _split_part(label, size, k1_call, k1_work, reps) -> dict:
    split = {}
    for legs in (1, 3, 5):
        moves, heights, _ = (int(v) for v in k1_work(legs).sum(0, dtype=torch.int64))
        split[f"legs_{legs}"] = dict(
            kernel_ms=kernel_ms(lambda: k1_call(legs=legs), reps, _KERNEL["k1"]),
            moves=moves, fine_steps=heights)
    print(json.dumps(dict(part="split", card=label, size=size, k1=split)), flush=True)
    return split


def _k3s_part(label, size, rounds, reps) -> dict:
    """K3s's variants on the staged volume frame's batches: in index order
    in turns (with census and the check against the shipped library), then
    longest first and the 32 longest alone."""
    batches = _k3s_items(size)
    kernel = _KERNEL["k3s"]
    want = [_flat(call()) for call, _ in batches]
    shipped = _build.kernels()
    libs = {name: shipped if edit is None else _library(f"k3s_{name}", {_K3S: edit})
            for name, edit in VARIANTS.items()}
    res = {name: [dict(kernel_ms=[]) for _ in batches] for name in VARIANTS}
    for name in _in_turns(VARIANTS, rounds):
        _build._lib = libs[name]
        for (call, moves), r, w in zip(batches, res[name], want):
            if "moves" not in r:
                census = torch.zeros(1, dtype=torch.int64, device="cuda")
                if not all(same(a, b) for a, b in zip(_flat(call(census=census)), w)):
                    raise RuntimeError(f"k3s {name} differs from the shipped kernel")
                total, static = int(moves.sum(dtype=torch.int64)), static_warp_iterations(moves)
                iters = int(census.item())
                r.update(rays=moves.numel(), moves=total, static_warp_iterations=static,
                         static_lane_use=lane_use(total, static), warp_iterations=iters,
                         lane_use=lane_use(total, iters))
            r["kernel_ms"].append(kernel_ms(call, reps, kernel))
    for name in VARIANTS:
        _build._lib = libs[name]
        for (call, moves), r in zip(batches, res[name]):
            longest = torch.argsort(moves.reshape(-1), descending=True)
            lone = int(moves.reshape(-1)[longest[0]])
            r.update(longest_first_ms=kernel_ms(lambda: call(longest), reps, kernel),
                     longest_32_ms=kernel_ms(lambda: call(longest[:32]), reps, kernel),
                     longest_32_moves=lone)
            r["longest_32_us_per_move"] = r["longest_32_ms"] * 1e3 / max(lone, 1)
        mean = lambda xs: sum(xs) / len(xs)
        print(json.dumps(dict(
            part="k3s", variant=name, card=label, size=size, batches=res[name],
            frame_ms=sum(mean(r["kernel_ms"]) for r in res[name]),
            longest_first_frame_ms=sum(r["longest_first_ms"] for r in res[name]))), flush=True)
    _build._lib = shipped
    return res


PARTS = ("rule", "order", "split", "k3s")


def run(rounds: int = 2, reps: int = 10, size: int = 1024, part: str = "all") -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the march lanes need a CUDA GPU")
    label = card()
    parts = PARTS if part == "all" else (part,)
    out = {}
    if set(parts) & {"rule", "order", "split"}:
        k1_call, k1_moves, k1_work = _k1_items(size)
        items = {"k1": (k1_call, k1_moves), "k3": _k3_items(size)}
        for b, item in enumerate(_k4_items(size)):
            items[f"k4_b{b}"] = item
    if "rule" in parts:
        out["rules"] = _rule_part(label, size, items, rounds, reps)
    if "order" in parts:
        out["orders"] = _order_part(label, size, items, reps)
    if "split" in parts:
        out["split"] = _split_part(label, size, k1_call, k1_work, reps)
    if "k3s" in parts:
        out["k3s"] = _k3s_part(label, size, rounds, reps)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--part", choices=("all",) + PARTS, default="all")
    args = ap.parse_args()
    run(args.rounds, args.reps, args.size, args.part)


if __name__ == "__main__":
    main()
