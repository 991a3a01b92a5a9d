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

``--part glue`` times the frame's glue kernels instead (the fused and
volume_fast pipelines' tables and uniforms):

- R1 (``frame_rays_kernel``) alone in each form (fused, volume, hf) at 8x8
  (little more than the grid's block of frame scalars), 512², 1024²,
  1920x1080 and a 270-row band of the 4K frame;
- S1 (``shade_fused_kernel``, and ``sky_table_kernel`` where the
  checkout has it) alone at ``--size`` on the fused frame's K1 outputs
  (``main``) and on the same words made all sky, all terrain with every
  weight set, all terrain with no weight set, and on the main words under
  a night sun (negative sunlight), each against its plain version bit for
  bit (``equal``), with each mix's share of sky pixels and of set bounce
  weights;
- where the checkout has them, ``finalize_frame`` (F1, ``finalize_kernel``)
  alone on the main G-buffers' denoised light, and ``denoise_chain``'s
  call;
- the SASS counts (``measure.sass_counts``) of those kernels.

``--part dda`` times the exact DDA at the ``volume`` pipeline's view: the
whole frame eager (``render_frame_packed``, as a parent checkout without D1 runs
it) and, where the checkout has D1 (``trace_dda.march_rays_dda``), the
graphed ``draw_frame`` and D1 alone (``trace_dda_kernel``) on each
of the frame's three batches (``dda_batches``: the primaries and the two
bounce pairs) beside the launch floor of its grid, its moves, lane use and the volume
words it reads (``dda_census``) and its bound (``dda_work``).

``--part counters`` times K1 and K3 alone on the fused and volume_fast
frames' march inputs without and with their census (warp iterations and
moves, taken as each warp exits: what the frame program counts in every
frame), in turns (without, with, with, without, twice over): ``null_ms``
and ``set_ms``, and ``cost_pct``, the median with over the median
without, less 1, in %.

``--part tiles`` times the tile stage's two kernels alone: T1
(``hf_tables_kernel``) building the tables of a packed lr and, where the
checkout's ``build_hf_tables`` takes a ``key``, skipping them; G1
(``worldgen_kernel``) on a streamed slab and a teleport's region, and its
box mode (``worldgen_box_kernel``) on a 64³ chunk, a 512x64x64 row and a
256³ box, and, where the checkout's ``generate_box`` takes
``with_minefield``, its form for any box without the minefield
(``worldgen_box_kernel<false>``; each call launches one form) on a chunk,
an unaligned 100x77x45 box and the 256³ box; O1 on the generated world around the origin, in place as
``Pipeline.vol_tables`` calls it: a slab update at texel 240 on array axes 0
and 2 and at texel 8 on axis 2, and a full build (``vol_tables_kernel``, one
launch a call; in a checkout of the two-launch O1 its ``vol_bricks_kernel``
and ``vol_pyramid_kernel`` apart and summed); and, where the checkout has
``measure.launch_floor_ms``, the launch floor of each kernel's grid (an
empty kernel on the same blocks).

It prints one JSON line with the card's name and power limit.  It uses only
the wrappers' calls and ``denoise.chain_passes``, so it also runs in a
checkout of an earlier commit that has them, to compare its kernels with
these (copy this file, ``testing/measure.py`` and ``testing/gbuffers.py``
into it).

Usage: python -m raytrace_tpu_torch.apps.kernel_times [--reps 10]
[--part fused|volume|counters|glue|tiles|dda|all]   (needs a CUDA GPU)
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from .. import _build
from ..ops import (
    denoise, finalize, integrate, lighting, path_vol, rays, shading, trace_dda, trace_vol)
from ..render.camera import Camera
from ..render.pipeline import Pipeline, render_frame_packed, unpack_uniforms
from ..testing.gbuffers import random_gbuffers
from ..testing.measure import call_ms, card, denoise_pass_ms, kernel_ms, same, sass_counts


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
    if part in ("counters", "all"):
        res.update(_counters(reps, size))
    if part in ("glue", "all"):
        res.update(_glue(reps, size))
    if part in ("tiles", "all"):
        res.update(_tiles(reps))
    if part in ("dda", "all"):
        res.update(_dda(reps, size))
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

        integrate.integrate_gbuffers(trace, pipe.blue_noise, uniforms, size, size,
                                     bounces=pipe.bounces)
        per_batch = [kernel_ms(lambda: trace_vol.trace_rays_vol(
            tables, volume, o, d, uniforms["lr"], pipe.max_steps, active=a), reps,
            "trace_rays_vol_kernel") for o, d, a in batches]
        res["k3s"] = dict(kernel_ms=per_batch, frame_kernel_ms=sum(per_batch))
    return res


COUNTER_TURNS = 4  # rounds of (without, with) or (with, without)


def _census_cost(call, reps: int, kernel: str) -> dict:
    """``kernel`` alone, launched by ``call(census)`` with no census and with
    a (2,) one, in turns."""
    import statistics

    census = torch.zeros(2, dtype=torch.int64, device="cuda")
    got = dict(null_ms=[], set_ms=[])
    for k in range(COUNTER_TURNS):
        for which in (("null", "set") if k % 2 == 0 else ("set", "null")):
            arg = census if which == "set" else None
            got[f"{which}_ms"].append(kernel_ms(lambda: call(arg), reps, kernel))
    got["cost_pct"] = 100.0 * (statistics.median(got["set_ms"])
                               / statistics.median(got["null_ms"]) - 1.0)
    return got


def _counters(reps: int, size: int) -> dict:
    pipe, uniforms = _pipeline(size, "fused")
    march = lighting.march_inputs(pipe.tables(), pipe.blue_noise, uniforms, size, size)["march"]
    budget = (pipe.max_steps, pipe.seed, 1 + 2 * pipe.bounces)
    k1 = _census_cost(lambda census: lighting.march_paths(*march, *budget, census=census),
                      reps, "march_paths_kernel")
    del pipe, march
    vpipe, vuniforms = _pipeline(size, "volume_fast")
    vmarch = path_vol.march_inputs(vpipe.world()[1], vpipe.blue_noise, vuniforms, size,
                                   size)["march"]
    legs = path_vol.legs_of(vpipe.bounces)
    k3 = _census_cost(lambda census: trace_vol.march_paths_vol(
        *vmarch, vpipe.max_steps, legs, census=census), reps, "march_paths_vol_kernel")
    return dict(counters=dict(k1=k1, k3=k3))


# R1's shapes: label -> (width, height, row0, rows).
R1_SHAPES = {"8x8": (8, 8, 0, 8), "512": (512, 512, 0, 512), "1024": (1024, 1024, 0, 1024),
             "1920x1080": (1920, 1080, 0, 1080), "4k_band_1080+270": (3840, 2160, 1080, 270)}
# S1's path bits (meta >> 12): p_air, then the weights a1 .. a4.
P_AIR, WEIGHTS = 1 << 12, 0b11110 << 12
NIGHT_SUN = -2.0  # a sun angle whose sunlight has negative components


def _glue(reps: int, size: int) -> dict:
    pipe, uniforms = _pipeline(size, "fused")
    vpipe, _ = _pipeline(size, "volume_fast")
    hf_tables, vol_tables = pipe.tables(), vpipe.world()[1]
    r1 = {}
    for label, (w, h, row0, rows) in R1_SHAPES.items():
        for form, tables in (("fused", hf_tables), ("volume", vol_tables), ("hf", hf_tables)):
            call = lambda: rays.frame_rays(uniforms, pipe.blue_noise, w, h, row0, rows,
                                           tables=tables, form=form)
            r1[f"{form}_{label}"] = kernel_ms(call, reps, "frame_rays_kernel")
    frame = lighting.march_inputs(hf_tables, pipe.blue_noise, uniforms, size, size)
    meta, pd = lighting.march_paths(*frame["march"], pipe.max_steps, pipe.seed,
                                    1 + 2 * pipe.bounces)
    night = dict(frame["shade"], sun=shading.sun_vector(
        torch.tensor(NIGHT_SUN, dtype=torch.float32, device=pipe.device)))
    mixes = dict(main=(meta, frame["shade"]), all_sky=(meta | P_AIR, frame["shade"]),
                 all_weight=((meta & ~P_AIR) | WEIGHTS, frame["shade"]),
                 zero_weight=(meta & ~(P_AIR | WEIGHTS), frame["shade"]),
                 night=(meta, night))
    # S1's kernels: the shade, and the frame's table of bounce skies where
    # the checkout has it.
    names = ("shade_fused_kernel",) + (
        ("sky_table_kernel",) if hasattr(lighting, "SKY_TABLE_ENTRIES") else ())
    s1 = {}
    for label, (words, kw) in mixes.items():
        terrain = (words & P_AIR) == 0
        call = lambda: lighting.shade(words, pd, **kw)
        got, want = call(), lighting.shade_plain(words, pd, **kw)
        bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t.to(torch.int32)
        times = dict(equal=all(same(bits(got[k]), bits(want[k])) for k in want),
                     **{name: kernel_ms(call, reps, name) for name in names})
        s1[label] = dict(**times, sky_share=float((~terrain).float().mean()),
                         a2_share=float((terrain & (((words >> 14) & 1) == 1)).float().mean()),
                         a4_share=float((terrain & (((words >> 16) & 1) == 1)).float().mean()),
                         night_sunlight=[float(v) for v in kw["sun"][3:6]])
    res = dict(r1_kernel_ms=r1, s1=s1)
    if hasattr(finalize, "finalize_frame"):
        gb = pipe.gbuffers
        den = denoise.denoise_chain(gb["lighting"], gb["depth"], gb["normal"])
        f1 = lambda: finalize.finalize_frame(gb["albedo"], gb["emission"], gb["fog"], den,
                                             gb["depth"], pipe.blue_noise)
        res["f1"] = dict(kernel_ms=kernel_ms(f1, reps, "finalize_kernel"),
                         call_ms=call_ms(f1, reps),
                         chain_call_ms=call_ms(lambda: denoise.denoise_chain(
                             gb["lighting"], gb["depth"], gb["normal"]), reps))
    _build.build()
    names = ("frame_rays_kernel", "shade_fused_kernel", "sky_table_kernel",
             "finalize_kernel")
    res["sass"] = {name: v for k, v in sass_counts(Path(_build.build_info["path"])).items()
                   for name in names if name in k}
    return res


# G1's timed boxes: (label, origin, shape): the slab and the region
# chip_smoke.py times, then its box mode's chunk, row and 256³ box.
G1_BOXES = [("slab", "into", 2), ("region", "into", -2),
            ("chunk", "box", ((0, 0, 0), (64, 64, 64))),
            ("row_512", "box", ((-256, 64, 0), (512, 64, 64))),
            ("box_256", "box", ((-128, -128, -128), (256, 256, 256))),
            ("chunk_bare", "bare", ((0, 0, 0), (64, 64, 64))),
            ("unaligned_bare", "bare", ((-37, 21, -5), (100, 77, 45))),
            ("box_256_bare", "bare", ((-128, -128, -128), (256, 256, 256)))]


def _tiles(reps: int) -> dict:
    import inspect

    from ..ops import hf_tables, worldgen
    from ..render.pipeline import FrameUniforms
    from ..testing import enclosure, measure
    from ..world.generate import generate_box

    dev = torch.device("cuda")
    floors = "rt_launch_floor" in _build._SIGNATURES
    packed = torch.from_numpy(FrameUniforms(lr=(16, 0, 0), seed=3).packed()).to(dev)
    out = hf_tables.empty_tables(dev, hcol=True)
    t1 = dict(build_ms=kernel_ms(lambda: hf_tables.build_hf_tables(
        packed, 0, out=out, hcol=True), reps, "hf_tables_kernel"))
    if "key" in inspect.signature(hf_tables.build_hf_tables).parameters:
        key = torch.zeros(4, dtype=torch.int32, device=dev)
        t1["skip_ms"] = kernel_ms(lambda: hf_tables.build_hf_tables(
            packed, 0, out=out, hcol=True, key=key), reps, "hf_tables_kernel")
    if floors:
        t1["floor_ms"] = measure.launch_floor_ms(
            hf_tables.T1_BLOCKS, hf_tables.STRIP_THREADS, True, reps)
        t1["parent_grid_floor_ms"] = measure.launch_floor_ms((64, 1), 1024, False, reps)
    g1 = {}
    volume = torch.zeros(256 ** 3, dtype=torch.int32, device=dev)
    bare = "with_minefield" in inspect.signature(generate_box).parameters
    for label, mode, box in G1_BOXES:
        if mode == "bare" and not bare:  # a checkout without the form for any box
            continue
        if mode == "into":
            _, origin, ns, axis, seed = enclosure.STREAM_CASES[box]
            w0, shape = enclosure.stream_box(origin, ns, axis)
            call, name = lambda: worldgen.generate_into(volume, w0, shape, seed), \
                "worldgen_kernel"
        elif mode == "box":
            w0, shape = box
            call, name = lambda: generate_box(w0, shape, seed=0, device=dev), \
                "worldgen_box_kernel"
        else:
            w0, shape = box
            call, name = lambda: generate_box(w0, shape, 0, False, device=dev), \
                "worldgen_box_kernel"
        g1[label] = dict(w0=list(w0), shape=list(shape), kernel_ms=kernel_ms(call, reps, name))
        if floors:
            grid = measure.worldgen_grid(w0, shape)
            g1[label].update(grid=grid, floor_ms=measure.launch_floor_ms(
                grid["blocks"], grid["threads"], True, reps))
    return dict(t1=t1, g1=g1, o1=_o1(reps, floors))


# O1's timed calls: (label, array axis, texel start); no axis is a full build.
O1_CALLS = [("update_axis0_t240", 0, 240), ("update_axis2_t240", 2, 240),
            ("update_axis2_t8", 2, 8), ("build", None, None)]
# The two-launch O1's kernels and their block sizes.
O1_PARENT_KERNELS = (("bricks", "vol_bricks_kernel", 256), ("pyramid", "vol_pyramid_kernel", 1024))


def _o1(reps: int, floors: bool) -> dict:
    from ..ops import vol_tables as vt
    from ..ops.volume import fuse_volume
    from ..testing import measure
    from ..world.generate import generate_box

    dev = torch.device("cuda")
    box = generate_box((-128,) * 3, (256,) * 3, seed=0, device=dev)
    volume = fuse_volume(box["materials"], box["minefield"])
    tables = vt.build_vol_tables(volume)
    one_launch = hasattr(vt, "launch_grid")
    res = {}
    for label, axis, t in O1_CALLS:
        if axis is None:
            call, bricks = lambda: vt.build_vol_tables(volume, out=tables), [(0, vt.NB)] * 3
        else:
            call = lambda: vt.update_vol_tables(tables, volume, t, axis, out=tables)
            bricks = [(0, vt.NB)] * 3
            bricks[axis] = (t >> 3, 2)
        if one_launch:
            rec = dict(kernel_ms=kernel_ms(call, reps, "vol_tables_kernel"))
            if floors:
                grid = vt.launch_grid(bricks)
                rec.update(grid=grid, floor_ms=measure.launch_floor_ms(
                    grid["blocks"], grid["threads"], False, reps))
        else:
            rec = {f"{part}_ms": kernel_ms(call, reps, name)
                   for part, name, _ in O1_PARENT_KERNELS}
            rec["kernel_ms"] = rec["bricks_ms"] + rec["pyramid_ms"]
            if floors:
                # A warp per 4 bricks side by side in x, then one block.
                (_, nbz), (_, nby), (bx0, nbx) = bricks
                warps = nbz * nby * (((bx0 + nbx + 3) >> 2) - (bx0 >> 2))
                blocks = dict(bricks=(warps * 32 + 255) // 256, pyramid=1)
                for part, _, threads in O1_PARENT_KERNELS:
                    rec[f"{part}_grid"] = dict(blocks=(blocks[part], 1), threads=threads)
                    rec[f"{part}_floor_ms"] = measure.launch_floor_ms(
                        (blocks[part], 1), threads, False, reps)
        res[label] = rec
    return res


# float32 operations of one D1 move (add, sub, mul, div, floor, abs each 1;
# counted from csrc/trace_dda.cu, at least): the three boundary distances
# (8 each), the move (6), the texel (6) and the window test (6).
OPS_PER_DDA_MOVE = 42


def dda_batches(volume, blue_noise, uniforms: dict, width: int, height: int,
                max_steps: int, bounces: int) -> list:
    """The exact frame's batches as ``trace_dda.render_gbuffers`` hands
    them to D1: (origin, direction, active) of the primaries and of each
    bounce's pair."""
    f = rays.frame_rays(uniforms, blue_noise, width, height, tables=None, form="dda")
    batches = []

    def trace(o, d, active):
        batches.append((o, d, active))
        return trace_dda.march_rays_dda(volume, o, d, active, uniforms["lr"], max_steps)[0]

    integrate.stage_gbuffers(trace, integrate.DDA, f, f["nw"], uniforms["origin"], bounces,
                             (height, width))
    return batches


def dda_work(rays_n: int, masked: bool, moves: int, words: int) -> tuple:
    """(bytes, float32 operations) that D1 needs for ``rays_n`` rays making
    ``moves`` moves in all and reading ``words`` distinct volume words: each
    ray's origin and direction (and flag, in a masked batch) read once, its
    hit written once (21 bytes), ``lr``, and each word read once."""
    return (rays_n * (24 + int(masked) + 21) + 12 + 4 * words,
            OPS_PER_DDA_MOVE * moves)


# Set bits of each byte value.
_POPCOUNT = torch.tensor([bin(v).count("1") for v in range(256)], dtype=torch.int64)


def dda_census(volume, o, d, active, lr, max_steps) -> dict:
    """One D1 launch with its census and touched bitmap: the batch's
    ``moves``, its warps' ``lane_use`` (moves / 32 x each warp's longest
    ray's) and ``words``, the distinct volume words its rays read."""
    dev = o.device
    census = torch.zeros(2, dtype=torch.int64, device=dev)
    touched = torch.zeros(256 ** 3 // 32, dtype=torch.int32, device=dev)
    trace_dda.march_rays_dda(volume, o, d, active, lr, max_steps, census, touched)
    moves, warp_moves = census.tolist()
    words = int(_POPCOUNT.to(dev)[touched.view(torch.uint8).long()].sum())
    return dict(moves=moves, warp_moves=warp_moves,
                lane_use=moves / max(1, 32 * warp_moves), words=words)


def _dda(reps: int, size: int) -> dict:
    from ..testing import measure

    pipe, uniforms = _pipeline(size, "volume")
    volume = pipe.world()
    packed = torch.from_numpy(pipe.uniforms.packed()).to(pipe.device)
    eager = lambda: render_frame_packed(volume, pipe.blue_noise, packed, size, size,
                                        pipe.max_steps, pipe.seed, pipe.bounces, "volume")
    res = dict(frame_eager_ms=call_ms(eager, reps))
    if not hasattr(trace_dda, "march_rays_dda"):  # a checkout without D1: eager only
        return dict(dda=res)
    cam = Camera(origin=[-30.0, -100.0, 60.0])
    cam.pitch = -0.3
    res["frame_graphed_ms"] = call_ms(lambda: pipe.draw_frame(cam, 0.6), reps)
    res["batches"] = []
    for o, d, a in dda_batches(volume, pipe.blue_noise, uniforms, size, size, pipe.max_steps,
                               pipe.bounces):
        d1 = lambda: trace_dda.march_rays_dda(volume, o, d, a, uniforms["lr"], pipe.max_steps)
        work = dda_census(volume, o, d, a, uniforms["lr"], pipe.max_steps)
        n = o.shape[0]
        blocks = (n + 255) // 256
        res["batches"].append(dict(
            rays=n, kernel_ms=kernel_ms(d1, reps, "trace_dda_kernel"), call_ms=call_ms(d1, reps),
            floor_ms=measure.launch_floor_ms((blocks, 1), 256, False, reps), **work,
            **measure.bound(*dda_work(n, a is not None, work["moves"], work["words"]))))
    res["frame_kernel_ms"] = sum(b["kernel_ms"] for b in res["batches"])
    return dict(dda=res)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--part", choices=("fused", "volume", "counters", "glue", "tiles", "dda",
                                       "all"),
                    default="all")
    args = ap.parse_args()
    run(args.reps, args.size, args.part)


if __name__ == "__main__":
    main()
