#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (raytrace_tpu_torch) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It builds the
CUDA kernels from ``raytrace_tpu_torch/csrc``, holds each kernel against its
plain PyTorch version at the shapes the frame gives it (first T1, the
region tables, word for word at eleven regions, and through a key that
skips the build of the region the tables hold, ``hf_tables_kernel``; G1,
the streamed slabs and regions written in place, word for word against
its plain version and the old enclosure-and-roll path,
``worldgen_kernel``; G1's box mode, ``generate_box`` on the card, word
for word against ``generate_box_plain`` on chunks, 512- and 4096-wide
rows and a 256³ box, ``generate_box_kernel``; O1, the occupancy tables
built and updated in place in one launch, against the plain build and
update at texels 0, 8, 120 and 240, along a chain of updates and across
all-solid bricks made air and solid again, ``vol_tables_kernel``),
holds JAX's public ``denoise_chain`` (six K2 launches) and
``finalize_frame`` (F1, one launch) to their plain versions on the main
path's G-buffers, whole, in a band and unflipped (``finalize_kernel``),
renders the 64² golden frame, then drives the frame paths through
``create_instance`` -> ``teleport`` -> ``draw_frame`` at 1024²: 20 frames
of the heightfield path (``tracer="fused"``: T1, K1, K2 in each frame's
graph), of the volume path (``tracer="volume_fast"``:
the streamed volume, its occupancy tables, K3, K2) and of the staged
heightfield path (``tracer="hf"``: R1, K4 once per leg batch with the leg
batch P1 between, the shade S2, K2), an edit of the volume, and 20 frames
of the exact DDA (``tracer="volume"``: R1, D1 once per leg batch, P1, S2,
K2, one graph replay a frame, each against an eager twin), with D1 held to
its plain version on that path's three 1024² batches at max_steps 2048 and
64, on config 1's, on edge batches and in a CUDA graph replayed twice
(``dda_kernel``).  On the volume path's
own volume, tables and uniforms it also drives the staged volume tracer:
K3s against its plain version on the three 1024² leg batches and, at tight
round budgets (rounds 1-3, caps 2 and 8), on the 256² batches and one 1024²
pair batch, 20 frames of ``render_gbuffers_vol`` + denoise (R1, K3s three
times a frame, P1 twice, S2), and the staged G-buffers against K3's
whole-path ones.  P1 and S2 are held to their plain versions on the
records of the hf, staged volume and exact DDA frames, config 2's, bands'
and random ones (``staged_glue_kernel``).  It
holds the column table K1 reads equal to the plain march's heights on
every column of each region it renders, and renders a fused frame from
bare region tables.  Then the apps: the host codec (``native_codec``),
``generate_world`` and a cache-streamed ``volume_fast`` pipeline held bit
for bit to a device-streamed one (``cache_stream``; the chunk misses
through G1's box mode), each kernel against its plain version at the
apps' shapes (``app_shapes_*``: 1920x1080 b1, 512² b0 and b2), the
benchmark's configs 1-4 (``benchmark_configs``: each with
``exhausted_px`` 0; configs 1 (volume_fast and the exact DDA) and 2 one CUDA
graph replay a frame, each against an eager twin, bit for bit), ``capture`` (its four-deep pinned
readback against a synchronous one, PNGs against the ``.dat`` bytes),
``flythrough`` (scripted, and the ``b`` edit), ``debug_view --gbuffers``
and ``stage_times``.  Then the row bands and the tile split: each tracer's
bands against the same rows of its whole frame (``row_bands``), K2's
finalizing pass on a row window against plain and the tile split's band
denoise run band after band in the process (``k2_bands``: halo and gather
plans), ``render_frame_tiled`` over a one-rank NCCL group and with no
group (``tiled_nccl``), and config 5 at 3840x2160 (``config5_4k_*``: K1,
K3 and K2 against plain at the 4K width, then the config for fused and
volume_fast with its ``parity``).  Then JAX's calls (``jax_api``):
``render_frame`` of a uniforms dict with ``with_gbuffers`` on each tracer at
1024² against ``render_frame_packed`` and ``draw_frame``, ``Pipeline`` by
position in JAX's order, ``create_instance(None, ...)``, a fused pipeline
with a preloaded volume against one without, ``generate_box`` without the
minefield (G1's form for any box) word for word against its plain version
on unaligned boxes and at 256³, timed alone beside its bound, the profile
app's trace and each entry point's default device, the card.  The frame as one CUDA graph replay
(``graph_frames_*``): each graphed tracer's ``draw_frame`` against an
eager twin pipeline, bit for bit, across a slice crossing, a slab, an edit
and a teleport, with its launch counts (on the volume tracers G1 once a
slab and a teleport, on volume_fast O1 once a table rebuild or slab
update), its kernels by name
in a profiler trace, and host ms/frame graphed and eager in turns; the
march's counters that every replay of the frame graph adds to
(``frame_census_fused``, ``frame_census_volume_fast``): the moves its
recorded ``replay`` spans carry (and K1's warp iterations) against the
march's census alone on the same frames.  It times the kernels alone
(with the profiler records kept of those asked for, ``kept``) and against
their plain versions (K2 per pass of its chain), and prints
each kernel's least possible time on the card (``bound_ms``) beside its
own, the lane-use census of K1, K3, K3s and K4 (``warp_iterations``,
``lane_use``; K1's and K3's count their moves, which must be the plain
version's: ``moves_equal``), and each kernel's ptxas line and SASS
instruction counts.
It imports no JAX and nothing of the JAX package.  Any failure
raises and the script exits non-zero; with no CUDA GPU, or outside a
checkout, it exits non-zero before printing any result.  The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import math
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W = H = 1024
FRAMES = 20
CANON = dict(origin=(-30.0, -100.0, 60.0), pitch=-0.3, sun=0.6)
K1_ATOL = 1e-5  # shaded lighting, kernel against plain
VOL_DX = 1.2  # camera x step per frame on the volume path: crosses a slice
WEIRD = dict(origin=(0.0, -80.0, 40.0), pitch=-0.4, sun=0.6)  # weird scene view
HF_MATCH = 0.9999  # share of pixels whose hf (K4) and fused (K1) G-buffers agree
MAX_STEPS = 2048  # the step budget of the apps (MAX_TRACE_STEPS)
# K3s's tight round budgets: (rounds, cap), where many rays exhaust.
TIGHT = [(rounds, cap) for rounds in (1, 2, 3) for cap in (2, 8)]

# A kernel's bound is the larger of its bytes (each input read once, each
# output written once) over the card's memory rate and its float32
# operations over its float32 rate (testing/measure.py `bound`).
# float32 operations (add, sub, mul, div, sqrt, floor, abs, pow each 1; no
# compares, no integer work) counted from the CUDA sources, at least:
OPS_PER_HF_MOVE = 31  # K1, K4: a fine move (two wall distances, the top, the step, the window)
OPS_PER_HEIGHT = 88  # K4, K1's column table: height_from_corners with its perlin octave
OPS_PER_VOL_MOVE = 36  # K3: move_to_boundary, the texels and the window test
OPS_PER_TAP = 16  # K2: unpack, weight, and the three weighted channel sums
DENOISE_TAPS = 36
# T1: a lattice point's word (the five-octave field 202, the four two-octave
# slope samples 4 x 82 with their offsets and [0, 1] maps, the two
# divisions by 600 and the quantization 16; a perlin octave is 36).
OPS_PER_LATTICE = 548
# T1's regions, (lr, seed): negative and large offsets (float32 holds lr
# exactly below 2^24); lr.y off 0 only through the int32 (3,) form.
T1_REGIONS = [((0, 0, 0), 0), ((16, 0, 0), 7), ((-48, 0, 0), 0), ((1000, 0, -1000), 7),
              ((-1000, 0, 1000), 0), ((4096, 0, 64), 7), ((-70000, 0, 0), 7),
              ((1 << 20, 0, 0), 0), ((-(1 << 23), 0, 0), 7), ((256, 512, 0), 0),
              ((-64, -4096, 0), 7)]


def _canonical_uniforms(rt, view=CANON, seed=0):
    """The canonical terrain view of the JAX package's golden tests (or
    another view looking along +y)."""
    p = view["pitch"]
    return rt.render.pipeline.FrameUniforms(
        origin=view["origin"], sun_angle=view["sun"], seed=seed,
        forward=(0.0, math.cos(p), math.sin(p)),
        up=(0.0, -0.4 * math.sin(p), 0.4 * math.cos(p)), right=(0.4, 0.0, 0.0),
    )


def _kernel_name(mangled: str) -> str:
    """The ``*_kernel`` name inside a mangled entry name (its length prefix
    may follow the digits of an anonymous namespace's hash), with the
    integer arguments of a template instance ("denoise_pass_kernel<2,2>").
    Of the candidates, the last: the hash's own digits may spell a length
    that runs to the same end ("...3e76711918shade_fused_kernel")."""
    found = None
    for m in re.finditer(r"\d+", mangled):
        run = m.group()
        for k in range(len(run)):
            length = int(run[k:])
            name = mangled[m.end():m.end() + length]
            if len(name) == length and name.endswith("_kernel"):
                args = re.match(r"I((?:Li-?\d+E)+)E", mangled[m.end() + length:])
                if args:
                    name += "<" + ",".join(re.findall(r"Li(-?\d+)E", args.group(1))) + ">"
                found = name
    return found or mangled


def _ptxas(log: str) -> dict:
    """Per kernel of the build log (each template instance apart): ptxas's
    resource line (registers, stack, shared memory) and its stack frame and
    spill line."""
    frames, out, entry = {}, {}, None
    lines = log.splitlines()
    for k, ln in enumerate(lines):
        m = re.search(r"Function properties for (\w+)", ln)
        if m and k + 1 < len(lines):
            frames[m.group(1)] = lines[k + 1].strip()
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
        if entry and "registers" in ln:
            out[entry] = dict(resources=ln.split(":", 1)[1].strip(),
                              frame=frames.get(entry))
            entry = None
    return {_kernel_name(k): v for k, v in out.items()}


def _exhausted(gb, torch, lighting) -> int:
    return int((gb["depth"].to(torch.int32) == lighting.EXHAUSTED_DEPTH).sum())


def _bound(bytes_moved: float, ops: float) -> dict:
    """The least time the card could take: ``bound_ms`` and ``bound_by``."""
    from raytrace_tpu_torch.testing.measure import bound

    return bound(bytes_moved, ops)


def _census(torch, moves, census) -> dict:
    """Lane use of a kernel run (its census counter: warp iterations in
    ``census[0]``) beside that of one thread per index, 32 consecutive
    indices to a warp (the launch order of the kernels before persistent
    lanes), from the plain version's per-index moves.  K1's and K3's census
    counts the moves too (``census[1]``): ``kernel_moves``, and
    ``moves_equal``, whether they are the plain version's."""
    from raytrace_tpu_torch.testing.census import lane_use, static_warp_iterations

    total = int(moves.sum(dtype=torch.int64))
    warp_iterations = int(census[0])
    static = static_warp_iterations(moves)
    res = dict(warp_iterations=warp_iterations, lane_use=lane_use(total, warp_iterations),
               static_warp_iterations=static, static_lane_use=lane_use(total, static))
    if census.numel() == 2:
        res.update(kernel_moves=int(census[1]), moves_equal=int(census[1]) == total)
    return res


def _timed_once(torch, fn):
    """(result, device ms) of one call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _alone(fn, reps, kernel) -> dict:
    """The kernel alone (``measure.kernel_times``): its mean ms over the
    profiler records kept, and how many of the ``reps`` were kept."""
    from raytrace_tpu_torch.testing.measure import kernel_times

    times = kernel_times(fn, reps, kernel)
    return dict(kernel_ms=sum(times) / len(times), kept=f"{len(times)}/{reps}")


def _passes(gb, blue, reps) -> dict:
    """K2 alone per pass (``measure.denoise_pass_times``): ``pass_ms`` the
    means, ``pass_kept`` the profiler records kept of ``reps``."""
    from raytrace_tpu_torch.testing.measure import denoise_pass_times

    times = denoise_pass_times(gb, blue, reps)
    return dict(pass_ms={k: sum(t) / len(t) for k, t in times.items()},
                pass_kept={k: f"{len(t)}/{reps}" for k, t in times.items()})


def _wh(size):
    """(width, height) of a square ``size`` or a (width, height) pair."""
    return (size, size) if isinstance(size, int) else tuple(size)


def phase_k1(torch, tables, blue, packed, size, max_steps, seed, bounces, timed=False,
             band=None):
    """K1 against its plain version on the march inputs the frame gives it
    (``size``: square, or (width, height); ``band``: (row0, rows) of its
    image rows, default all).

    Both are built without FMA contraction, so every meta word must be
    equal, and with it the normal, albedo and shaded lighting.  K1 reads
    the column heights from the tables' column table, the plain version
    evaluates them.  Reports K1's lane-use census, whose moves must be the
    plain version's and whose warp iterations its warps' most steps (one
    thread per pixel: ``warp_iterations_equal``); ``timed``: also K1 alone
    (torch.profiler, 10 calls) and the plain version (once).
    -> (ok, res, the kernel's G-buffers)."""
    from raytrace_tpu_torch.ops import lighting
    from raytrace_tpu_torch.render.pipeline import unpack_uniforms
    from raytrace_tpu_torch.testing.census import static_warp_iterations

    frame = lighting.march_inputs(tables, blue, unpack_uniforms(packed), *_wh(size),
                                  *(band or ()))
    budget = (max_steps, seed, 1 + 2 * bounces)
    census = torch.zeros(2, dtype=torch.int64, device=packed.device)
    meta_k, pd_k = lighting.march_paths(*frame["march"], *budget, census=census)
    (meta_p, pd_p, work), t_p = _timed_once(
        torch, lambda: lighting.march_paths_plain(*frame["march"], *budget))
    gk = lighting.shade(meta_k, pd_k, **frame["shade"])
    gp = lighting.shade(meta_p, pd_p, **frame["shade"])
    dd = torch.abs(gk["depth"].to(torch.int32) - gp["depth"].to(torch.int32))
    res = dict(
        size=size, band=band, bounces=bounces, lr=[int(v) for v in frame["march"][3][2:5]],
        meta_equal=float((meta_k == meta_p).float().mean()),
        max_abs_err=float(torch.abs(gk["lighting"] - gp["lighting"]).max()),
        max_depth_diff=int(dd.max()),
        sky_px=int((gk["depth"].to(torch.int32) == 0xFFFF).sum()),
        exhausted_kernel=_exhausted(gk, torch, lighting),
        exhausted_plain=_exhausted(gp, torch, lighting),
    )
    n = meta_k.shape[0]
    moves, heights, _ = (int(v) for v in work.sum(0, dtype=torch.int64))
    res["work"] = dict(moves=moves, heights=heights)
    res["census"] = _census(torch, work[:, 0], census)
    res["census"]["warp_iterations_equal"] = (
        res["census"]["warp_iterations"] == static_warp_iterations(work[:, 2]))
    # K1 reads a fine step's height from the column table (no float work)
    # and takes the pyramid's two words, the column table and the sphere
    # table as inputs.  Building the column table is work once per region,
    # not per frame: its own bound stands beside K1's.  `parent_work` is the
    # bound of the work K1 did before it read the table (each height
    # evaluated from the four corner words): the same work as the old times.
    per_path = n * (12 + 12 + 4 + 8) + 64
    res.update(_bound(per_path + 2 * 4096 + 2 * 256 * 256 + 256 * 8, OPS_PER_HF_MOVE * moves))
    res["column_table_bound_ms"] = _bound(4 * 4096 + 2 * 256 * 256,
                                          OPS_PER_HEIGHT * 256 * 256)["bound_ms"]
    res["parent_work_bound_ms"] = _bound(
        per_path + 6 * 4096, OPS_PER_HF_MOVE * moves + OPS_PER_HEIGHT * heights)["bound_ms"]
    if timed:
        res.update(**_alone(lambda: lighting.march_paths(*frame["march"], *budget), 10,
                            "march_paths_kernel"), plain_ms=t_p)
    ok = (res["meta_equal"] == 1.0 and res["max_abs_err"] <= K1_ATOL
          and res["census"]["moves_equal"] and res["census"]["warp_iterations_equal"]
          and res["max_depth_diff"] <= 1
          and res["exhausted_kernel"] == 0 and res["exhausted_plain"] == 0)
    return ok, res, gk


def phase_k3(torch, volume, tables, blue, packed, size, max_steps, bounces, timed=False,
             band=None):
    """K3 against its plain version on the march inputs the frame gives it
    (``size``: square, or (width, height); ``band``: (row0, rows) of its
    image rows, default all).

    Both are built without FMA contraction, so the four outputs (meta word,
    primary and dif1 hit voxels, primary distance) must be equal on every
    pixel, and neither may cut a primary.  Reports K3's lane-use census,
    whose moves must be the plain version's (its warp iterations depend on
    the order in which the persistent lanes draw their windows, so nothing
    else gives them); ``timed``: also K3 alone (torch.profiler, 10 calls)
    and the plain version (once)."""
    from raytrace_tpu_torch.ops import lighting, path_vol, trace_vol
    from raytrace_tpu_torch.render.pipeline import unpack_uniforms

    legs = path_vol.legs_of(bounces)
    frame = path_vol.march_inputs(tables, blue, unpack_uniforms(packed), *_wh(size),
                                  *(band or ()))
    census = torch.zeros(2, dtype=torch.int64, device=packed.device)
    got = trace_vol.march_paths_vol(*frame["march"], max_steps, legs, census=census)
    (*want, moves), t_p = _timed_once(
        torch, lambda: trace_vol.march_paths_vol_plain(*frame["march"], max_steps, legs))
    gk = path_vol.shade(volume, *got, legs=legs, **frame["shade"])
    gp = path_vol.shade(volume, *want, legs=legs, **frame["shade"])
    names = ("meta", "prim_lin", "dif1_lin", "prim_dist")
    res = dict(
        size=size, band=band, bounces=bounces, lr=[int(v) for v in frame["march"][3][:3]],
        equal={n: float((a == b).float().mean()) for n, a, b in zip(names, got, want)},
        max_abs_err=float(torch.abs(gk["lighting"] - gp["lighting"]).max()),
        sky_px=int((gk["depth"].to(torch.int32) == 0xFFFF).sum()),
        exhausted_kernel=_exhausted(gk, torch, lighting),
        exhausted_plain=_exhausted(gp, torch, lighting),
    )
    n = got[0].shape[0]
    tables_bytes = sum(tables[k].numel() * 4 for k in ("any8", "all8", "any_hi", "detail"))
    res["work"] = dict(moves=int(moves.sum(dtype=torch.int64)))
    res["census"] = _census(torch, moves, census)
    res.update(_bound(n * (12 + 12 + 48 + 16) + 56 + tables_bytes,
                      OPS_PER_VOL_MOVE * res["work"]["moves"]))
    if timed:
        res.update(**_alone(lambda: trace_vol.march_paths_vol(
            *frame["march"], max_steps, legs), 10, "march_paths_vol_kernel"), plain_ms=t_p)
    ok = (all(v == 1.0 for v in res["equal"].values()) and res["max_abs_err"] == 0.0
          and res["census"]["moves_equal"] and 0.0 < res["census"]["lane_use"] <= 1.0
          and res["exhausted_kernel"] == 0 and res["exhausted_plain"] == 0)
    return ok, res


def _volumes(torch, dev):
    """The weird scene (slab, floating box, cave tunnel; the JAX package's
    volume tests) and the generated world around the origin, as fused
    volumes at lr = 0."""
    from raytrace_tpu_torch.ops.volume import fuse_volume
    from raytrace_tpu_torch.world.chunk import minefield_from_solid
    from raytrace_tpu_torch.world.generate import PACKED_ROCK

    solid = torch.zeros((256, 256, 256), dtype=torch.bool, device=dev)
    solid[:100] = True
    solid[140:150, 120:140, 120:140] = True
    solid[90:100, 128:132, 128:132] = False
    mats = torch.where(solid, PACKED_ROCK, 0).to(torch.int32)
    weird = fuse_volume(mats, minefield_from_solid(solid))
    return {"weird": (weird, WEIRD), "world": (_generated_volume(dev), CANON)}


def _generated_volume(dev):
    """The generated world around the origin (lr 0), fused."""
    from raytrace_tpu_torch.ops.volume import fuse_volume
    from raytrace_tpu_torch.world.generate import generate_box

    box = generate_box((-128,) * 3, (256,) * 3, seed=0, device=dev)
    return fuse_volume(box["materials"], box["minefield"])


def phase_volume_main(rt, torch):
    """The volume path: 20 frames at 1024² through create_instance/
    draw_frame with tracer="volume_fast", the camera moving +VOL_DX in x per
    frame so that slices stream in (G1) and the occupancy tables update
    (O1): one G1 launch and one O1 launch a slab; each frame R1, K3, S3 once
    and K2 six times."""
    from raytrace_tpu_torch.ops import denoise, lighting
    from raytrace_tpu_torch.ops.vol_tables import build_vol_tables
    from raytrace_tpu_torch.render.camera import Camera

    pipe = rt.create_instance(width=W, height=H, tracer="volume_fast")
    cam = Camera(origin=list(CANON["origin"]))
    cam.pitch = CANON["pitch"]
    pipe.teleport(cam)
    base = list(cam.origin)
    drained = []
    drain = pipe.streamer.drain_slab_log

    def counting_drain():
        log = drain()
        drained.append(log)
        return log

    pipe.streamer.drain_slab_log = counting_drain
    pipe.vol_tables()  # the teleported volume's full build, outside the count
    drained.clear()
    torch.cuda.synchronize()
    _zero_counts()
    finite, exhausted = [], []
    t0 = time.perf_counter()
    for t in range(FRAMES):
        cam.origin = [base[0] + VOL_DX * t, base[1], base[2]]
        frame = pipe.draw_frame(cam, CANON["sun"] + 0.01 * t)
        finite.append(torch.isfinite(frame).all())
        exhausted.append((pipe.gbuffers["depth"].to(torch.int32)
                          == lighting.EXHAUSTED_DEPTH).sum())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    counts = _launch_counts()
    k3, k2 = counts["K3"], counts["K2"]
    rebuilt = build_vol_tables(pipe.streamer.volume)
    tables = pipe.vol_tables()
    res = dict(
        frames=FRAMES, shape=list(frame.shape), ms_per_frame=ms,
        all_finite=bool(torch.stack(finite).all()),
        exhausted_px=int(torch.stack(exhausted).sum()),
        r1_launches=counts["R1"], k3_launches=k3, s3_launches=counts["S3"],
        k2_launches=k2, g1_launches=counts["G1"],
        o1_launches=counts["O1"], lr=list(pipe.uniforms.lr),
        slabs_drained=sum(len(log) for log in drained if log),
        full_rebuilds=sum(log is None for log in drained),
        tables_equal_rebuild={k: bool(torch.equal(tables[k], rebuilt[k])) for k in rebuilt},
    )
    ok = (res["all_finite"] and res["exhausted_px"] == 0 and k3 == FRAMES
          and counts["R1"] == FRAMES and counts["S3"] == FRAMES
          and k2 == len(denoise.DENOISE_SIZES) * FRAMES and tuple(frame.shape) == (H, W, 3)
          and res["slabs_drained"] >= 1 and res["full_rebuilds"] == 0
          and res["g1_launches"] == res["slabs_drained"]
          and res["o1_launches"] == res["slabs_drained"]
          and all(res["tables_equal_rebuild"].values()))
    return ok, res, pipe


def phase_volume_edit(torch, pipe):
    """One edit of the resident volume, then a frame: the tables rebuild
    and the primary depth changes where the new box stands."""
    from raytrace_tpu_torch.ops.vol_tables import build_vol_tables
    from raytrace_tpu_torch.render.camera import Camera

    cam = Camera(origin=list(pipe.uniforms.origin))
    cam.pitch = CANON["pitch"]
    before = pipe.gbuffers["depth"].to(torch.int32)
    x, y, z = (int(v) for v in cam.origin)
    # A snow wall 24 voxels ahead of the camera, over the right half of the
    # view.
    pipe.edit_box((x, y + 24, z - 40), (40, 4, 60), 6)
    frame = pipe.draw_frame(cam, CANON["sun"])
    after = pipe.gbuffers["depth"].to(torch.int32)
    rebuilt = build_vol_tables(pipe.streamer.volume)
    tables = pipe.vol_tables()
    res = dict(
        finite=bool(torch.isfinite(frame).all()),
        nearer_px=int((after < before).sum()),
        unchanged_px=int((after == before).sum()),
        tables_equal_rebuild=all(torch.equal(tables[k], rebuilt[k]) for k in rebuilt),
    )
    ok = (res["finite"] and res["nearer_px"] > 0 and res["unchanged_px"] > 0
          and res["tables_equal_rebuild"])
    return ok, res


def _k3s_batches(volume, tables, blue, uniforms, size, max_steps, bounces):
    """The staged volume G-buffer pass with K3s, recording each trace call:
    (origin, direction, active, hit dict) of the primary batch and of each
    bounce's sun + diffuse pair."""
    from raytrace_tpu_torch.ops import integrate, trace_vol

    batches = []

    def trace(o, d, active=None):
        hit = trace_vol.trace_rays_vol(tables, volume, o, d, uniforms["lr"], max_steps,
                                       active=active)
        batches.append((o, d, active, hit))
        return hit

    gb = integrate.integrate_gbuffers(trace, blue, uniforms, size, size, bounces=bounces)
    return gb, batches


def phase_k3s(torch, volume, tables, blue, packed, size, max_steps, bounces, timed=False):
    """K3s against its plain version on the batches a frame gives it: the
    primary rays, then each bounce's sun + diffuse pair with its active
    mask.  Built without FMA contraction, every output must be equal on
    every ray (NaN matching NaN), and no primary may be exhausted.  Reports
    each batch's work (the plain version's moves), bound and lane-use
    census; ``timed``: also the kernel alone (torch.profiler, 10 calls), the
    wrapper's call (CUDA events) and the plain version (once), per batch.
    -> (ok, res, the batches: (origin, direction, active, hit dict))."""
    from raytrace_tpu_torch.ops import trace_vol
    from raytrace_tpu_torch.render.pipeline import unpack_uniforms
    from raytrace_tpu_torch.testing.measure import call_ms, same

    uniforms = unpack_uniforms(packed)
    _, batches = _k3s_batches(volume, tables, blue, uniforms, size, max_steps, bounces)
    keys = ("position", "normal", "air", "albedo", "distance", "exhausted")
    tables_bytes = sum(tables[k].numel() * 4 for k in ("any8", "all8", "any_hi", "detail"))
    res = dict(size=size, bounces=bounces, lr=[int(v) for v in uniforms["lr"]], batches=[],
               max_abs_err=0.0)
    ok = True
    for b, (o, d, active, _) in enumerate(batches):
        args = (tables, volume, o, d, uniforms["lr"], max_steps)
        census = torch.zeros(1, dtype=torch.int64, device=o.device)
        got = trace_vol.trace_rays_vol(*args, active=active, census=census)
        want, t_p = _timed_once(torch, lambda: trace_vol.trace_rays_vol_plain(
            *args, active=active))
        equal = {k: same(got[k], want[k]) for k in keys}
        err = float(torch.nan_to_num(got["position"] - want["position"]).abs().max())
        n = o.numel() // 3
        moves = int(want["moves"].sum(dtype=torch.int64))
        traced = torch.ones_like(got["air"]) if active is None else active
        exhausted = int((got["exhausted"] & traced).sum())
        batch = dict(rays=n, traced=int(traced.sum()), equal=equal, moves=moves,
                     exhausted_traced=exhausted, air=int((got["air"] & traced).sum()),
                     census=_census(torch, want["moves"], census),
                     **_bound(n * (12 + 12 + (0 if active is None else 1) + 18) + 40
                              + tables_bytes, OPS_PER_VOL_MOVE * moves))
        if timed:
            batch.update(
                ms=call_ms(lambda: trace_vol.trace_rays_vol(*args, active=active), 10),
                **_alone(lambda: trace_vol.trace_rays_vol(*args, active=active), 10,
                         "trace_rays_vol_kernel"),
                plain_ms=t_p)
        res["batches"].append(batch)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        ok = ok and all(equal.values()) and (b > 0 or exhausted == 0)
    bounds = res["batches"]
    res.update(bound_ms=sum(x["bound_ms"] for x in bounds) / len(bounds),
               bound_by=max(bounds, key=lambda x: x["bound_ms"])["bound_by"])
    return ok, res, batches


def phase_k3s_tight(torch, cases):
    """K3s against its plain version at the TIGHT round budgets, where the
    cut of an exhausted ray falls mid-round, mid-resolve or at a round's
    end: every output equal on every ray (NaN matching NaN).  ``cases``:
    label -> (volume, tables, lr, origin, direction, active).  Counts the
    exhausted traced rays compared; fails if there are none.  ``seconds``:
    the phase's time on the host's clock."""
    from raytrace_tpu_torch.ops import trace_vol
    from raytrace_tpu_torch.testing.measure import same

    t0 = time.perf_counter()
    keys = ("position", "normal", "air", "albedo", "distance", "exhausted")
    res = dict(budgets=[list(b) for b in TIGHT], batches={}, exhausted_compared=0)
    ok = True
    for label, (volume, tables, lr, o, d, active) in cases.items():
        traced = None if active is None else active.reshape(-1)
        rows = []
        for rounds, cap in TIGHT:
            kw = dict(rounds=rounds, cap=cap, active=active)
            got = trace_vol.trace_rays_vol(tables, volume, o, d, lr, **kw)
            want = trace_vol.trace_rays_vol_plain(tables, volume, o, d, lr, **kw)
            ex = want["exhausted"].reshape(-1)
            exhausted = int((ex if traced is None else ex & traced).sum())
            equal = all(same(got[k], want[k]) for k in keys)
            rows.append(dict(rounds=rounds, cap=cap, equal=equal, exhausted=exhausted))
            res["exhausted_compared"] += exhausted
            ok = ok and equal
        res["batches"][label] = dict(rays=o.numel() // 3, runs=rows)
    res["seconds"] = time.perf_counter() - t0
    return ok and res["exhausted_compared"] > 0, res


def phase_staged_vol_main(torch, pipe):
    """The staged volume path: FRAMES frames of render_gbuffers_vol +
    denoise_finalize at 1024² on the volume_fast pipeline's own volume and
    tables (``apps.profile.staged_frame``: the uniforms as draw_frame fills
    them, at the pipeline's last camera position, the sun moving per
    frame).  Each frame launches R1 (its volume form) once, K3s once per leg
    batch (1 + bounces), P1 once per bounce, S2 once and K2 six times, and
    nothing else."""
    from raytrace_tpu_torch.apps.profile import staged_frame
    from raytrace_tpu_torch.ops import denoise, lighting
    from raytrace_tpu_torch.render.camera import Camera

    cam = Camera(origin=list(pipe.uniforms.origin))
    cam.pitch = CANON["pitch"]
    torch.cuda.synchronize()
    _zero_counts()
    finite, exhausted = [], []
    t0 = time.perf_counter()
    for t in range(FRAMES):
        frame = staged_frame(pipe, cam, CANON["sun"] + 0.01 * t)
        finite.append(torch.isfinite(frame).all())
        exhausted.append((pipe.gbuffers["depth"].to(torch.int32)
                          == lighting.EXHAUSTED_DEPTH).sum())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    counts = _counts()
    want = {"R1": FRAMES, "K3s": (1 + pipe.bounces) * FRAMES, "P1": pipe.bounces * FRAMES,
            "S2": FRAMES, "K2": len(denoise.DENOISE_SIZES) * FRAMES}
    res = dict(
        frames=FRAMES, shape=list(frame.shape), ms_per_frame=ms,
        all_finite=bool(torch.stack(finite).all()),
        exhausted_px=int(torch.stack(exhausted).sum()),
        k3s_launches=counts.get("K3s", 0), launches=counts, launches_want=want,
        lr=list(pipe.uniforms.lr),
    )
    ok = (res["all_finite"] and res["exhausted_px"] == 0 and counts == want
          and tuple(frame.shape) == (H, W, 3))
    return ok, res, cam


def phase_staged_vs_path(torch, pipe, max_steps=4096):
    """At the volume_fast pipeline's own volume, tables and uniforms, the
    staged G-buffers (K3s leg by leg) against the whole-path ones (K3), at
    max_steps 4096: depth and normal equal on every pixel, the radiometric
    buffers within rtol 1e-5, atol 1e-6 on every pixel whose staged rays
    all finished (the JAX package's contract between the two passes).  A
    bounce ray K3s exhausts (43 rounds of 96 coarse steps, where a whole
    path may take 41,600) counts as shadowed there; those pixels are
    counted apart (``cut_px``), with how many of them differ."""
    from raytrace_tpu_torch.ops import path_vol
    from raytrace_tpu_torch.render.pipeline import unpack_uniforms

    volume, tables = pipe.world()
    uniforms = unpack_uniforms(torch.from_numpy(pipe.uniforms.packed()).to(pipe.device))
    staged, batches = _k3s_batches(volume, tables, pipe.blue_noise, uniforms, W, max_steps,
                                   pipe.bounces)
    path = path_vol.render_gbuffers_path(volume, tables, pipe.blue_noise, uniforms, W, H,
                                         max_steps, bounces=pipe.bounces)
    cut = torch.zeros(H * W, dtype=torch.bool, device=pipe.device)
    for _, _, active, hit in batches:
        ex = hit["exhausted"] if active is None else hit["exhausted"] & active
        cut = cut | ex.reshape(-1, H * W).any(0)
    cut = cut.reshape(H, W)
    res = dict(max_steps=max_steps, pixels=H * W, cut_px=int(cut.sum()), mismatch={},
               mismatch_cut_px={}, max_abs_err={})
    for k in ("depth", "normal"):
        res["mismatch"][k] = int((staged[k].to(torch.int32) != path[k].to(torch.int32)).sum())
    for k in ("lighting", "albedo", "emission", "fog"):
        bad = ~torch.isclose(staged[k], path[k], rtol=1e-5, atol=1e-6).all(-1)
        res["mismatch"][k] = int((bad & ~cut).sum())
        res["mismatch_cut_px"][k] = int((bad & cut).sum())
        res["max_abs_err"][k] = float((staged[k] - path[k])[~cut].abs().max())
    res["sky_px"] = int((staged["depth"].to(torch.int32) == 0xFFFF).sum())
    return all(v == 0 for v in res["mismatch"].values()), res


def _blue_noise(torch, dev):
    from raytrace_tpu_torch.render.pipeline import get_blue_noise_f32

    return torch.from_numpy(get_blue_noise_f32()).to(dev)


def phase_column_table(torch, regions):
    """The column table K1 reads (``tables["hcol"]``) against the heights
    the plain march evaluates (``hf_tables.classify`` at each column's
    center), on every column of each region: they must be equal."""
    from raytrace_tpu_torch.ops import hf_tables

    res, ok = {}, True
    for name, (tables, seed) in regions.items():
        dev = tables["r0"].device
        r0x, r0y = (int(v) for v in tables["r0"].tolist())
        k = torch.arange(256, dtype=torch.float32, device=dev) + 0.5
        py, px = torch.meshgrid(k + r0y, k + r0x, indexing="ij")
        rising = torch.zeros_like(px, dtype=torch.bool)
        want = hf_tables.classify(tables, px, py, torch.zeros_like(px), rising, r0x, r0y,
                                  seed)["hcol"]
        got = tables["hcol"].reshape(256, 256).to(torch.int32)
        res[name] = dict(r0=[r0x, r0y], seed=seed, equal=bool(torch.equal(got, want)),
                         mismatches=int((got != want).sum()), max_height=int(got.max()))
        ok = ok and res[name]["equal"]
    return ok, res


def phase_k2(torch, blue, gbs):
    """K2's chain (6 passes, finalize fused) against the plain chain, on
    each set of G-buffers, and two single passes against the plain pass."""
    from raytrace_tpu_torch.ops import denoise

    h, w = gbs["main"]["depth"].shape
    res = dict(size=[h, w], atol=3e-5, max_abs_err={})
    for name, gb in gbs.items():
        got = denoise.denoise_finalize(gb, blue)
        want = denoise.denoise_finalize_plain(gb, blue)
        res["max_abs_err"][name] = float(torch.abs(got - want).max())
    # Single passes through denoise_pass, which packs the working plane in
    # PyTorch: one plane to plane, one finalizing.
    gb = gbs["main"]
    light = gb["lighting"].permute(2, 0, 1).contiguous()
    geom = denoise.geometry_plane(gb["depth"], gb["normal"])
    fin = (gb["albedo"], gb["emission"], gb["fog"], blue)
    for size, f in ((4, None), (16, fin)):
        got = denoise.denoise_pass(light, geom, size, f)
        want = denoise.denoise_pass_plain(light, geom, size, f)
        res["max_abs_err"][f"pass_{size}{'_fin' if f else ''}"] = float(
            torch.abs(got - want).max())
    # One pass, the mean of the chain's: light in and out, the geometry
    # plane, and in the last pass albedo, emission, fog and the noise.
    passes, n = len(denoise.DENOISE_SIZES), h * w
    chain_bytes = passes * n * (12 + 4 + 12) + n * 36 + blue.numel() * 4
    chain_ops = passes * n * (DENOISE_TAPS * OPS_PER_TAP + 11) + n * 30
    res.update(_bound(chain_bytes / passes, chain_ops / passes))
    return all(e <= res["atol"] for e in res["max_abs_err"].values()), res


# F1's cases: (label, first row, rows, row0 of the dither, flip, the light
# read: the chain's working plane (4 floats a pixel) or the contiguous
# G-buffer (3)).
F1_CASES = [("1024", 0, H, 0, True, "chain"), ("band_300+300", 300, 300, 300, True, "chain"),
            ("1024_no_flip", 0, H, 0, False, "chain"), ("1024_contiguous", 0, H, 0, True,
                                                        "gbuffer")]
OPS_F1 = 15  # float32 operations of a channel: composite, fog, the filmic curve, dither


def phase_finalize_kernel(torch, blue, gb):
    """JAX's ``denoise_chain`` and ``finalize_frame`` on the card
    (``ops/denoise.py``, ``ops/finalize.py``): the chain (six K2 launches)
    against the plain chain and F1 against its plain version on the main
    path's G-buffers, every output bit for bit, at F1_CASES; the chain then
    F1 against K2's fused finalize (``denoise_finalize``); F1 alone
    (torch.profiler, ``kept``), its call, the plain version and the bound
    at 1024²."""
    from raytrace_tpu_torch.ops import denoise, finalize
    from raytrace_tpu_torch.testing.measure import call_ms

    t0 = time.perf_counter()
    light, depth, normal = gb["lighting"], gb["depth"], gb["normal"]
    before = _launch_counts()
    den = denoise.denoise_chain(light, depth, normal)
    chain = dict(launches=_launches_since(before),
                 equal=_bits_equal(den.contiguous(),
                                   denoise.denoise_chain_plain(light, depth, normal)),
                 plane_view=list(den.stride()),
                 call_ms=call_ms(lambda: denoise.denoise_chain(light, depth, normal), 10))
    res, ok = dict(chain=chain), chain["equal"] and chain["launches"] == {"K2": 6}
    for label, first, rows, row0, flip, read in F1_CASES:
        cut = lambda t: t[first:first + rows]
        args = (cut(gb["albedo"]), cut(gb["emission"]), cut(gb["fog"]),
                cut(den if read == "chain" else light), cut(depth), blue)
        before = _launch_counts()
        got = finalize.finalize_frame(*args, row0=row0, flip=flip)
        launches = _launches_since(before)
        want, plain_ms = _timed_once(torch, lambda: finalize.finalize_frame_plain(
            *args, row0=row0, flip=flip))
        one = dict(equal=_bits_equal(got, want), max_abs_err=_max_abs(got, want),
                   launches=launches, lstride=args[3].stride(1), plain_ms=plain_ms)
        if label == "1024":
            f1 = lambda: finalize.finalize_frame(*args, row0=row0, flip=flip)
            n = W * H
            texels = min(H, blue.shape[0]) * min(W, blue.shape[1])
            one.update(call_ms=call_ms(f1, 10), **_alone(f1, 10, KERNEL_NAMES["F1"]),
                       **_bound(n * 62 + texels * 3 * 4, n * 3 * OPS_F1))
            # The chain then F1 is K2's chain with finalize fused, bit for bit.
            one["equals_denoise_finalize"] = _bits_equal(got, denoise.denoise_finalize(gb, blue))
            ok = ok and one["equals_denoise_finalize"]
        res[label] = one
        ok = ok and one["equal"] and launches == {"F1": 1}
    res["seconds"] = time.perf_counter() - t0
    return ok, res


# The key sequence of hf_tables_kernel: (lr, seed) of each keyed build
# through one key and one set of buffers, A, A, B, A, then A under another
# seed, and again.  A step equal to the one before must skip its build.
T1_KEY_STEPS = [((16, 0, 0), 0), ((16, 0, 0), 0), ((-48, 0, 0), 0), ((16, 0, 0), 0),
                ((16, 0, 0), 7), ((16, 0, 0), 7)]
T1_SENTINEL = -12345  # written into h3[0] and hcol[0] before a step that must skip


def phase_hf_tables_kernel(rt, torch, dev):
    """T1 (``csrc/hf_tables.cu``) against its plain version on the card: at
    each of T1_REGIONS, from the packed uniforms (lr.y 0) and from an int32
    (3,) lr on the device, with and without the column table, every table
    word, ``r0`` and the column table equal to ``build_hf_tables_plain``
    (its pyramid from ``heightmap_grid``) and to ``column_heights`` of those
    tables, each computed by PyTorch on the card.  Then the key
    (T1_KEY_STEPS from the packed uniforms, as the fused frame program
    launches T1): a step whose lr and seed the key holds leaves a sentinel
    in ``h3[0]`` and ``hcol[0]`` (the skip), every other step equals a
    fresh plain build, and the key holds (lr.x, lr.y, seed, 1) after each.
    Then, at the region of a packed vector: T1 alone (torch.profiler, 20
    calls) building (no key) and skipping (a key that holds the region),
    the launch floor of its grid (an empty kernel in clusters of four) and
    of the grid before the tile stage's redesign (64 blocks of 1024
    threads), its wrapper's call and the plain build with its column table
    (CUDA events), and T1's bound."""
    from raytrace_tpu_torch.ops import hf_tables
    from raytrace_tpu_torch.testing.measure import call_ms, launch_floor_ms

    res, ok = dict(regions=[], max_abs_err=0), True
    packed_of = lambda lr: torch.from_numpy(
        rt.render.pipeline.FrameUniforms(lr=lr, seed=3).packed()).to(dev)

    def plain(lr, seed):
        want = hf_tables.build_hf_tables_plain(lr, seed, dev)
        want["hcol"] = hf_tables.column_heights(want, seed)
        return want

    def compare(got, want) -> bool:
        res["max_abs_err"] = max(res["max_abs_err"], *(
            int((got[k].long() - want[k].long()).abs().max()) for k in got))
        return set(got) <= set(want) and all(torch.equal(got[k], want[k]) for k in got)

    for lr, seed in T1_REGIONS:
        want = plain(lr, seed)
        forms = dict(lr=torch.tensor(lr, dtype=torch.int32, device=dev))
        if lr[1] == 0:
            forms["packed"] = packed_of(lr)
        for form, src in forms.items():
            for with_hcol in (True, False):
                got = hf_tables.build_hf_tables(src, seed, hcol=with_hcol)
                equal = compare(got, want) and ("hcol" in got) == with_hcol
                res["regions"].append(dict(
                    lr=list(lr), seed=seed, form=form, hcol=with_hcol, equal=equal,
                    mismatched={k: int((got[k] != want[k]).sum()) for k in got}))
                ok = ok and equal
    out = hf_tables.empty_tables(dev, hcol=True)
    key = torch.zeros(4, dtype=torch.int32, device=dev)
    res["key_steps"], last = [], None
    for lr, seed in T1_KEY_STEPS:
        skip = (lr, seed) == last
        if skip:
            out["h3"][0] = T1_SENTINEL
            out["hcol"][0] = T1_SENTINEL
        hf_tables.build_hf_tables(packed_of(lr), seed, out=out, hcol=True, key=key)
        want = plain(lr, seed)
        if skip:
            kept = int(out["h3"][0]) == T1_SENTINEL and int(out["hcol"][0]) == T1_SENTINEL
            rest = all(torch.equal(out[k][1:], want[k][1:]) for k in ("h3", "hcol")) and all(
                torch.equal(out[k], want[k]) for k in want if k not in ("h3", "hcol"))
            step_ok = kept and rest
        else:
            step_ok = compare(dict(out), want)
        step_ok = step_ok and key.tolist() == [lr[0], lr[1], seed, 1]
        res["key_steps"].append(dict(lr=list(lr), seed=seed, skip=skip, ok=step_ok,
                                     key=key.tolist()))
        ok = ok and step_ok
        last = (lr, seed)
    packed = packed_of((16, 0, 0))
    hf_tables.build_hf_tables(packed, 0, out=out, hcol=True, key=key)
    t1 = lambda: hf_tables.build_hf_tables(packed, 0, out=out, hcol=True)
    t1_skip = lambda: hf_tables.build_hf_tables(packed, 0, out=out, hcol=True, key=key)
    rebuilt, skipped = _alone(t1, 20, "hf_tables_kernel"), _alone(t1_skip, 20, "hf_tables_kernel")
    res.update(**rebuilt, skipped_ms=skipped["kernel_ms"], skipped_kept=skipped["kept"],
               floor_ms=launch_floor_ms(hf_tables.T1_BLOCKS, hf_tables.STRIP_THREADS, True, 20),
               parent_grid_floor_ms=launch_floor_ms((64, 1), 1024, False, 20),
               ms=call_ms(t1, 20),
               plain_ms=call_ms(lambda: hf_tables.column_heights(
                   hf_tables.build_hf_tables_plain((16, 0, 0), 0, dev), 0), 3))
    # Each table written once (six 1,024-word tables, r0, the int16 column
    # table) and the packed vector read; the 33 x 33 lattice points of the
    # region and one height per column.
    res.update(_bound(16 * 4 + 6 * 4096 + 8 + 2 * 256 * 256,
                      OPS_PER_LATTICE * 33 * 33 + OPS_PER_HEIGHT * 256 * 256))
    return ok, res


def _max_word_diff(torch, a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def phase_worldgen_kernel(rt, torch, dev):
    """G1 (``csrc/worldgen.cu``) against its plain version and against the
    old enclosure-and-roll path (``testing/enclosure.py``), word for word,
    on every ``STREAM_CASES`` entry: slabs on each axis in both directions,
    off-axis texel ranges that wrap (ns 15), offsets near +-2^20, a
    teleport's region and the initial region, each written into a copy of
    the generated world volume.  Then G1 alone (torch.profiler, 20 calls),
    its wrapper's call synced, the plain version and the old path (CUDA
    events), for a slab and for a region, with G1's bound, its grid and
    the grid's launch floor (an empty kernel in the same clusters)."""
    from raytrace_tpu_torch.ops.worldgen import generate_into, generate_into_plain
    from raytrace_tpu_torch.testing import enclosure
    from raytrace_tpu_torch.testing.measure import (
        call_ms, launch_floor_ms, synced_ms, worldgen_grid)

    base = _generated_volume(dev)
    res, ok = dict(cases=[], max_abs_err=0), True
    for label, origin, ns, axis, seed in enclosure.STREAM_CASES:
        w0, shape = enclosure.stream_box(origin, ns, axis)
        got = generate_into(base.clone(), w0, shape, seed)
        plain = generate_into_plain(base.clone(), w0, shape, seed)
        old = enclosure.stream_old(base.clone(), origin, ns, axis, seed)
        case = dict(label=label, w0=list(w0), shape=list(shape), seed=seed,
                    equal_plain=bool(torch.equal(got, plain)),
                    equal_old=bool(torch.equal(got, old)),
                    mismatched_plain=int((got != plain).sum()),
                    mismatched_old=int((got != old).sum()))
        res["cases"].append(case)
        res["max_abs_err"] = max(res["max_abs_err"], _max_word_diff(torch, got, plain),
                                 _max_word_diff(torch, got, old))
        ok = ok and case["equal_plain"] and case["equal_old"]
    torch.cuda.synchronize()
    for kind, (label, origin, ns, axis, seed) in (("slab", enclosure.STREAM_CASES[2]),
                                                 ("region", enclosure.STREAM_CASES[-2])):
        w0, shape = enclosure.stream_box(origin, ns, axis)
        volume = base.clone()
        g1 = lambda: generate_into(volume, w0, shape, seed)
        alone = _alone(g1, 20, "worldgen_kernel")
        # Each word written once; the lattice points and heights of the
        # box's 32-aligned column cover (the per-voxel work is integer).
        cover = [((w + s + 31) & -32) - (w & -32) for w, s in zip(w0[:2], shape[:2])]
        grid = worldgen_grid(w0, shape)
        res[kind] = dict(label=label, kernel_ms=alone["kernel_ms"], kept=alone["kept"],
                         grid=grid, floor_ms=launch_floor_ms(grid["blocks"], grid["threads"],
                                                             True, 20),
                         call_synced_ms=[synced_ms(g1) for _ in range(3)],
                         plain_ms=call_ms(lambda: generate_into_plain(volume, w0, shape, seed), 3),
                         old_path_ms=call_ms(lambda: enclosure.stream_old(
                             volume, origin, ns, axis, seed), 3),
                         **_bound(4 * shape[0] * shape[1] * shape[2],
                                  OPS_PER_LATTICE * (cover[0] // 8 + 1) * (cover[1] // 8 + 1)
                                  + OPS_PER_HEIGHT * cover[0] * cover[1]))
    res.update(kernel_ms=res["slab"]["kernel_ms"], kept=res["slab"]["kept"],
               plain_ms=res["slab"]["plain_ms"], bound_ms=res["slab"]["bound_ms"],
               bound_by=res["slab"]["bound_by"])
    return ok, res


# generate_box's boxes on the card (label, origin xyz, shape xyz, seed): the
# chunk cache's chunks, an all-solid and an all-air chunk, x-rows of chunks
# 512 and 4096 wide (generate_world's at radius 4 and 32) and config 5's
# 256³ world.
BOX_CASES = [("chunk_0_0_0", (0, 0, 0), (64, 64, 64), 0),
             ("chunk_-1_2_0", (-64, 128, 0), (64, 64, 64), 0),
             ("all_solid", (0, 0, -64), (64, 64, 64), 7),
             ("all_air", (0, 0, 1024), (64, 64, 64), 7),
             ("row_512", (-256, 64, 0), (512, 64, 64), 0),
             ("row_4096", (-2048, -64, 0), (4096, 64, 64), 7),
             ("box_256", (-128, -128, -128), (256, 256, 256), 0)]
BOX_TIMED = ("chunk_0_0_0", "row_512", "box_256")


def phase_generate_box_kernel(rt, torch, dev):
    """G1's box mode (``world/generate.generate_box`` on the card: one
    launch) against its plain version ``generate_box_plain`` on the card,
    word for word on materials, minefield and solid, at each of BOX_CASES.
    Then for a chunk, a 512x64x64 row and the 256³ box: the kernel alone
    (torch.profiler, 20 calls), its call synced, the plain version (CUDA
    events), the bound (6 B written a voxel; the lattice points and the
    heights of its columns), the grid and its launch floor."""
    from raytrace_tpu_torch.testing.measure import (
        call_ms, launch_floor_ms, synced_ms, worldgen_grid)
    from raytrace_tpu_torch.world.generate import generate_box, generate_box_plain

    res, ok = dict(cases=[], max_abs_err=0), True
    for label, origin, shape, seed in BOX_CASES:
        before = generate_box.launches
        got = generate_box(origin, shape, seed=seed, device=dev)
        launches = generate_box.launches - before
        want = generate_box_plain(origin, shape, seed=seed, device=dev)
        equal = {k: set(got) == set(want) and got[k].dtype == want[k].dtype
                 and bool(torch.equal(got[k], want[k])) for k in want}
        solid = float(want["solid"].float().mean())
        res["cases"].append(dict(label=label, origin=list(origin), shape=list(shape),
                                 seed=seed, launches=launches, equal=equal, solid_share=solid,
                                 mismatched={k: int((got[k] != want[k]).sum()) for k in want}))
        res["max_abs_err"] = max(res["max_abs_err"], *(_max_word_diff(torch, got[k], want[k])
                                                       for k in want))
        expected = {"all_solid": solid == 1.0, "all_air": solid == 0.0}.get(label, 0 < solid < 1)
        ok = ok and all(equal.values()) and launches == 1 and expected
        del got, want
    for label, origin, shape, seed in BOX_CASES:
        if label not in BOX_TIMED:
            continue
        g1 = lambda: generate_box(origin, shape, seed=seed, device=dev)
        alone = _alone(g1, 20, "worldgen_box_kernel")
        voxels, columns = shape[0] * shape[1] * shape[2], shape[0] * shape[1]
        grid = worldgen_grid(origin, shape)
        res[label] = dict(
            kernel_ms=alone["kernel_ms"], kept=alone["kept"], grid=grid,
            floor_ms=launch_floor_ms(grid["blocks"], grid["threads"], True, 20),
            call_synced_ms=[synced_ms(g1) for _ in range(3)],
            plain_ms=call_ms(lambda: generate_box_plain(origin, shape, seed=seed,
                                                        device=dev), 3),
            **_bound(6 * voxels, OPS_PER_LATTICE * (shape[0] // 8 + 1) * (shape[1] // 8 + 1)
                     + OPS_PER_HEIGHT * columns))
    torch.cuda.synchronize()
    return ok, res

# generate_box without the minefield (G1's form for any box): the boxes of
# tests/test_torch_api.py (unaligned, negative origins, one voxel, one
# column), a chunk and the 256³ box; the three timed alone.
BARE_BOXES = [("chunk_0_0_0", (0, 0, 0), (64, 64, 64)),
              ("unaligned_100x77x45", (-37, 21, -5), (100, 77, 45)),
              ("negative_origin", (-131, -67, -30), (33, 70, 80)),
              ("across_the_surface", (5, -9, 2), (31, 17, 20)),
              ("one_voxel", (-1, -1, -1), (1, 1, 1)),
              ("one_voxel_above", (13, 7, 90), (1, 1, 1)),
              ("one_column", (-300, 517, -3), (1, 1, 64)),
              ("box_256", (-128, -128, -128), (256, 256, 256))]
BARE_TIMED = ("chunk_0_0_0", "unaligned_100x77x45", "box_256")
BARE_SEED = 3
JAX_API_TRACERS = ("fused", "hf", "volume_fast", "volume")


def _box_bound(origin, shape, bytes_per_voxel) -> dict:
    """G1's bound for a box: the bytes it writes, and the lattice points
    and column heights of its columns."""
    (x0, y0, _), (sx, sy, sz) = origin, shape
    lattice = ((x0 + sx - 1) // 8 - x0 // 8 + 2) * ((y0 + sy - 1) // 8 - y0 // 8 + 2)
    return _bound(bytes_per_voxel * sx * sy * sz,
                  OPS_PER_LATTICE * lattice + OPS_PER_HEIGHT * sx * sy)


def _jax_frames(rt, torch, dev, cam) -> tuple:
    """``render_frame`` of a uniforms dict (``FrameUniforms.as_device_dict``,
    on the card by default) with ``with_gbuffers=True`` on each tracer's
    pipeline (``create_instance(None, ...)``) at 1024², against
    ``render_frame_packed`` of the same uniforms and against the frame and
    G-buffers ``draw_frame`` just drew from them (the graph's replay),
    bit for bit.  -> (ok, results, the fused pipeline's last frame)."""
    from raytrace_tpu_torch.render.pipeline import render_frame, render_frame_packed

    res, ok, fused_frame = {}, True, None
    for tracer in JAX_API_TRACERS:
        pipe = rt.create_instance(None, width=W, height=H, tracer=tracer)
        pipe.teleport(cam)
        for i in range(3):
            drawn = pipe.draw_frame(cam, CANON["sun"] + 0.01 * i)
        u, world = pipe.uniforms, pipe.world()
        uniforms = u.as_device_dict()
        args = (W, H, pipe.max_steps)
        frame, gb = render_frame(world, pipe.blue_noise, uniforms, *args, with_gbuffers=True,
                                 tracer=tracer, seed=pipe.seed, bounces=pipe.bounces)
        alone = render_frame(world, pipe.blue_noise, uniforms, *args, tracer=tracer,
                             seed=pipe.seed, bounces=pipe.bounces)
        want, gb_want = render_frame_packed(
            world, pipe.blue_noise, torch.from_numpy(u.packed()).to(dev), *args, pipe.seed,
            pipe.bounces, tracer)
        one = dict(
            frame_equals_packed=_bits_equal(frame, want),
            gbuffers_equal_packed=_gbuffers_equal(gb, gb_want),
            frame_equals_draw_frame=_bits_equal(frame, drawn),
            gbuffers_equal_draw_frame=_gbuffers_equal(gb, pipe.gbuffers),
            frame_alone=isinstance(alone, torch.Tensor) and _bits_equal(alone, frame),
            finite=bool(torch.isfinite(frame).all()), lr=list(u.lr),
            uniforms_on=str(uniforms["origin"].device), pipeline_on=str(pipe.device),
            old_origin_kept=u.old_origin == u.origin)
        res[tracer] = one
        ok = ok and all(v for k, v in one.items() if isinstance(v, bool)) and all(
            one["gbuffers_equal_packed"].values()) and all(
            one["gbuffers_equal_draw_frame"].values()) and one["uniforms_on"] == "cuda:0"
        if tracer == "fused":
            fused_frame = drawn
        del pipe, world, frame, gb, alone, want, gb_want
    return ok, res, fused_frame


def _jax_pipelines(torch, cam, fused_frame) -> tuple:
    """``Pipeline`` built by position in JAX's order draws the frame
    ``create_instance``'s fused pipeline drew; a fused pipeline given a
    preloaded volume holds it, streams slabs into it (G1) and draws the
    frames of one without it, bit for bit, across slice moves."""
    from raytrace_tpu_torch.render.camera import Camera
    from raytrace_tpu_torch.render.pipeline import Pipeline

    res = {}
    p = Pipeline(W, H, 0, MAX_STEPS, "device", None, "fused", None, False, 2)
    p.teleport(cam)
    for i in range(3):
        frame = p.draw_frame(cam, CANON["sun"] + 0.01 * i)
    res["by_position"] = dict(
        config=[p.width, p.height, p.seed, p.max_steps, p.streamer.source, p.tracer,
                p.validate, p.bounces, str(p.device)],
        frame_equals_create_instance=_bits_equal(frame, fused_frame))
    ok = res["by_position"]["frame_equals_create_instance"] and res["by_position"][
        "config"] == [W, H, 0, MAX_STEPS, "device", "fused", False, 2, "cuda"]
    del p
    volume = _generated_volume(torch.device("cuda:0"))
    held = Pipeline(width=W, height=H, tracer="fused", preloaded_volume=volume)
    bare = Pipeline(width=W, height=H, tracer="fused")
    held_at_start = bool(torch.equal(held.streamer.volume, volume))
    walk = Camera(origin=list(CANON["origin"]))
    walk.pitch = CANON["pitch"]
    equal, before = [], _launch_counts()
    for i in range(6):
        equal.append(_bits_equal(held.draw_frame(walk, CANON["sun"]),
                                 bare.draw_frame(walk, CANON["sun"])))
    torch.cuda.synchronize()
    launches = _launches_since(before)
    res["preloaded_fused"] = dict(
        held_at_start=held_at_start, frames_equal=equal, lr=list(held.uniforms.lr),
        bare_volume=bare.streamer.volume is None, launches=launches,
        streamed=not bool(torch.equal(held.streamer.volume, volume)))
    ok = ok and held_at_start and all(equal) and bare.streamer.volume is None \
        and launches.get("G1", 0) > 0 and res["preloaded_fused"]["streamed"]
    return ok, res


def _bare_boxes(torch, dev) -> tuple:
    """``generate_box(origin, shape, seed, with_minefield=False)`` on the
    card by default: one launch of G1's form for any box each, counted
    (the counts set to 0 just before), word for word against
    ``generate_box_plain(..., with_minefield=False)`` on the card, and on
    the aligned boxes equal to the minefield form's materials and solid.
    Then at BARE_TIMED: the kernel alone (torch.profiler, 20 calls), its
    call synced, the plain version, the bound (5 B written a voxel; the
    lattice points and column heights), the grid and its launch floor, and
    on the aligned boxes the minefield form alone, in turns (minefield,
    bare, bare, minefield)."""
    from raytrace_tpu_torch.testing.measure import (
        call_ms, launch_floor_ms, synced_ms, worldgen_grid)
    from raytrace_tpu_torch.world.generate import generate_box, generate_box_plain

    _zero_counts()
    got = {label: generate_box(origin, shape, BARE_SEED, False)
           for label, origin, shape in BARE_BOXES}
    torch.cuda.synchronize()
    launches = _counts()
    res, ok = dict(launches=launches, cases=[], max_abs_err=0), \
        launches == {"G1box": len(BARE_BOXES)}
    for label, origin, shape in BARE_BOXES:
        mine = got.pop(label)
        want = generate_box_plain(origin, shape, BARE_SEED, False, device=dev)
        equal = {k: mine[k].dtype == want[k].dtype and bool(torch.equal(mine[k], want[k]))
                 for k in want}
        one = dict(label=label, origin=list(origin), shape=list(shape), keys=sorted(mine),
                   on=str(mine["solid"].device), equal=equal,
                   solid_share=float(want["solid"].float().mean()))
        if all(v % 64 == 0 for v in origin + shape):
            boxed = generate_box(origin, shape, BARE_SEED, device=dev)
            one["equals_minefield_form"] = all(
                bool(torch.equal(mine[k], boxed[k])) for k in ("materials", "solid"))
            del boxed
        res["cases"].append(one)
        res["max_abs_err"] = max(res["max_abs_err"], *(_max_word_diff(torch, mine[k], want[k])
                                                       for k in want))
        ok = ok and all(equal.values()) and one["keys"] == ["materials", "solid"] \
            and one["on"] == "cuda:0" and one.get("equals_minefield_form", True)
        del mine, want
    for label, origin, shape in BARE_BOXES:
        if label not in BARE_TIMED:
            continue
        bare = lambda: generate_box(origin, shape, BARE_SEED, False, device=dev)
        boxed = lambda: generate_box(origin, shape, BARE_SEED, device=dev)
        aligned = all(v % 64 == 0 for v in origin + shape)
        turns = dict(bare_ms=[], minefield_ms=[])
        for form in ("minefield", "bare", "bare", "minefield"):
            if form == "bare":
                turns["bare_ms"].append(_alone(bare, 20, "worldgen_box_kernel"))
            elif aligned:
                turns["minefield_ms"].append(_alone(boxed, 20, "worldgen_box_kernel"))
        grid = worldgen_grid(origin, shape)
        res[label] = dict(
            kernel_ms=sum(t["kernel_ms"] for t in turns["bare_ms"]) / 2,
            kept=[t["kept"] for t in turns["bare_ms"]],
            turns={k: [t["kernel_ms"] for t in v] for k, v in turns.items()}, grid=grid,
            floor_ms=launch_floor_ms(grid["blocks"], grid["threads"], True, 20),
            call_synced_ms=[synced_ms(bare) for _ in range(3)],
            plain_ms=call_ms(lambda: generate_box_plain(origin, shape, BARE_SEED, False,
                                                        device=dev), 3),
            **_box_bound(origin, shape, 5))
    torch.cuda.synchronize()
    return ok, res


def _profile_trace(torch) -> tuple:
    """``apps.profile.run(out_dir=...)`` writes the torch.profiler trace of
    each path's profiled frames there, and the port's kernels are in it."""
    from raytrace_tpu_torch.apps import profile

    out = _scratch_dir("profile_trace")
    got = profile.run(out_dir=str(out), frames=5, width=256, height=256, tracer="fused")
    names = profile.port_kernels()
    res = {}
    for path in ("graphed", "eager"):
        trace = Path(got[path]["trace"])
        events = json.loads(trace.read_text()).get("traceEvents", []) if trace.is_file() else []
        kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"
                          and profile.is_port_kernel(e["name"], names)})
        res[path] = dict(trace=str(trace.relative_to(ROOT)), in_out_dir=trace.parent == out,
                         bytes=trace.stat().st_size if trace.is_file() else 0,
                         port_kernels=sorted({re.findall(r"\w+_kernel", k)[0]
                                              for k in kernels}))
    ok = all(r["in_out_dir"] and r["port_kernels"] for r in res.values())
    return ok, res


def _default_devices(rt) -> tuple:
    """Each entry point given no device lands on the card."""
    from raytrace_tpu_torch.ops.hf_tables import build_hf_tables
    from raytrace_tpu_torch.render.pipeline import FrameUniforms
    from raytrace_tpu_torch.world import generate, heightmap, noise

    res = dict(
        generate_box=generate.generate_box((0, 0, 0), (64, 64, 64))["minefield"].device,
        generate_box_bare=generate.generate_box((1, 2, 3), (4, 5, 6),
                                                with_minefield=False)["solid"].device,
        generate_chunk=generate.generate_chunk((0, 0, 0))[0].device,
        build_hf_tables=build_hf_tables((0, 0, 0))["h3"].device,
        heightmap_grid=heightmap.heightmap_grid(0, 0).device,
        generate_heightmap=heightmap.generate_heightmap((0, 0)).device,
        mountain_noise2_grid=noise.mountain_noise2_grid(0, 0, (4, 4)).device,
        as_device_dict=FrameUniforms().as_device_dict()["origin"].device,
        create_instance=rt.create_instance(width=16, height=16).device)
    res = {k: str(v) for k, v in res.items()}
    return all(v.startswith("cuda") for v in res.values()), res


def phase_jax_api(rt, torch, dev):
    """JAX's calls on the card: ``render_frame`` of a uniforms dict on each
    tracer (``_jax_frames``), ``Pipeline`` by position in JAX's order and a
    fused pipeline with a preloaded volume (``_jax_pipelines``),
    ``generate_box`` without the minefield on any box (``_bare_boxes``:
    G1's form for it, the main path of that form), ``apps.profile.run``'s
    trace (``_profile_trace``) and the entry points' default device
    (``_default_devices``)."""
    from raytrace_tpu_torch.render.camera import Camera

    t0 = time.perf_counter()
    cam = Camera(origin=list(CANON["origin"]))
    cam.pitch = CANON["pitch"]
    ok, frames, fused_frame = _jax_frames(rt, torch, dev, cam)
    res = dict(render_frame=frames)
    ok_pipes, pipes = _jax_pipelines(torch, cam, fused_frame)
    del fused_frame
    ok_boxes, boxes = _bare_boxes(torch, dev)
    ok_trace, trace = _profile_trace(torch)
    ok_devices, devices = _default_devices(rt)
    res.update(pipelines=pipes, g1_bare=boxes, profile=trace, default_device=devices,
               passed=dict(render_frame=ok, pipelines=ok_pipes, g1_bare=ok_boxes,
                           profile=ok_trace, default_device=ok_devices),
               seconds=time.perf_counter() - t0)
    torch.cuda.synchronize()
    return ok and ok_pipes and ok_boxes and ok_trace and ok_devices, res


def phase_vol_tables_kernel(rt, torch, dev):
    """O1 (``csrc/vol_tables.cu``) against its plain versions on the weird
    scene and the generated world: the full build on each key, and at every
    array axis and texel start 0, 8, 120 and 240 (8 and 120: the slab's two
    brick planes in two 16-level planes) a slab of the other scene written
    in, updated functionally and in place (``out=``), against the plain
    update and the plain rebuild.  Then a chain of four in-place updates on
    one set of buffers (one call repeated; each launch takes and resets the
    ticket of the last block), and a slab that turns all-solid bricks into
    air and back, each against the plain rebuild.  Then O1 alone (its one
    launch in torch.profiler, 20 calls) beside the launch floor of its
    grid, its call synced and the plain version, for a slab update and a
    full build, with the bounds."""
    from raytrace_tpu_torch.ops import vol_tables as vt
    from raytrace_tpu_torch.ops.volume import STEP_SHIFT
    from raytrace_tpu_torch.testing.measure import call_ms, launch_floor_ms, synced_ms

    scenes = {k: v[0] for k, v in _volumes(torch, dev).items()}
    res, ok = dict(builds={}, updates=[], max_abs_err=0), True

    def compare(got, want):
        nonlocal ok
        eq = {k: bool(torch.equal(got[k], want[k])) for k in vt.LAYOUT}
        res["max_abs_err"] = max(res["max_abs_err"], *(
            _max_word_diff(torch, got[k], want[k]) for k in vt.LAYOUT))
        ok = ok and all(eq.values())
        return all(eq.values()), [k for k, e in eq.items() if not e]

    def written(base, source, arr_axis, t):
        """``base`` with the slab at texel ``t`` of ``source`` written in."""
        new = base.clone()
        new.view(256, 256, 256).narrow(arr_axis, t, 16).copy_(
            source.view(256, 256, 256).narrow(arr_axis, t, 16))
        return new

    for name, volume in scenes.items():
        res["builds"][name] = compare(vt.build_vol_tables(volume),
                                      vt.build_vol_tables_plain(volume))
    names = list(scenes)
    for k, name in enumerate(names):
        base, other = scenes[name], scenes[names[1 - k]]
        before = vt.build_vol_tables(base)
        for arr_axis in (0, 1, 2):
            for t in (0, 8, 120, 240):
                new = written(base, other, arr_axis, t)
                want = vt.update_vol_tables_plain(before, new, t, arr_axis)
                functional = vt.update_vol_tables(before, new, t, arr_axis)
                in_place = {key: v.clone() for key, v in before.items()}
                vt.update_vol_tables(in_place, new, t, arr_axis, out=in_place)
                res["updates"].append(dict(
                    scene=name, arr_axis=arr_axis, t=t,
                    functional=compare(functional, want), in_place=compare(in_place, want),
                    rebuild=compare(in_place, vt.build_vol_tables_plain(new))))
        unchanged = compare(before, vt.build_vol_tables_plain(base))
        res["builds"][f"{name}_unchanged_by_update"] = unchanged
    # Four in-place updates of one set of buffers, the second call repeated.
    volume, tables = scenes["world"].clone(), vt.build_vol_tables(scenes["world"])
    res["chain"] = []
    for arr_axis, t in CHAIN_SLABS:
        volume = written(volume, scenes["weird"], arr_axis, t)
        vt.update_vol_tables(tables, volume, t, arr_axis, out=tables)
        res["chain"].append(dict(arr_axis=arr_axis, t=t, rebuild=compare(
            tables, vt.build_vol_tables_plain(volume))))
    # The weird scene's all-solid bricks under z 96 made air, then solid again:
    # their any8 and all8 bits flip both ways.
    weird = scenes["weird"]
    air = torch.full_like(weird, 1 << STEP_SHIFT)  # step 1: not solid
    volume, tables = weird.clone(), vt.build_vol_tables(weird)
    res["all_solid_flip"] = []
    for label, source in (("to_air", air), ("back", weird)):
        volume = written(volume, source, 0, 16)
        vt.update_vol_tables(tables, volume, 16, 0, out=tables)
        res["all_solid_flip"].append(dict(
            step=label, all8_words_set=int((tables["all8"] != 0).sum()),
            rebuild=compare(tables, vt.build_vol_tables_plain(volume))))
    flips = [step["all8_words_set"] for step in res["all_solid_flip"]]
    ok = ok and flips[0] < flips[1]  # the bricks' all8 bits cleared, then set again
    torch.cuda.synchronize()
    volume = scenes["world"]
    tables = vt.build_vol_tables(volume)
    update = lambda: vt.update_vol_tables(tables, volume, 240, 2, out=tables)
    build = lambda: vt.build_vol_tables(volume, out=tables)
    slab_box = [(0, vt.NB), (0, vt.NB), (240 >> 3, 2)]
    detail_bytes = 4 * vt.DETAIL_WORDS
    packed_bytes = 4 * (8 * 128 * 2 + 2 * 128)  # any8, all8, any_hi
    for kind, fn, box in (("update", update, slab_box), ("build", build, [(0, vt.NB)] * 3)):
        bricks = box[0][1] * box[1][1] * box[2][1]
        alone = _alone(fn, 20, KERNEL_NAMES["O1"])
        grid = vt.launch_grid(box)
        # The slab's or the volume's words read once; the bricks' detail
        # rows and flags and the packed pyramid written once (the other
        # bricks' flags read once by the pyramid).
        res[kind] = dict(kernel_ms=alone["kernel_ms"], kept=alone["kept"], grid=grid,
                         floor_ms=launch_floor_ms(grid["blocks"], grid["threads"], False, 20),
                         call_synced_ms=[synced_ms(fn) for _ in range(3)],
                         plain_ms=call_ms(lambda: vt.build_vol_tables_plain(volume) if kind ==
                                          "build" else vt.update_vol_tables_plain(
                                              tables, volume, 240, 2), 3),
                         **_bound(4 * 512 * bricks + bricks * (detail_bytes + 2)
                                  + 2 * (vt.NUM_BRICKS - bricks) + packed_bytes, 0))
    res.update(kernel_ms=res["update"]["kernel_ms"], kept=res["update"]["kept"],
               plain_ms=res["update"]["plain_ms"], bound_ms=res["update"]["bound_ms"],
               bound_by=res["update"]["bound_by"])
    return ok, res


# vol_tables_kernel's chain of in-place slab updates: (array axis, texel).
CHAIN_SLABS = [(2, 240), (0, 8), (0, 8), (1, 120)]


def phase_golden(rt, torch, dev):
    """The committed 64² golden frame through the port's kernel path."""
    import numpy as np

    from raytrace_tpu_torch.ops.hf_tables import build_hf_tables, with_column_heights
    from raytrace_tpu_torch.render.pipeline import render_frame_packed
    from raytrace_tpu_torch.testing.golden import compare_images

    u = _canonical_uniforms(rt)
    packed = torch.from_numpy(u.packed()).to(dev)
    frame, _ = render_frame_packed(with_column_heights(build_hf_tables((0, 0, 0), device=dev)),
                                   _blue_noise(torch, dev), packed, 64, 64, tracer="fused")
    want = np.load(ROOT / "tests" / "goldens" / "terrain_frame_64.npz")["frame"]
    stats = compare_images(frame.cpu().numpy(), want)
    return bool(stats["ok"]), stats


def phase_fused_bare_tables(torch, tables, blue, packed, size=256):
    """A fused frame from bare region tables (``build_hf_tables``, no column
    table: render_gbuffers_fused builds it for the call) against one from
    the same tables with the column table: frame and G-buffers bit-equal,
    and K1 launched for each."""
    from raytrace_tpu_torch.ops import lighting
    from raytrace_tpu_torch.render.pipeline import render_frame_packed
    from raytrace_tpu_torch.testing.measure import same

    bare = {k: v for k, v in tables.items() if k != "hcol"}
    launches = lighting.march_paths.launches
    got, gb_got = render_frame_packed(bare, blue, packed, size, size, tracer="fused")
    want, gb_want = render_frame_packed(tables, blue, packed, size, size, tracer="fused")
    res = dict(size=size, k1_launches=lighting.march_paths.launches - launches,
               frame_equal=same(got, want), gbuffers_equal=_gbuffers_equal(gb_got, gb_want))
    ok = res["frame_equal"] and all(res["gbuffers_equal"].values()) and res["k1_launches"] == 2
    return ok, res


# R1's shapes: (label, (width, height), band (row0, rows) or None, view).
# The main path's 1024², a band that starts on no band boundary, the apps'
# 1920x1080 and 512², one band of config 5's 4K frame, and a camera below
# the region (origin y < -128: the rays start on its floor).
BELOW = dict(origin=(-30.0, -200.0, 60.0), pitch=0.3, sun=0.6)
R1_CASES = [("8x8", (8, 8), None, CANON),
            ("1024", (1024, 1024), None, CANON), ("1024_band_300+200", (1024, 1024),
                                                   (300, 200), CANON),
            ("1920x1080", (1920, 1080), None, CANON), ("512", (512, 512), None, CANON),
            ("4k_band_1080+270", (3840, 2160), (1080, 270), CANON),
            ("below_256", (256, 256), None, BELOW)]
# float32 operations of a pixel (counted from csrc/frame_rays.cu and
# csrc/shade.cu, at least): R1's rays, noise offset and noise bytes, and its
# volume_fast invariants besides (the sun, two jittered sun directions and
# two sphere points); a sample_sky; S1's and S3's work around their skies.
OPS_R1_FUSED = 42
OPS_R1_VOLUME = 105
OPS_PER_SKY = 41
OPS_S1_OTHER = 60  # two bounce directions, the albedos, the radiance sums
# S1's path bits (meta >> 12): p_air, and the bounce weights a2, a4.
S1_P_AIR, S1_BOUNCE_WEIGHTS = 1 << 12, (1 << 14) | (1 << 16)
S1_TABLE_KERNEL = "sky_table_kernel"  # S1's first launch: the frame's bounce skies
NIGHT_SUN = -2.0  # a sun angle whose sunlight has negative components
OPS_S3_OTHER = 20  # the albedos, the radiance sums, depth and fog
R1_UNIFORM_BYTES = 4 * (4 * 3 + 1 + 1 + 3)  # origin, forward, up, right, sun_angle, seed, lr
# The region centres of R1's any8b cases: on the 8-voxel lattice, and two
# off it, whose windows cut a brick slot at the wrap on every axis.
R1_OCC_LR = [(0, 0, 0), (5, -3, 203), (-130, 7, -77)]


def _occupancy_cases(torch, dev, lr) -> dict:
    """R1's any8b tables (32, 32, 32) bool, indexed (bz, by, bx): empty,
    full, one brick at the slot that straddles the wrap on each axis (with
    a second brick elsewhere), and seeded random ones at three densities."""
    import numpy as np

    def straddling(axis):
        slots = [bt for bt in range(32) if (8 * bt - lr[axis]) % 256 > 248]
        return slots[0] if slots else 0

    wrap = np.zeros((32, 32, 32), bool)
    wrap[straddling(2), straddling(1), straddling(0)] = True
    wrap[7, 20, 13] = True
    cases = dict(empty=np.zeros((32, 32, 32), bool), full=np.ones((32, 32, 32), bool),
                 wrap=wrap)
    rng = np.random.default_rng(sum(lr) & 0xFFFF)
    for p in (0.002, 0.05, 0.5):
        cases[f"random_{p}"] = rng.random((32, 32, 32)) < p
    return {k: torch.from_numpy(v).to(dev) for k, v in cases.items()}


def _bits_equal(a, b) -> bool:
    """Equal in shape, type and every bit (floats compared as int32 words:
    -0 is not +0)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(_wide(a), _wide(b)))


def _max_abs(a, b) -> float:
    import torch

    if not a.is_floating_point():
        return float((_wide(a).to(torch.int64) - _wide(b).to(torch.int64)).abs().max())
    return float((a - b).abs().max()) if a.numel() else 0.0


def phase_frame_rays_kernel(rt, torch, dev, blue, tables, vol_world):
    """R1 against its plain version in its four forms (fused and hf: the
    region tables ``tables``; volume: the world ``vol_world``'s occupancy
    tables, and any8b tables that are empty, full, straddle the wrap or are
    random at R1_OCC_LR; dda: no tables), every
    output bit for bit, at each shape of R1_CASES; R1 alone
    (torch.profiler, ``kept``), its call synced, the plain version (once)
    and the bound of each."""
    from raytrace_tpu_torch.ops import rays
    from raytrace_tpu_torch.render.pipeline import unpack_uniforms
    from raytrace_tpu_torch.testing.measure import call_ms

    t0 = time.perf_counter()
    res, ok = {}, True
    for label, (w, h), band, view in R1_CASES:
        uni = unpack_uniforms(torch.from_numpy(
            _canonical_uniforms(rt, view, seed=7).packed()).to(dev))
        row0, rows = band or (0, h)
        n = w * rows
        for form, tabs in (("fused", tables), ("volume", vol_world[1]), ("hf", tables),
                           ("dda", None)):
            args = (uni, blue, w, h, row0, rows)
            kw = dict(tables=tabs, form=form)
            got = rays.frame_rays(*args, **kw)
            want, plain_ms = _timed_once(torch, lambda: rays.frame_rays_plain(*args, **kw))
            equal = {k: _bits_equal(got[k], want[k]) for k in want}
            # Inputs read once: the uniforms, the two channels R1 reads of
            # each texel the band touches (its rows and columns and the two
            # beyond, wrapped; the offset texel besides), and the tables.
            texels = min(rows + 2, blue.shape[0]) * min(w + 2, blue.shape[1]) + 1
            in_bytes = R1_UNIFORM_BYTES + texels * 2 * 4
            if form != "volume":  # hf reads no pyramid words: its iscal has no maxh
                tabled = form != "dda"  # dda: no tables, no scalars but the sun
                out_bytes = n * 28 + 8 * 4 + (8 * 4 if tabled else 0)
                in_bytes += (1024 * 4 if form == "fused" else 0) + (2 * 4 if tabled else 0)
                ops = OPS_R1_FUSED * n
            else:
                out_bytes = n * (12 + 12 + 48) + 10 * 4 + 4 * 4 + 8 * 4
                in_bytes += 32 ** 3 + 256 * 8
                ops = OPS_R1_VOLUME * n
            one = dict(equal=equal, max_abs_err=max(_max_abs(got[k], want[k]) for k in want),
                       below=bool(-float(uni["origin"][1]) > 128.0),
                       call_ms=call_ms(lambda: rays.frame_rays(*args, **kw), 10),
                       plain_ms=plain_ms, **_alone(lambda: rays.frame_rays(*args, **kw), 10,
                                                   KERNEL_NAMES["R1"]),
                       **_bound(out_bytes + in_bytes, ops))
            res[f"{form}_{label}"] = one
            ok = ok and all(equal.values()) and one["below"] == (view is BELOW)
    # The sun (sinf and cosf in R1, torch.sin and torch.cos in the plain
    # version) at 181 angles: the frames' 0.6 + 0.01 k and -7 .. 7.
    angles = [0.6 + 0.01 * k for k in range(40)] + [-7.0 + 0.1 * k for k in range(141)]
    uni = unpack_uniforms(torch.from_numpy(_canonical_uniforms(rt, seed=7).packed()).to(dev))
    sun_equal = []
    for a in angles:
        uni["sun_angle"] = torch.tensor(a, dtype=torch.float32, device=dev)
        for form, tabs in (("fused", tables), ("volume", vol_world[1]), ("hf", tables),
                           ("dda", None)):
            kw = dict(tables=tabs, form=form)
            got = rays.frame_rays(uni, blue, 8, 8, **kw)
            want = rays.frame_rays_plain(uni, blue, 8, 8, **kw)
            sun_equal.append(all(_bits_equal(got[k], want[k]) for k in ("sun", "inv")
                                 if k in want))
    res["sun_angles"] = dict(angles=len(angles), equal=sum(sun_equal), of=len(sun_equal))
    ok = ok and all(sun_equal)
    # The volume form's occupancy bounds (the scalars' block) on any8b
    # tables that are empty, full, straddle the wrap or are random, at
    # region centres on and off the brick lattice.
    occ_equal, occ_bounds = [], {}
    for lr in R1_OCC_LR:
        uni = unpack_uniforms(torch.from_numpy(_canonical_uniforms(rt, seed=7).packed()).to(dev))
        uni["lr"] = torch.tensor(lr, dtype=torch.float32, device=dev)
        for label, any8b in _occupancy_cases(torch, dev, lr).items():
            kw = dict(tables=dict(vol_world[1], any8b=any8b), form="volume")
            got = rays.frame_rays(uni, blue, 64, 64, **kw)
            want = rays.frame_rays_plain(uni, blue, 64, 64, **kw)
            occ_equal.append(all(_bits_equal(got[k], want[k]) for k in want))
            occ_bounds[f"{label}_{lr[0]}_{lr[1]}_{lr[2]}"] = want["iscal"][3:9].tolist()
    res["occupancy_cases"] = dict(equal=sum(occ_equal), of=len(occ_equal), bounds=occ_bounds)
    ok = ok and all(occ_equal)
    res["seconds"] = time.perf_counter() - t0
    return ok, res


def _random_meta(torch, dev, n, seed, fused):
    """``n`` seeded random meta words over every leg (0-5), normal id (0-7),
    material code (0-3) and sky bit, in K1's layout (``fused``) or K3's."""
    import numpy as np

    rng = np.random.default_rng(seed)
    r = lambda hi: rng.integers(0, hi, n, dtype=np.int64)
    if fused:
        acc = r(32) | (r(4) << 5) | (r(4) << 7)
        meta = r(6) | (r(8) << 3) | (r(8) << 6) | (r(8) << 9) | (acc << 12)
    else:
        meta = (r(6) << 6) | (r(8) << 9) | (r(8) << 12) | (r(32) << 15)
    return torch.from_numpy(meta.astype(np.int32)).to(dev)


def _random_rays(torch, dev, n, seed):
    """(N, 3) f32 seeded random unit directions and (N,) f32 distances,
    some past the depth clamp (65535 / 32)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = rng.uniform(0.0, 3000.0, n)
    dist[:16] = [0.0, 2047.96875, 2048.0, 2999.0] * 4
    return (torch.from_numpy(d.astype(np.float32)).to(dev),
            torch.from_numpy(dist.astype(np.float32)).to(dev))


def _s1_alone(call) -> dict:
    """S1's two kernels alone (torch.profiler): the frame's table of bounce
    skies and the shade, and their sum ``kernel_ms``, S1's time."""
    shade, table = _alone(call, 10, KERNEL_NAMES["S1"]), _alone(call, 10, S1_TABLE_KERNEL)
    return dict(kernel_ms=shade["kernel_ms"] + table["kernel_ms"],
                shade_kernel_ms=shade["kernel_ms"], table_kernel_ms=table["kernel_ms"],
                kept=shade["kept"], table_kept=table["kept"])


def _s1_bound(meta) -> dict:
    """S1's bound on the words ``meta``: its bytes (meta, the distance, the
    direction and the noise word in, four 12-byte G-buffers, depth and
    normal out; the sun and the trig table) and the skies these words need,
    the primary's of every pixel and a bounce's of each weight a terrain
    pixel has (the table is how S1 computes them, not a part of the
    function)."""
    terrain = (meta & S1_P_AIR) == 0
    weights = int((terrain & ((meta & (1 << 14)) != 0)).sum()) + int(
        (terrain & ((meta & (1 << 16)) != 0)).sum())
    n = meta.numel()
    return _bound(n * (24 + 51) + 8 * 4 + 256 * 8,
                  n * (OPS_PER_SKY + OPS_S1_OTHER) + weights * OPS_PER_SKY)


def phase_shade_kernel(rt, torch, pipe, vpipe):
    """S1 and S3 against their plain versions, every G-buffer bit for bit:
    S1 on the main path's K1 outputs (``pipe``'s tables and uniforms, 1024²),
    the same words made all sky, with no bounce weight and under a night
    sun (negative sunlight), each timed alone, on 4096 seeded random meta
    words (every leg, normal id, material code and sky bit; exhausted
    pixels; distances past the depth clamp), the same made all sky, with no
    bounce weight and at night, and on words whose bounce skies
    are negative at night with every weight 0 (plain lighting -0);
    S3 on K3's outputs at b0, b1 and b2 on the volume path (``vpipe``'s
    volume, tables and uniforms, 1024²; hit pixels whose dif1 ray found no
    voxel, ``dif1_lin < 0``, counted) and on 4096 random words at each of
    legs 1, 3, 5.  Each timed alone (torch.profiler, ``kept``), its call
    synced and its plain version once, at the main path's shapes."""
    import numpy as np

    from raytrace_tpu_torch.ops import lighting, path_vol, shading, trace_vol
    from raytrace_tpu_torch.render.pipeline import unpack_uniforms
    from raytrace_tpu_torch.testing.measure import call_ms

    t0 = time.perf_counter()
    dev = pipe.device
    res = {}

    def held(got, want):
        return dict(equal={k: _bits_equal(got[k], want[k]) for k in want},
                    max_abs_err=max(_max_abs(got[k], want[k]) for k in want))

    # S1 on the main path's K1 outputs.
    uni = unpack_uniforms(torch.from_numpy(pipe.uniforms.packed()).to(dev))
    frame = lighting.march_inputs(pipe.tables(), pipe.blue_noise, uni, W, H)
    meta, pd = lighting.march_paths(*frame["march"], pipe.max_steps, pipe.seed,
                                    1 + 2 * pipe.bounces)
    s1 = lambda: lighting.shade(meta, pd, **frame["shade"])
    want, plain_ms = _timed_once(torch, lambda: lighting.shade_plain(meta, pd, **frame["shade"]))
    n = W * H
    res["s1_main"] = dict(**held(s1(), want), call_ms=call_ms(s1, 10), plain_ms=plain_ms,
                          **_s1_alone(s1), **_s1_bound(meta),
                          exhausted_px=int(((meta & 7) == 0).sum()))
    # S1 on random words.
    k = 4096
    rmeta = _random_meta(torch, dev, k, 11, fused=True)
    rdir, rdist = _random_rays(torch, dev, k, 12)
    rnw = torch.from_numpy(np.random.default_rng(13).integers(
        -2 ** 31, 2 ** 31, k, dtype=np.int64).astype(np.int32)).to(dev)
    shade_kw = dict(direction=rdir, nw=rnw, sun=frame["shade"]["sun"], shape=(64, 64))
    res["s1_random"] = held(lighting.shade(rmeta, rdist, **shade_kw),
                            lighting.shade_plain(rmeta, rdist, **shade_kw))
    res["s1_random"]["legs_seen"] = sorted({int(v) for v in (rmeta & 7).unique()})
    # S1 on the main path's words made all sky, with no bounce weight (a2 =
    # a4 = 0), and under a night sun (negative sunlight: every sky of a
    # terrain pixel evaluated), timed alone beside the main words.
    night = shading.sun_vector(torch.tensor(NIGHT_SUN, dtype=torch.float32, device=dev))
    s1_mixes = dict(s1_all_sky=(meta | S1_P_AIR, frame["shade"]),
                    s1_zero_weight=(meta & ~S1_BOUNCE_WEIGHTS, frame["shade"]),
                    s1_night=(meta, dict(frame["shade"], sun=night)),
                    s1_night_zero_weight=(meta & ~S1_BOUNCE_WEIGHTS,
                                          dict(frame["shade"], sun=night)))
    for label, (words, kw) in s1_mixes.items():
        call = lambda: lighting.shade(words, pd, **kw)
        res[label] = dict(**held(call(), lighting.shade_plain(words, pd, **kw)),
                          **_s1_alone(call), sky_px=int(((words & S1_P_AIR) != 0).sum()))
    res["s1_night"]["sunlight"] = night[3:6].tolist()
    # The same mixes on the random words (every leg, face id 0-7, noise
    # byte and distance).
    for label, (words, sun) in dict(
            s1_random_all_sky=(rmeta | S1_P_AIR, shade_kw["sun"]),
            s1_random_zero_weight=(rmeta & ~S1_BOUNCE_WEIGHTS, shade_kw["sun"]),
            s1_random_night=(rmeta, night),
            s1_random_night_zero_weight=(rmeta & ~S1_BOUNCE_WEIGHTS, night)).items():
        kw = dict(shade_kw, sun=sun)
        res[label] = held(lighting.shade(words, rdist, **kw),
                          lighting.shade_plain(words, rdist, **kw))
    # The trap of skipping a bounce sky: a night sky is negative, 0 times
    # it is -0, and a terrain pixel with no weight set whose two bounce
    # skies are negative has -0 lighting.  Words whose bounce directions
    # (every noise byte pair, faces 0-5) give a negative night sky, every
    # weight 0: the plain version's -0 values must be S1's.
    pairs = torch.arange(1 << 16, dtype=torch.int32, device=dev)
    cand_nw = pairs | (pairs << 16)
    n1r, n1g, _, _ = lighting.noise_bytes(cand_nw)
    trap_nw, trap_face = [], []
    for face in range(6):
        ids = torch.full_like(pairs, face)
        d = shading.diffuse_direction(n1r, n1g, ids)
        sky = torch.stack(shading.sample_sky(d, tuple(night[:3]), tuple(night[3:6]), True))
        neg = (sky < 0).any(0)
        trap_nw.append(cand_nw[neg][:k // 6])
        trap_face.append(ids[neg][:k // 6])
    trap_nw, trap_face = torch.cat(trap_nw), torch.cat(trap_face)
    m = trap_nw.numel()
    codes = torch.from_numpy(np.random.default_rng(14).integers(
        0, 16, m, dtype=np.int64).astype(np.int32)).to(dev)
    trap_meta = 5 | (trap_face << 6) | (trap_face << 9) | ((codes << 5) << 12)
    trap_kw = dict(direction=rdir[:m], nw=trap_nw, sun=night, shape=(1, m))
    want = lighting.shade_plain(trap_meta, rdist[:m], **trap_kw)
    res["s1_night_trap"] = dict(
        **held(lighting.shade(trap_meta, rdist[:m], **trap_kw), want), words=m,
        negative_zero_values=int((want["lighting"].view(torch.int32) == -2 ** 31).sum()))

    # S3 on K3's outputs at b0, b1, b2.
    volume, tables = vpipe.world()
    vuni = unpack_uniforms(torch.from_numpy(vpipe.uniforms.packed()).to(dev))
    for bounces in (0, 1, 2):
        legs = path_vol.legs_of(bounces)
        vframe = path_vol.march_inputs(tables, vpipe.blue_noise, vuni, W, H)
        marched = trace_vol.march_paths_vol(*vframe["march"], vpipe.max_steps, legs)
        s3 = lambda: path_vol.shade(volume, *marched, legs=legs, **vframe["shade"])
        want, plain_ms = _timed_once(torch, lambda: path_vol.shade_plain(
            volume, *marched, legs=legs, **vframe["shade"]))
        vmeta, prim_lin, dif1_lin = marched[:3]
        hit = prim_lin >= 0
        # The skies this run's data needs: the primary's, and a bounce's
        # where its ray reached the sky.
        bits = lambda b: ((vmeta >> (trace_vol.SKY_SHIFT + b)) & 1) == 1
        bounce_skies = (int((hit & bits(2)).sum()) if legs >= 3 else 0) + (
            int((hit & ~bits(2) & bits(4)).sum()) if legs >= 5 else 0)
        one = dict(**held(s3(), want), legs=legs, hit_px=int(hit.sum()),
                   dif1_missed_px=int((hit & (dif1_lin < 0)).sum()) if legs >= 5 else None,
                   **_bound(n * (84 + 51) + 8 * 4,
                            n * (OPS_PER_SKY + OPS_S3_OTHER) + bounce_skies * OPS_PER_SKY))
        if bounces == vpipe.bounces:
            one.update(call_ms=call_ms(s3, 10), plain_ms=plain_ms,
                       **_alone(s3, 10, KERNEL_NAMES["S3"]))
        res[f"s3_main_b{bounces}"] = one
        vsun = vframe["shade"]["sun"]
        del marched, vframe
        # S3 on random words, this frame's sun.
        rmeta = _random_meta(torch, dev, k, 20 + bounces, fused=False)
        rng = np.random.default_rng(30 + bounces)
        lin = lambda: torch.from_numpy(np.where(
            rng.random(k) < 0.3, -1, rng.integers(0, 256 ** 3, k)).astype(np.int32)).to(dev)
        rinv = torch.from_numpy(rng.uniform(-1, 1, (k, 12)).astype(np.float32)).to(dev)
        rkw = dict(direction=rdir, inv=rinv, sun=vsun,
                   shape=(64, 64), legs=legs)
        args = (volume, rmeta, lin(), lin(), rdist)
        res[f"s3_random_b{bounces}"] = held(path_vol.shade(*args, **rkw),
                                            path_vol.shade_plain(*args, **rkw))
    res["seconds"] = time.perf_counter() - t0
    ok = all(all(r["equal"].values()) for r in res.values() if isinstance(r, dict))
    ok = ok and res["s1_random"]["legs_seen"] == [0, 1, 2, 3, 4, 5]
    ok = ok and res["s1_night_trap"]["negative_zero_values"] > 0
    ok = ok and min(res["s1_night"]["sunlight"]) < 0
    ok = ok and res["s3_main_b2"]["dif1_missed_px"] > 0
    return ok, res


def phase_main(rt, torch):
    """The main path: 20 frames at 1024² through create_instance/draw_frame,
    each of them T1 (the region tables, inside the frame's graph), R1 (the
    rays, noise and march scalars), K1, S1 (the shade) and six K2 passes."""
    from raytrace_tpu_torch.ops import denoise, lighting
    from raytrace_tpu_torch.render.camera import Camera

    pipe = rt.create_instance(width=W, height=H)
    cam = Camera(origin=list(CANON["origin"]))
    cam.pitch = CANON["pitch"]
    pipe.teleport(cam)
    base = list(cam.origin)
    pipe.converge_streaming((base[0], 0, base[2]), max_moves=32)
    torch.cuda.synchronize()
    _zero_counts()
    finite, exhausted = [], []
    t0 = time.perf_counter()
    for t in range(FRAMES):
        cam.origin = [base[0] + 0.03 * t, base[1] + 0.03 * t, base[2]]
        frame = pipe.draw_frame(cam, CANON["sun"] + 0.01 * t)
        finite.append(torch.isfinite(frame).all())
        exhausted.append((pipe.gbuffers["depth"].to(torch.int32)
                          == lighting.EXHAUSTED_DEPTH).sum())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    counts = _launch_counts()
    k1, k2, t1 = counts["K1"], counts["K2"], counts["T1"]
    res = dict(
        frames=FRAMES, shape=list(frame.shape), ms_per_frame=ms,
        all_finite=bool(torch.stack(finite).all()),
        exhausted_px=int(torch.stack(exhausted).sum()),
        t1_launches=t1, r1_launches=counts["R1"], k1_launches=k1, s1_launches=counts["S1"],
        k2_launches=k2, f1_launches=counts["F1"], lr=list(pipe.uniforms.lr),
    )
    # Each frame: T1, R1, K1, S1 once, K2 six times (finalize fused into the
    # last: no F1).
    ok = (res["all_finite"] and res["exhausted_px"] == 0 and k1 == FRAMES and t1 == FRAMES
          and counts["F1"] == 0
          and counts["R1"] == FRAMES and counts["S1"] == FRAMES
          and k2 == len(denoise.DENOISE_SIZES) * FRAMES and tuple(frame.shape) == (H, W, 3))
    return ok, res, pipe


def phase_times(rt, torch, dev, pipe, gbs, blue):
    """Kernel against plain at 1024²: whole frame (plain: R1's, K1's, S1's
    and K2's plain versions), K1 (the wrapper's call and the kernel alone),
    K2 (the chain's call, and each pass's kernel alone), on the main path's
    own tables, uniforms and G-buffers (K2 also on random G-buffers)."""
    from raytrace_tpu_torch.ops import denoise, lighting, rays
    from raytrace_tpu_torch.render.pipeline import render_frame_packed, unpack_uniforms
    from raytrace_tpu_torch.testing.measure import call_ms

    packed = torch.from_numpy(pipe.uniforms.packed()).to(dev)
    tables = pipe.tables()
    budget = (pipe.max_steps, pipe.seed, 1 + 2 * pipe.bounces)
    frame_ms = call_ms(lambda: render_frame_packed(
        tables, pipe.blue_noise, packed, W, H, *budget[:2], pipe.bounces, "fused"), 10)
    inputs = lighting.march_inputs(
        tables, pipe.blue_noise, unpack_uniforms(packed), W, H)

    def plain_frame():
        f = rays.frame_rays_plain(unpack_uniforms(packed), pipe.blue_noise, W, H,
                                  tables=tables, form="fused")
        meta, pd, _ = lighting.march_paths_plain(
            f["origin"], f["direction"], f["nw"], f["iscal"], f["fscal"], tables, *budget)
        gb = lighting.shade_plain(meta, pd, f["direction"], f["nw"], f["sun"], (H, W))
        return denoise.denoise_finalize_plain(gb, pipe.blue_noise)

    k1 = lambda: lighting.march_paths(*inputs["march"], *budget)
    k1_alone = _alone(k1, 10, "march_paths_kernel")
    times = dict(
        frame_ms=frame_ms, plain_frame_ms=call_ms(plain_frame, 1),
        k1_ms=call_ms(k1, 10), k1_kernel_ms=k1_alone["kernel_ms"], k1_kept=k1_alone["kept"],
        k1_plain_ms=call_ms(
            lambda: lighting.march_paths_plain(*inputs["march"], *budget), 1),
    )
    for name, gb in gbs.items():
        sfx = "" if name == "main" else f"_{name}"
        times[f"k2_chain_ms{sfx}"] = call_ms(lambda: denoise.denoise_finalize(gb, blue), 10)
        k2 = _passes(gb, blue, 10)
        times[f"k2_pass_ms{sfx}"], times[f"k2_pass_kept{sfx}"] = k2["pass_ms"], k2["pass_kept"]
        times[f"k2_chain_plain_ms{sfx}"] = call_ms(
            lambda: denoise.denoise_finalize_plain(gb, blue), 2)
    return times


def phase_volume_times(torch, dev, pipe):
    """K3 against its plain version at 1024² on the volume path's own
    volume, tables and uniforms (plain: one rep), and the whole
    volume_fast frame.  ``k3_ms`` times the wrapper's call (CUDA events),
    ``k3_kernel_ms`` the kernel alone (torch.profiler)."""
    from raytrace_tpu_torch.ops import path_vol, trace_vol
    from raytrace_tpu_torch.render.pipeline import render_frame_packed, unpack_uniforms
    from raytrace_tpu_torch.testing.measure import call_ms

    packed = torch.from_numpy(pipe.uniforms.packed()).to(dev)
    world = pipe.world()
    legs = path_vol.legs_of(pipe.bounces)
    inputs = path_vol.march_inputs(
        world[1], pipe.blue_noise, unpack_uniforms(packed), W, H)
    k3_alone = _alone(lambda: trace_vol.march_paths_vol(
        *inputs["march"], pipe.max_steps, legs), 10, "march_paths_vol_kernel")
    return dict(
        vol_frame_ms=call_ms(lambda: render_frame_packed(
            world, pipe.blue_noise, packed, W, H, pipe.max_steps, pipe.seed,
            pipe.bounces, "volume_fast"), 10),
        k3_ms=call_ms(lambda: trace_vol.march_paths_vol(
            *inputs["march"], pipe.max_steps, legs), 10),
        k3_kernel_ms=k3_alone["kernel_ms"], k3_kept=k3_alone["kept"],
        k3_plain_ms=call_ms(lambda: trace_vol.march_paths_vol_plain(
            *inputs["march"], pipe.max_steps, legs), 1),
    )


def phase_staged_vol_times(torch, pipe, cam, k3s_res):
    """K3s per batch (the kernel alone, the wrapper's call and the plain
    version, from ``k3s_res``) and the device ms of the whole staged volume
    frame (``apps.profile.staged_frame``) at the pipeline's view."""
    from raytrace_tpu_torch.apps.profile import staged_frame
    from raytrace_tpu_torch.testing.measure import call_ms

    batches = k3s_res["batches"]
    return dict(k3s_kernel_ms=[b["kernel_ms"] for b in batches],
                k3s_kept=[b["kept"] for b in batches],
                k3s_ms=[b["ms"] for b in batches],
                k3s_plain_ms=[b["plain_ms"] for b in batches],
                staged_vol_frame_ms=call_ms(lambda: staged_frame(pipe, cam, CANON["sun"]), 10))


def _k4_batches(tables, blue, uniforms, size, max_steps, seed, bounces):
    """The hf G-buffer pass with K4, recording each trace call: (origin,
    direction, active, caps, hit dict) of the primary batch and of each
    bounce's sun + diffuse pair.  ``size``: square, or (width, height)."""
    from raytrace_tpu_torch.ops import integrate, trace_hf

    batches = []

    def trace(o, d, active=None):
        caps = () if active is None else trace_hf.COMPACT_CAPS
        hit = trace_hf.trace_rays_hf(tables, o, d, uniforms["lr"], max_steps, seed,
                                     caps=caps, active=active)
        batches.append((o, d, active, caps, hit))
        return hit

    gb = integrate.integrate_gbuffers(trace, blue, uniforms, *_wh(size), bounces=bounces)
    return gb, batches


def phase_k4(torch, tables, blue, packed, size, max_steps, seed, bounces):
    """K4 against its plain version on the batches a frame gives it: the
    primary rays, then each bounce's sun + diffuse pair with its active
    mask.  Built without FMA contraction, every output must be equal on
    every ray, and no primary may be cut.  Times each batch alone: the
    kernel over 10 calls, the plain version once; ``k4_ms`` (the wrapper's
    call, CUDA events), ``k4_kernel_ms`` (the kernel alone, torch.profiler)
    and ``k4_plain_ms`` are the means over the batches.  Reports K4's
    lane-use census of each batch."""
    from raytrace_tpu_torch.ops import trace_hf
    from raytrace_tpu_torch.render.pipeline import unpack_uniforms
    from raytrace_tpu_torch.testing.measure import call_ms, same

    uniforms = unpack_uniforms(packed)
    _, batches = _k4_batches(tables, blue, uniforms, size, max_steps, seed, bounces)
    keys = ("position", "normal", "air", "albedo", "distance", "exhausted")
    res = dict(size=size, bounces=bounces, batches=[], max_abs_err=0.0)
    ok = True
    ms, k_ms, kept, plain_ms, bounds = [], [], [], [], []
    for b, (o, d, active, caps, _) in enumerate(batches):
        args = (tables, o, d, uniforms["lr"], max_steps, seed)
        kw = dict(caps=caps, active=active)
        census = torch.zeros(1, dtype=torch.int64, device=o.device)
        got = trace_hf.trace_rays_hf(*args, **kw, census=census)
        want, t_p = _timed_once(torch, lambda: trace_hf.trace_rays_hf_plain(*args, **kw))
        ms.append(call_ms(lambda: trace_hf.trace_rays_hf(*args, **kw), 10))
        alone = _alone(lambda: trace_hf.trace_rays_hf(*args, **kw), 10, "trace_hf_kernel")
        k_ms.append(alone["kernel_ms"])
        kept.append(alone["kept"])
        plain_ms.append(t_p)
        equal = {k: same(got[k], want[k]) for k in keys}
        err = float(torch.nan_to_num(got["position"] - want["position"]).abs().max())
        n = o.numel() // 3
        moves, heights = (int(v) for v in want["work"].reshape(-1, 2).sum(0, dtype=torch.int64))
        bound = _bound(n * (12 + 12 + (0 if active is None else 1) + 24) + 32 + 6 * 4096,
                       OPS_PER_HF_MOVE * moves + OPS_PER_HEIGHT * heights)
        bounds.append(bound)
        traced = torch.ones_like(got["air"]) if active is None else active
        exhausted = int((got["exhausted"] & traced).sum())
        res["batches"].append(dict(rays=n, equal=equal, moves=moves, heights=heights,
                                   exhausted_traced=exhausted, ms=ms[-1],
                                   kernel_ms=k_ms[-1], kept=kept[-1], plain_ms=plain_ms[-1],
                                   census=_census(torch, want["work"][..., 0], census),
                                   **bound))
        res["max_abs_err"] = max(res["max_abs_err"], err)
        ok = ok and all(equal.values()) and (b > 0 or exhausted == 0)
    res.update(k4_ms=sum(ms) / len(ms), k4_kernel_ms=sum(k_ms) / len(k_ms), kept=kept,
               k4_plain_ms=sum(plain_ms) / len(plain_ms),
               bound_ms=sum(x["bound_ms"] for x in bounds) / len(bounds),
               bound_by=max(bounds, key=lambda x: x["bound_ms"])["bound_by"])
    return ok, res


def phase_hf_main(rt, torch):
    """The staged heightfield path: 20 frames at 1024² through
    create_instance(tracer="hf")/draw_frame, the camera moving as on the
    main path.  Each frame's graph launches R1 (its hf form) once, K4 once
    per leg batch (1 + bounces), P1 once per bounce, S2 once and K2 six
    times; T1 runs between frames, at most once (the region's tables)."""
    from raytrace_tpu_torch.ops import denoise, lighting
    from raytrace_tpu_torch.render.camera import Camera

    pipe = rt.create_instance(width=W, height=H, tracer="hf")
    cam = Camera(origin=list(CANON["origin"]))
    cam.pitch = CANON["pitch"]
    pipe.teleport(cam)
    base = list(cam.origin)
    pipe.converge_streaming((base[0], 0, base[2]), max_moves=32)
    torch.cuda.synchronize()
    _zero_counts()
    finite, exhausted = [], []
    t0 = time.perf_counter()
    for t in range(FRAMES):
        cam.origin = [base[0] + 0.03 * t, base[1] + 0.03 * t, base[2]]
        frame = pipe.draw_frame(cam, CANON["sun"] + 0.01 * t)
        finite.append(torch.isfinite(frame).all())
        exhausted.append((pipe.gbuffers["depth"].to(torch.int32)
                          == lighting.EXHAUSTED_DEPTH).sum())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    counts = _counts()
    t1 = counts.pop("T1", 0)
    want = {"R1": FRAMES, "K4": (1 + pipe.bounces) * FRAMES, "P1": pipe.bounces * FRAMES,
            "S2": FRAMES, "K2": len(denoise.DENOISE_SIZES) * FRAMES}
    res = dict(
        frames=FRAMES, shape=list(frame.shape), ms_per_frame=ms,
        all_finite=bool(torch.stack(finite).all()),
        exhausted_px=int(torch.stack(exhausted).sum()),
        k4_launches=counts.get("K4", 0), p1_launches=counts.get("P1", 0),
        s2_launches=counts.get("S2", 0), t1_launches=t1, launches=counts,
        launches_want=want, lr=list(pipe.uniforms.lr),
    )
    ok = (res["all_finite"] and res["exhausted_px"] == 0 and counts == want
          and t1 <= 1 and tuple(frame.shape) == (H, W, 3))
    return ok, res, pipe


def phase_hf_vs_fused(torch, pipe, tables):
    """At the hf path's own tables (``tables``: with the column table K1
    reads) and uniforms, the staged G-buffers (K4) against the fused ones
    (K1): normal and albedo equal, depth within a
    quantum and lighting within 1e-5 on at least HF_MATCH of the pixels.
    Not on all: K4 renormalizes its directions (as the JAX kernel does) and
    K1 takes the camera's, so a direction can differ by an ulp and a ray
    that grazes an edge can take the other face.  Given K4's renormalized
    directions, K1 must agree with K4 on every primary normal."""
    from raytrace_tpu_torch.ops import lighting, trace_hf
    from raytrace_tpu_torch.ops.rays import normalize
    from raytrace_tpu_torch.render.pipeline import unpack_uniforms

    uniforms = unpack_uniforms(torch.from_numpy(pipe.uniforms.packed()).to(pipe.device))
    args = (tables, pipe.blue_noise, uniforms, W, H, pipe.max_steps, pipe.seed)
    staged = trace_hf.render_gbuffers_hf(*args, bounces=pipe.bounces)
    fused = lighting.render_gbuffers_fused(*args, bounces=pipe.bounces)
    normal_ok = staged["normal"] == fused["normal"]
    albedo_ok = (staged["albedo"] == fused["albedo"]).all(-1)
    depth_ok = (staged["depth"].to(torch.int32) - fused["depth"].to(torch.int32)).abs() <= 1
    light_ok = (staged["lighting"] - fused["lighting"]).abs().amax(-1) <= 1e-5
    agree = normal_ok & albedo_ok & depth_ok & light_ok
    o, d, *rest = lighting.march_inputs(*args[:5])["march"]
    d = torch.stack(normalize(d[:, 0], d[:, 1], d[:, 2]), -1)
    meta, _ = lighting.march_paths(o, d, *rest, pipe.max_steps, pipe.seed, 1)
    k1_normal = torch.where(((meta >> 12) & 1) == 1, 16, (meta >> 6) & 7)
    res = dict(
        normal_mismatch_given_k4_directions=int(
            (k1_normal.reshape(H, W) != staged["normal"].to(torch.int32)).sum()),
        pixels=agree.numel(), normal_mismatch=int((~normal_ok).sum()),
        albedo_mismatch=int((~albedo_ok).sum()), depth_mismatch=int((~depth_ok).sum()),
        lighting_mismatch=int((~light_ok).sum()),
        lighting_mismatch_where_normal_agrees=int((normal_ok & ~light_ok).sum()),
        agree_share=float(agree.float().mean()),
        exhausted_staged=int((staged["depth"].to(torch.int32) == lighting.EXHAUSTED_DEPTH).sum()),
    )
    ok = (res["agree_share"] >= HF_MATCH and res["exhausted_staged"] == 0
          and res["normal_mismatch_given_k4_directions"] == 0)
    return ok, res


def phase_volume_exact(rt, torch):
    """The exact DDA's path (tracer="volume"): 20 frames at 1024² through
    create_instance/draw_frame, the camera moving as on the main path, each
    one CUDA graph replay of R1 (its dda form), D1 once per leg batch (1 +
    bounces), P1 once per bounce, S2 once and K2 six times, the counts set
    to 0 before the frames and read after them.  Each frame and its
    G-buffers must equal those of an eager twin pipeline
    (``apps.profile.eager_frame``, the same frames after the counts are
    read) bit for bit; host ms/frame of a train, graphed and eager in turns;
    and the share of pixels whose primary normal agrees with volume_fast on
    the same volume.  -> (ok, res, the pipeline)."""
    from raytrace_tpu_torch.apps.profile import eager_frame
    from raytrace_tpu_torch.ops import denoise, lighting, path_vol
    from raytrace_tpu_torch.ops.vol_tables import build_vol_tables
    from raytrace_tpu_torch.render.camera import Camera
    from raytrace_tpu_torch.render.pipeline import unpack_uniforms
    from raytrace_tpu_torch.testing.measure import same

    t_start = time.perf_counter()
    pipe = rt.create_instance(width=W, height=H, tracer="volume")
    twin = rt.create_instance(width=W, height=H, tracer="volume")
    cam = Camera(origin=list(CANON["origin"]))
    cam.pitch = CANON["pitch"]
    for p in (pipe, twin):
        p.teleport(cam)
        p.converge_streaming((cam.origin[0], 0, cam.origin[2]), max_moves=32)
    base = list(cam.origin)
    views = [([base[0] + 0.03 * t, base[1] + 0.03 * t, base[2]], CANON["sun"] + 0.01 * t)
             for t in range(FRAMES)]
    torch.cuda.synchronize()
    _zero_counts()
    frames, gbs = [], []
    for origin, sun in views:
        cam.origin = list(origin)
        frames.append(pipe.draw_frame(cam, sun))
        gbs.append({k: v.clone() for k, v in pipe.gbuffers.items()})
    torch.cuda.synchronize()
    counts = _counts()
    want = {"R1": FRAMES, "D1": (1 + pipe.bounces) * FRAMES, "P1": pipe.bounces * FRAMES,
            "S2": FRAMES, "K2": len(denoise.DENOISE_SIZES) * FRAMES}
    frame_equal, gbuffers_equal = [], []
    for (origin, sun), frame, gb in zip(views, frames, gbs):
        cam.origin = list(origin)
        frame_equal.append(same(frame, eager_frame(twin, cam, sun)))
        gbuffers_equal.append(all(_gbuffers_equal(gb, twin.gbuffers).values()))
    exhausted = sum(_exhausted(gb, torch, lighting) for gb in gbs)
    del frames, gbs
    ms = dict(graphed=[], eager=[])
    draws = dict(graphed=pipe.draw_frame, eager=lambda c, a: eager_frame(pipe, c, a))
    for name in ("graphed", "eager", "eager", "graphed"):
        ms[name].append(_train_ms(torch, draws[name], cam))
    uniforms = unpack_uniforms(torch.from_numpy(pipe.uniforms.packed()).to(pipe.device))
    fast = path_vol.render_gbuffers_path(
        pipe.streamer.volume, build_vol_tables(pipe.streamer.volume), pipe.blue_noise,
        uniforms, W, H, pipe.max_steps, bounces=pipe.bounces)
    res = dict(
        frames=FRAMES, ms_per_frame=min(ms["graphed"]), ms=ms, lr=list(pipe.uniforms.lr),
        launches=counts, launches_want=want, frame_equal=frame_equal,
        gbuffers_equal=gbuffers_equal, exhausted_px=exhausted,
        all_finite=bool(torch.isfinite(pipe.draw_frame(cam, CANON["sun"])).all()),
        normal_agree_with_volume_fast=float(
            (pipe.gbuffers["normal"] == fast["normal"]).float().mean()),
        seconds=time.perf_counter() - t_start,
    )
    ok = (res["all_finite"] and exhausted == 0 and counts == want and all(frame_equal)
          and all(gbuffers_equal))
    return ok, res, pipe


# D1's max_steps on the exact path's batches: the apps' budget, and one that
# exhausts many rays.
DDA_STEPS = (MAX_STEPS, 64)


def _dda_batch(torch, volume, lr, batch, max_steps, timed):
    """D1 against its plain version on one batch: position, normal, air,
    the packed word (or the exhausted mark) and ``steps`` bit for bit; its
    moves, lane use and the volume words it reads (a launch with its census
    and touched bitmap); ``timed``: D1 alone (torch.profiler), its call,
    its grid's launch floor, the plain version (once) and the bound."""
    from raytrace_tpu_torch.apps.kernel_times import dda_census, dda_work
    from raytrace_tpu_torch.ops import trace_dda
    from raytrace_tpu_torch.ops.integrate import EXHAUSTED, Record
    from raytrace_tpu_torch.testing import measure

    o, d, active = batch
    got, steps = trace_dda.march_rays_dda(volume, o, d, active, lr, max_steps)
    (want, want_steps), plain_ms = _timed_once(torch, lambda: trace_dda.march_rays_dda_plain(
        volume, o, d, active, lr, max_steps))
    work = dda_census(volume, o, d, active, lr, max_steps)
    n = o.shape[0]
    res = dict(rays=n, max_steps=max_steps, traced=n if active is None else int(active.sum()),
               equal={k: _held(a, b) for k, a, b in zip(Record._fields, got, want)},
               steps=[int(steps), int(want_steps)],
               exhausted=int(((got.mat & EXHAUSTED) != 0).sum()),
               max_abs_err=_max_abs(torch.nan_to_num(got.pos), torch.nan_to_num(want.pos)),
               **work, **_bound(*dda_work(n, active is not None, work["moves"], work["words"])))
    res["equal"]["steps"] = res["steps"][0] == res["steps"][1]
    if timed:
        d1 = lambda: trace_dda.march_rays_dda(volume, o, d, active, lr, max_steps)
        res.update(call_ms=measure.call_ms(d1, 10), plain_ms=plain_ms,
                   floor_ms=measure.launch_floor_ms(((n + 255) // 256, 1), 256, False, 10),
                   **_alone(d1, 10, KERNEL_NAMES["D1"]))
    return res


def _dda_same(volume, lr, o, d, active, max_steps, got=None) -> dict:
    """D1's record and ``steps`` (``got``: those of a launch already made,
    else one launch now) against the plain version's on the same rays,
    bit for bit."""
    from raytrace_tpu_torch.ops import trace_dda
    from raytrace_tpu_torch.ops.integrate import Record

    if got is None:
        got = trace_dda.march_rays_dda(volume, o, d, active, lr, max_steps)
    (record, steps), (want, want_steps) = got, trace_dda.march_rays_dda_plain(
        volume, o, d, active, lr, max_steps)
    equal = {k: _held(a, b) for k, a, b in zip(Record._fields, record, want)}
    equal["steps"] = int(steps) == int(want_steps)
    return dict(rays=o.shape[0], traced=o.shape[0] if active is None else int(active.sum()),
                steps=[int(steps), int(want_steps)], equal=equal)


def _dda_edges(torch, volume, lr, batches, max_steps) -> dict:
    """D1 against its plain version on edge batches cut from the exact
    frame's (``batches``: primaries, pair 1, pair 2): n = 1, 31, 33 and 1000
    rays with and without pair 1's mask; pair 1 all inactive, the primaries
    all active under a mask, pair 1 under a seeded 80%-inactive mask and
    pair 1 reversed."""
    (po, pd, _), (o1, d1, a1), _ = batches
    gen = torch.Generator(device=o1.device).manual_seed(20)
    sparse = torch.rand(o1.shape[0], generator=gen, device=o1.device) >= 0.8
    cases = {}
    for n in (1, 31, 33, 1000):
        at = o1.shape[0] // 2 - n // 2  # across pair 1's sun and diffuse halves
        cut = lambda t: t[at:at + n].contiguous()
        cases[f"n{n}_masked"] = (cut(o1), cut(d1), cut(a1))
        cases[f"n{n}_primaries"] = (po[:n].contiguous(), pd[:n].contiguous(), None)
    cases.update(
        all_inactive=(o1, d1, torch.zeros_like(a1)),
        all_active_masked=(po, pd, torch.ones(po.shape[0], dtype=torch.bool, device=po.device)),
        inactive_80=(o1, d1, sparse),
        reversed=(o1.flip(0).contiguous(), d1.flip(0).contiguous(), a1.flip(0).contiguous()))
    res = {k: _dda_same(volume, lr, o, d, a, max_steps) for k, (o, d, a) in cases.items()}
    res["all_inactive"]["zero_steps"] = res["all_inactive"]["steps"] == [0, 0]
    return res


def _dda_graph(torch, volume, lr, batches, max_steps) -> dict:
    """D1 captured three times in one CUDA graph (the exact frame's three
    batches, copied into static inputs) and replayed twice: the first
    replay on the batches as they are, the second after the primaries are
    reversed, pair 1 made all inactive and pair 2 given a seeded
    80%-inactive mask; each replay's records and ``steps`` against the
    plain version's on that replay's inputs (a replay that skipped its
    memset or its launch would leave the second's ``steps`` high or its
    records stale)."""
    from raytrace_tpu_torch.ops import trace_dda

    static = [(o.clone(), d.clone(), None if a is None else a.clone()) for o, d, a in batches]
    run = lambda: [trace_dda.march_rays_dda(volume, o, d, a, lr, max_steps)
                   for o, d, a in static]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    res = {}
    for replay in (1, 2):
        if replay == 2:
            (po, pd, _), (_, _, a1), (o2, _, a2) = static
            po.copy_(po.flip(0).clone())
            pd.copy_(pd.flip(0).clone())
            a1.zero_()
            gen = torch.Generator(device=o2.device).manual_seed(20)
            a2.copy_(torch.rand(o2.shape[0], generator=gen, device=o2.device) >= 0.8)
        graph.replay()
        torch.cuda.synchronize()
        res[f"replay_{replay}"] = [
            _dda_same(volume, lr, o, d, a, max_steps, got=(rec, steps.clone()))
            for (o, d, a), (rec, steps) in zip(static, outs)]
    res["replay_2"][1]["zero_steps"] = res["replay_2"][1]["steps"] == [0, 0]
    return res


def phase_dda_kernel(torch, dev, pipe):
    """D1 against its plain version (``_dda_batch``) on the exact path's
    three 1024² batches at its last frame's view (``pipe``: the
    volume_exact pipeline; the primaries and each bounce's pair with its
    active flags, ``kernel_times.dda_batches``) at max_steps 2048 and 64,
    and on config 1's single chunk (512² primaries, max_steps 1024); D1
    timed alone at 2048 beside its grid's launch floor; then on
    edge batches (``_dda_edges``) and in a CUDA graph replayed twice
    (``_dda_graph``).  No primary may be exhausted at the apps' budgets."""
    from raytrace_tpu_torch.apps import benchmark
    from raytrace_tpu_torch.apps.kernel_times import dda_batches
    from raytrace_tpu_torch.ops import rays
    from raytrace_tpu_torch.render.pipeline import unpack_uniforms

    t0 = time.perf_counter()
    uni = unpack_uniforms(torch.from_numpy(pipe.uniforms.packed()).to(dev))
    volume = pipe.world()
    batches = dda_batches(volume, pipe.blue_noise, uni, W, H, pipe.max_steps, pipe.bounces)
    res = {f"main_{m}": [_dda_batch(torch, volume, uni["lr"], b, m, m == MAX_STEPS)
                         for b in batches] for m in DDA_STEPS}
    chunk = benchmark.single_chunk_volume(dev)
    cuni = benchmark._moved(benchmark.CONFIG1_CAMERA, dev)(0.0)
    f = rays.frame_rays(cuni, pipe.blue_noise, 512, 512, tables=None, form="dda")
    res["config1_512_b0"] = _dda_batch(torch, chunk, cuni["lr"],
                                       (f["origin"], f["direction"], None), 1024, True)
    edges = _dda_edges(torch, volume, uni["lr"], batches, MAX_STEPS)
    graphed = _dda_graph(torch, volume, uni["lr"], batches, MAX_STEPS)
    main = res[f"main_{MAX_STEPS}"]
    res.update(max_abs_err=max(b["max_abs_err"] for k, v in res.items()
                               for b in (v if isinstance(v, list) else [v])),
               kernel_ms=sum(b["kernel_ms"] for b in main) / len(main),
               plain_ms=sum(b["plain_ms"] for b in main) / len(main),
               bound_ms=sum(b["bound_ms"] for b in main) / len(main),
               bound_by=max(main, key=lambda b: b["bound_ms"])["bound_by"],
               seconds=time.perf_counter() - t0)
    every = [b for k, v in res.items() if isinstance(v, (list, dict)) and k != "max_abs_err"
             for b in (v if isinstance(v, list) else [v])]
    every += list(edges.values()) + [b for v in graphed.values() for b in v]
    res.update(edges=edges, graph=graphed)
    ok = (all(all(b["equal"].values()) for b in every)
          and main[0]["exhausted"] == 0 and res["config1_512_b0"]["exhausted"] == 0
          and any(b["exhausted"] for b in res["main_64"])
          and edges["all_inactive"]["zero_steps"] and graphed["replay_2"][1]["zero_steps"])
    return ok, res


def phase_hf_frame_ms(torch, pipe):
    """Device ms of the whole hf frame at the hf path's tables and uniforms."""
    from raytrace_tpu_torch.render.pipeline import render_frame_packed
    from raytrace_tpu_torch.testing.measure import call_ms

    packed = torch.from_numpy(pipe.uniforms.packed()).to(pipe.device)
    tables = pipe.tables()
    return call_ms(lambda: render_frame_packed(
        tables, pipe.blue_noise, packed, W, H, pipe.max_steps, pipe.seed,
        pipe.bounces, "hf"), 10)


# float32 operations of a pixel (counted from csrc/staged.cu, at least):
# P1's nudge and diffuse direction, and in the hf mode the noise bytes, the
# jittered sun and the sphere point besides; S2's work around its skies
# (the nudge, the radiance sums, the albedos, the depth and the fog).
OPS_P1_HF = 42
OPS_P1_VOLUME = 18
OPS_S2_OTHER = 30


def _held(a, b) -> bool:
    """Equal in shape, type and every bit, a NaN matching a NaN (-0 is not
    +0)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype != torch.float32:
        return bool(torch.equal(_wide(a), _wide(b)))
    eq = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
    return bool(eq.all())


def _staged_front(torch, mode, world, blue, uniforms, size, band=None):
    """The staged frame's front and raw tracer for ``mode`` ("hf": world =
    the region tables; "volume": (volume, tables); "dda": the volume) at
    ``size`` (square or (width, height)) and ``band`` (row0, rows) or the
    whole frame: (front, noise, trace, volume S2 reads, (rows, width))."""
    from raytrace_tpu_torch.ops import rays, trace_dda, trace_hf, trace_vol
    from raytrace_tpu_torch.ops.integrate import DDA, HF, Record

    w, h = _wh(size)
    row0, rows = band or (0, h)
    if mode == DDA:
        front = rays.frame_rays(uniforms, blue, w, h, row0, rows, tables=None, form=mode)

        def trace(o, d, active):
            return trace_dda.march_rays_dda(world, o, d, active, uniforms["lr"], MAX_STEPS)[0]
        return front, front["nw"], trace, None, (rows, w)
    if mode == HF:
        tables, volume = world, None
    else:
        volume, tables = world
    front = rays.frame_rays(uniforms, blue, w, h, row0, rows, tables=tables, form=mode)
    if mode == HF:
        def trace(o, d, active):
            caps = () if active is None else trace_hf.COMPACT_CAPS
            return Record(*trace_hf.march_rays_hf(o, d, active, front["iscal"], tables,
                                                  trace_hf.hf_budget(MAX_STEPS, caps), 0))
        return front, front["nw"], trace, volume, (rows, w)
    rounds = trace_vol.rays_vol_rounds(MAX_STEPS)

    def trace(o, d, active):
        return Record(*trace_vol.march_rays_vol(o, d, active, front["iscal"], tables, rounds))
    return front, front["inv"], trace, volume, (rows, w)


def _p1_bound(mode, n, chained) -> dict:
    """P1's bound for n pixels: each input read once (the hit, its flags,
    the earlier flags of a chained batch, the noise), each output written
    once (two rays a pixel)."""
    words = mode != "volume"  # the noise words and the sphere table (hf, dda)
    flags = {"hf": 4, "volume": 2, "dda": 1}[mode]
    reads = n * (12 + 4 + flags + (1 if chained else 0) + (4 if words else 24))
    reads += 8 * 4 + (256 * 8 if words else 0)
    return _bound(reads + n * 2 * (12 + 12 + 1), n * (OPS_P1_HF if words else OPS_P1_VOLUME))


def _s2_bound(torch, mode, records, volume_hits, n) -> dict:
    """S2's bound for n pixels from this run's records: the primary's hit,
    flags and direction, each pair's two air flags and diffuse direction,
    the first diffuse hit's material (and position, in the volume mode),
    one volume word a hit that gathers one, the six G-buffers written; a
    sky for each pixel and for each diffuse ray that reached the sky."""
    hf = mode == "hf"
    flag = 4 if hf else 1  # an air flag
    mat = 1 if mode == "volume" else 4  # a done flag or a packed word
    bounces = len(records) - 1
    reads = n * (12 + 4 + flag + mat + 12) + 8 * 4 + 3 * 4 + volume_hits * 4
    reads += n * bounces * (2 * flag + 12) + (
        n * (mat + (12 if mode == "volume" else 0)) if bounces == 2 else 0)
    air = lambda r: (r.air[n:] != 0) if hf else r.air[n:]
    skies = n + sum(int(air(r).sum()) for r in records[1:])
    return _bound(reads + n * 51, skies * OPS_PER_SKY + n * OPS_S2_OTHER)


def _staged_glue_case(torch, mode, world, blue, uniforms, size, bounces, band=None,
                      timed=False):
    """P1 and S2 against their plain versions on one staged frame's own
    records: the tracer's raw hits of each batch, each P1 call (its whole
    2N-ray output: both halves) and the S2 call, every output bit for bit
    (a NaN matching a NaN).  ``timed``: each call alone (torch.profiler,
    ``kept``), its call (CUDA events) and its plain version (once)."""
    from raytrace_tpu_torch.ops import integrate
    from raytrace_tpu_torch.ops.lighting import EXHAUSTED_DEPTH
    from raytrace_tpu_torch.testing.measure import call_ms

    front, noise, trace, volume, shape = _staged_front(torch, mode, world, blue, uniforms,
                                                       size, band)
    n = shape[0] * shape[1]
    res = dict(mode=mode, shape=list(shape), bounces=bounces, band=band, p1=[], equal={},
               p1_max_abs_err=0.0, s2_max_abs_err=0.0)
    records = [trace(front["origin"], front["direction"], None)]
    directions = [front["direction"]]
    active = None
    for bounce in range(bounces):
        args = (mode, records[-1], noise, front["sun"], bounce, active)
        got = integrate.leg_batch(*args)
        want, plain_ms = _timed_once(torch, lambda: integrate.leg_batch_plain(*args))
        for k, g, w_ in zip(("origin", "direction", "active"), got, want):
            res["equal"][f"p1_{bounce}_{k}"] = _held(g, w_)
            res["p1_max_abs_err"] = max(res["p1_max_abs_err"], _max_abs(
                torch.nan_to_num(g.float()), torch.nan_to_num(w_.float())))
        one = dict(rays=2 * n, active=int(got[2].sum()), **_p1_bound(mode, n, bounce > 0))
        if timed:
            p1 = lambda: integrate.leg_batch(*args)
            one.update(call_ms=call_ms(p1, 10), plain_ms=plain_ms,
                       **_alone(p1, 10, KERNEL_NAMES["P1"]))
        res["p1"].append(one)
        origin, direction, active = got
        records.append(trace(origin, direction, active))
        directions.append(direction)
    args = (mode, records, directions, front["sun"], uniforms["origin"], shape, volume)
    got = integrate.shade_staged(*args)
    want, plain_ms = _timed_once(torch, lambda: integrate.shade_staged_plain(*args))
    for k in want:
        res["equal"][f"s2_{k}"] = _held(got[k], want[k])
        res["s2_max_abs_err"] = max(res["s2_max_abs_err"], _max_abs(
            torch.nan_to_num(_wide(got[k]).float()), torch.nan_to_num(_wide(want[k]).float())))
    hits = 0
    if mode == "volume":  # volume words gathered: the primary's hits and the first diffuse hits'
        hit = lambda r, lo, hi: (r.mat[lo:hi] & ~r.air[lo:hi])
        hits = int(hit(records[0], 0, n).sum()) + (
            int(hit(records[1], n, 2 * n).sum()) if bounces == 2 else 0)
    exhausted = int((got["depth"].to(torch.int32) == EXHAUSTED_DEPTH).sum())
    res["s2"] = dict(exhausted_px=exhausted, sky_px=int(
        (got["depth"].to(torch.int32) == 0xFFFF).sum()), **_s2_bound(torch, mode, records,
                                                                      hits, n))
    if timed:
        s2 = lambda: integrate.shade_staged(*args)
        res["s2"].update(call_ms=call_ms(s2, 10), plain_ms=plain_ms,
                         **_alone(s2, 10, KERNEL_NAMES["S2"]))
    return all(res["equal"].values()) and exhausted == 0, res


def _random_record(torch, dev, mode, m, seed):
    """``m`` seeded random raw hits of ``mode``: positions over the region
    (a tenth on texel faces, a twentieth NaN), normal ids 0-7, air, and
    packed words (a quarter 0) or done flags (some air rays not done)."""
    import numpy as np

    from raytrace_tpu_torch.ops.integrate import EXHAUSTED, Record

    rng = np.random.default_rng(seed)
    pos = rng.uniform(-140.0, 140.0, (m, 3)).astype(np.float32)
    face = rng.random(m) < 0.1
    pos[face] = np.floor(pos[face])
    pos[rng.random(m) < 0.05] = np.nan
    normal = rng.integers(0, 8, m).astype(np.int32)
    air = rng.random(m) < 0.3
    if mode == "hf":
        mat = rng.integers(-2 ** 31, 2 ** 31, m, dtype=np.int64).astype(np.int32)
        mat[rng.random(m) < 0.25] = 0
        air = air.astype(np.int32)
    elif mode == "dda":  # packed words (a fifth 0, none for air) and exhausted rays
        mat = rng.integers(0, EXHAUSTED, m).astype(np.int32)
        mat[(rng.random(m) < 0.2) | air] = 0
        mat[~air & (rng.random(m) < 0.1)] = EXHAUSTED
    else:
        mat = air | (rng.random(m) < 0.8)
        mat[rng.random(m) < 0.03] = False
    return Record(*(torch.from_numpy(a).to(dev) for a in (pos, normal, air, mat)))


def _staged_glue_random(torch, dev, mode, volume, n, seed) -> dict:
    """P1 and S2 against their plain versions on random raw records at b0,
    b1 and b2 (``_random_record``), random noise, earlier flags, bounce
    directions and camera: every output bit for bit (a NaN matching a
    NaN)."""
    import numpy as np

    from raytrace_tpu_torch.ops import integrate, shading

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev)
    noise = (t(rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32))
             if mode != "volume" else t(rng.uniform(-1, 1, (n, 12)).astype(np.float32)))
    sun = shading.sun_vector(torch.tensor(0.6, dtype=torch.float32, device=dev))
    cam = t(rng.uniform(-100, 100, 3).astype(np.float32))
    records = [_random_record(torch, dev, mode, n if b == 0 else 2 * n, seed + b)
               for b in range(3)]
    dirs, _ = _random_rays(torch, dev, 5 * n, seed + 3)
    directions = [dirs[:n], dirs[n:3 * n], dirs[3 * n:]]
    prev = t(rng.random(2 * n) < 0.6)
    prev[n:] = prev[:n]
    equal = {}
    for bounce, rec, act in ((0, records[0], None), (1, records[1], prev)):
        args = (mode, rec, noise, sun, bounce, act)
        got, want = integrate.leg_batch(*args), integrate.leg_batch_plain(*args)
        for k, g, w_ in zip(("origin", "direction", "active"), got, want):
            equal[f"p1_{bounce}_{k}"] = _held(g, w_)
    for bounces in (0, 1, 2):
        args = (mode, records[:1 + bounces], directions[:1 + bounces], sun, cam, (n // 64, 64),
                volume)
        got, want = integrate.shade_staged(*args), integrate.shade_staged_plain(*args)
        for k in want:
            equal[f"s2_b{bounces}_{k}"] = _held(got[k], want[k])
    return dict(mode=mode, pixels=n, equal=equal)


def phase_staged_glue_kernel(torch, dev, blue, hf_world, vol_world):
    """P1 and S2 against their plain versions, every output bit for bit
    (a NaN matching a NaN), on the records of the staged frames: hf on the
    hf path's tables and uniforms (``hf_world``: (tables, packed)), and the
    staged volume frame and the exact DDA's frame on the volume_fast path's
    world (``vol_world``: ((volume, tables), packed)), each at 1024² b2 (P1
    both bounces, both halves of each batch; timed: each kernel alone, its
    call, its plain version, its bound); config 2's hf frame at 1920x1080
    b1; a 270-row band of each (hf 1920x1080 rows 270-539, volume and dda
    1024² rows 300-569, b2); then 4096 random raw records of each mode at
    b0, b1 and b2."""
    from raytrace_tpu_torch.apps import benchmark
    from raytrace_tpu_torch.ops.hf_tables import build_hf_tables
    from raytrace_tpu_torch.render.pipeline import unpack_uniforms

    t0 = time.perf_counter()
    hf_uni = unpack_uniforms(hf_world[1])
    vol_uni = unpack_uniforms(vol_world[1])
    res, ok = {}, True
    cases = {
        "hf_main_b2": ("hf", hf_world[0], hf_uni, W, 2, None, True),
        "volume_main_b2": ("volume", vol_world[0], vol_uni, W, 2, None, True),
        "hf_config2_1920x1080_b1": (
            "hf", build_hf_tables((0, 0, 0), seed=0, device=dev),
            benchmark._moved(benchmark.CONFIG2_CAMERA, dev)(0.0), (1920, 1080), 1, None,
            False),
        "hf_band_1920x1080_270+270_b2": ("hf", hf_world[0], hf_uni, (1920, 1080), 2,
                                         (270, 270), False),
        "volume_band_300+270_b2": ("volume", vol_world[0], vol_uni, W, 2, (300, 270), False),
        "dda_main_b2": ("dda", vol_world[0][0], vol_uni, W, 2, None, True),
        "dda_band_300+270_b2": ("dda", vol_world[0][0], vol_uni, W, 2, (300, 270), False),
    }
    for label, (mode, world, uni, size, bounces, band, timed) in cases.items():
        one_ok, res[label] = _staged_glue_case(torch, mode, world, blue, uni, size, bounces,
                                               band, timed)
        ok = ok and one_ok
    for mode, volume in (("hf", None), ("volume", vol_world[0][0]), ("dda", None)):
        res[f"{mode}_random"] = _staged_glue_random(torch, dev, mode, volume, 4096, 60)
        ok = ok and all(res[f"{mode}_random"]["equal"].values())
    res["seconds"] = time.perf_counter() - t0
    return ok, res


GRAPH_FRAMES = 16  # frames flown at +VOL_DX in x: one slice crossing at least
# The kernel launches of one b2 frame of each graphed tracer.
GRAPH_KERNELS = {"fused": {"T1": 1, "R1": 1, "K1": 1, "S1": 1, "K2": 6},
                 "hf": {"R1": 1, "K4": 3, "P1": 2, "S2": 1, "K2": 6},
                 "volume_fast": {"R1": 1, "K3": 1, "S3": 1, "K2": 6},
                 "volume": {"R1": 1, "D1": 3, "P1": 2, "S2": 1, "K2": 6}}
# Each kernel's name in a profiler trace.
KERNEL_NAMES = {"T1": "hf_tables_kernel", "K1": "march_paths_kernel",
                "K2": "denoise_pass_kernel", "F1": "finalize_kernel",
                "R1": "frame_rays_kernel",
                "S1": "shade_fused_kernel", "S3": "shade_vol_kernel",
                "K3": "march_paths_vol_kernel", "K4": "trace_hf_kernel",
                "K3s": "trace_rays_vol_kernel", "D1": "trace_dda_kernel",
                "P1": "leg_batch_kernel",
                "S2": "shade_staged_kernel",
                "G1": "worldgen_kernel", "O1": "vol_tables_kernel"}
TELEPORT_DX = (600.0, -300.0)  # x, z of the graph_frames teleport
PROFILED_REPLAYS = 3  # steady replays in graph_frames' profiler trace


def _train_ms(torch, draw, cam, frames=FRAMES) -> float:
    """Host ms/frame of ``frames`` frames enqueued back to back, one sync
    at the end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(frames):
        draw(cam, CANON["sun"] + 0.01 * t)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / frames


def phase_graph_frames(rt, torch, tracer):
    """The frame as one CUDA graph replay (``render/frame_graph.py``):
    ``draw_frame`` of ``tracer`` at 1024² against a twin pipeline that
    renders the same frames eagerly (``apps.profile.eager_frame``: the same
    streaming, uniforms and ``render_frame`` on its own world), bit for bit
    on every frame and G-buffer.  The train flies GRAPH_FRAMES frames at
    +VOL_DX in x (slice crossings; on the volume tracers a streamed slab
    each), then, on the volume tracers, edits the volume; then both
    teleport.  A frame
    held across the next two draws must not change; the launch counters
    around the graphed draws must equal GRAPH_KERNELS times the frames (on
    hf, T1 once per region: the first frame's, each crossing's and the
    teleport's, built between frames), and a profiler trace of
    PROFILED_REPLAYS graphed frames must name each kernel (fused: T1 at
    least once and at most once a replay, its tables rebuilt inside the
    graph; hf and the volume tracers: no T1).  Then the timings, graphed
    and eager in turns on the same pipeline: the host ms/frame of a
    FRAMES-frame train, a steady frame, a slice-crossing frame and the
    frame after a teleport, each alone; then a crossing's parts alone (T1's
    build of the region tables through ``build_hf_tables``, or the slab
    and, on volume_fast, the occupancy tables' update)."""
    from raytrace_tpu_torch.apps.profile import eager_frame
    from raytrace_tpu_torch.ops import lighting
    from raytrace_tpu_torch.render.camera import Camera
    from raytrace_tpu_torch.testing.measure import same, synced_ms

    t_start = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pipe = rt.create_instance(width=W, height=H, tracer=tracer)
    twin = rt.create_instance(width=W, height=H, tracer=tracer)
    cam = Camera(origin=list(CANON["origin"]))
    cam.pitch = CANON["pitch"]
    for p in (pipe, twin):
        p.teleport(cam)
    base = list(cam.origin)
    steps = [("fly", [base[0] + VOL_DX * t, base[1], base[2]]) for t in range(GRAPH_FRAMES)]
    last = steps[-1][1]
    volume_tracer = tracer in ("volume_fast", "volume")
    if volume_tracer:
        steps += [("edit", last), ("frame", last)]
    far = [last[0] + TELEPORT_DX[0], last[1], last[2] + TELEPORT_DX[1]]
    steps += [("teleport", far), ("frame", far), ("frame", far)]
    _zero_counts()
    launched, res = {}, dict(tracer=tracer, frames=0, frame_equal=[], gbuffers_equal=[],
                             exhausted_px=0, crossings=0, slabs=0, teleports=0, events=[])
    # The graphed pipeline's slabs (G1 each) and table drains (O1: a
    # rebuild, or one update a slab), counted by the streamer's own calls.
    streamed, drains = [], []
    setup, drain = pipe.streamer.setup_next_request, pipe.streamer.drain_slab_log

    def counted_setup():
        streamed.append(setup())
        return streamed[-1]

    def counted_drain():
        drains.append(drain())
        return drains[-1]

    pipe.streamer.setup_next_request = counted_setup
    pipe.streamer.drain_slab_log = counted_drain
    held, region, regions = None, None, 0
    for t, (event, origin) in enumerate(steps):
        cam.origin = list(origin)
        res["events"].append(event)
        # The graphed pipeline's world event and frame, counted; then the
        # twin's, outside the count.
        before = _launch_counts()
        if event == "edit":
            x, y, z = (int(v) for v in cam.origin)
            depth_before = pipe.gbuffers["depth"].to(torch.int32)
            edit = ((x, y + 24, z - 40), (40, 4, 60), 6)  # a snow wall, as volume_edit
            pipe.edit_box(*edit)
        if event == "teleport":
            pipe.teleport(cam)
            res["teleports"] += 1
        lr = pipe.streamer.get_render_offset()
        frame = pipe.draw_frame(cam, CANON["sun"] + 0.01 * t)
        for k, n in _launches_since(before).items():
            launched[k] = launched.get(k, 0) + n
        regions += pipe.uniforms.lr != region
        region = pipe.uniforms.lr
        if event == "edit":
            twin.edit_box(*edit)
        if event == "teleport":
            twin.teleport(cam)
        want = eager_frame(twin, cam, CANON["sun"] + 0.01 * t)
        res["frames"] += 1
        res["crossings"] += event == "fly" and pipe.streamer.get_render_offset() != lr
        res["frame_equal"].append(same(frame, want) and pipe.uniforms.lr == twin.uniforms.lr)
        res["gbuffers_equal"].append(all(_gbuffers_equal(pipe.gbuffers, twin.gbuffers).values()))
        res["exhausted_px"] += _exhausted(pipe.gbuffers, torch, lighting)
        if event == "edit":
            res["edit_changed_px"] = int(
                (pipe.gbuffers["depth"].to(torch.int32) != depth_before).sum())
        if t == 2:
            held, held_copy = frame, frame.clone()
        if t == 4:
            res["held_frame_unchanged"] = same(held, held_copy)
    pipe.streamer.setup_next_request, pipe.streamer.drain_slab_log = setup, drain
    res["launches"] = launched
    res["launches_want"] = {k: n * res["frames"] for k, n in GRAPH_KERNELS[tracer].items()}
    if tracer == "hf":
        res["launches_want"]["T1"] = regions
    if volume_tracer:
        # G1 once a slab and once a teleport's region; on volume_fast O1
        # once a drain that rebuilds (an edit, a teleport) and once a slab
        # it updates.
        res["slabs"] = sum(streamed)
        res["launches_want"]["G1"] = res["slabs"] + res["teleports"]
    if tracer == "volume_fast":
        res["launches_want"]["O1"] = sum(1 if log is None else len(log) for log in drains)
    # The profiler can drop the first few records of a trace in a long
    # process (T1, the replay's first kernel, went missing so), so the
    # trace takes PROFILED_REPLAYS replays: each kernel must show at least
    # once, T1 on fused in no more replays than were taken (one a replay).
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(PROFILED_REPLAYS):
            pipe.draw_frame(cam, CANON["sun"])
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    res["profiled_activities"] = len(names)
    res["profiled_activities_per_replay"] = len(names) / PROFILED_REPLAYS
    res["profiled_replays"] = PROFILED_REPLAYS
    res["profiled_kernels"] = {k: sum(KERNEL_NAMES[k] in n for n in names)
                               for k in GRAPH_KERNELS[tracer]}
    if not volume_tracer:  # "fused" rebuilds its tables in every replay; "hf" not
        res["profiled_kernels"]["T1"] = sum(KERNEL_NAMES["T1"] in n for n in names)
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    res["memory_reserved"] = torch.cuda.memory_reserved()

    # Timings on the graphed pipeline: its own path and the eager one, in
    # turns (graphed, eager, eager, graphed), then the events alone.
    draws = dict(graphed=pipe.draw_frame, eager=lambda c, a: eager_frame(pipe, c, a))
    ms = {k: dict(train=[], steady=[], crossing=[], teleport=[], after_teleport=[])
          for k in draws}
    for name in ("graphed", "eager", "eager", "graphed"):
        draw = draws[name]
        ms[name]["train"].append(_train_ms(torch, draw, cam))
        ms[name]["steady"].append(synced_ms(lambda: draw(cam, CANON["sun"])))
        # Past the slice the region follows: teleport rounds the offset to
        # within 8 voxels of the camera, and a move needs a drift of 17.
        cam.origin[0] += 25.0
        lr = pipe.streamer.get_render_offset()
        ms[name]["crossing"].append(synced_ms(lambda: draw(cam, CANON["sun"])))
        res["crossings_timed_ok"] = (res.get("crossings_timed_ok", True)
                                     and pipe.streamer.get_render_offset() != lr)
        cam.origin[2] += TELEPORT_DX[1]
        ms[name]["teleport"].append(synced_ms(lambda: pipe.teleport(cam)))
        ms[name]["after_teleport"].append(synced_ms(lambda: draw(cam, CANON["sun"])))
        res["exhausted_px"] += _exhausted(pipe.gbuffers, torch, lighting)
    # A crossing's parts alone, synced: the region tables (and K1's column
    # table), or the slab's generation and the occupancy tables' update.
    reps = range(3)
    if volume_tracer:
        def slab():  # one slice move along +x: G1
            pipe.streamer.request_increase(0)
            pipe.streamer.setup_next_request()
        tables = tracer == "volume_fast"  # and the occupancy tables' update (O1)
        ms["parts"] = dict(slab=[], **(dict(vol_tables_update=[]) if tables else {}))
        for _ in reps:
            ms["parts"]["slab"].append(synced_ms(slab))
            if tables:
                ms["parts"]["vol_tables_update"].append(synced_ms(pipe.vol_tables))
        # G1 and O1 alone on the same path (each call streams one slab).
        ms["parts"]["g1_alone"] = _alone(slab, 10, KERNEL_NAMES["G1"])
        if tables:
            pipe.vol_tables()
            ms["parts"]["o1_alone"] = _alone(lambda: (slab(), pipe.vol_tables()), 10,
                                             KERNEL_NAMES["O1"])
    else:
        # T1 through its wrapper as Pipeline.tables() calls it (a host lr
        # uploaded from pinned memory, one launch; with the column table
        # for fused), and T1 alone in the profiler.
        from raytrace_tpu_torch.ops.hf_tables import build_hf_tables

        lr = pipe.streamer.get_render_offset()
        lr_k = lambda k: (lr[0] + 16 * (k + 1), 0, lr[2])
        fused = tracer == "fused"
        ms["parts"] = dict(hf_tables=[synced_ms(lambda: build_hf_tables(
            lr_k(k), seed=pipe.seed, device=pipe.device, hcol=fused)) for k in reps])
        ms["parts"]["t1_alone"] = _alone(lambda: build_hf_tables(
            lr_k(0), seed=pipe.seed, device=pipe.device, hcol=fused), 10, KERNEL_NAMES["T1"])
    res["ms"] = ms
    res["seconds"] = time.perf_counter() - t_start
    ok = (all(res["frame_equal"]) and all(res["gbuffers_equal"]) and res["exhausted_px"] == 0
          and res["held_frame_unchanged"] and res["crossings"] >= 1
          and res["crossings_timed_ok"] and launched == res["launches_want"]
          and all(n >= GRAPH_KERNELS[tracer].get(k, 0) for k, n in res["profiled_kernels"].items())
          and (1 <= res["profiled_kernels"]["T1"] <= PROFILED_REPLAYS if tracer == "fused"
               else res["profiled_kernels"].get("T1", 0) == 0))
    if volume_tracer:
        ok = ok and res["slabs"] >= 1 and res["edit_changed_px"] > 0
    return ok, res


COUNTED_FRAMES = 3  # frames drawn under the profiler in frame_census


def phase_frame_census(rt, torch, tracer):
    """The march's counters in the frame program's graph, which every
    replay adds to, against the march's census on the same frames run
    alone: the moves each recorded ``replay`` span carries, and on one
    thread per pixel (K1) the warp iterations too.  The frames cross
    slices (on volume_fast each streams a slab)."""
    from raytrace_tpu_torch.ops import lighting, path_vol, trace_vol
    from raytrace_tpu_torch.render.camera import Camera
    from raytrace_tpu_torch.render.pipeline import unpack_uniforms
    from raytrace_tpu_torch.utils import perf

    pipe = rt.create_instance(width=W, height=H, tracer=tracer)
    cam = Camera(origin=list(CANON["origin"]))
    cam.pitch = CANON["pitch"]
    pipe.teleport(cam)
    pipe.draw_frame(cam, CANON["sun"])  # the warm-up, which captures the graph
    want = []
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities):
        for t in range(COUNTED_FRAMES):
            cam.origin = [CANON["origin"][0] + 12.0 * (t + 1), *CANON["origin"][1:]]
            pipe.draw_frame(cam, CANON["sun"])
            uniforms = unpack_uniforms(torch.from_numpy(pipe.uniforms.packed()).to(pipe.device))
            census = torch.zeros(2, dtype=torch.int64, device=pipe.device)
            if tracer == "fused":
                march = lighting.march_inputs(pipe.tables(), pipe.blue_noise, uniforms, W,
                                              H)["march"]
                lighting.march_paths(*march, pipe.max_steps, pipe.seed, 1 + 2 * pipe.bounces,
                                     census=census)
            else:
                march = path_vol.march_inputs(pipe.world()[1], pipe.blue_noise, uniforms, W,
                                              H)["march"]
                trace_vol.march_paths_vol(*march, pipe.max_steps,
                                          path_vol.legs_of(pipe.bounces), census=census)
            want.append(dict(zip(("warp_iterations", "moves"), census.tolist())))
    got = [s.counts for s in perf.recorded() if s.name == "replay"]
    res = dict(tracer=tracer, recorded=got, alone=want)
    same = ("warp_iterations", "moves") if tracer == "fused" else ("moves",)
    ok = len(got) == COUNTED_FRAMES and all(
        g[k] == w[k] for g, w in zip(got, want) for k in same)
    return ok, res


def _scratch_dir(name: str) -> Path:
    """An empty directory inside the checkout's build directory (which
    ``.gitignore`` lists) for the files a phase writes."""
    import shutil

    path = ROOT / "raytrace_tpu_torch" / "build" / "smoke" / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def _launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    from raytrace_tpu_torch.ops import (
        denoise, finalize, hf_tables, integrate, lighting, path_vol, rays, trace_dda,
        trace_hf, trace_vol, vol_tables, worldgen)
    from raytrace_tpu_torch.world import generate

    return dict(D1=trace_dda.march_rays_dda.launches,T1=hf_tables.build_hf_tables.launches, R1=rays.frame_rays.launches,
                F1=finalize.finalize_frame.launches,
                P1=integrate.leg_batch.launches, S2=integrate.shade_staged.launches,
                K1=lighting.march_paths.launches, S1=lighting.shade.launches,
                S3=path_vol.shade.launches,
                K2=denoise.launch_pass.launches,
                K3=trace_vol.march_paths_vol.launches,
                K3s=trace_vol.march_rays_vol.launches, K4=trace_hf.march_rays_hf.launches,
                G1=worldgen.generate_into.launches, G1box=generate.generate_box.launches,
                O1=vol_tables.build_vol_tables.launches + vol_tables.update_vol_tables.launches)


def _launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launch_counts().items() if v != before[k]}


def phase_native_codec(torch, dev):
    """The port's host codec: the library builds with g++, a chunk generated
    on the card (G1's box mode) survives encode and decode through
    ``ChunkStorage`` (a miss, generated by G1's box mode too, then a hit),
    its file starts with ``RTL4``, and ``native.copy3d`` equals
    ``coords.copy_3d_clipped`` on a box clipped on every axis."""
    import numpy as np

    from raytrace_tpu_torch import native
    from raytrace_tpu_torch.utils.coords import copy_3d_clipped
    from raytrace_tpu_torch.world.generate import generate_chunk
    from raytrace_tpu_torch.world.storage import ChunkStorage

    t0 = time.perf_counter()
    res = dict(lz4=native.lz4_available(), build_error=native.build_error,
               library=native.library_path().name)
    storage = ChunkStorage(_scratch_dir("codec"), seed=0, device=dev)
    coord = (0, 0, 0)
    before = _launch_counts()
    mats, mf = (t.cpu().numpy() for t in generate_chunk(coord, seed=0, device=dev))
    miss = storage.borrow_packed_chunk_data(coord)
    blob = storage.path_for(coord).read_bytes()
    hit = storage.borrow_packed_chunk_data(coord)
    res.update(launches=_launches_since(before))
    res.update(magic=blob[:4].decode("latin-1"), file_bytes=len(blob),
               solid_voxels=int((mats != 0).sum()),
               miss_equal=bool(np.array_equal(miss[0], mats) and np.array_equal(miss[1], mf)),
               hit_equal=bool(np.array_equal(hit[0], mats) and np.array_equal(hit[1], mf)))
    copies = {}
    for name, src in (("materials", mats), ("minefield", mf)):
        got = np.zeros((40, 48, 56), src.dtype)
        want = got.copy()
        box = ((64, 64, 64), (5, -7, 9), (-11, 13, -3))  # size, src start, dst start
        native.copy3d(src, got, *box)
        copy_3d_clipped(src, want, *box)
        copies[name] = bool(np.array_equal(got, want)) and bool(got.any() or not src.any())
    res.update(copy3d_equal=copies, seconds=time.perf_counter() - t0)
    ok = (res["lz4"] and res["magic"] == "RTL4" and res["miss_equal"] and res["hit_equal"]
          and all(copies.values()) and res["launches"] == {"G1box": 2})
    return ok, res


CACHE_SIZE = 512  # frames of the cache_stream phase
CACHE_FRAMES = 20


def phase_cache_stream(rt, torch):
    """``apps.generate_world.run(radius=2)`` writes the 64 chunks of the
    initial region (16 x-rows: 16 launches of G1's box mode); then a
    ``volume_fast`` pipeline streaming from that cache and one generating
    on the card fly CACHE_FRAMES frames at +VOL_DX x a frame.  The slabs
    beyond the region are cache misses, each chunk generated on the card
    by one launch of G1's box mode and stored.  Their volumes must be
    bit-equal after every frame, and so must their frames.  Times each
    frame of each pipeline on the host clock, synchronized, apart for the
    frames that streamed a slab, and those of the cache pipeline apart for
    the slabs with misses and those of hits only."""
    import os

    from raytrace_tpu_torch.apps import generate_world
    from raytrace_tpu_torch.render.camera import Camera
    from raytrace_tpu_torch.world.storage import ChunkStorage

    t0 = time.perf_counter()
    cache_dir = _scratch_dir("world")
    before = _launch_counts()
    generate_world.run(radius=2, storage_dir=cache_dir)
    world_launches = _launches_since(before)
    written = sorted(os.listdir(cache_dir))
    magics = {(cache_dir / f).read_bytes()[:4] for f in written}
    gen_s = time.perf_counter() - t0
    kw = dict(width=CACHE_SIZE, height=CACHE_SIZE, tracer="volume_fast")
    pipes = dict(cache=rt.create_instance(source="cache",
                                          storage=ChunkStorage(cache_dir, seed=0), **kw),
                 device=rt.create_instance(**kw))
    res = dict(generate_world_seconds=gen_s, generate_world_launches=world_launches,
               chunks_written=len(written),
               magics=sorted(m.decode("latin-1") for m in magics),
               initial_volume_equal=bool(torch.equal(pipes["cache"].streamer.volume,
                                                     pipes["device"].streamer.volume)))
    cam = Camera(origin=[8.0, -100.0, 60.0], pitch=-0.3)
    ms = {k: [] for k in pipes}
    streamed, misses, volume_equal, frame_equal = [], [], [], []
    flight = _launch_counts()
    for t in range(CACHE_FRAMES):
        cam.origin = [8.0 + VOL_DX * t, -100.0, 60.0]
        frames = {}
        stored = len(os.listdir(cache_dir))
        for name, pipe in pipes.items():
            before = pipe.streamer.get_render_offset()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            frames[name] = pipe.draw_frame(cam, CANON["sun"])
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t1) * 1e3)
            moved = before != pipe.streamer.get_render_offset()
        streamed.append(moved)
        misses.append(len(os.listdir(cache_dir)) - stored)
        volume_equal.append(bool(torch.equal(pipes["cache"].streamer.volume,
                                             pipes["device"].streamer.volume)))
        frame_equal.append(bool(torch.equal(frames["cache"], frames["device"])))
    # Frame 0 also builds the occupancy tables: it is left out of the means.
    mean = lambda xs: sum(xs) / len(xs) if xs else None
    flight_launches = _launches_since(flight)
    for name in pipes:
        later = list(zip(ms[name], streamed))[1:]
        res[f"{name}_ms_slab_frames"] = mean([m for m, moved in later if moved])
        res[f"{name}_ms_other_frames"] = mean([m for m, moved in later if not moved])
        res[f"{name}_ms"] = ms[name]
    slabs = [(m, n) for m, moved, n in list(zip(ms["cache"], streamed, misses))[1:] if moved]
    res.update(cache_ms_miss_slabs=[m for m, n in slabs if n],
               cache_ms_hit_slabs=[m for m, n in slabs if not n],
               misses_per_slab=[n for _, n in slabs], flight_launches=flight_launches)
    stored = sorted(os.listdir(cache_dir))
    res.update(frames=CACHE_FRAMES, size=CACHE_SIZE, slab_frames=[t for t, s in
                                                                   enumerate(streamed) if s],
               lr=list(pipes["cache"].uniforms.lr),
               misses_stored=len(stored) - len(written),
               magics_after=sorted({(cache_dir / f).read_bytes()[:4].decode("latin-1")
                                    for f in stored}),
               volume_equal_every_frame=all(volume_equal),
               frame_equal_every_frame=all(frame_equal),
               seconds=time.perf_counter() - t0)
    ok = (len(written) == 64 and magics == {b"RTL4"} and res["magics_after"] == ["RTL4"]
          and res["initial_volume_equal"]
          and res["volume_equal_every_frame"] and res["frame_equal_every_frame"]
          and res["misses_stored"] > 0 and len(res["slab_frames"]) > 0
          and world_launches == {"G1box": 16} and sum(misses) == res["misses_stored"]
          and flight_launches.get("G1box") == res["misses_stored"])
    return ok, res


def _view_uniforms(rt, cam, sun, seed, lr=(0, 0, 0)):
    """Packed uniforms of a camera (its scaled basis) at region offset lr."""
    fwd, up, right = cam.scaled_basis()
    return rt.render.pipeline.FrameUniforms(origin=tuple(cam.origin), forward=fwd, up=up,
                                            right=right, sun_angle=sun, seed=seed, lr=lr)


def phase_app_shapes(rt, torch, dev, blue):
    """Each kernel against its plain version at the shapes the apps give it,
    before any app is timed: K1 at config 2's 1920x1080 b1 (the canonical
    view, lr 0) and at capture's 512² b2 (its first view, teleported), K2's
    chain on the 1080x1920 G-buffers of that K1 frame, K3 at config 1's
    512² b0 on its one-chunk volume, K4 at debug_view's 512² b2 and at
    config 2's 1920x1080 b1 (``--tracer hf``).  The tolerances of the
    existing phases.  Capture's K1 view is the first of the sweep's second
    position: at the first position the heightfield tracers see only sky
    (in the JAX package too), so K1 makes no move there.
    -> (ok, {name: (ok, res)}, seconds)."""
    from raytrace_tpu_torch.apps import benchmark, capture
    from raytrace_tpu_torch.ops import denoise
    from raytrace_tpu_torch.ops.hf_tables import build_hf_tables, with_column_heights
    from raytrace_tpu_torch.ops.vol_tables import build_vol_tables
    from raytrace_tpu_torch.render.camera import Camera
    from raytrace_tpu_torch.testing.measure import call_ms

    out = {}
    t0 = time.perf_counter()
    tables = with_column_heights(build_hf_tables((0, 0, 0), seed=0, device=dev), 0)
    canon = torch.from_numpy(_canonical_uniforms(rt, seed=7).packed()).to(dev)
    ok, res, gb = phase_k1(torch, tables, blue, canon, (1920, 1080), MAX_STEPS, 0, 1,
                           timed=True)
    out["k1_1920x1080_b1"] = (ok, res)
    ok, res = phase_k2(torch, blue, dict(main=gb))
    res.update(chain_ms=call_ms(lambda: denoise.denoise_finalize(gb, blue), 10),
               **_passes(gb, blue, 10),
               chain_plain_ms=call_ms(lambda: denoise.denoise_finalize_plain(gb, blue), 2))
    out["k2_1080x1920"] = (ok, res)
    del gb
    first = list(capture.sweep_configs())[len(capture.SUN_ANGLES) * capture.NUM_HEADINGS]
    pipe = rt.create_instance(width=512, height=512)
    cam = Camera(origin=list(first["origin"]), heading=first["heading"],
                 pitch=first["pitch"])
    pipe.teleport(cam)
    pipe.fill_uniforms(cam, first["sun_angle"])
    ok, res, _ = phase_k1(torch, pipe.tables(), blue,
                          torch.from_numpy(pipe.uniforms.packed()).to(dev), 512, MAX_STEPS,
                          0, 2, timed=True)
    out["k1_512_b2_capture"] = (ok, res)
    del pipe
    volume = benchmark.single_chunk_volume(dev)
    packed = torch.from_numpy(_view_uniforms(
        rt, Camera(**benchmark.CONFIG1_CAMERA), 0.6, 7).packed()).to(dev)
    ok, res = phase_k3(torch, volume, build_vol_tables(volume), blue, packed, 512, 1024, 0,
                       timed=True)
    out["k3_512_b0_single_chunk"] = (ok, res)
    bare = build_hf_tables((0, 0, 0), seed=0, device=dev)
    ok, res = phase_k4(torch, bare, blue, canon, 512, 1024, 0, 2)
    out["k4_512_b2_debug_view"] = (ok, res)
    ok, res = phase_k4(torch, bare, blue, canon, (1920, 1080), MAX_STEPS, 0, 1)
    out["k4_1920x1080_b1"] = (ok, res)
    return all(ok for ok, _ in out.values()), out, time.perf_counter() - t0


# The kernels each benchmark config must launch (its frames: one warm frame
# and the timed ones; config 1's world one box of G1, config 2 hf's K4 one
# launch a leg batch, two at b1, with R1, one P1 and S2 a frame; config 3
# twice 64 frames, config 4 one a
# view), by config and tracer.
CONFIG_KERNELS = {("1", "volume_fast"): {"G1box": 1, "O1": 1, "R1": 21, "K3": 21, "S3": 21},
                  ("1", "volume"): {"G1box": 1, "R1": 21, "D1": 21, "S2": 21},
                  ("2", "fused"): {"T1": 1, "R1": 21, "K1": 21, "S1": 21, "K2": 126},
                  ("2", "hf"): {"T1": 1, "R1": 21, "K4": 42, "P1": 21, "S2": 21, "K2": 126},
                  ("3", "fused"): {"T1": 128, "R1": 128, "K1": 128, "S1": 128, "K2": 768},
                  ("4", "fused"): {"T1": 30, "R1": 30, "K1": 30, "S1": 30, "K2": 180}}
# The outputs an eager twin must equal, by graphed config.
TWIN_OUTPUTS = {("1", "volume_fast"): ("depth", "albedo"), ("1", "volume"): ("depth", "albedo"),
                ("2", "fused"): ("frame",),
                ("2", "hf"): ("frame",)}


def _twin(torch, dev, key):
    """A graphed config's frame function at the app's size: its step
    program timed as the app times it and an eager twin of the same
    function (``graphed=False``) timed in turns (graphed, eager, eager,
    graphed), the graph's outputs after each graphed train against one
    eager call at the train's last step, bit for bit."""
    from raytrace_tpu_torch.apps import benchmark
    from raytrace_tpu_torch.testing.measure import same

    config, tracer = key
    frame_of_step = (benchmark.config1_frame(dev, 512, 512, tracer) if config == "1"
                     else benchmark.config2_frame(dev, 1920, 1080, tracer))
    programs = dict(graphed=benchmark.StepProgram(frame_of_step, dev),
                    eager=benchmark.StepProgram(frame_of_step, dev, graphed=False))
    t_last = torch.tensor(benchmark.step_of_frame(benchmark.TRAIN - 1), dtype=torch.float32,
                          device=dev)
    res = dict(graphed=[], eager=[], equal=[])
    for turn in ("graphed", "eager", "eager", "graphed"):
        program = programs[turn]
        res[turn].append(benchmark.time_steps(program))
        if turn == "graphed":
            got = {k: program.call.outputs[k].clone() for k in TWIN_OUTPUTS[key]}
            want = frame_of_step(t_last)
            res["equal"].append({k: same(_wide(got[k]), _wide(want[k])) for k in got})
            del got, want
    ok = (all(all(e.values()) for e in res["equal"])
          and all(r["graphed"] and r["exhausted_px"] == 0 for r in res["graphed"])
          and all(not r["graphed"] and r["exhausted_px"] == 0 for r in res["eager"]))
    return ok, res


def phase_benchmark_configs(torch, dev):
    """``apps.benchmark`` configs 1-4 as the app runs them (each prints its
    JSON line; config 1 also ``--tracer volume``, config 2 also ``--tracer
    hf``), with each config's kernel launches: every config must have
    ``exhausted_px == 0``, configs 1 and 2 ``graphed``, and launch exactly
    the kernels of its path (CONFIG_KERNELS).  Then
    each graphed config of 1 and 2 against its eager twin (``_twin``)."""
    from raytrace_tpu_torch.apps import benchmark

    t0 = time.perf_counter()
    records, launches = [], {}
    for key in CONFIG_KERNELS:
        config, tracer = key
        _zero_counts()
        got = benchmark.CONFIGS[config](tracer=tracer)
        torch.cuda.synchronize()
        launches[f"{config}_{tracer}"] = _counts()
        records += list(got) if isinstance(got, tuple) else [got]
    twins = {f"{c}_{t}": _twin(torch, dev, (c, t)) for c, t in TWIN_OUTPUTS}
    res = dict(records=records, launches=launches, twins={k: r for k, (_, r) in twins.items()},
               seconds=time.perf_counter() - t0)
    graphed = {r["tracer"]: r["graphed"] for r in records[:4]}
    ok = (len(records) == 7 and all(r["exhausted_px"] == 0 for r in records)
          and graphed == {"volume_fast": True, "volume": True, "fused": True, "hf": True}
          and launches == {f"{c}_{t}": v for (c, t), v in CONFIG_KERNELS.items()}
          and all(ok for ok, _ in twins.values()))
    return ok, res


CAPTURE_SIZE = 256
CAPTURE_VIEWS = 4


def phase_capture(rt, torch):
    """``apps.capture.run`` of CAPTURE_VIEWS views in ``dat`` format and as
    many in ``png-fast``: the ``.dat`` bytes must equal a synchronous
    readback of the same views' frames (kept on the card while the capture
    reads its pinned copies back four views deep), and each PNG must decode
    to its view's ``.dat`` bytes."""
    import json as _json

    import numpy as np

    from raytrace_tpu_torch.apps import capture
    from raytrace_tpu_torch.testing.golden import read_png

    t0 = time.perf_counter()
    pipe = rt.create_instance(width=CAPTURE_SIZE, height=CAPTURE_SIZE)
    kept, draw = [], pipe.draw_frame

    def keep(camera, sun_angle):
        frame = draw(camera, sun_angle)
        kept.append(frame)
        return frame

    pipe.draw_frame = keep
    dirs = {fmt: _scratch_dir(f"capture_{fmt}") for fmt in ("dat", "png-fast")}
    n, dt = capture.run(dirs["dat"], CAPTURE_SIZE, CAPTURE_SIZE, CAPTURE_VIEWS,
                        pipeline=pipe, fmt="dat")
    shape = (CAPTURE_SIZE, CAPTURE_SIZE, 3)
    dat = [np.fromfile(dirs["dat"] / f"view_{i:05d}.dat", np.uint8).reshape(shape)
           for i in range(CAPTURE_VIEWS)]
    synced = [capture.quantize(f).cpu().numpy() for f in kept]
    capture.run(dirs["png-fast"], CAPTURE_SIZE, CAPTURE_SIZE, CAPTURE_VIEWS, fmt="png-fast")
    png = [read_png(dirs["png-fast"] / f"view_{i:05d}.png") for i in range(CAPTURE_VIEWS)]
    manifests = {k: _json.loads((d / "manifest.json").read_text()) for k, d in dirs.items()}
    res = dict(views=CAPTURE_VIEWS, size=CAPTURE_SIZE, views_timed=n, seconds_timed=dt,
               dat_equal_sync_readback=[bool(np.array_equal(a, b)) for a, b in zip(dat, synced)],
               png_equal_dat=[bool(np.array_equal(a, b)) for a, b in zip(png, dat)],
               distinct_views=len({a.tobytes() for a in dat}),
               manifest_entries={k: len(v) for k, v in manifests.items()},
               seconds=time.perf_counter() - t0)
    ok = (len(kept) == CAPTURE_VIEWS and all(res["dat_equal_sync_readback"])
          and all(res["png_equal_dat"]) and res["distinct_views"] == CAPTURE_VIEWS
          and all(v == CAPTURE_VIEWS for v in res["manifest_entries"].values()))
    return ok, res


FLY_SIZE = 256


def phase_flythrough(torch):
    """``apps.flythrough.run``: 10 scripted frames of ``fused`` (forward,
    sun up), then 3 frames of ``volume_fast`` twice without an edit and
    once with a ``b`` press at frame 1: the two unedited runs bit-equal,
    the edited one different."""
    import numpy as np

    from raytrace_tpu_torch.apps import flythrough

    t0 = time.perf_counter()
    before = _launch_counts()
    common = dict(width=FLY_SIZE, height=FLY_SIZE, quiet=True)
    fused, avg, mx = flythrough.run(frames=10, tracer="fused", script=[
        (0, "press", "w"), (0, "press", "r"), (6, "release", "r")], **common)
    cam = ["0", "0", "60", "1.5708", "-0.3", "0.6"]
    vol = lambda script: flythrough.run(cam, frames=3, tracer="volume_fast",
                                        script=script, **common)[0]
    base, again, edited = vol([]), vol([]), vol([(1, "press", "b")])
    res = dict(fused_shape=list(fused.shape), fused_finite=bool(np.isfinite(fused).all()),
               hud_avg_ms=avg, hud_max_ms=mx, unedited_equal=bool(np.array_equal(base, again)),
               edited_differs=bool(not np.array_equal(base, edited)),
               edited_px=int((np.abs(base - edited).max(-1) > 0).sum()),
               launches=_launches_since(before), seconds=time.perf_counter() - t0)
    ok = (res["fused_shape"] == [FLY_SIZE, FLY_SIZE, 3] and res["fused_finite"]
          and res["unedited_equal"] and res["edited_differs"]
          and res["launches"].get("K1") == 10 and res["launches"].get("K3") == 9)
    return ok, res


def phase_debug_and_stage_times(torch):
    """``apps.debug_view --gbuffers`` (K4 at 512²: 3 launches, every PNG
    readable, no primary cut) and ``apps.stage_times`` for ``fused`` over 3
    frames (every stage a positive time; the launches counted from 0, F1
    once a finalize call)."""
    import numpy as np

    from raytrace_tpu_torch.apps import debug_view, stage_times
    from raytrace_tpu_torch.ops import lighting
    from raytrace_tpu_torch.testing.golden import read_png

    t0 = time.perf_counter()
    out = _scratch_dir("debug_view")
    before = _launch_counts()
    gb = debug_view.run(out, gbuffers=True)
    names = sorted(p.name for p in out.glob("*.png"))
    shapes = {n: list(read_png(out / n).shape) for n in names}
    dv = dict(pngs=shapes, launches=_launches_since(before),
              exhausted_px=_exhausted(gb, torch, lighting),
              sky_px=int((gb["depth"].to(torch.int32) == 0xFFFF).sum()))
    t1 = time.perf_counter()
    _zero_counts()
    st = stage_times.run("fused", frames=3)
    res = dict(debug_view=dv, stage_times=st, stage_times_launches=_counts(),
               debug_view_seconds=t1 - t0, stage_times_seconds=time.perf_counter() - t1)
    stages = (st["gbuffers_ms"], st["chain_ms"], st["finalize_ms"], st["denoise_ms"],
              st["frame_ms"])
    # stage_times' finalize: one F1 launch a call, a warm-up and 3 timed.
    ok = (len(names) == 7 and dv["launches"].get("K4") == 3 and dv["exhausted_px"] == 0
          and res["stage_times_launches"].get("F1") == 4
          and shapes["gb_albedo.png"] == [512, 512, 3]
          and all(np.isfinite(v) and v > 0 for v in stages))
    return ok, res


def _zero_counts() -> None:
    """Every kernel wrapper's launch count set to 0."""
    from raytrace_tpu_torch.render.frame_graph import COUNTED

    for fn in COUNTED:
        fn.launches = 0


def _counts() -> dict:
    """The kernels launched since the counts were set to 0, with their counts."""
    return {k: v for k, v in _launch_counts().items() if v}


def _wide(t):
    """uint16 as int32: uint16 tensors take no ``==``."""
    import torch

    return t.to(torch.int32) if t.dtype == torch.uint16 else t


def _gbuffers_equal(a: dict, b: dict) -> dict:
    from raytrace_tpu_torch.testing.measure import same

    return {k: same(_wide(a[k]), _wide(b[k])) for k in b}


def _world_volume(dev):
    """The generated world around the origin (lr 0), fused, with its tables."""
    from raytrace_tpu_torch.ops.vol_tables import build_vol_tables

    volume = _generated_volume(dev)
    return volume, build_vol_tables(volume)


# Bands of the 1024² frame: four of 256 rows, and one that starts on no
# band boundary.
ROW_BANDS = [(0, 256), (256, 256), (512, 256), (768, 256), (300, 200)]


def phase_row_bands(rt, torch, dev, blue, tables, vol_world):
    """Each band's G-buffers (``row0``/``rows``) equal the same rows of the
    whole frame's bit for bit, at 1024² b2 and the canonical view, for
    fused (K1), volume_fast (K3), hf (K4), the staged volume tracer (K3s)
    and the exact DDA (D1), with each tracer's launches over the whole
    frame and the bands."""
    from raytrace_tpu_torch.ops.trace_vol import render_gbuffers_vol
    from raytrace_tpu_torch.render.pipeline import frame_gbuffers, unpack_uniforms

    t0 = time.perf_counter()
    uni = unpack_uniforms(torch.from_numpy(_canonical_uniforms(rt, seed=7).packed()).to(dev))
    renders = {
        "fused": lambda **b: frame_gbuffers(tables, blue, uni, W, H, tracer="fused", **b),
        "volume_fast": lambda **b: frame_gbuffers(vol_world, blue, uni, W, H,
                                                  tracer="volume_fast", **b),
        "hf": lambda **b: frame_gbuffers(tables, blue, uni, W, H, tracer="hf", **b),
        "staged_volume": lambda **b: render_gbuffers_vol(*vol_world, blue, uni, W, H, **b),
        "volume": lambda **b: frame_gbuffers(vol_world[0], blue, uni, W, H, tracer="volume",
                                             **b),
    }
    res = {}
    for name, render in renders.items():
        _zero_counts()
        whole = render()
        equal = {}
        for row0, rows in ROW_BANDS:
            band = render(row0=row0, rows=rows)
            rows_of = {k: v[row0:row0 + rows] for k, v in whole.items()}
            equal[f"{row0}+{rows}"] = all(_gbuffers_equal(band, rows_of).values())
        torch.cuda.synchronize()
        res[name] = dict(equal=equal, launches=_counts(),
                         sky_px=int((whole["depth"].to(torch.int32) == 0xFFFF).sum()))
    res["seconds"] = time.perf_counter() - t0
    want = {"fused": "K1", "volume_fast": "K3", "hf": "K4", "staged_volume": "K3s",
            "volume": "D1"}
    ok = all(all(res[n]["equal"].values()) and res[n]["launches"].get(k, 0) > 0
             and 0 < res[n]["sky_px"] < W * H for n, k in want.items())
    return ok, res


def _cut_bands(gb, ranks):
    """``gb`` cut into ``ranks`` bands of consecutive rows, in rank order."""
    band = gb["depth"].shape[0] // ranks
    return [{k: v[r * band:(r + 1) * band].contiguous() for k, v in gb.items()}
            for r in range(ranks)]


def phase_k2_bands(torch, blue, gb):
    """K2's finalizing pass on a row window with a dither offset against
    its plain pass (max |err| 0, one pass and the chain), then the tile
    split's band denoise as 2, 4, 8 and 16 in-process bands of ``gb``: the
    assembled frame equal to ``denoise_finalize`` bit for bit, K2 launched
    six times a band (``tiles.denoise_in_turn``: the tile split's band
    regions, chains and assembly, each halo cut from its neighbour)."""
    from raytrace_tpu_torch.ops import denoise
    from raytrace_tpu_torch.parallel import tiles

    t0 = time.perf_counter()
    first, count, dither_row0 = 300, 200, 1300
    rows = slice(first, first + count)
    light = gb["lighting"].permute(2, 0, 1).contiguous()
    geom = denoise.geometry_plane(gb["depth"], gb["normal"])
    fin = tuple(gb[k][rows].contiguous() for k in ("albedo", "emission", "fog")) + (blue,)
    window = dict(window=(first, count), dither_row0=dither_row0)
    err = lambda a, b: float(torch.abs(a - b).max())
    res = dict(window=[first, count], dither_row0=dither_row0, max_abs_err=dict(
        pass_16_fin=err(denoise.denoise_pass(light, geom, 16, fin, **window),
                        denoise.denoise_pass_plain(light, geom, 16, fin, **window))))
    band_gb = dict(gb, **{k: gb[k][rows].contiguous() for k in ("albedo", "emission", "fog")})
    res["max_abs_err"]["chain"] = err(denoise.denoise_finalize(band_gb, blue, **window),
                                      denoise.denoise_finalize_plain(band_gb, blue, **window))
    whole = denoise.denoise_finalize(gb, blue)
    res["bands"] = {}
    for ranks in (2, 4, 8, 16):
        _zero_counts()
        frame = tiles.denoise_in_turn(_cut_bands(gb, ranks), blue)
        how = tiles.plan(ranks, gb["depth"].shape[0] // ranks)
        torch.cuda.synchronize()
        res["bands"][ranks] = dict(plan=how, equal=bool(torch.equal(frame, whole)),
                                   k2_launches=denoise.launch_pass.launches)
    res["seconds"] = time.perf_counter() - t0
    passes = len(denoise.DENOISE_SIZES)
    ok = (all(e == 0.0 for e in res["max_abs_err"].values())
          and all(b["equal"] and b["k2_launches"] == passes * r
                  for r, b in res["bands"].items())
          and {b["plan"] for b in res["bands"].values()} == {"halo", "gather"})
    return ok, res


def phase_tiled_nccl(rt, torch, dev, blue, tables, vol_world):
    """``render_frame_tiled`` at 1024² through an NCCL process group of one
    rank (file store) and with no process group: both equal the whole-frame
    path (the tracer's G-buffers, then ``denoise_finalize``) bit for bit,
    for fused, volume_fast and the exact DDA; and the group's gather of a frame and of the
    uint16 depth (sent as bytes) gives them back unchanged."""
    import torch.distributed as dist

    from raytrace_tpu_torch.ops.denoise import denoise_finalize
    from raytrace_tpu_torch.parallel import tiles
    from raytrace_tpu_torch.render.pipeline import frame_gbuffers, unpack_uniforms

    t0 = time.perf_counter()
    uni = unpack_uniforms(torch.from_numpy(_canonical_uniforms(rt, seed=7).packed()).to(dev))
    worlds = {"fused": tables, "volume_fast": vol_world, "volume": vol_world[0]}
    wants = {}
    for tracer, world in worlds.items():
        gb = frame_gbuffers(world, blue, uni, W, H, tracer=tracer)
        wants[tracer] = (denoise_finalize(gb, blue), gb["depth"])
    store = _scratch_dir("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", world_size=1, rank=0,
                            device_id=dev)
    res = dict(backend=dist.get_backend(), ranks=dist.get_world_size())
    try:
        for tracer, world in worlds.items():
            want, depth = wants[tracer]
            got = tiles.render_frame_tiled(world, blue, uni, W, H, tracer=tracer)
            (frame,), (depth_back,) = (tiles.gather_ranks(t, 1, None) for t in (got, depth))
            res[f"{tracer}_group"] = dict(equal=bool(torch.equal(got, want)),
                                          gathered_equal=bool(torch.equal(frame, want)),
                                          depth_gathered_equal=bool(torch.equal(
                                              _wide(depth_back), _wide(depth))))
    finally:
        dist.destroy_process_group()
    for tracer, world in worlds.items():
        got = tiles.render_frame_tiled(world, blue, uni, W, H, tracer=tracer)
        res[f"{tracer}_no_group"] = dict(equal=bool(torch.equal(got, wants[tracer][0])))
    res["seconds"] = time.perf_counter() - t0
    ok = res["backend"] == "nccl" and all(
        all(v.values()) for k, v in res.items() if isinstance(v, dict))
    return ok, res


CONFIG5_BAND = (1080, 270)  # image rows of one band of an 8-way split at 4K


def phase_config5(rt, torch, dev, blue):
    """Config 5 at 3840x2160 b2: first K1 and K3 against their plain
    versions on one 270-row band (rows 1080-1350, the band of an 8-way
    split; the plain march on the whole 4K frame would take tens of
    seconds), K1 alone on the whole frame, and K2's chain on the whole
    frame's G-buffers and as 8 in-process bands against plain; then
    ``apps.benchmark`` config 5 for fused and volume_fast, each with the
    counts set to 0 before it and read after: ``exhausted_px`` 0, its
    ``parity``, its Mrays/s and ms, and its launches (the whole frame its
    parity compares with, one warm and three timed frames)."""
    from raytrace_tpu_torch.apps import benchmark
    from raytrace_tpu_torch.ops import denoise, lighting
    from raytrace_tpu_torch.parallel import tiles
    from raytrace_tpu_torch.render.pipeline import frame_gbuffers, unpack_uniforms
    from raytrace_tpu_torch.testing.measure import call_ms

    t0 = time.perf_counter()
    w, h = benchmark.CONFIG5_SIZE
    packed = torch.from_numpy(_canonical_uniforms(rt, seed=7).packed()).to(dev)
    tables = benchmark.config5_world("fused", dev)
    out = {}
    ok, res, _ = phase_k1(torch, tables, blue, packed, (w, h), MAX_STEPS, 0, 2, timed=True,
                          band=CONFIG5_BAND)
    inputs = lighting.march_inputs(tables, blue, unpack_uniforms(packed), w, h)
    whole = _alone(lambda: lighting.march_paths(*inputs["march"], MAX_STEPS, 0, 5), 10,
                   "march_paths_kernel")
    res.update(whole_frame_kernel_ms=whole["kernel_ms"], whole_frame_kept=whole["kept"])
    del inputs
    out["k1"] = (ok, res)
    vol_world = benchmark.config5_world("volume_fast", dev)
    out["k3"] = phase_k3(torch, vol_world[0], vol_world[1], blue, packed, (w, h), MAX_STEPS,
                         2, timed=True, band=CONFIG5_BAND)
    gb = frame_gbuffers(tables, blue, unpack_uniforms(packed), w, h)
    ok, res = phase_k2(torch, blue, dict(main=gb))
    frame = tiles.denoise_in_turn(_cut_bands(gb, 8), blue)
    how = tiles.plan(8, h // 8)
    res.update(chain_ms=call_ms(lambda: denoise.denoise_finalize(gb, blue), 10),
               **_passes(gb, blue, 10),
               chain_plain_ms=call_ms(lambda: denoise.denoise_finalize_plain(gb, blue), 2),
               bands_8=dict(plan=how, equal=bool(torch.equal(
                   frame, denoise.denoise_finalize(gb, blue)))))
    out["k2"] = (ok and res["bands_8"]["equal"], res)
    del gb, frame, tables, vol_world
    for tracer in ("fused", "volume_fast"):
        _zero_counts()
        rec = benchmark.config5_tiled_4k(tracer)
        torch.cuda.synchronize()
        rec["launches"] = _counts()
        main = ("K1", "S1") if tracer == "fused" else ("K3", "S3")
        frames = 2 + benchmark.CONFIG5_FRAMES  # the whole frame, the warm one, the timed
        world = {"T1": 1} if tracer == "fused" else {"G1box": 1, "O1": 1}
        want = {"R1": frames, **{k: frames for k in main}, "K2": 6 * frames, **world}
        out[f"run_{tracer}"] = (rec["exhausted_px"] == 0 and rec["devices"] == 1
                                and rec["parity"] and rec["launches"] == want, rec)
    return all(ok for ok, _ in out.values()), out, time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    if not (ROOT / "raytrace_tpu_torch" / "csrc").is_dir() \
            or not (ROOT / "raytrace_tpu_torch" / "constants.py").is_file():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import raytrace_tpu_torch as rt
    import raytrace_tpu_torch.render.pipeline  # noqa: F401
    from raytrace_tpu_torch import _build
    from raytrace_tpu_torch.ops import denoise
    from raytrace_tpu_torch.ops.hf_tables import build_hf_tables, with_column_heights
    from raytrace_tpu_torch.render.pipeline import get_blue_noise_f32, unpack_uniforms
    from raytrace_tpu_torch.testing import measure

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed = []

    def report(name, ok, res):
        print(f"[{name}] {'PASS' if ok else 'FAIL'} {json.dumps(res)}", flush=True)
        if not ok:
            failed.append(name)

    card = measure.card()
    name = torch.cuda.get_device_name(0)
    bn_sha = hashlib.sha256(get_blue_noise_f32().tobytes()).hexdigest()
    print(card, flush=True)
    report("device", True, dict(card=card, torch_name=name,
                                torch=torch.__version__, cuda=torch.version.cuda,
                                blue_noise_sha256=bn_sha))

    start = time.perf_counter()
    t0 = time.perf_counter()
    _build.build()
    build = dict(_build.build_info)
    _build.kernels()
    build_s = time.perf_counter() - t0
    ptxas = _ptxas(build.get("log", ""))
    # The kernels keep their state in registers: no spills (K2, K4, G1, O1,
    # R1, S1, S3, P1, S2), and K1, K3, K3s, D1 and O1 no stack.
    # A kernel missing from the parse reads as a frame of -1: not lean.
    frame = lambda k: [int(v) for v in re.findall(
        r"\d+", ptxas[k]["frame"] or "-")] if k in ptxas else [-1]
    k2 = [k for k in ptxas if k.startswith("denoise_pass_kernel")]
    o1 = [k for k in ptxas if k.startswith("vol_tables_kernel")]  # one a block's units
    d1 = [k for k in ptxas if k.startswith("trace_dda_kernel")]  # counting or not
    lean = build["cached"] or (frame("march_paths_vol_kernel") == [0, 0, 0]
                               and frame("march_paths_kernel") == [0, 0, 0]
                               and frame("trace_hf_kernel")[1:] == [0, 0]
                               and frame("trace_rays_vol_kernel") == [0, 0, 0]
                               and len(d1) > 0 and all(frame(k) == [0, 0, 0] for k in d1)
                               and len(k2) > 0 and all(frame(k)[1:] == [0, 0] for k in k2)
                               and len(o1) > 0 and all(frame(k) == [0, 0, 0] for k in o1)
                               and all(frame(k)[1:] == [0, 0] for k in (
                                   "worldgen_kernel", "frame_rays_kernel",
                                   "shade_fused_kernel", "shade_vol_kernel",
                                   "leg_batch_kernel", "shade_staged_kernel")))
    sass = {_kernel_name(k): v for k, v in measure.sass_counts(Path(build["path"])).items()}
    report("build", lean, dict(seconds=build_s, nvcc_seconds=build["seconds"],
                               cached=build["cached"], ptxas=ptxas, sass=sass))

    if "jax" in sys.modules:
        raise RuntimeError("chip_smoke imported jax")

    ok, t1_res = phase_hf_tables_kernel(rt, torch, dev)
    report("hf_tables_kernel", ok, t1_res)
    ok, g1_res = phase_worldgen_kernel(rt, torch, dev)
    report("worldgen_kernel", ok, g1_res)
    ok, box_res = phase_generate_box_kernel(rt, torch, dev)
    report("generate_box_kernel", ok, box_res)
    ok, o1_res = phase_vol_tables_kernel(rt, torch, dev)
    report("vol_tables_kernel", ok, o1_res)
    blue = _blue_noise(torch, dev)
    canon = torch.from_numpy(_canonical_uniforms(rt).packed()).to(dev)
    canon_tables = build_hf_tables((0, 0, 0), seed=0, device=dev, hcol=True)
    r1_world = _world_volume(dev)
    ok, r1_res = phase_frame_rays_kernel(rt, torch, dev, blue, canon_tables, r1_world)
    report("frame_rays_kernel", ok, r1_res)
    del r1_world
    for bounces in (2, 1):
        ok, res, _ = phase_k1(torch, canon_tables, blue, canon, 256, 2048, 0, bounces)
        report(f"k1_vs_plain_b{bounces}", ok, res)
    ok, res = phase_golden(rt, torch, dev)
    report("golden_64", ok, res)
    ok, res = phase_fused_bare_tables(torch, canon_tables, blue, canon)
    report("fused_bare_tables", ok, res)
    ok, main_res, pipe = phase_main(rt, torch)
    report("main_path", ok, main_res)
    # K1 once more at the main path's own size, region and uniforms.
    ok, k1_res, _ = phase_k1(
        torch, pipe.tables(), pipe.blue_noise,
        torch.from_numpy(pipe.uniforms.packed()).to(dev), W,
        pipe.max_steps, pipe.seed, pipe.bounces)
    report("k1_vs_plain_main", ok, k1_res)
    # K2 on random G-buffers and on the main path's last frame's.
    from raytrace_tpu_torch.testing.gbuffers import random_gbuffers

    gbs = dict(main=pipe.gbuffers, random=random_gbuffers(H, W, 7, dev))
    ok, k2_res = phase_k2(torch, blue, gbs)
    report("k2_vs_plain", ok, k2_res)
    ok, f1_res = phase_finalize_kernel(torch, blue, gbs["main"])
    report("finalize_kernel", ok, f1_res)
    times = phase_times(rt, torch, dev, pipe, gbs, blue)
    regions = dict(canonical=(canon_tables, 0), main=(pipe.tables(), pipe.seed))

    # The volume path: K3 at 256² on two scenes, then the main path.
    from raytrace_tpu_torch.ops.vol_tables import build_vol_tables

    tight = {}  # K3s's batches at tight budgets: label -> (volume, tables, lr, o, d, active)
    for scene, (volume, view) in _volumes(torch, dev).items():
        tables = build_vol_tables(volume)
        packed = torch.from_numpy(_canonical_uniforms(rt, view, seed=7).packed()).to(dev)
        for bounces in (0, 1, 2):
            ok, res = phase_k3(torch, volume, tables, blue, packed, 256, 2048, bounces)
            report(f"k3_vs_plain_{scene}_b{bounces}", ok, res)
        for bounces in (0, 1, 2):
            ok, res, batches = phase_k3s(torch, volume, tables, blue, packed, 256, 2048,
                                         bounces)
            report(f"k3s_vs_plain_{scene}_b{bounces}", ok, res)
        lr = unpack_uniforms(packed)["lr"]
        for b, (o, d, active, _) in enumerate(batches):
            tight[f"{scene}_256_b{b}"] = (volume, tables, lr, o, d, active)
    ok, vol_res, vpipe = phase_volume_main(rt, torch)
    report("volume_main", ok, vol_res)
    # K3 once more at the volume path's own size, volume, tables and uniforms.
    ok, k3_res = phase_k3(
        torch, vpipe.streamer.volume, vpipe.vol_tables(), vpipe.blue_noise,
        torch.from_numpy(vpipe.uniforms.packed()).to(dev), W, vpipe.max_steps,
        vpipe.bounces)
    report("k3_vs_plain_main", ok, k3_res)
    ok, shade_res = phase_shade_kernel(rt, torch, pipe, vpipe)
    report("shade_kernel", ok, shade_res)
    times.update(phase_volume_times(torch, dev, vpipe))
    # The staged volume path on the same pipeline: K3s on its three 1024²
    # batches, 20 staged frames, and the staged G-buffers against K3's.
    vpacked = torch.from_numpy(vpipe.uniforms.packed()).to(dev)
    ok, k3s_res, batches = phase_k3s(torch, *vpipe.world(), vpipe.blue_noise, vpacked, W,
                                     vpipe.max_steps, vpipe.bounces, timed=True)
    report("k3s_vs_plain_main", ok, k3s_res)
    o, d, active, _ = batches[1]
    tight["main_1024_b1"] = (*vpipe.world(), unpack_uniforms(vpacked)["lr"], o, d, active)
    del batches
    ok, res = phase_k3s_tight(torch, tight)
    report("k3s_tight_budget", ok, res)
    del tight
    ok, staged_res, cam = phase_staged_vol_main(torch, vpipe)
    report("staged_vol_main", ok, staged_res)
    ok, res = phase_staged_vs_path(torch, vpipe)
    report("staged_vs_path_main", ok, res)
    times.update(phase_staged_vol_times(torch, vpipe, cam, k3s_res))
    # The staged volume frame's world and uniforms, for staged_glue_kernel.
    staged_world = (vpipe.world(), torch.from_numpy(vpipe.uniforms.packed()).to(dev))
    ok, res = phase_volume_edit(torch, vpipe)
    report("volume_edit", ok, res)
    del vpipe

    # The staged heightfield path: K4 at 256² on the canonical view, then
    # the path itself, K4 at its own 1024² tables and uniforms, and the hf
    # G-buffers against the fused ones.
    for bounces in (0, 1, 2):
        ok, res = phase_k4(torch, canon_tables, blue, canon, 256, 2048, 0, bounces)
        report(f"k4_vs_plain_b{bounces}", ok, res)
    ok, hf_res, hpipe = phase_hf_main(rt, torch)
    report("hf_main", ok, hf_res)
    ok, k4_res = phase_k4(
        torch, hpipe.tables(), hpipe.blue_noise,
        torch.from_numpy(hpipe.uniforms.packed()).to(dev), W, hpipe.max_steps,
        hpipe.seed, hpipe.bounces)
    report("k4_vs_plain_main", ok, k4_res)
    # The hf pipeline's tables have no column table: K1 gets them with one.
    hf_k1_tables = with_column_heights(hpipe.tables(), hpipe.seed)
    ok, res = phase_hf_vs_fused(torch, hpipe, hf_k1_tables)
    report("hf_vs_fused_main", ok, res)
    regions["hf"] = (hf_k1_tables, hpipe.seed)
    ok, res = phase_column_table(torch, regions)
    report("column_table", ok, res)
    hf_frame_ms = phase_hf_frame_ms(torch, hpipe)
    # P1 and S2 against their plain versions on the hf and staged volume
    # frames' own records, config 2's, two bands' and random ones.
    hf_world = (hpipe.tables(), torch.from_numpy(hpipe.uniforms.packed()).to(dev))
    ok, glue_res = phase_staged_glue_kernel(torch, dev, blue, hf_world, staged_world)
    report("staged_glue_kernel", ok, glue_res)
    del hpipe, hf_world, staged_world

    # The frame as one CUDA graph replay: each graphed tracer against its
    # eager twin across slice crossings, a slab, an edit and a teleport,
    # and the host ms/frame of both paths in turns.
    graph_ms = {}
    for tracer in GRAPH_KERNELS:
        ok, res = phase_graph_frames(rt, torch, tracer)
        graph_ms[tracer] = res.pop("ms")
        report(f"graph_frames_{tracer}", ok, res)
    print(f"[graph_frames_ms] {json.dumps(dict(card=card, **graph_ms))}", flush=True)
    for tracer in ("fused", "volume_fast"):
        ok, res = phase_frame_census(rt, torch, tracer)
        report(f"frame_census_{tracer}", ok, res)
    ok, exact_res, epipe = phase_volume_exact(rt, torch)
    report("volume_exact", ok, exact_res)
    # D1 against its plain version on the exact path's own batches, and on
    # config 1's.
    ok, d1_res = phase_dda_kernel(torch, dev, epipe)
    report("dda_kernel", ok, d1_res)
    del epipe

    # The apps: the chunk cache, then each kernel at the apps' shapes before
    # any app is timed, then the apps themselves.
    ok, res = phase_native_codec(torch, dev)
    report("native_codec", ok, res)
    ok, cache_res = phase_cache_stream(rt, torch)
    report("cache_stream", ok, cache_res)
    ok, app_shapes, app_shapes_s = phase_app_shapes(rt, torch, dev, blue)
    for label, (ok, res) in app_shapes.items():
        report(f"app_shapes_{label}", ok, res)
    print(f"[app_shapes] seconds {app_shapes_s:.3f}", flush=True)
    ok, bench_res = phase_benchmark_configs(torch, dev)
    report("benchmark_configs", ok, bench_res)
    ok, res = phase_capture(rt, torch)
    report("capture", ok, res)
    ok, res = phase_flythrough(torch)
    report("flythrough", ok, res)
    ok, stage_res = phase_debug_and_stage_times(torch)
    report("debug_view_stage_times", ok, stage_res)

    # Row bands and the tile split: each tracer's bands against its whole
    # frame, K2's band denoise in one process, render_frame_tiled over NCCL,
    # and config 5 at 4K.
    vol_world = _world_volume(dev)
    ok, res = phase_row_bands(rt, torch, dev, blue, canon_tables, vol_world)
    report("row_bands", ok, res)
    ok, res = phase_k2_bands(torch, blue, gbs["main"])
    report("k2_bands", ok, res)
    ok, res = phase_tiled_nccl(rt, torch, dev, blue, canon_tables, vol_world)
    report("tiled_nccl", ok, res)
    del vol_world
    ok, config5, config5_s = phase_config5(rt, torch, dev, blue)
    for label, (ok_one, res) in config5.items():
        report(f"config5_4k_{label}", ok_one, res)
    report("config5_4k", ok, dict(seconds=config5_s, records=[
        config5[f"run_{t}"][1] for t in ("fused", "volume_fast")]))
    # JAX's calls: render_frame of a dict, Pipeline by position, a preloaded
    # volume with the fused tracer, generate_box without the minefield (G1's
    # form for any box), the profile's trace and the default device.
    ok, api_res = phase_jax_api(rt, torch, dev)
    report("jax_api", ok, api_res)
    times.update(k4_ms=k4_res["k4_ms"], k4_kernel_ms=k4_res["k4_kernel_ms"],
                 k4_plain_ms=k4_res["k4_plain_ms"],
                 hf_frame_ms=hf_frame_ms, volume_frame_ms=exact_res["ms_per_frame"])
    # smoke_seconds: the script from before the build to here.
    report("times", True, dict(card=card, size=H, smoke_seconds=time.perf_counter() - start,
                               **times))
    if "jax" in sys.modules or any(m.split(".")[0] == "raytrace_tpu" for m in sys.modules):
        raise RuntimeError("chip_smoke imported jax or the JAX package")

    # Each ms is the kernel alone (torch.profiler), without the wrapper's
    # glue: K2's the mean of the main path's chain's passes (its chain call
    # beside it), K3s's and K4's the mean over a frame's batches.
    passes = len(denoise.DENOISE_SIZES)
    # No single PyTorch call computes any of these functions (an edge-aware
    # a-trous pass, a voxel march, a frame's rays or its shade), so
    # library_ms is null.
    bound = lambda res: dict(bound_ms=res["bound_ms"], bound_by=res["bound_by"],
                             library_ms=None)
    # The lane-use census of the main path's run (per batch for K3s and K4).
    lanes = lambda c: dict(warp_iterations=c["warp_iterations"], lane_use=c["lane_use"])

    # Each kernel at the apps' shapes (app_shapes_*): its time alone, its
    # plain version's, its bound, and its launches in the benchmark configs.
    def at(label, ms, plain_ms):
        res = app_shapes[label][1]
        return dict(shape=label, ms=ms, plain_ms=plain_ms, max_abs_err=res["max_abs_err"]
                    if not isinstance(res["max_abs_err"], dict)
                    else max(res["max_abs_err"].values()),
                    kept=res.get("kept", res.get("pass_kept")),
                    bound_ms=res["bound_ms"], bound_by=res["bound_by"])

    def bench_launches(kernel):
        return {f"config_{k}": v[kernel] for k, v in bench_res["launches"].items()
                if kernel in v}

    k1_app = [at(label, app_shapes[label][1]["kernel_ms"], app_shapes[label][1]["plain_ms"])
              for label in ("k1_1920x1080_b1", "k1_512_b2_capture")]

    # Each kernel of config 5 at 4K: K1 and K3 alone, plain and bound on
    # the 270-row band (K1 alone on the whole frame too), K2 per pass on the
    # whole frame, and the launches of config 5's run.
    def at_4k(label, ms, plain_ms, kernel, **extra):
        res = config5[label][1]
        tracer = "fused" if kernel in ("K1", "K2") else "volume_fast"
        return dict(shape="3840x2160 b2", band=res.get("band"), ms=ms, plain_ms=plain_ms,
                    max_abs_err=res["max_abs_err"] if not isinstance(res["max_abs_err"], dict)
                    else max(res["max_abs_err"].values()), bound_ms=res["bound_ms"],
                    bound_by=res["bound_by"], kept=res.get("kept", res.get("pass_kept")),
                    launches=config5[f"run_{tracer}"][1]["launches"].get(kernel), **extra)

    k2_4k = config5["k2"][1]
    config5_entries = dict(
        K1=at_4k("k1", config5["k1"][1]["kernel_ms"], config5["k1"][1]["plain_ms"], "K1",
                 whole_frame_ms=config5["k1"][1]["whole_frame_kernel_ms"],
                 whole_frame_kept=config5["k1"][1]["whole_frame_kept"]),
        K2=at_4k("k2", sum(k2_4k["pass_ms"].values()) / len(denoise.DENOISE_SIZES),
                 k2_4k["chain_plain_ms"] / len(denoise.DENOISE_SIZES), "K2",
                 chain_ms=k2_4k["chain_ms"]),
        K3=at_4k("k3", config5["k3"][1]["kernel_ms"], config5["k3"][1]["plain_ms"], "K3"),
    )
    k2_app = app_shapes["k2_1080x1920"][1]
    k3_app = app_shapes["k3_512_b0_single_chunk"][1]
    app = dict(
        K1=dict(shapes=k1_app, launches=bench_launches("K1")),
        K2=dict(shapes=[at("k2_1080x1920", sum(k2_app["pass_ms"].values()) / passes,
                           k2_app["chain_plain_ms"] / passes)
                        | dict(chain_ms=k2_app["chain_ms"])], launches=bench_launches("K2")),
        K3=dict(shapes=[at("k3_512_b0_single_chunk", k3_app["kernel_ms"], k3_app["plain_ms"])],
                launches=bench_launches("K3")),
        K3s=dict(shapes=[], launches=bench_launches("K3s")),
        K4=dict(shapes=[at(label, app_shapes[label][1]["k4_kernel_ms"],
                           app_shapes[label][1]["k4_plain_ms"])
                        for label in ("k4_512_b2_debug_view", "k4_1920x1080_b1")],
                launches=bench_launches("K4")),
    )
    r1_main, r1_vol, r1_hf = r1_res["fused_1024"], r1_res["volume_1024"], r1_res["hf_1024"]
    r1_shapes = {label: {form: r1_res[f"{form}_{label}"]["kernel_ms"]
                         for form in ("fused", "volume", "hf", "dda")}
                 for label, _, _, _ in R1_CASES}
    s1_mixes = {k: dict(ms=v["kernel_ms"], shade_ms=v["shade_kernel_ms"],
                        table_ms=v["table_kernel_ms"], kept=v["kept"])
                for k, v in shade_res.items()
                if k in ("s1_all_sky", "s1_zero_weight", "s1_night", "s1_night_zero_weight")}
    f1_main = f1_res["1024"]
    s1_main, s3_main = shade_res["s1_main"], shade_res["s3_main_b2"]
    err = lambda res, prefix="": max(v["max_abs_err"] for k, v in res.items()
                                     if k.startswith(prefix) and isinstance(v, dict)
                                     and "max_abs_err" in v)
    # P1 and S2 on the hf frame's records at 1024² b2 (P1: the mean of its
    # two calls), with the staged volume frame's beside them.
    glue_err = lambda k: max(v[f"{k}_max_abs_err"] for v in glue_res.values()
                             if isinstance(v, dict) and f"{k}_max_abs_err" in v)

    def glue(case, k):
        calls = case["p1"] if k == "p1" else [case["s2"]]
        mean = lambda key: sum(c[key] for c in calls) / len(calls)
        return dict(ms=mean("kernel_ms"), kept=[c["kept"] for c in calls],
                    plain_ms=mean("plain_ms"), call_ms=mean("call_ms"),
                    bound_ms=mean("bound_ms"),
                    bound_by=max(calls, key=lambda c: c["bound_ms"])["bound_by"])

    hf_glue, vol_glue = glue_res["hf_main_b2"], glue_res["volume_main_b2"]
    dda_glue = glue_res["dda_main_b2"]
    r1_dda = r1_res["dda_1024"]
    d1_main = d1_res[f"main_{MAX_STEPS}"]
    kernels = [
        dict(name="P1 leg_batch (a bounce's sun + diffuse ray batch, staged frames)",
             route="cuda", source="raytrace_tpu_torch/csrc/staged.cu",
             replaces="raytrace_tpu/ops/trace_jax.py:310",
             launches=hf_res["p1_launches"], launches_per_frame=hf_res["p1_launches"] / FRAMES,
             max_abs_err=glue_err("p1"), **glue(hf_glue, "p1"), library_ms=None,
             volume_mode=dict(launches=staged_res["launches"].get("P1", 0),
                              **glue(vol_glue, "p1")),
             dda_mode=dict(launches=exact_res["launches"].get("P1", 0),
                           **glue(dda_glue, "p1")),
             app_shapes=dict(launches=bench_launches("P1"))),
        dict(name="S2 shade_staged (the staged frames' G-buffers)", route="cuda",
             source="raytrace_tpu_torch/csrc/staged.cu",
             replaces="raytrace_tpu/ops/trace_jax.py:330",
             launches=hf_res["s2_launches"], launches_per_frame=hf_res["s2_launches"] / FRAMES,
             max_abs_err=glue_err("s2"), **glue(hf_glue, "s2"), library_ms=None,
             volume_mode=dict(launches=staged_res["launches"].get("S2", 0),
                              **glue(vol_glue, "s2")),
             dda_mode=dict(launches=exact_res["launches"].get("S2", 0),
                           **glue(dda_glue, "s2")),
             app_shapes=dict(launches=bench_launches("S2"))),
        dict(name="R1 frame_rays (rays, noise and march scalars of a frame)", route="cuda",
             source="raytrace_tpu_torch/csrc/frame_rays.cu",
             replaces="raytrace_tpu/ops/lighting_pallas.py:849",
             also_replaces=["raytrace_tpu/ops/trace_jax.py:168",
                            "raytrace_tpu/ops/path_vol.py:373"],
             launches=main_res["r1_launches"], max_abs_err=err(r1_res),
             ms=r1_main["kernel_ms"], kept=r1_main["kept"], plain_ms=r1_main["plain_ms"],
             call_ms=r1_main["call_ms"], **bound(r1_main), shapes_ms=r1_shapes,
             volume_form=dict(launches=vol_res["r1_launches"], ms=r1_vol["kernel_ms"],
                              kept=r1_vol["kept"], plain_ms=r1_vol["plain_ms"],
                              call_ms=r1_vol["call_ms"], bound_ms=r1_vol["bound_ms"],
                              bound_by=r1_vol["bound_by"],
                              staged_volume_launches=staged_res["launches"].get("R1", 0)),
             hf_form=dict(launches=hf_res["launches"].get("R1", 0), ms=r1_hf["kernel_ms"],
                          kept=r1_hf["kept"], plain_ms=r1_hf["plain_ms"],
                          call_ms=r1_hf["call_ms"], bound_ms=r1_hf["bound_ms"],
                          bound_by=r1_hf["bound_by"]),
             dda_form=dict(launches=exact_res["launches"].get("R1", 0), ms=r1_dda["kernel_ms"],
                           kept=r1_dda["kept"], plain_ms=r1_dda["plain_ms"],
                           call_ms=r1_dda["call_ms"], bound_ms=r1_dda["bound_ms"],
                           bound_by=r1_dda["bound_by"]),
             app_shapes=dict(launches=bench_launches("R1"))),
        dict(name="S1 shade_fused (the fused frame's planar shade)", route="cuda",
             source="raytrace_tpu_torch/csrc/shade.cu",
             replaces="raytrace_tpu/ops/lighting_pallas.py:1007",
             launches=main_res["s1_launches"], max_abs_err=err(shade_res, "s1_"),
             ms=s1_main["kernel_ms"], kept=s1_main["kept"], plain_ms=s1_main["plain_ms"],
             call_ms=s1_main["call_ms"], **bound(s1_main), word_mixes=s1_mixes,
             shade_ms=s1_main["shade_kernel_ms"], table_ms=s1_main["table_kernel_ms"],
             table_kept=s1_main["table_kept"],
             app_shapes=dict(launches=bench_launches("S1"))),
        dict(name="F1 finalize (JAX's finalize_frame alone)", route="cuda",
             source="raytrace_tpu_torch/csrc/denoise.cu",
             replaces="raytrace_tpu/ops/finalize.py:21",
             launches=stage_res["stage_times_launches"].get("F1", 0),
             launches_from="apps.stage_times (the chain and finalize timed apart)",
             main_path_launches=main_res["f1_launches"],
             max_abs_err=max(v["max_abs_err"] for v in f1_res.values()
                             if isinstance(v, dict) and "max_abs_err" in v),
             ms=f1_main["kernel_ms"], kept=f1_main["kept"], plain_ms=f1_main["plain_ms"],
             call_ms=f1_main["call_ms"], **bound(f1_main),
             chain=dict(launches=f1_res["chain"]["launches"],
                        call_ms=f1_res["chain"]["call_ms"])),
        dict(name="S3 shade_vol (the volume_fast frame's planar shade)", route="cuda",
             source="raytrace_tpu_torch/csrc/shade.cu",
             replaces="raytrace_tpu/ops/path_vol.py:605",
             launches=vol_res["s3_launches"], max_abs_err=err(shade_res, "s3_"),
             ms=s3_main["kernel_ms"], kept=s3_main["kept"], plain_ms=s3_main["plain_ms"],
             call_ms=s3_main["call_ms"], **bound(s3_main),
             app_shapes=dict(launches=bench_launches("S3"))),
        dict(name="T1 hf_tables (region tables from the device lr)", route="cuda",
             source="raytrace_tpu_torch/csrc/hf_tables.cu",
             replaces="raytrace_tpu/ops/trace_pallas.py:60",
             launches=main_res["t1_launches"], max_abs_err=t1_res["max_abs_err"],
             ms=t1_res["kernel_ms"], kept=t1_res["kept"], plain_ms=t1_res["plain_ms"],
             launches_per_frame=main_res["t1_launches"] / main_res["frames"],
             **bound(t1_res), call_ms=t1_res["ms"],
             app_shapes=dict(launches=bench_launches("T1"))),
        dict(name="G1 worldgen (a streamed slab or region, in place)", route="cuda",
             source="raytrace_tpu_torch/csrc/worldgen.cu",
             replaces="raytrace_tpu/render/streaming.py:79",
             launches=vol_res["g1_launches"], max_abs_err=g1_res["max_abs_err"],
             ms=g1_res["kernel_ms"], kept=g1_res["kept"], plain_ms=g1_res["plain_ms"],
             **bound(g1_res), call_synced_ms=g1_res["slab"]["call_synced_ms"],
             old_path_ms=g1_res["slab"]["old_path_ms"], region=g1_res["region"],
             box=dict(replaces="raytrace_tpu/world/generate.py:66",
                      max_abs_err=box_res["max_abs_err"],
                      **{label: box_res[label] for label in BOX_TIMED},
                      launches=dict(bench_launches("G1box"),
                                    config_5=config5["run_volume_fast"][1]["launches"].get(
                                        "G1box", 0),
                                    generate_world=cache_res["generate_world_launches"].get(
                                        "G1box", 0),
                                    cache_stream=cache_res["flight_launches"].get(
                                        "G1box", 0)))),
        dict(name="G1 worldgen_box<false> (generate_box without the minefield, any box)",
             route="cuda", source="raytrace_tpu_torch/csrc/worldgen.cu",
             replaces="raytrace_tpu/world/generate.py:66",
             launches=api_res["g1_bare"]["launches"].get("G1box", 0),
             launches_from="jax_api (generate_box(..., with_minefield=False), one a box)",
             max_abs_err=api_res["g1_bare"]["max_abs_err"],
             ms=api_res["g1_bare"]["box_256"]["kernel_ms"],
             kept=api_res["g1_bare"]["box_256"]["kept"],
             plain_ms=api_res["g1_bare"]["box_256"]["plain_ms"],
             **bound(api_res["g1_bare"]["box_256"]),
             shapes={label: api_res["g1_bare"][label] for label in BARE_TIMED}),
        dict(name="O1 vol_tables (occupancy tables, built or updated in place)",
             route="cuda", source="raytrace_tpu_torch/csrc/vol_tables.cu",
             replaces="raytrace_tpu/ops/trace_vol_pallas.py:163",
             launches=vol_res["o1_launches"], max_abs_err=o1_res["max_abs_err"],
             ms=o1_res["kernel_ms"], kept=o1_res["kept"], plain_ms=o1_res["plain_ms"],
             **bound(o1_res), floor_ms=o1_res["update"]["floor_ms"],
             call_synced_ms=o1_res["update"]["call_synced_ms"], build=o1_res["build"]),
        dict(name="K1 march_paths (whole-path lighting march)", route="cuda",
             source="raytrace_tpu_torch/csrc/lighting.cu",
             replaces="raytrace_tpu/ops/lighting_pallas.py:143",
             launches=main_res["k1_launches"], max_abs_err=k1_res["max_abs_err"],
             ms=times["k1_kernel_ms"], kept=times["k1_kept"], plain_ms=times["k1_plain_ms"],
             **bound(k1_res),
             column_table_bound_ms=k1_res["column_table_bound_ms"],
             parent_work_bound_ms=k1_res["parent_work_bound_ms"], app_shapes=app["K1"],
             config5_4k=config5_entries["K1"]),
        dict(name="K2 denoise_pass (a-trous pass, finalize fused)", route="cuda",
             source="raytrace_tpu_torch/csrc/denoise.cu",
             replaces="raytrace_tpu/ops/denoise_pallas.py:132",
             launches=main_res["k2_launches"],
             max_abs_err=max(k2_res["max_abs_err"].values()),
             ms=sum(times["k2_pass_ms"].values()) / passes, kept=times["k2_pass_kept"],
             chain_ms=times["k2_chain_ms"],
             plain_ms=times["k2_chain_plain_ms"] / passes, **bound(k2_res),
             app_shapes=app["K2"],
             config5_4k=config5_entries["K2"]),
        dict(name="K3 march_paths_vol (whole-path volume_fast march)", route="cuda",
             source="raytrace_tpu_torch/csrc/trace_vol.cu",
             replaces="raytrace_tpu/ops/trace_vol_pallas.py:254",
             launches=vol_res["k3_launches"], max_abs_err=k3_res["max_abs_err"],
             ms=times["k3_kernel_ms"], kept=times["k3_kept"], plain_ms=times["k3_plain_ms"],
             **bound(k3_res),
             census=lanes(k3_res["census"]), app_shapes=app["K3"],
             config5_4k=config5_entries["K3"]),
        dict(name="D1 trace_dda (the exact DDA, tracer=\"volume\")", route="cuda",
             source="raytrace_tpu_torch/csrc/trace_dda.cu",
             replaces="raytrace_tpu/ops/trace_jax.py:59",
             launches=exact_res["launches"].get("D1", 0),
             launches_per_frame=exact_res["launches"].get("D1", 0) / FRAMES,
             max_abs_err=d1_res["max_abs_err"], ms=d1_res["kernel_ms"],
             kept=[b["kept"] for b in d1_main], plain_ms=d1_res["plain_ms"],
             bound_ms=d1_res["bound_ms"], bound_by=d1_res["bound_by"], library_ms=None,
             batches=[{k: b[k] for k in ("rays", "kernel_ms", "call_ms", "floor_ms", "plain_ms",
                                         "bound_ms", "moves", "words", "lane_use", "steps")}
                      for b in d1_main],
             config1=dict(launches=bench_launches("D1"), **{
                 k: d1_res["config1_512_b0"][k] for k in ("kernel_ms", "floor_ms", "plain_ms",
                                                          "bound_ms", "lane_use")})),
        dict(name="K3s trace_rays_vol (staged volume tracer)", route="cuda",
             source="raytrace_tpu_torch/csrc/trace_rays_vol.cu",
             replaces="raytrace_tpu/ops/trace_vol_pallas.py:939",
             launches=staged_res["k3s_launches"], max_abs_err=k3s_res["max_abs_err"],
             ms=sum(times["k3s_kernel_ms"]) / len(times["k3s_kernel_ms"]),
             kept=times["k3s_kept"],
             plain_ms=sum(times["k3s_plain_ms"]) / len(times["k3s_plain_ms"]),
             **bound(k3s_res), census=[lanes(b["census"]) for b in k3s_res["batches"]],
             app_shapes=app["K3s"]),
        dict(name="K4 trace_rays_hf (staged heightfield tracer)", route="cuda",
             source="raytrace_tpu_torch/csrc/trace_hf.cu",
             replaces="raytrace_tpu/ops/trace_pallas.py:208",
             launches=hf_res["k4_launches"], max_abs_err=k4_res["max_abs_err"],
             ms=k4_res["k4_kernel_ms"], kept=k4_res["kept"], plain_ms=k4_res["k4_plain_ms"],
             **bound(k4_res),
             census=[lanes(b["census"]) for b in k4_res["batches"]], app_shapes=app["K4"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    if failed:
        raise SystemExit(f"chip_smoke: failed phases: {failed}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
