"""Kernel K4 and its plain version: the staged heightfield tracer, and the
staged G-buffer pass built on it (``tracer="hf"``).

Port of ``raytrace_tpu/ops/trace_pallas.py``: ``trace_rays_hf``
(``:512-706``), ``render_gbuffers_hf`` (``:709-753``) and
``_packed_material`` (``:478-489``).  The march is kernel K4,
``_make_kernel`` (``:208-475``), written for Hopper in ``csrc/trace_hf.cu``
as persistent lanes that each trace ray after ray (``march_rays_hf``);
``march_rays_hf_plain`` below is the same march in plain PyTorch, one step
of every live ray per iteration.  The frame's glue around K4 is R1's hf
form (``rays.frame_rays``), P1 and S2 (``integrate.stage_gbuffers``).

One step is the JAX unified body ``body_f`` (``:362-438``): classify the
current voxel from the region tables (``hf_tables.classify``); where the
step is fine and the voxel lies below its column's exact height, the ray
hits here, keeping the normal of its previous move (0 for a ray born inside
a column); otherwise it moves to the nearest boundary and, if that leaves
the region, completes as air.  There is no sky-escape rule (K1 has one):
an air ray's position is where it left the region.  A hit ray's material
is the packed word of its voxel's material band.

Budget: a ray may take ``hf_budget(max_steps, caps)`` iterations.  JAX runs
primaries (no cascade) through its unified body for exactly ``max_steps``
iterations, and bounce batches through its phased body in the
``COMPACT_CAPS`` cascade, whose levels run at most their cap and the last
``max_steps``; so a primary gets exactly JAX's budget, and a bounce ray at
least as many moves as JAX gives it: every ray that completes in JAX
completes identically here.  The phased body, the sort cascade and the
lane-shuffle lookups are TPU workarounds with no counterpart.

Rays with ``active`` False are born done, as in JAX (``:631-636``): they
come back at their origin with normal 0, air 0 and no material, so they
count as exhausted; the caller masks them.
"""

from __future__ import annotations

import itertools

import torch

from ..constants import MAX_TRACE_STEPS, ROOT_BLOCK_SIZE
from ..world.generate import PACKED_GRASS, PACKED_ROCK, PACKED_SNOW, material_band
from ..world.noise import hash3_u32
from .hf_tables import TABLE_KEYS, bdist, classify, step_reciprocal
from .integrate import HF, Record, flat_rays, record_hits, stage_gbuffers
from .rays import frame_rays, normalize

_HALF = ROOT_BLOCK_SIZE // 2
_EPS = 1e-4
COMPACT_CAPS = (16, 48, 160)


def hf_budget(max_steps: int, caps: tuple = ()) -> int:
    """Iterations one ray may take: ``max_steps`` plus every cascade cap
    below it (JAX's cascade levels, ``trace_pallas.py:606``)."""
    return sum(c for c in caps if 0 < c < max_steps) + max_steps


def march_iscal(tables: dict, lr: torch.Tensor) -> torch.Tensor:
    """K4's (8,) int32 scalars: r0x, r0y, the region centre lr (x, y, z)
    and the packed grass, rock and snow words of the material bands."""
    words = [torch.full((1,), w, dtype=torch.int32, device=lr.device)
             for w in (PACKED_GRASS, PACKED_ROCK, PACKED_SNOW)]
    return torch.cat([tables["r0"], lr.to(torch.int32), *words])


# ---------------------------------------------------------------------------
# The march, plain PyTorch (the CPU path, and the reference for K4)
# ---------------------------------------------------------------------------


def march_rays_hf_plain(origin, direction, active, iscal, tables, budget: int,
                        seed: int):
    """K4's plain PyTorch version.

    origin, direction: (N, 3) f32; active: (N,) bool or None (all traced);
    iscal: (8,) int32 from ``march_iscal``.  Returns ``(position (N, 3) f32
    before the nudge, normal (N,) int32, air (N,) int32, packed (N,) int32,
    work (N, 2) int32)``; ``work`` counts each ray's moves and exact
    column-height evaluations, the work K4 does for it.  Finished rays are
    compacted away every 16 iterations (a speed device only).
    """
    iv = iscal.tolist()
    r0x, r0y = iv[0], iv[1]
    lrf = [float(v) for v in iv[2:5]]
    n = origin.shape[0]
    dev = origin.device
    pos = origin.clone()
    normal = torch.zeros(n, dtype=torch.int32, device=dev)
    air = torch.zeros(n, dtype=torch.bool, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    work = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    traced = (torch.ones(n, dtype=torch.bool, device=dev) if active is None
              else active.to(torch.bool))
    idx = torch.nonzero(traced)[:, 0]
    d = normalize(direction[idx, 0], direction[idx, 1], direction[idx, 2])
    zi = torch.zeros(idx.shape[0], dtype=torch.int32, device=dev)
    zb = torch.zeros(idx.shape[0], dtype=torch.bool, device=dev)
    s = dict(idx=idx, px=origin[idx, 0], py=origin[idx, 1], pz=origin[idx, 2],
             normal=zi, air=zb, hit=zb, moves=zi, heights=zi)
    for k, a in enumerate("xyz"):
        s["d" + a] = d[k]
        s["lp" + a] = 1.0 / torch.abs(d[k])
        s["mul" + a] = torch.where(d[k] > 0, -1.0, 1.0).to(torch.float32)
        s["nid" + a] = torch.where(d[k] > 0, 2 * k + 1, 2 * k).to(torch.int32)

    def flush(s, sel):
        j = s["idx"][sel]
        pos[j] = torch.stack([s["px"][sel], s["py"][sel], s["pz"][sel]], -1)
        normal[j] = s["normal"][sel]
        air[j] = s["air"][sel]
        hit[j] = s["hit"][sel]
        work[j] = torch.stack([s["moves"][sel], s["heights"][sel]], -1)

    live = ~(s["hit"] | s["air"])
    for i in range(budget):
        if i % 16 == 0:
            flush(s, ~live)
            if not bool(live.any()):
                break
            s = {k: v[live] for k, v in s.items()}
            live = live[live]
        _step(s, live, tables, r0x, r0y, lrf, seed)
        live = ~(s["hit"] | s["air"])
    else:
        flush(s, torch.ones_like(live))

    xi, yi, zv = (torch.floor(pos[:, k]).to(torch.int32) for k in range(3))
    band = material_band(zv, hash3_u32(xi, yi, zv, seed + 1))
    word = torch.where(band == 2, iv[5], torch.where(band == 5, iv[6], iv[7]))
    packed = torch.where(hit, word, 0).to(torch.int32)
    return pos, normal, air.to(torch.int32), packed, work


def _step(s: dict, live, tables, r0x: int, r0y: int, lrf, seed: int) -> None:
    """One iteration of ``body_f`` for the ``live`` lanes of ``s``, in place."""
    px, py, pz = s["px"], s["py"], s["pz"]
    c = classify(tables, px, py, pz, s["dz"] >= 0, r0x, r0y, seed)
    fine = c["fine"]
    hit_now = live & fine & (c["zi"] < c["hcol"])
    one = torch.ones_like(px)
    step_f = torch.clamp(c["step"], min=1).to(torch.float32)
    inv_step = step_reciprocal(c["step"])
    ztop = c["hcol"].to(torch.float32)
    lzf = torch.where((s["dz"] < 0) & (pz >= ztop), (_EPS + (pz - ztop)) * s["lpz"],
                      torch.full_like(pz, float("inf")))
    lx = torch.where(fine, bdist(px, s["mulx"], s["lpx"], one, one),
                     bdist(px, s["mulx"], s["lpx"], step_f, inv_step))
    ly = torch.where(fine, bdist(py, s["muly"], s["lpy"], one, one),
                     bdist(py, s["muly"], s["lpy"], step_f, inv_step))
    lz = torch.where(fine, lzf, bdist(pz, s["mulz"], s["lpz"], step_f, inv_step))
    use_x = (lx < ly) & (lx < lz)
    use_y = ~(lx < ly) & (ly < lz)
    lmin = torch.where(use_x, lx, torch.where(use_y, ly, lz))
    nrm = torch.where(use_x, s["nidx"], torch.where(use_y, s["nidy"], s["nidz"]))
    move = live & ~hit_now
    for a, p in zip("xyz", (px, py, pz)):
        s["p" + a] = torch.where(move, p + s["d" + a] * lmin, p)
    oob = ((torch.abs(s["px"] - lrf[0]) >= _HALF) | (torch.abs(s["py"] - lrf[1]) >= _HALF)
           | (torch.abs(s["pz"] - lrf[2]) >= _HALF))
    s["normal"] = torch.where(move, nrm, s["normal"])
    s["air"] = s["air"] | (move & oob)
    s["hit"] = s["hit"] | hit_now
    s["moves"] = s["moves"] + move.to(torch.int32)
    s["heights"] = s["heights"] + (live & fine).to(torch.int32)


# ---------------------------------------------------------------------------
# The tracer: plain version on the CPU, kernel K4 on the card
# ---------------------------------------------------------------------------


def march_rays_hf(origin, direction, active, iscal, tables, budget: int, seed: int,
                  census=None, counter=None):
    """K4 on a batch of rays -> ``(position (N, 3) f32 before the nudge,
    normal, air, packed (N,) int32)``, the raw hits (``integrate.Record``,
    mode HF).

    origin, direction: (N, 3) f32 contiguous; active: (N,) bool or None;
    iscal: (8,) int32 from ``march_iscal`` (or R1's hf form); ``budget``
    iterations a ray (``hf_budget``).  CPU tensors take
    ``march_rays_hf_plain``; CUDA tensors launch K4 (``csrc/trace_hf.cu``)
    on the current stream, and ``march_rays_hf.launches`` counts those
    launches.  Any other device raises.  ``census``, a (1,) int64 tensor on
    the same device, or None: K4 adds the loop iterations of each of its
    warps to it (the lane-use census of ``testing/census.py``).
    ``counter``, a (1,) int32 tensor of zero, or None (one is made): the
    lanes' ray counter, which the launch uses up.
    """
    if origin.device.type == "cpu":
        return march_rays_hf_plain(origin, direction, active, iscal, tables, budget,
                                   seed)[:4]
    if origin.device.type != "cuda":
        raise RuntimeError(f"march_rays_hf: no kernel for device {origin.device}")
    from .._build import check_launch, check_tensor, kernels

    n = origin.shape[0]
    dev = origin.device
    ins = [origin, direction] + ([] if active is None else [active]) + [iscal] \
        + [tables[k] for k in TABLE_KEYS]
    want = [(torch.float32, (n, 3))] * 2 + ([] if active is None else [(torch.bool, (n,))]) \
        + [(torch.int32, (8,))] + [(torch.int32, (1024,))] * 6
    for t, (dtype, shape) in zip(ins, want):
        check_tensor("march_rays_hf", t, dtype, shape, dev)
    if census is not None:
        check_tensor("march_rays_hf", census, torch.int64, (1,), dev)
    if counter is None:
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
    check_tensor("march_rays_hf", counter, torch.int32, (1,), dev)
    pos = torch.empty((n, 3), dtype=torch.float32, device=dev)
    normal, air, packed = (torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels().rt_trace_hf(
        origin.data_ptr(), direction.data_ptr(), None if active is None else active.data_ptr(),
        iscal.data_ptr(), *(tables[k].data_ptr() for k in TABLE_KEYS),
        pos.data_ptr(), normal.data_ptr(), air.data_ptr(), packed.data_ptr(),
        n, budget, seed, counter.data_ptr(),
        None if census is None else census.data_ptr(), stream,
    )
    check_launch("rt_trace_hf", err)
    march_rays_hf.launches += 1
    return pos, normal, air, packed


march_rays_hf.launches = 0


def trace_rays_hf_plain(tables: dict, origin, direction, lr,
                        max_steps: int = MAX_TRACE_STEPS, seed: int = 0,
                        caps: tuple = COMPACT_CAPS, active=None) -> dict:
    """``trace_rays_hf`` through the plain march, on any device.  The hit
    dict also carries ``work`` (..., 2): each ray's moves and column-height
    evaluations."""
    o, d, a = flat_rays(origin, direction, active)
    *out, work = march_rays_hf_plain(o, d, a, march_iscal(tables, lr), tables,
                                     hf_budget(max_steps, caps), seed)
    res = record_hits(HF, origin, Record(*out))
    res["work"] = work.reshape(*origin.shape[:-1], 2)
    return res


def trace_rays_hf(tables: dict, origin, direction, lr,
                  max_steps: int = MAX_TRACE_STEPS, seed: int = 0, *,
                  caps: tuple = COMPACT_CAPS, active=None, census=None) -> dict:
    """Trace rays over the heightfield of the region centred at ``lr``.

    ``tables`` from ``build_hf_tables`` for that region; origin, direction
    (..., 3) f32 (directions need not be unit); ``active`` (...,) bool or
    None.  Returns the hit dict of ``integrate.hit_result``.  CPU tensors
    take the plain march (``trace_rays_hf_plain``); CUDA tensors launch K4
    through ``march_rays_hf`` (counted on ``march_rays_hf.launches``).  Any
    other device raises.  ``census`` as for ``march_rays_hf``.  As JAX's
    ``tile_rows`` and ``interpret`` follow ``seed``, what follows it is
    keyword-only.
    """
    if origin.device.type == "cpu":
        return trace_rays_hf_plain(tables, origin, direction, lr, max_steps, seed,
                                   caps, active)
    if origin.device.type != "cuda":
        raise RuntimeError(f"trace_rays_hf: no kernel for device {origin.device}")
    o, d, a = flat_rays(origin, direction, active)
    out = march_rays_hf(o, d, a, march_iscal(tables, lr), tables, hf_budget(max_steps, caps),
                        seed, census)
    return record_hits(HF, origin, Record(*out))


def render_gbuffers_hf(tables: dict, blue_noise: torch.Tensor, uniforms: dict,
                       width: int, height: int, max_steps: int = MAX_TRACE_STEPS,
                       seed: int = 0, row0: int = 0, rows: int | None = None, *,
                       bounces: int = 2, caps: tuple = COMPACT_CAPS) -> dict:
    """G-buffers of one frame (or of its rows ``row0 .. row0 + rows``)
    through the staged heightfield tracer (``trace_pallas.py:709-753``):
    ``integrate.stage_gbuffers`` over K4's raw hits.  On the card R1 (its
    hf form: the rays, the noise word, the sun and K4's scalars), K4, then
    P1 and K4 for each bounce, then S2: 3 + 2 * ``bounces`` launches.
    Primaries run without the cascade's budget, bounce batches with
    ``caps``' (``hf_budget``), as in JAX (``trace_pallas.py:740-749``);
    ``tables`` from ``build_hf_tables`` for the region at
    ``uniforms["lr"]``.  The result equals ``integrate_gbuffers`` with
    ``trace_rays_hf`` bit for bit.  JAX's ``interpret`` follows ``rows``, so
    ``bounces`` and ``caps`` are keyword-only."""
    rows = height if rows is None else rows
    f = frame_rays(uniforms, blue_noise, width, height, row0, rows, tables=tables,
                   form="hf")
    # K4's ray counters, one a batch, zeroed at once.
    counters = torch.zeros(1 + bounces, dtype=torch.int32, device=blue_noise.device)
    batch = itertools.count()

    def trace(o, d, active):
        k = next(batch)
        budget = hf_budget(max_steps, () if active is None else caps)
        return Record(*march_rays_hf(o, d, active, f["iscal"], tables, budget, seed,
                                     counter=counters[k:k + 1]))

    return stage_gbuffers(trace, HF, f, f["nw"], uniforms["origin"], bounces,
                          (rows, width))
