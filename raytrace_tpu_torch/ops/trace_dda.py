"""The exact DDA tracer over the fused volume, and its G-buffer pass
(``tracer="volume"``).

Port of ``raytrace_tpu/ops/trace_jax.py:59-165`` (``trace_rays``) and
``:191-215`` (``render_gbuffers``).  The JAX package runs this march as a
jitted ``lax.while_loop``, not a Pallas kernel; on the card the port runs
it as kernel D1 (``csrc/trace_dda.cu``, one thread per ray), and on the CPU
as its plain version ``march_rays_dda_plain``.  It is the reference the
volume tracers are held to, and the whole frame of ``tracer="volume"``.

Each ray steps through the resident volume by its minefield: from a voxel
whose step field is ``s``, it moves to the next boundary of the
``(1 << s) // 2`` grid (by ``1e-4`` per unit of length along the ray where
that is 0), looks up the fused word there (``volume.lookup``) and hits where
the word's step is 0; leaving the 256-voxel window is air.  Each ray has
``max_steps`` moves, and ``steps`` counts the moves the JAX loop would run
(its ``while`` ends when every ray is done).
"""

from __future__ import annotations

import torch

from ..constants import MAX_TRACE_STEPS, ROOT_BLOCK_SIZE
from .integrate import DDA, EXHAUSTED, Record, flat_rays, record_hits, stage_gbuffers
from .rays import frame_rays, normalize
from .volume import MATERIAL_MASK, STEP_SHIFT, lookup

_HALF = ROOT_BLOCK_SIZE // 2
_EPS = 1e-4
_CHECK_EVERY = 16


def _step_size(step: torch.Tensor) -> torch.Tensor:
    """``((1 << step) // 2)`` as float32: 0 for step 0, else 2^(step-1)."""
    return torch.floor_divide(torch.bitwise_left_shift(torch.ones_like(step), step),
                              2).to(torch.float32)


def march_rays_dda_plain(volume: torch.Tensor, origin: torch.Tensor,
                         direction: torch.Tensor, active, lr: torch.Tensor,
                         max_steps: int = MAX_TRACE_STEPS):
    """D1's plain PyTorch version (see ``march_rays_dda``): the rays step
    together, and those that are done are compacted away every 16 moves (a
    speed device only); the loop stops when none is live."""
    n = origin.shape[0]
    dev = origin.device
    traced = (torch.ones(n, dtype=torch.bool, device=dev) if active is None
              else active.to(torch.bool))
    zi = lambda m: torch.zeros(m, dtype=torch.int32, device=dev)
    zb = lambda m: torch.zeros(m, dtype=torch.bool, device=dev)
    out = dict(pos=origin.clone(), normal=zi(n), air=zb(n), mat=zi(n))
    idx = torch.nonzero(traced)[:, 0]
    o = origin[idx]
    d = torch.stack(normalize(direction[idx, 0], direction[idx, 1], direction[idx, 2]), -1)
    m = idx.shape[0]
    ax = torch.arange(3, dtype=torch.int32, device=dev)
    s = dict(idx=idx, pos=o, d=d, lp=1.0 / torch.abs(d),
             normals=torch.where(d > 0, 2 * ax + 1, 2 * ax).to(torch.int32),
             muls=torch.where(d > 0, -1.0, 1.0).to(torch.float32),
             normal=zi(m), air=zb(m), done=zb(m), packed=zi(m),
             step=_step_size(lookup(volume, o) >> STEP_SHIFT))
    # The JAX loop's move count: one past the last move that completed a ray
    # (or max_steps while a ray is live), kept on the device.
    steps = torch.zeros((), dtype=torch.int32, device=dev)

    def flush(s, sel):
        j = s["idx"][sel]
        out["pos"][j] = s["pos"][sel]
        out["normal"][j] = s["normal"][sel]
        out["air"][j] = s["air"][sel]
        out["mat"][j] = torch.where(s["done"][sel], s["packed"][sel], EXHAUSTED)

    cut = True
    for i in range(max_steps):
        if i % _CHECK_EVERY == 0:
            live = ~s["done"]
            flush(s, ~live)
            if not bool(live.any()):
                cut = False
                break
            s = {k: v[live] for k, v in s.items()}
        active = ~s["done"]
        shifted = (s["pos"] + float(_HALF)) * s["muls"]
        ss = s["step"][:, None]
        rem = torch.where(ss > 0, torch.remainder(shifted, torch.where(ss > 0, ss, 1.0)), 0.0)
        lvec = (_EPS + rem) * s["lp"]
        lx, ly, lz = lvec[:, 0], lvec[:, 1], lvec[:, 2]
        use_x = (lx < ly) & (lx < lz)
        use_y = ~(lx < ly) & (ly < lz)
        lmin = torch.where(use_x, lx, torch.where(use_y, ly, lz))
        nrm = s["normals"]
        axis_normal = torch.where(use_x, nrm[:, 0], torch.where(use_y, nrm[:, 1], nrm[:, 2]))
        p = torch.where(active[:, None], s["pos"] + s["d"] * lmin[:, None], s["pos"])
        fused = lookup(volume, p)
        oob = (torch.abs(p - lr) >= _HALF).any(-1)
        new_air = active & oob
        new_hit = active & ~oob & ((fused >> STEP_SHIFT) <= 0)
        s["pos"] = p
        s["normal"] = torch.where(active, axis_normal, s["normal"])
        s["air"] = s["air"] | new_air
        s["done"] = s["done"] | new_air | new_hit
        s["packed"] = torch.where(new_hit, fused & MATERIAL_MASK, s["packed"])
        s["step"] = torch.where(s["done"], s["step"], _step_size(fused >> STEP_SHIFT))
        steps = torch.where((new_air | new_hit).any(), i + 1, steps)
    if cut:
        flush(s, torch.ones_like(s["done"]))
        if not bool(s["done"].all()):
            steps = torch.full((), max_steps, dtype=torch.int32, device=dev)
    return Record(out["pos"], out["normal"], out["air"], out["mat"]), steps


def march_rays_dda(volume: torch.Tensor, origin: torch.Tensor, direction: torch.Tensor,
                   active, lr: torch.Tensor, max_steps: int = MAX_TRACE_STEPS, census=None,
                   touched=None):
    """D1 on a batch of rays -> ``(Record, steps)``: the raw hits in the
    ``integrate.DDA`` mode (position (N, 3) f32 before any nudge, entry-face
    normal (N,) int32, air (N,) bool, and ``mat`` (N,) int32: the hit's
    packed word, 0 for air, or ``integrate.EXHAUSTED`` where the ray is not
    done after ``max_steps`` moves) and ``steps``, a 0-d int32 tensor: one
    past the last move that finished a ray, or ``max_steps`` while one is
    live (JAX's loop counter).

    ``volume`` the fused (256^3,) int32 volume; origin, direction (N, 3)
    f32 contiguous (directions need not be unit); ``active`` (N,) bool or
    None (every ray traced): an inactive ray is born done at its origin,
    normal 0, not air, ``mat`` 0, and counts for no move; ``lr`` (3,) f32
    the region centre.  CPU tensors take ``march_rays_dda_plain``; CUDA
    tensors launch D1 (``csrc/trace_dda.cu``) on the current stream, which
    reads ``lr`` on the device and writes ``steps`` there (no host read),
    and ``march_rays_dda.launches`` counts those launches.  Any other
    device raises.  ``census``, a (2,) int64 tensor on the card, or None:
    D1 adds the moves of the batch's rays to ``census[0]`` and, per warp of
    32 rays in index order, its longest ray's moves to ``census[1]``;
    ``touched``, a (2^19,) int32 bitmap on the card, or None: D1 sets the
    bit of every volume word a ray reads (bit ``i & 31`` of word ``i >> 5``
    for the linear texel ``i``).  Both are for measurement.
    """
    dev = origin.device
    if dev.type == "cpu":
        return march_rays_dda_plain(volume, origin, direction, active, lr, max_steps)
    if dev.type != "cuda":
        raise RuntimeError(f"march_rays_dda: no kernel for device {dev}")
    from .._build import check_launch, check_tensor, kernels

    n = origin.shape[0]
    ins = [origin, direction] + ([] if active is None else [active]) + [volume, lr]
    want = [(torch.float32, (n, 3))] * 2 + ([] if active is None else [(torch.bool, (n,))]) \
        + [(torch.int32, (ROOT_BLOCK_SIZE ** 3,)), (torch.float32, (3,))]
    for t, (dtype, shape) in zip(ins, want):
        check_tensor("march_rays_dda", t, dtype, shape, dev)
    if census is not None:
        check_tensor("march_rays_dda: census", census, torch.int64, (2,), dev)
    if touched is not None:
        check_tensor("march_rays_dda: touched", touched, torch.int32,
                     (ROOT_BLOCK_SIZE ** 3 // 32,), dev)
    if max_steps < 0:
        raise ValueError(f"march_rays_dda: max_steps {max_steps} < 0")
    pos = torch.empty((n, 3), dtype=torch.float32, device=dev)
    normal, mat = (torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2))
    air = torch.empty(n, dtype=torch.bool, device=dev)
    steps = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels().rt_trace_dda(
        origin.data_ptr(), direction.data_ptr(), None if active is None else active.data_ptr(),
        volume.data_ptr(), lr.data_ptr(), pos.data_ptr(), normal.data_ptr(), air.data_ptr(),
        mat.data_ptr(), n, max_steps, steps.data_ptr(),
        None if census is None else census.data_ptr(),
        None if touched is None else touched.data_ptr(), stream,
    )
    check_launch("rt_trace_dda", err)
    march_rays_dda.launches += 1
    return Record(pos, normal, air, mat), steps


march_rays_dda.launches = 0


def trace_rays(fused_flat: torch.Tensor, origin: torch.Tensor,
               direction: torch.Tensor, lr: torch.Tensor,
               max_steps: int = MAX_TRACE_STEPS) -> dict:
    """Trace a batch of rays (..., 3) f32 through the fused (256^3,) int32
    volume of the region centred at ``lr`` (3,) f32: every ray, as JAX
    traces them.

    Returns the hit dict of ``integrate.hit_result`` (position nudged 0.001
    off the entry face, distance before the nudge; ``integrate.record_hits``
    in the DDA mode) and ``steps``, a 0-d int32 tensor: the moves made until
    every ray was done, at most ``max_steps``.  D1 on CUDA tensors, with no
    host read; the plain march on CPU tensors.
    """
    o, d, _ = flat_rays(origin, direction, None)
    record, steps = march_rays_dda(fused_flat, o, d, None, lr.to(torch.float32).contiguous(),
                                   max_steps)
    res = record_hits(DDA, origin, record)
    res["steps"] = steps
    return res


def render_gbuffers(fused_flat: torch.Tensor, blue_noise: torch.Tensor,
                    uniforms: dict, width: int, height: int,
                    max_steps: int = MAX_TRACE_STEPS, row0: int = 0,
                    rows: int | None = None, bounces: int = 2) -> dict:
    """G-buffers of one frame (or of its rows ``row0 .. row0 + rows``)
    through the exact DDA: ``integrate.stage_gbuffers`` over D1's raw hits.
    On the card R1 (its dda form: the rays, the noise words and the sun),
    D1, then P1 and D1 for each bounce, then S2: 3 + 2 * ``bounces``
    launches, none of which waits for the host.  The bounce rays of sky
    pixels are inactive (born done); JAX traces them too, but no G-buffer
    reads them (``trace_jax.py:210-213``), so the G-buffers are the same."""
    rows = height if rows is None else rows
    f = frame_rays(uniforms, blue_noise, width, height, row0, rows, tables=None, form="dda")
    lr = uniforms["lr"]

    def trace(o, d, active):
        return march_rays_dda(fused_flat, o, d, active, lr, max_steps)[0]

    return stage_gbuffers(trace, DDA, f, f["nw"], uniforms["origin"], bounces, (rows, width))
