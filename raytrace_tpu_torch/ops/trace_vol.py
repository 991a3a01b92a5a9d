"""Kernels K3 and K3s and their plain versions: the volume_fast light path
of a pixel, and the staged volume tracer of independent rays.

Port of the per-ray work of ``raytrace_tpu/ops/trace_vol_pallas.py``: the
coarse brick march ``_make_vol_kernel`` (``:254-429``) and the in-brick
voxel march ``resolve_mixed`` (``:437-579``), in two forms.  The code the
two kernels share is ``csrc/vol_march.cuh``.

- **K3** walks every pixel's whole path, the work of
  ``raytrace_tpu/ops/path_vol.py``'s round loop with its leg transition
  ``_transition`` (``path_vol.py:161-302``).  The JAX package alternates a
  Pallas kernel pass and an XLA resolve in rounds over the whole frame and
  runs the transitions between rounds; here each pixel walks its own path
  in one loop, written for Hopper in ``csrc/trace_vol.cu`` (persistent
  lanes that each walk path after path, one move per loop iteration) and
  below in plain PyTorch (``march_paths_vol_plain``, one loop iteration per
  step of every live path).
- **K3s** traces independent rays, the work of ``trace_rays_vol``
  (``trace_vol_pallas.py:799-1200``, its plain round loop ``:924-1006``):
  in ``csrc/trace_rays_vol.cu`` persistent lanes walk ray after ray, one
  move per loop iteration, with the round loop's budget in each lane's
  state (``march_rays_vol``), and ``march_rays_vol_plain`` below runs one
  coarse step of every live ray per loop iteration.
  ``render_gbuffers_vol`` is the staged G-buffer pass built on it
  (``:1203-1246``): R1's volume form, K3s and the glue P1 and S2
  (``integrate.stage_gbuffers``).

One step of a ray:
  1. coarse step: a ray out of the window, or past the occupancy bounds
     and not moving back toward them, completes as air; in an all-solid
     brick it hits; entering a mixed brick it parks; otherwise it moves to
     the next 8/16/32/64-aligned boundary (the largest empty level), and
     completes as air if that leaves the window;
  2. a parked ray marches voxel by voxel through its brick's 16-word
     detail row (at most 23 crossings): a solid voxel is a hit, leaving the
     window is air, leaving the brick (or running out of crossings)
     resumes the coarse march;
  3. (K3) a completed ray runs the leg transition: primary -> sun1 -> dif1
     -> sun2 -> dif2, capped at ``legs`` rays, new legs starting from the
     nudged hit with entry normal 0.

K3's budget: each path may take ``path_budget(max_steps, legs)`` =
``2 * legs * ceil(max_steps / 416) * 416`` coarse steps and as many brick
resolves; it stops where either runs out.  The JAX package gives the frame
``legs * ceil(max_steps / 416)`` rounds of up to 416 coarse steps and one
resolve each, then a safety drain of as many rounds again, so both give a
path at least that many steps; the marches are memoryless in position and
direction, so every path that ends within both budgets ends the same way.
A path cut in its primary leg is the exhausted (pink) pixel of the shade.

K3s's budget is JAX's plain round loop, per ray: ``rounds`` rounds
(default ``max(1, ceil(max_steps / cap))``), each of up to
``round_steps(cap) = 2 * ceil(cap / 2)`` coarse steps (the kernel runs two
steps per test of its step counter) that end early where the ray parks,
hits or goes to air; a parked ray then gets one resolve.  A ray still live
after ``rounds`` rounds is exhausted.

Path meta word (int32), as ``path_vol.py:80-95`` without the transient low
bits (the per-ray status and entry normal stay in registers):
  bits 6-8   leg: 0 prim, 1 sun1, 2 dif1, 3 sun2, 4 dif2, 5 path done
  bits 9-11  primary hit normal id
  bits 12-14 dif1 hit normal id (basis of the dif2 direction)
  bit 15     primary reached sky
  bits 16-19 sun1 / dif1 / sun2 / dif2 reached sky
``prim_lin``/``dif1_lin`` are the linear texel indices of the primary and
dif1 hit voxels (-1: none) and ``prim_dist`` the distance from the camera
origin to the nudged primary hit.
"""

from __future__ import annotations

import torch

from ..constants import MAX_TRACE_STEPS, ROOT_BLOCK_SIZE
from . import shading
from .integrate import VOLUME, Record, flat_rays, record_hits, stage_gbuffers
from .rays import INV_WIDTH, frame_rays, normalize
from .vol_tables import occupancy_world_bounds

_HALF = ROOT_BLOCK_SIZE // 2
_N = ROOT_BLOCK_SIZE
NB = _N // 8
DONE, AIR, PARKED = 1, 2, 32
LEG_SHIFT = 6
LEG_DONE = 5
PRIM_NORMAL_SHIFT = 9
DIF1_NORMAL_SHIFT = 12
SKY_SHIFT = 15  # bit 15 + leg: that leg's ray reached sky
MAX_CROSSINGS = 23  # voxel crossings of one brick resolve
ROUND_CAP = 416  # coarse steps per JAX round (path_vol.DEFAULT_CAP)
RAYS_CAP = 96  # K3s: coarse steps per round (trace_rays_vol's cap)
_EPS = 1e-4
_BIG = 1 << 30  # escape=False bounds: never reached in the window


def path_budget(max_steps: int, legs: int) -> int:
    """Coarse steps (and brick resolves) one path may take."""
    return 2 * legs * -(-max_steps // ROUND_CAP) * ROUND_CAP


# ---------------------------------------------------------------------------
# The plain version (the CPU path, and the reference for K3)
# ---------------------------------------------------------------------------


class _Ctx:
    """Per-launch constants of the plain marches (K3's also read the camera
    origin ``fscal`` and the path's ``legs``)."""

    def __init__(self, iscal, tables, fscal=None, legs=0):
        iv = iscal.tolist()
        self.lr = [float(v) for v in iv[0:3]]
        self.bounds = [float(v) for v in iv[3:9]]
        self.origin = None if fscal is None else fscal[:3].tolist()
        self.any8 = tables["any8"].reshape(-1)
        self.all8 = tables["all8"].reshape(-1)
        self.hi = tables["any_hi"].reshape(-1)
        self.detail = tables["detail"]
        self.legs = legs


def _oob(px, py, pz, c: _Ctx):
    return ((torch.abs(px - c.lr[0]) >= _HALF) | (torch.abs(py - c.lr[1]) >= _HALF)
            | (torch.abs(pz - c.lr[2]) >= _HALF))


def _texels(px, py, pz):
    return [(torch.floor(p).to(torch.int32) + _HALF) & (_N - 1) for p in (px, py, pz)]


def _axis_terms(v):
    """Per-axis sign multiplier, length per unit and normal id of a move."""
    one = torch.ones_like(v[0])
    mul = [torch.where(d > 0, -one, one) for d in v]
    lp = [1.0 / torch.abs(d) for d in v]
    nid = [torch.where(d > 0, 2 * k + 1, 2 * k).to(torch.int32) for k, d in enumerate(v)]
    return mul, lp, nid


def _nearest(p, v, modulus):
    """Move to the nearest boundary of the ``modulus`` grid -> (p, normal)."""
    mul, lp, nid = _axis_terms(v)
    lx, ly, lz = ((_EPS + torch.remainder((p[k] + float(_HALF)) * mul[k], modulus)) * lp[k]
                  for k in range(3))
    use_x = (lx < ly) & (lx < lz)
    use_y = ~(lx < ly) & (ly < lz)
    lmin = torch.where(use_x, lx, torch.where(use_y, ly, lz))
    nrm = torch.where(use_x, nid[0], torch.where(use_y, nid[1], nid[2]))
    return [p[k] + v[k] * lmin for k in range(3)], nrm


def _bit(words, i):
    return (words[(i >> 5).long()] >> (i & 31)) & 1


def _coarse(s, c: _Ctx, act):
    """One coarse step of the ``act`` lanes -> status (0 moved, DONE hit,
    DONE|AIR air, PARKED); moves positions and entry normals in place."""
    p = [s["px"], s["py"], s["pz"]]
    v = [s["vx"], s["vy"], s["vz"]]
    b = c.bounds
    air = act & _oob(*p, c)
    esc = (((v[0] >= 0) & (p[0] >= b[1])) | ((v[0] <= 0) & (p[0] < b[0]))
           | ((v[1] >= 0) & (p[1] >= b[3])) | ((v[1] <= 0) & (p[1] < b[2]))
           | ((v[2] >= 0) & (p[2] >= b[5])) | ((v[2] <= 0) & (p[2] < b[4])))
    air = air | (act & esc)
    act = act & ~air
    tx, ty, tz = _texels(*p)
    brick = ((tz >> 3) * NB + (ty >> 3)) * NB + (tx >> 3)
    a8 = _bit(c.any8, brick)
    f8 = _bit(c.all8, brick)
    a16 = _bit(c.hi, ((tz >> 4) * 16 + (ty >> 4)) * 16 + (tx >> 4))
    a32 = _bit(c.hi, 128 * 32 + ((tz >> 5) * 8 + (ty >> 5)) * 8 + (tx >> 5))
    a64 = _bit(c.hi, 192 * 32 + ((tz >> 6) * 4 + (ty >> 6)) * 4 + (tx >> 6))
    step = torch.where(a64 == 0, 64, torch.where(a32 == 0, 32,
                                                 torch.where(a16 == 0, 16, 8)))
    hit = act & (f8 == 1)
    mixed = act & (a8 == 1) & (f8 == 0)
    move = act & ~hit & ~mixed
    q, nrm = _nearest(p, v, step.to(torch.float32))
    for k, a in enumerate("xyz"):
        s["p" + a] = torch.where(move, q[k], p[k])
    s["normal"] = torch.where(move, nrm, s["normal"])
    s["moves"] = s["moves"] + move.to(torch.int32)
    air = air | (move & _oob(s["px"], s["py"], s["pz"], c))
    return torch.where(air, DONE | AIR, torch.where(hit, DONE, torch.where(
        mixed, PARKED, 0))).to(torch.int32)


def _resolve(s, c: _Ctx, idx):
    """March the parked lanes ``idx`` through their brick's voxels ->
    status (DONE hit, DONE|AIR air, 0 live again); moves them in place."""
    p = [s["p" + a][idx] for a in "xyz"]
    v = [s["v" + a][idx] for a in "xyz"]
    normal = s["normal"][idx]

    def brick_of(p):
        tx, ty, tz = _texels(*p)
        return ((tz >> 3) * NB + (ty >> 3)) * NB + (tx >> 3), tx, ty, tz

    b0 = brick_of(p)[0]
    words = c.detail[b0.long()]
    # 0 in the brick, 1 hit, 2 left the brick, 3 left the window
    st = torch.zeros_like(b0)
    moves = torch.zeros_like(b0)
    for _ in range(MAX_CROSSINGS):
        act = st == 0
        if not bool(act.any()):
            break
        b_now, tx, ty, tz = brick_of(p)
        oob = _oob(*p, c)
        st = torch.where(act & oob, 3, torch.where(act & (b_now != b0) & ~oob, 2, st))
        act = act & (b_now == b0) & ~oob
        vox = ((tz & 7) << 6) | ((ty & 7) << 3) | (tx & 7)
        word = words.gather(1, (vox >> 5).long()[:, None])[:, 0]
        hit = act & (((word >> (vox & 31)) & 1) == 1)
        st = torch.where(hit, 1, st)
        move = act & ~hit
        q, nrm = _nearest(p, v, 1.0)
        p = [torch.where(move, q[k], p[k]) for k in range(3)]
        normal = torch.where(move, nrm, normal)
        moves = moves + move.to(torch.int32)
    for k, a in enumerate("xyz"):
        s["p" + a][idx] = p[k]
    s["normal"][idx] = normal
    s["moves"][idx] = s["moves"][idx] + moves
    return torch.where(st == 1, DONE, torch.where(st == 3, DONE | AIR, 0)).to(torch.int32)


def _transition(s, c: _Ctx, comp, air):
    """Start the next leg for the ``comp`` lanes, whose ray completed
    (``air``: reached sky; else hit at the current position)."""
    legs = c.legs
    meta, nrm = s["meta"], s["normal"]
    leg = (meta >> LEG_SHIFT) & 7
    x, y, z = s["px"], s["py"], s["pz"]
    # Hit voxel before the nudge; floor(p + 128), as the JAX transition
    # takes it, which can differ from floor(p) + 128 within an ulp of a face.
    tx, ty, tz = (torch.remainder(torch.floor(q + float(_HALF)).to(torch.int32), _N)
                  for q in (x, y, z))
    lin = (tz * _N + ty) * _N + tx
    nxv, nyv, nzv = shading.face_normal_vector(nrm)
    hx, hy, hz = x + 0.001 * nxv, y + 0.001 * nyv, z + 0.001 * nzv
    is0 = leg == 0
    prim_hit = comp & is0 & ~air
    m = meta | torch.where(prim_hit, nrm << PRIM_NORMAL_SHIFT, 0)
    m = m | ((comp & is0 & air).to(torch.int32) << SKY_SHIFT)
    o = c.origin
    dist = torch.sqrt((hx - o[0]) * (hx - o[0]) + (hy - o[1]) * (hy - o[1])
                      + (hz - o[2]) * (hz - o[2]))
    s["prim_lin"] = torch.where(prim_hit, lin, s["prim_lin"])
    s["prim_dist"] = torch.where(prim_hit, dist, s["prim_dist"])
    if legs == 1:
        s["meta"] = torch.where(comp, (m & ~(7 << LEG_SHIFT)) | (LEG_DONE << LEG_SHIFT), m)
        return
    is1, is2, is3 = leg == 1, leg == 2, leg == 3
    dif1_hit = comp & is2 & ~air
    for k in range(1, legs):
        m = m | ((comp & (leg == k) & air).to(torch.int32) << (SKY_SHIFT + k))
    if legs >= 5:
        m = m | torch.where(dif1_hit, nrm << DIF1_NORMAL_SHIFT, 0)
    nleg = torch.where(is0, torch.where(air, 5, 1), torch.where(
        is1, 2, torch.where(is2, torch.where(air, 5, 3), torch.where(is3, 4, 5))))
    nleg = torch.where(nleg >= legs, 5, nleg)
    nleg = torch.where(comp, nleg, leg).to(torch.int32)
    cont = comp & (nleg < LEG_DONE)
    s["meta"] = (m & ~(7 << LEG_SHIFT)) | (nleg << LEG_SHIFT)
    s["normal"] = torch.where(cont, 0, nrm).to(torch.int32)

    inv = s["inv"]
    pn = (m >> PRIM_NORMAL_SHIFT) & 7
    d1 = shading.diffuse_from_sphere((inv[:, 3], inv[:, 4], inv[:, 5]), pn)
    start = [cont & is0, cont & is1]
    dirs = [(inv[:, 0], inv[:, 1], inv[:, 2]), d1]
    from_hit = [True, False]
    if legs >= 5:
        dn = (m >> DIF1_NORMAL_SHIFT) & 7
        start += [cont & is2, cont & is3]
        dirs += [(inv[:, 6], inv[:, 7], inv[:, 8]),
                 shading.diffuse_from_sphere((inv[:, 9], inv[:, 10], inv[:, 11]), dn)]
        from_hit += [True, False]
        s["dif1_lin"] = torch.where(dif1_hit, lin, s["dif1_lin"])
        set_anchor = prim_hit | dif1_hit
    else:
        set_anchor = prim_hit
    h = (hx, hy, hz)
    anchor = (s["ax"], s["ay"], s["az"])
    starting = start[0]
    for st in start[1:]:
        starting = starting | st
    new_dir = []
    for k, a in enumerate("xyz"):
        pk, dk = s["p" + a], torch.zeros_like(x)
        for st, d, fh in zip(start, dirs, from_hit):
            pk = torch.where(st, h[k] if fh else anchor[k], pk)
            dk = torch.where(st, d[k], dk)
        s["p" + a] = pk
        s["a" + a] = torch.where(set_anchor, h[k], anchor[k])
        new_dir.append(dk)
    # A new leg's direction is normalized once, as the JAX kernel and
    # resolve renormalize the leg's direction on every call.
    v = normalize(*new_dir)
    for k, a in enumerate("xyz"):
        s["v" + a] = torch.where(starting, v[k], s["v" + a])


def march_paths_vol_plain(origin, direction, inv, iscal, fscal, tables,
                          max_steps: int, legs: int):
    """K3's plain PyTorch version: one step of every live path per loop
    iteration.

    origin, direction: (N, 3) f32 primary rays; inv: (N, 12) f32 per-pixel
    sd1, sp1, sd2, sp2 (jittered sun directions and unit-sphere points);
    iscal: (10,) int32 = lr xyz, occupancy bounds xmin xmax ymin ymax zmin
    zmax, pad; fscal: (4,) f32 = camera origin xyz, pad; tables from
    ``build_vol_tables``.  Returns ``(meta, prim_lin, dif1_lin, prim_dist,
    moves)``, each (N,): ``moves`` counts the path's moves, coarse and in
    bricks, the work K3 does for it.  Finished and halted lanes are
    compacted away every 16 iterations (a speed device only).
    """
    c = _Ctx(iscal, tables, fscal, legs)
    n = origin.shape[0]
    dev = origin.device
    budget = path_budget(max_steps, legs)
    zf = torch.zeros(n, dtype=torch.float32, device=dev)
    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    v = normalize(direction[:, 0], direction[:, 1], direction[:, 2])
    s = dict(px=origin[:, 0], py=origin[:, 1], pz=origin[:, 2],
             vx=v[0], vy=v[1], vz=v[2], ax=zf, ay=zf, az=zf,
             meta=zi, normal=zi, prim_lin=zi - 1, dif1_lin=zi - 1, prim_dist=zf,
             moves=zi, coarse=zi + budget, bricks=zi + budget,
             halt=torch.zeros(n, dtype=torch.bool, device=dev), inv=inv)
    s = {k: t.clone() for k, t in s.items()}
    out = dict(meta=zi.clone(), prim_lin=zi.clone(), dif1_lin=zi.clone(),
               prim_dist=zf.clone(), moves=zi.clone())
    idx = torch.arange(n, device=dev)
    i = 0
    while True:
        live = (((s["meta"] >> LEG_SHIFT) & 7) < LEG_DONE) & ~s["halt"]
        if i % 16 == 0:
            for k in out:
                out[k][idx[~live]] = s[k][~live]
            if not bool(live.any()):
                return tuple(out.values())
            s = {k: t[live] for k, t in s.items()}
            idx, live = idx[live], live[live]
        i += 1
        s["halt"] = s["halt"] | (live & (s["coarse"] == 0))
        act = live & ~s["halt"]
        s["coarse"] = s["coarse"] - act.to(torch.int32)
        status = _coarse(s, c, act)
        parked = status == PARKED
        s["halt"] = s["halt"] | (parked & (s["bricks"] == 0))
        res = parked & (s["bricks"] > 0)
        s["bricks"] = s["bricks"] - res.to(torch.int32)
        ridx = torch.nonzero(res)[:, 0]
        if ridx.numel():
            status[ridx] = _resolve(s, c, ridx)
        _transition(s, c, (status & DONE) != 0, (status & AIR) != 0)


# ---------------------------------------------------------------------------
# The wrapper: plain version on the CPU, kernel K3 on the card
# ---------------------------------------------------------------------------


def march_paths_vol(origin, direction, inv, iscal, fscal, tables,
                    max_steps: int, legs: int, census=None):
    """Walk every pixel's volume_fast path ->
    ``(meta, prim_lin, dif1_lin, prim_dist)``.

    CPU tensors take ``march_paths_vol_plain``; CUDA tensors launch K3
    (``csrc/trace_vol.cu``) on the current stream, and
    ``march_paths_vol.launches`` counts those launches.  Any other device
    raises.  ``census``, a (2,) int64 tensor on the same device, or None:
    K3 adds the loop iterations of each of its warps to ``census[0]`` and
    the moves of its paths to ``census[1]`` (the lane-use census of
    ``testing/census.py``; moves as ``march_paths_vol_plain`` counts them).
    K3 counts as each warp exits, so a census costs its loop nothing; the
    plain version leaves it as it is.
    """
    if origin.device.type == "cpu":
        return march_paths_vol_plain(origin, direction, inv, iscal, fscal, tables,
                                     max_steps, legs)[:4]
    if origin.device.type != "cuda":
        raise RuntimeError(f"march_paths_vol: no kernel for device {origin.device}")
    from .._build import check_launch, check_tensor, kernels

    n = origin.shape[0]
    dev = origin.device
    ins = [origin, direction, inv, iscal, fscal, tables["any8"], tables["all8"],
           tables["any_hi"], tables["detail"]]
    want = [(torch.float32, (n, 3)), (torch.float32, (n, 3)),
            (torch.float32, (n, INV_WIDTH)), (torch.int32, (10,)),
            (torch.float32, (4,)), (torch.int32, (8, 128)), (torch.int32, (8, 128)),
            (torch.int32, (2, 128)), (torch.int32, (NB ** 3, 16))]
    for t, (dtype, shape) in zip(ins, want):
        check_tensor("march_paths_vol", t, dtype, shape, dev)
    if census is not None:
        check_tensor("march_paths_vol", census, torch.int64, (2,), dev)
    outs = [torch.empty(n, dtype=dt, device=dev)
            for dt in (torch.int32, torch.int32, torch.int32, torch.float32)]
    nxt = torch.zeros(1, dtype=torch.int32, device=dev)  # the lanes' path counter
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels().rt_march_paths_vol(
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        n, path_budget(max_steps, legs), legs, nxt.data_ptr(),
        None if census is None else census.data_ptr(), stream,
    )
    check_launch("rt_march_paths_vol", err)
    march_paths_vol.launches += 1
    return tuple(outs)


march_paths_vol.launches = 0


# ---------------------------------------------------------------------------
# K3s: the staged tracer of independent rays
# ---------------------------------------------------------------------------


def rays_vol_rounds(max_steps: int, cap: int = RAYS_CAP) -> int:
    """K3s's default rounds per ray (``trace_vol_pallas.py:876-877``)."""
    return max(1, -(-max_steps // cap))


def round_steps(cap: int) -> int:
    """Coarse steps in one round: the Pallas kernel tests its step counter
    against ``cap`` once every two steps (``unroll=2``, ``:402-411``)."""
    return 2 * -(-cap // 2)


def rays_vol_iscal(tables: dict, lr: torch.Tensor, escape: bool = True) -> torch.Tensor:
    """K3s's (10,) int32 scalars: lr xyz, the escape bounds xmin xmax ymin
    ymax zmin zmax (the occupancy bounds, or +-2^30 with ``escape`` False,
    ``:907-914``), pad."""
    lri = lr.to(torch.int32)
    if escape:
        bounds = occupancy_world_bounds(tables["any8b"], lri)
    else:
        bounds = torch.tensor([-_BIG, _BIG] * 3, dtype=torch.int32, device=lri.device)
    return torch.cat([lri, bounds, torch.zeros(1, dtype=torch.int32, device=lri.device)])


def march_rays_vol_plain(origin, direction, active, iscal, tables, rounds: int,
                         cap: int = RAYS_CAP):
    """K3s's plain PyTorch version: one coarse step of every live ray per
    loop iteration, with the resolve of the rays that park in it.

    origin, direction: (N, 3) f32 (directions need not be unit); active:
    (N,) bool or None (all traced); iscal: (10,) int32 from
    ``rays_vol_iscal``; tables from ``build_vol_tables``.  A ray gets
    ``rounds`` rounds of up to ``round_steps(cap)`` coarse steps, a round
    ending early where it parks (then one resolve), hits or goes to air.
    Returns ``(position (N, 3) f32 before any nudge, normal (N,) int32,
    air (N,) bool, done (N,) bool, moves (N,) int32)``: a ray not done is
    exhausted and keeps its resume position and entry normal; an inactive
    ray is born done at its origin with normal 0 (``:901-904``); ``moves``
    counts each ray's coarse moves and voxel crossings, the work K3s does
    for it.  Finished rays are compacted away every 16 iterations (a speed
    device only).
    """
    c = _Ctx(iscal, tables)
    n = origin.shape[0]
    dev = origin.device
    steps = round_steps(cap)
    pos = origin.clone()
    normal = torch.zeros(n, dtype=torch.int32, device=dev)
    air = torch.zeros(n, dtype=torch.bool, device=dev)
    traced = (torch.ones(n, dtype=torch.bool, device=dev) if active is None
              else active.to(torch.bool))
    done = ~traced
    moves = torch.zeros(n, dtype=torch.int32, device=dev)
    idx = torch.nonzero(traced)[:, 0]
    v = normalize(direction[idx, 0], direction[idx, 1], direction[idx, 2])
    zi = torch.zeros(idx.shape[0], dtype=torch.int32, device=dev)
    # status: 0 live, DONE hit, DONE|AIR air; k: steps in the round; r: rounds spent
    s = dict(idx=idx, px=origin[idx, 0], py=origin[idx, 1], pz=origin[idx, 2],
             vx=v[0], vy=v[1], vz=v[2], normal=zi, moves=zi, status=zi, k=zi, r=zi)
    s = {k: t.clone() for k, t in s.items()}

    def flush(s, sel):
        j = s["idx"][sel]
        pos[j] = torch.stack([s["px"][sel], s["py"][sel], s["pz"][sel]], -1)
        normal[j] = s["normal"][sel]
        air[j] = (s["status"][sel] & AIR) != 0
        done[j] = (s["status"][sel] & DONE) != 0
        moves[j] = s["moves"][sel]

    i = 0
    while True:
        live = ((s["status"] & DONE) == 0) & (s["r"] < rounds)
        if i % 16 == 0:
            flush(s, ~live)
            if not bool(live.any()):
                return pos, normal, air, done, moves
            s = {k: t[live] for k, t in s.items()}
            live = live[live]
        i += 1
        status = _coarse(s, c, live)
        parked = status == PARKED
        ridx = torch.nonzero(parked)[:, 0]
        if ridx.numel():
            status[ridx] = _resolve(s, c, ridx)
        s["k"] = s["k"] + live.to(torch.int32)
        end = live & (status == 0) & (parked | (s["k"] == steps))
        s["r"] = s["r"] + end.to(torch.int32)
        s["k"] = torch.where(end, 0, s["k"])
        s["status"] = torch.where(live, status, s["status"])


def march_rays_vol(origin, direction, active, iscal, tables, rounds: int,
                   cap: int = RAYS_CAP, census=None):
    """K3s on a batch of rays -> ``(position (N, 3) f32 before any nudge,
    normal (N,) int32, air (N,) bool, done (N,) bool)``, the raw hits
    (``integrate.Record``, mode VOLUME; see ``march_rays_vol_plain``).

    origin, direction: (N, 3) f32 contiguous; active: (N,) bool or None;
    iscal: (10,) int32 from ``rays_vol_iscal`` (or R1's volume form, the
    escape bounds).  CPU tensors take ``march_rays_vol_plain``; CUDA
    tensors launch K3s (``csrc/trace_rays_vol.cu``) on the current stream,
    and ``march_rays_vol.launches`` counts those launches.  Any other device
    raises.  ``census``, a (1,) int64 tensor on the card, or None: K3s adds
    the loop iterations of each of its warps to it (the lane-use census of
    ``testing/census.py``).
    """
    if origin.device.type == "cpu":
        return march_rays_vol_plain(origin, direction, active, iscal, tables, rounds,
                                    cap)[:4]
    if origin.device.type != "cuda":
        raise RuntimeError(f"march_rays_vol: no kernel for device {origin.device}")
    from .._build import check_launch, check_tensor, kernels

    n = origin.shape[0]
    dev = origin.device
    keys = ("any8", "all8", "any_hi", "detail")
    ins = [origin, direction] + ([] if active is None else [active]) + [iscal] \
        + [tables[k] for k in keys]
    want = [(torch.float32, (n, 3))] * 2 + ([] if active is None else [(torch.bool, (n,))]) \
        + [(torch.int32, (10,)), (torch.int32, (8, 128)), (torch.int32, (8, 128)),
           (torch.int32, (2, 128)), (torch.int32, (NB ** 3, 16))]
    for t, (dtype, shape) in zip(ins, want):
        check_tensor("march_rays_vol", t, dtype, shape, dev)
    if census is not None:
        check_tensor("march_rays_vol", census, torch.int64, (1,), dev)
    pos = torch.empty((n, 3), dtype=torch.float32, device=dev)
    normal = torch.empty(n, dtype=torch.int32, device=dev)
    air, done = (torch.empty(n, dtype=torch.bool, device=dev) for _ in range(2))
    nxt = torch.empty(1, dtype=torch.int32, device=dev)  # the lanes' ray counter
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels().rt_trace_rays_vol(
        origin.data_ptr(), direction.data_ptr(), None if active is None else active.data_ptr(),
        iscal.data_ptr(), *(tables[k].data_ptr() for k in keys),
        pos.data_ptr(), normal.data_ptr(), air.data_ptr(), done.data_ptr(),
        n, rounds, round_steps(cap), nxt.data_ptr(),
        None if census is None else census.data_ptr(), stream,
    )
    check_launch("rt_trace_rays_vol", err)
    march_rays_vol.launches += 1
    return pos, normal, air, done


march_rays_vol.launches = 0


def trace_rays_vol_plain(tables: dict, volume, origin, direction, lr,
                         max_steps: int = MAX_TRACE_STEPS, rounds: int | None = None,
                         cap: int = RAYS_CAP, active=None, escape: bool = True) -> dict:
    """``trace_rays_vol`` through the plain march, on any device.  The hit
    dict also carries ``moves`` (...,): each ray's coarse moves and voxel
    crossings."""
    o, d, a = flat_rays(origin, direction, active)
    rounds = rays_vol_rounds(max_steps, cap) if rounds is None else rounds
    *out, moves = march_rays_vol_plain(o, d, a, rays_vol_iscal(tables, lr, escape),
                                       tables, rounds, cap)
    res = record_hits(VOLUME, origin, Record(*out), volume)
    res["moves"] = moves.reshape(origin.shape[:-1])
    return res


def trace_rays_vol(tables: dict, fused_flat, origin, direction, lr,
                   max_steps: int = MAX_TRACE_STEPS, *, rounds: int | None = None,
                   cap: int = RAYS_CAP, active=None, escape: bool = True,
                   census=None) -> dict:
    """Trace independent rays through the resident volume (the JAX
    package's ``trace_rays_vol``, a drop-in for the exact DDA).

    ``tables`` from ``build_vol_tables`` for ``fused_flat``, the resident
    volume (fused (256^3,) int32); origin, direction (..., 3) f32 (directions need not be unit);
    ``lr`` (3,) the region centre; ``active`` (...,) bool or None.  Each
    ray gets ``rounds`` rounds (default ``rays_vol_rounds(max_steps,
    cap)``) of up to ``round_steps(cap)`` coarse steps and one brick
    resolve.  ``escape``: complete rays as air the moment they clear the
    occupancy bounds moving away (False: bounds never reached).  Returns
    the hit dict: ``position`` (nudged 0.001 off the face for hits only),
    ``normal``, ``air``, ``albedo``, ``distance`` (before the nudge) and
    ``exhausted``; the packed material of a hit is the volume's word at
    ``floor(p + 128) mod 256`` of the position before the nudge (``:1140-
    1200``; ``integrate.record_hits``).  Inactive rays are born done: they
    come back as hits at their origin with its voxel's material and
    ``exhausted`` False (the caller masks them).

    CPU tensors take the plain march (``trace_rays_vol_plain``); CUDA
    tensors launch K3s through ``march_rays_vol`` (counted on
    ``march_rays_vol.launches``).  Any other device raises.  ``census`` as
    for ``march_rays_vol``.

    Every ray equals JAX's plain round loop (``cascade=False``).  JAX turns
    on its straggler cascade by itself when ``rounds >= 12`` and the batch
    spans at least 16 tiles (32768 rays, ``:1008-1014``); the cascade
    equals the plain loop on every ray that finishes (``:841-846``), so the
    port equals it there too, and may report a later resume position for a
    ray the cascade exhausts.  The TPU's tiles (``tile_rows``), padding
    rays, lane-shuffle lookups, round ``while_loop`` with its early exit,
    ``interpret`` and ``cascade`` have no counterpart, and the one-pass
    ``resolve_mixed_parallel`` (``resolve=``) is not ported: the serial
    resolve is JAX's default.  As JAX's ``tile_rows`` and ``interpret``
    follow ``max_steps``, what follows it is keyword-only.
    """
    if origin.device.type == "cpu":
        return trace_rays_vol_plain(tables, fused_flat, origin, direction, lr, max_steps,
                                    rounds, cap, active, escape)
    if origin.device.type != "cuda":
        raise RuntimeError(f"trace_rays_vol: no kernel for device {origin.device}")
    o, d, a = flat_rays(origin, direction, active)
    rounds = rays_vol_rounds(max_steps, cap) if rounds is None else rounds
    out = march_rays_vol(o, d, a, rays_vol_iscal(tables, lr, escape), tables, rounds, cap,
                         census)
    return record_hits(VOLUME, origin, Record(*out), fused_flat)


def render_gbuffers_vol(fused_flat: torch.Tensor, tables: dict, blue_noise: torch.Tensor,
                        uniforms: dict, width: int, height: int,
                        max_steps: int = MAX_TRACE_STEPS, row0: int = 0,
                        rows: int | None = None, *, bounces: int = 2,
                        escape: bool = True) -> dict:
    """G-buffers of one frame (or of its rows ``row0 .. row0 + rows``)
    through the staged volume tracer (``trace_vol_pallas.py:1203-1246``):
    ``integrate.stage_gbuffers`` over K3s's raw hits.  On the card R1 (its
    volume form: the rays, the invariants sd1, sp1, sd2, sp2, the sun and
    K3s's scalars with the escape bounds), K3s, then P1 and K3s for each
    bounce, then S2: 3 + 2 * ``bounces`` launches.  ``fused_flat`` and
    ``tables`` as for ``trace_rays_vol``, the region centre
    ``uniforms["lr"]``; ``escape`` False takes the never-reached bounds
    (``rays_vol_iscal``).  The result equals ``integrate_gbuffers`` with
    ``trace_rays_vol`` bit for bit.  JAX's ``interpret`` follows ``rows``,
    so ``bounces`` and ``escape`` are keyword-only."""
    rows = height if rows is None else rows
    f = frame_rays(uniforms, blue_noise, width, height, row0, rows, tables=tables,
                   form="volume")
    iscal = f["iscal"] if escape else rays_vol_iscal(tables, uniforms["lr"], escape=False)
    rounds = rays_vol_rounds(max_steps)

    def trace(o, d, active):
        return Record(*march_rays_vol(o, d, active, iscal, tables, rounds))

    return stage_gbuffers(trace, VOLUME, f, f["inv"], uniforms["origin"], bounces,
                          (rows, width), fused_flat)
