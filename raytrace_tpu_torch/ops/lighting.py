"""The fused G-buffer pass: the whole light path per pixel, then a planar
shade.

Port of ``raytrace_tpu/ops/lighting_pallas.py``: ``render_gbuffers_fused``
(``:807-1082``), ``check_material_codes`` (``:80-126``) and ``_mat_code``
(``:129-140``).  The march is kernel K1, ``_make_kernel`` (``:143-796``),
written for Hopper in ``csrc/lighting.cu``, one thread per pixel, reading
the column heights from the region's column table; ``march_paths_plain``
below is the same function in plain PyTorch, which evaluates every height
itself.  Around the march, the frame's rays, noise and scalars come from
``rays.frame_rays`` (kernel R1 on the card) and the planar shade
(``:1007-1073``, which XLA fuses) is kernel S1 (``csrc/shade.cu``), with
``shade_plain`` below as its plain version: a frame is three launches.

Each pixel walks primary -> sun1 -> dif1 -> sun2 -> dif2, capped at
``1 + 2 * bounces`` legs, over the region tables of ``ops/hf_tables.py``.
One step is the JAX unified body ``body_u`` (``:495-572``): classify the
position from the pyramid, detect completion statelessly (out of region or
the sky-escape rule means air, inside a column means hit), start the next
leg on completion, else move to the next boundary.  The whole path has a
budget of ``max_steps`` steps; the JAX cascade budgets per level instead,
so the two agree on every path that completes within budget.

Meta word layout (int32), as in JAX (``:31-39``):
  bits 0-2   leg (0 primary, 1 sun1, 2 dif1, 3 sun2, 4 dif2, 5 done)
  bits 3-5   current ray's entry-face normal id
  bits 6-8   primary hit normal id
  bits 9-11  dif1 hit normal id
  bit  12    primary reached sky
  bits 13-16 sun1 / dif1 / sun2 / dif2 reached sky
  bits 17-18 primary hit material code (0 none, 1 grass, 2 rock, 3 snow)
  bits 19-20 dif1 hit material code
"""

from __future__ import annotations

import torch

from .. import materials
from ..constants import (
    LIGHTING_SCALE,
    MAX_TRACE_STEPS,
    NORMAL_SKY,
    ROOT_BLOCK_SIZE,
)
from .._f32 import fdiv
from ..world.generate import material_band
from ..world.noise import hash3_u32
from . import shading
from .hf_tables import TABLE_KEYS, bdist, classify, step_reciprocal, with_column_heights
from .rays import frame_rays, normalize
from .shading import sphere_trig

_HALF = ROOT_BLOCK_SIZE // 2
LEG_DONE = 5
# Depth written for a pixel whose primary ray never resolved (the JAX
# package's REPORT_ERROR pink case): 256 * 254.
EXHAUSTED_DEPTH = 256 * 254
_EPS = 1e-4

_MAT_CODES_CHECKED = False


def check_material_codes() -> None:
    """Fail loudly if the 2-bit material codes stop covering the bands.

    The march compresses terrain materials to 2-bit codes (band id 2 -> 1,
    5 -> 2, 6 -> 3) and the shade rebuilds packed materials from them, which
    holds only while ``material_band`` emits exactly {2, 5, 6} and the CSV
    keeps those ids solid.  Runs once per process.
    """
    global _MAT_CODES_CHECKED
    if _MAT_CODES_CHECKED:
        return
    z = torch.arange(-64, 320, dtype=torch.int32)
    for bits in (0, 1, 17, 59, 0x7FFFFFFF, 0xFFFFFFFF):
        bands = material_band(z, torch.full(z.shape, bits, dtype=torch.int64))
        extra = set(torch.unique(bands).tolist()) - {2, 5, 6}
        if extra:
            raise AssertionError(
                f"material_band emits ids {sorted(extra)} outside the march's "
                "2-bit code table {2,5,6}; update mat_code"
            )
    if len(materials.MATERIALS) <= 6:
        raise AssertionError(
            "materials table no longer contains ids 2/5/6 used by the march "
            f"(len={len(materials.MATERIALS)})"
        )
    for mid in (2, 5, 6):
        if not materials.SOLID_TABLE[mid]:
            raise AssertionError(
                f"material id {mid} is no longer solid in materials.csv but "
                "the march shades it as terrain"
            )
        if int(materials.PACKED_MATERIALS[mid]) != materials.MATERIALS[mid].pack():
            raise AssertionError(f"PACKED_MATERIALS[{mid}] out of sync")
    _MAT_CODES_CHECKED = True


def mat_code(xi, yi, zi, seed: int) -> torch.Tensor:
    """Material band at a solid voxel as a 2-bit code (1 grass 2 rock 3 snow)."""
    band = material_band(zi, hash3_u32(xi, yi, zi, seed + 1))
    return torch.where(band == 2, 1, torch.where(band == 5, 2, 3)).to(torch.int32)


# ---------------------------------------------------------------------------
# The march, plain PyTorch (the CPU path, and the reference for K1)
# ---------------------------------------------------------------------------


def noise_bytes(nw):
    """The four noise values of the packed noise word, each byte k as
    k/255: noise1 r, g and noise2 r, g."""
    return tuple(fdiv(((nw >> (8 * k)) & 255).to(torch.float32), 255.0) for k in range(4))


def _noise_terms(nw, fscal):
    """Per-pixel jittered sun directions and sphere points from the noise
    word; pure functions of the noise, so both versions compute them once."""
    n1r, n1g, n2r, n2g = noise_bytes(nw)
    sun = fscal[0], fscal[1], fscal[2]
    sz = torch.zeros_like(n1r) + sun[2]
    sj1 = normalize(sun[0] + n1r * 0.05, sun[1] + n1g * 0.05, sz)
    sj2 = normalize(sun[0] + n2r * 0.05, sun[1] + n2g * 0.05, sz)
    return sj1, sj2, shading.sphere_point(n1r, n1g), shading.sphere_point(n2r, n2g)


class _Ctx:
    """Per-launch constants of the plain march."""

    def __init__(self, iscal, tables, seed, legs):
        iv = iscal.tolist()
        self.r0x, self.r0y = iv[0], iv[1]
        self.lrf = [float(v) for v in iv[2:5]]
        self.maxh = iv[5]
        self.t = {k: tables[k] for k in TABLE_KEYS}
        self.seed = seed
        self.legs = legs


def _detect(s, c: _Ctx):
    """Classification and stateless completion at the current position."""
    live = s["leg"] < LEG_DONE
    rising = s["dz"] >= 0
    d = classify(c.t, s["px"], s["py"], s["pz"], rising, c.r0x, c.r0y, c.seed)
    oob = (
        (torch.abs(s["px"] - c.lrf[0]) >= _HALF)
        | (torch.abs(s["py"] - c.lrf[1]) >= _HALF)
        | (torch.abs(s["pz"] - c.lrf[2]) >= _HALF)
        | (rising & (d["zi"] >= c.maxh))
    )
    # `fine` is implied for a real hit (the pyramid never reports a solid
    # voxel empty); keeping it makes the kernel's hcol-only-when-fine exact.
    hit = live & ~oob & d["fine"] & (d["zi"] < d["hcol"])
    return dict(d, air=live & oob, hit=hit)


def _transition(s, d, c: _Ctx, hoisted):
    """Start the next leg for lanes whose current ray completed."""
    sj1, sj2, sp1, sp2 = hoisted
    air, hit = d["air"], d["hit"]
    leg = s["leg"]
    completed = air | hit
    nxv, nyv, nzv = shading.face_normal_vector(s["cn"])
    hx = s["px"] + 0.001 * nxv
    hy = s["py"] + 0.001 * nyv
    hz = s["pz"] + 0.001 * nzv
    is0, is1, is2, is3, is4 = (leg == k for k in range(5))
    c0h = hit & is0
    c2h = hit & is2
    pn = torch.where(c0h, s["cn"], s["pn"])
    nn = torch.where(c2h, s["cn"], s["nn"])
    matc = mat_code(d["xi"], d["yi"], d["zi"], c.seed)
    acc = s["acc"]
    for k, isk in enumerate((is0, is1, is2, is3, is4)):
        acc = acc | ((air & isk).to(torch.int32) << k)
    acc = acc | torch.where(c0h, matc << 5, 0) | torch.where(c2h, matc << 7, 0)
    done = torch.full_like(leg, LEG_DONE)
    next_leg = torch.where(
        is0, torch.where(hit, 1, done),
        torch.where(is1, 2,
                    torch.where(is2, torch.where(hit, 3, done),
                                torch.where(is3, 4, done))),
    )
    next_leg = torch.where(next_leg >= c.legs, done, next_leg)
    leg_new = torch.where(completed, next_leg, leg)
    new_base = c0h | c2h
    qx = torch.where(new_base, hx, s["qx"])
    qy = torch.where(new_base, hy, s["qy"])
    qz = torch.where(new_base, hz, s["qz"])
    starts1 = c0h
    starts2 = completed & is1
    starts3 = c2h
    starts4 = completed & is3
    starting = starts1 | starts2 | starts3 | starts4
    df = shading.diffuse_from_sphere(sp1, pn)
    gf = shading.diffuse_from_sphere(sp2, nn)
    out = dict(s, qx=qx, qy=qy, qz=qz, leg=leg_new, pn=pn, nn=nn, acc=acc)
    for k, a in enumerate("xyz"):
        out["p" + a] = torch.where(starting, (qx, qy, qz)[k], s["p" + a])
        out["d" + a] = torch.where(
            starts1, sj1[k],
            torch.where(starts2, df[k],
                        torch.where(starts3, sj2[k],
                                    torch.where(starts4, gf[k], s["d" + a]))),
        )
    return out


def _move(s, d, act):
    """Advance ``act`` lanes to the nearest step-aligned boundary."""
    step, fine = d["step"], d["fine"]
    step_f = torch.clamp(step, min=1).to(torch.float32)
    inv_step = step_reciprocal(step)
    one = torch.ones_like(step_f)
    lims = []
    for a in "xyz":
        dv = s["d" + a]
        mul = torch.where(dv > 0, -one, one)
        lp = 1.0 / torch.abs(dv)
        lims.append((s["p" + a], mul, lp))
    (px, mulx, lpx), (py, muly, lpy), (pz, mulz, lpz) = lims
    lxf = bdist(px, mulx, lpx, one, one)
    lyf = bdist(py, muly, lpy, one, one)
    ztop = d["hcol"].to(torch.float32)
    lzf = torch.where(
        (s["dz"] < 0) & (pz >= ztop),
        (_EPS + (pz - ztop)) * lpz,
        torch.full_like(pz, float("inf")),
    )
    lx = torch.where(fine, lxf, bdist(px, mulx, lpx, step_f, inv_step))
    ly = torch.where(fine, lyf, bdist(py, muly, lpy, step_f, inv_step))
    lz = torch.where(fine, lzf, bdist(pz, mulz, lpz, step_f, inv_step))
    use_x = (lx < ly) & (lx < lz)
    use_y = ~(lx < ly) & (ly < lz)
    lmin = torch.where(use_x, lx, torch.where(use_y, ly, lz))
    dx, dy, dz = s["dx"], s["dy"], s["dz"]
    nrm = torch.where(
        use_x, torch.where(dx > 0, 1, 0),
        torch.where(use_y, torch.where(dy > 0, 3, 2), torch.where(dz > 0, 5, 4)),
    ).to(torch.int32)
    return dict(
        s,
        px=torch.where(act, px + dx * lmin, px),
        py=torch.where(act, py + dy * lmin, py),
        pz=torch.where(act, pz + dz * lmin, pz),
        cn=torch.where(act, nrm, s["cn"]),
        pd=s["pd"] + torch.where(act & (s["leg"] == 0), lmin, torch.zeros_like(lmin)),
    )


def march_paths_plain(origin, direction, nw, iscal, fscal, tables,
                      max_steps: int, seed: int, legs: int):
    """K1's plain PyTorch version: one step of every path per iteration.

    origin, direction: (N, 3) f32; nw: (N,) int32 packed noise bytes;
    iscal: (8,) int32 (r0x, r0y, lr xyz, maxh); fscal: (8,) f32 (sun xyz).
    Returns ``(meta (N,) int32, pd (N,) f32, work (N, 3) int32)``: ``work``
    counts each path's moves, exact column-height evaluations and steps
    (moves, the steps that complete a leg, and the step without a move
    where the budget ran out), the work K1 does for it: a warp of K1 runs
    as many loop iterations as its lanes' most steps.  Lanes whose path is
    done are compacted away every few steps (a speed device only: a done
    lane's step changes nothing).
    """
    c = _Ctx(iscal, tables, seed, legs)
    n = origin.shape[0]
    dev = origin.device
    zf = torch.zeros(n, dtype=torch.float32, device=dev)
    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    s = dict(px=origin[:, 0], py=origin[:, 1], pz=origin[:, 2],
             dx=direction[:, 0], dy=direction[:, 1], dz=direction[:, 2],
             qx=zf, qy=zf, qz=zf, pd=zf,
             leg=zi, cn=zi, pn=zi, nn=zi, acc=zi, moves=zi, heights=zi, steps=zi)
    hoisted = _noise_terms(nw, fscal)
    meta = torch.empty(n, dtype=torch.int32, device=dev)
    pd = torch.empty(n, dtype=torch.float32, device=dev)
    work = torch.empty((n, 3), dtype=torch.int32, device=dev)
    idx = torch.arange(n, device=dev)

    def flush(s, idx):
        meta[idx] = (s["leg"] | (s["cn"] << 3) | (s["pn"] << 6)
                     | (s["nn"] << 9) | (s["acc"] << 12))
        pd[idx] = s["pd"]
        work[idx] = torch.stack([s["moves"], s["heights"], s["steps"]], -1)

    def take(s, hoisted, keep):
        s = {k: v[keep] for k, v in s.items()}
        hoisted = tuple(tuple(t[keep] for t in h) for h in hoisted)
        return s, hoisted

    def detect(s):
        d = _detect(s, c)
        # The kernel evaluates a column height where a live ray is in the
        # region and its step is fine.
        live = s["leg"] < LEG_DONE
        s["heights"] = s["heights"] + (live & ~d["air"] & d["fine"]).to(torch.int32)
        s["steps"] = s["steps"] + live.to(torch.int32)
        return d

    for i in range(max_steps):
        if i % 16 == 0:
            live = s["leg"] < LEG_DONE
            flush({k: v[~live] for k, v in s.items()}, idx[~live])
            if not bool(live.any()):
                return meta, pd, work
            s, hoisted = take(s, hoisted, live)
            idx = idx[live]
        d = detect(s)
        act = (s["leg"] < LEG_DONE) & ~(d["air"] | d["hit"])
        s["moves"] = s["moves"] + act.to(torch.int32)
        s = _move(_transition(s, d, c, hoisted), d, act)
    # Budget spent: apply completions from the last move, then pack.
    s = _transition(s, detect(s), c, hoisted)
    flush(s, idx)
    return meta, pd, work


# ---------------------------------------------------------------------------
# The wrapper: plain version on the CPU, kernel K1 on the card
# ---------------------------------------------------------------------------

def march_paths(origin, direction, nw, iscal, fscal, tables,
                max_steps: int, seed: int, legs: int, census=None):
    """Walk every pixel's light path -> ``(meta, pd)``.

    CPU tensors take ``march_paths_plain``; CUDA tensors launch K1
    (``csrc/lighting.cu``) on the current stream, and ``march_paths.launches``
    counts those launches.  Any other device raises.  K1 reads the column
    heights from ``tables["hcol"]`` (``hf_tables.with_column_heights``,
    built with ``seed`` for the region of ``iscal``) and the pyramid words.
    ``census``, a (2,) int64 tensor on the same device, or None: K1 adds
    the loop iterations of each of its warps to ``census[0]`` and the moves
    of its paths to ``census[1]`` (the lane-use census of
    ``testing/census.py``; moves as ``march_paths_plain`` counts them).
    K1 counts as each warp exits, so a census costs its loop nothing; the
    plain version leaves it as it is.
    """
    if origin.device.type == "cpu":
        return march_paths_plain(origin, direction, nw, iscal, fscal, tables,
                                 max_steps, seed, legs)[:2]
    if origin.device.type != "cuda":
        raise RuntimeError(f"march_paths: no kernel for device {origin.device}")
    from .._build import check_launch, check_tensor, kernels

    if "hcol" not in tables:
        raise ValueError("march_paths: the tables have no column table 'hcol' "
                         "(hf_tables.with_column_heights)")
    n = origin.shape[0]
    dev = origin.device
    ins = [origin, direction, nw, iscal, fscal, sphere_trig(dev), tables["hsub"],
           tables["h3"], tables["hcol"]]
    want = [(torch.float32, (n, 3)), (torch.float32, (n, 3)), (torch.int32, (n,)),
            (torch.int32, (8,)), (torch.float32, (8,)), (torch.float32, (256, 2)),
            (torch.int32, (1024,)), (torch.int32, (1024,)),
            (torch.int16, (ROOT_BLOCK_SIZE ** 2,))]
    for t, (dtype, shape) in zip(ins, want):
        check_tensor("march_paths", t, dtype, shape, dev)
    if census is not None:
        check_tensor("march_paths", census, torch.int64, (2,), dev)
    meta = torch.empty(n, dtype=torch.int32, device=dev)
    pd = torch.empty(n, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels().rt_march_paths(
        *(t.data_ptr() for t in ins), meta.data_ptr(), pd.data_ptr(),
        n, max_steps, seed, legs,
        None if census is None else census.data_ptr(), stream,
    )
    check_launch("rt_march_paths", err)
    march_paths.launches += 1
    return meta, pd


march_paths.launches = 0


# ---------------------------------------------------------------------------
# The frame's G-buffer pass
# ---------------------------------------------------------------------------


def render_gbuffers_fused(tables: dict, blue_noise: torch.Tensor,
                          uniforms: dict, width: int, height: int,
                          max_steps: int = MAX_TRACE_STEPS, seed: int = 0, *,
                          row0: int = 0, rows: int | None = None,
                          bounces: int = 2, census=None) -> dict:
    """G-buffers of one frame, or of its image rows ``row0 .. row0 + rows``
    (a band of the tile split): the frame's rays (R1), every pixel's path
    (K1), then the shade (S1); three launches on the card.

    ``tables`` from ``build_hf_tables``, with or without the column table K1
    reads (``hf_tables.with_column_heights``): bare tables get it built here
    for this call (``Pipeline.tables()`` builds it once per region, so its
    frames build nothing); ``blue_noise`` (nh, nw, 4) f32 whose
    values are exact k/255 (the march and the shade both read the
    u8-requantized noise word, which is the texture's value only then);
    ``uniforms`` holds tensors origin,
    forward, up, right (3,) f32, sun_angle () f32, seed () int32 and
    lr (3,) f32, all on one device.  Returns lighting, albedo, emission and
    fog (rows, W, 3) f32, depth (rows, W) uint16 and normal (rows, W) uint8;
    a band's equal the same rows of the whole frame's bit for bit (on CPU
    tensors when ``width * rows`` and ``width * height`` are multiples of
    32: see ``integrate.integrate_gbuffers``).  JAX's TPU knobs after
    ``seed`` (``tile_rows``, ``interpret``, the cascade's ``caps``,
    ``unified``, ``unroll``, ``lazy_t``, ``tail_rows``, ``ref_state``) have
    no counterpart, so ``row0``, ``rows`` and ``bounces`` are keyword-only.
    ``census``: K1's, as ``march_paths`` takes it.
    """
    check_material_codes()
    if "hcol" not in tables:
        tables = with_column_heights(tables, seed)
    frame = march_inputs(tables, blue_noise, uniforms, width, height, row0, rows)
    meta, pdist = march_paths(*frame["march"], max_steps, seed, 1 + 2 * bounces, census)
    return shade(meta, pdist, **frame["shade"])


def march_inputs(tables: dict, blue_noise: torch.Tensor, uniforms: dict,
                 width: int, height: int, row0: int = 0,
                 rows: int | None = None) -> dict:
    """The march's inputs for one frame (or its rows ``row0 .. row0 +
    rows``) and what the shade reads besides, from ``rays.frame_rays``
    (R1 on the card).

    ``march``: the positional arguments of ``march_paths`` up to the
    budget (origin and direction (N, 3) f32, the packed noise word (N,)
    int32, iscal (8,) int32 = r0x, r0y, lr xyz, maxh, fscal (8,) f32 =
    sun xyz, sunlight rgb, and the tables).  ``shade``: keyword arguments
    of ``shade`` other than the march's outputs.
    """
    rows = height if rows is None else rows
    f = frame_rays(uniforms, blue_noise, width, height, row0, rows, tables=tables,
                   form="fused")
    return {
        "march": (f["origin"], f["direction"], f["nw"], f["iscal"], f["fscal"], tables),
        "shade": dict(direction=f["direction"], nw=f["nw"], sun=f["sun"],
                      shape=(rows, width)),
    }


def _mat_albedo(code):
    packed = torch.zeros_like(code)
    for c, mid in ((1, 2), (2, 5), (3, 6)):
        packed = torch.where(code == c, int(materials.PACKED_MATERIALS[mid]), packed)
    return [
        fdiv(((packed >> sh) & 0x7F).to(torch.float32), 127.0) for sh in (14, 7, 0)
    ]


def shade_plain(meta, pdist, direction, nw, sun, shape) -> dict:
    """S1's plain PyTorch version (see ``shade``)."""
    meta = meta.reshape(shape)
    pdist = pdist.reshape(shape)
    direction = direction.reshape(*shape, 3)
    n1r, n1g, n2r, n2g = (t.reshape(shape) for t in noise_bytes(nw))
    sun, sunlight = (sun[0], sun[1], sun[2]), (sun[3], sun[4], sun[5])
    leg = meta & 7
    pn = (meta >> 6) & 7
    nn = (meta >> 9) & 7
    acc = meta >> 12
    p_air = (acc & 1) != 0
    a1, a2, a3, a4 = (((acc >> k) & 1).to(torch.float32) for k in (1, 2, 3, 4))
    alb_p = _mat_albedo((acc >> 5) & 3)
    alb_d = _mat_albedo((acc >> 7) & 3)
    d1 = shading.diffuse_direction(n1r, n1g, pn)
    d2 = shading.diffuse_direction(n2r, n2g, nn)
    rd = (direction[..., 0], direction[..., 1], direction[..., 2])
    sky0 = shading.sample_sky(rd, sun, sunlight, True)
    sky1 = shading.sample_sky(d1, sun, sunlight, True)
    sky2 = shading.sample_sky(d2, sun, sunlight, True)
    fog0 = shading.sample_sky(rd, sun, sunlight, False)
    light = []
    for c in range(3):
        lh = a1 * sunlight[c] + a2 * sky1[c] + (a3 * sunlight[c] + a4 * sky2[c]) * alb_d[c]
        light.append(torch.where(p_air, sky0[c] + torch.zeros_like(lh), lh))
    lighting = torch.stack(light, -1) / LIGHTING_SCALE

    exhausted = leg == 0
    depth = torch.where(
        p_air, 0xFFFF,
        torch.clamp(pdist * 32.0, max=float(0xFFFF)).to(torch.int32),
    )
    depth = torch.where(exhausted, EXHAUSTED_DEPTH, depth)
    # Exhausted pixels fog to pink (1, 0, 1), the REPORT_ERROR colour.
    fog = torch.stack([
        torch.where(exhausted, pink, f.expand(leg.shape) / 2.0)
        for f, pink in zip(fog0, (1.0, 0.0, 1.0))
    ], -1)
    albedo = torch.stack([torch.where(p_air, 1.0, a) for a in alb_p], -1)
    normal = torch.where(p_air, NORMAL_SKY, pn)
    return {
        "lighting": lighting,
        "depth": depth.to(torch.uint16),
        "normal": normal.to(torch.uint8),
        "albedo": albedo,
        "emission": torch.zeros_like(lighting),
        "fog": fog,
    }


def shade(meta, pdist, direction, nw, sun, shape) -> dict:
    """Planar shade: radiance, depth, normal, albedo and fog from the path
    bits (lighting_pallas.py:1007-1073).

    ``meta``/``pdist`` are the march's (N,) outputs for the (rows, W)
    ``shape`` of pixels, ``direction`` (N, 3) f32 their primary rays,
    ``nw`` (N,) int32 their noise words (the bounce directions' noise, k/255
    of each byte: the texture's own values, as the texture holds exact
    k/255) and ``sun`` (8,) f32 the frame's sun and sunlight
    (``march_inputs``).  Returns the six G-buffers of
    ``render_gbuffers_fused``.

    CPU tensors take ``shade_plain``; CUDA tensors launch S1
    (``csrc/shade.cu``) on the current stream: the frame's table of bounce
    skies (``sky_table_kernel``, ``SKY_TABLE_ENTRIES`` float4 of scratch),
    then the shade (``shade_fused_kernel``), which reads it;
    ``shade.launches`` counts those calls.  Any other device raises.
    """
    if meta.device.type == "cpu":
        return shade_plain(meta, pdist, direction, nw, sun, shape)
    if meta.device.type != "cuda":
        raise RuntimeError(f"shade: no kernel for device {meta.device}")
    from .._build import check_launch, check_tensor, kernels

    dev = meta.device
    n = shape[0] * shape[1]
    ins = [meta, pdist, direction, nw, sun, shading.sphere_trig(dev)]
    want = [(torch.int32, (n,)), (torch.float32, (n,)), (torch.float32, (n, 3)),
            (torch.int32, (n,)), (torch.float32, (8,)), (torch.float32, (256, 2))]
    for t, (dtype, shp) in zip(ins, want):
        check_tensor("shade", t, dtype, shp, dev)
    out = gbuffers_like(shape, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The frame's bounce skies: scratch the first of S1's two launches
    # writes and the second reads.
    table = torch.empty((SKY_TABLE_ENTRIES, 4), dtype=torch.float32, device=dev)
    err = kernels().rt_shade_fused(
        *(t.data_ptr() for t in ins), table.data_ptr(),
        *(out[k].data_ptr() for k in GBUFFER_KEYS), n,
        *(int(materials.PACKED_MATERIALS[mid]) for mid in (2, 5, 6)), stream,
    )
    check_launch("rt_shade_fused", err)
    shade.launches += 1
    return out


shade.launches = 0

# The G-buffers in the order the shade kernels take them.
GBUFFER_KEYS = ("lighting", "albedo", "emission", "fog", "depth", "normal")
# S1's table of a frame's bounce skies: (face 0-5, noise byte g, noise byte k).
SKY_TABLE_ENTRIES = 6 * 256 * 256


def gbuffers_like(shape, device) -> dict:
    """Empty G-buffers of the (rows, W) ``shape``: lighting, albedo,
    emission and fog (rows, W, 3) f32, depth (rows, W) uint16, normal
    (rows, W) uint8."""
    f3 = lambda: torch.empty((*shape, 3), dtype=torch.float32, device=device)
    return dict(lighting=f3(), albedo=f3(), emission=f3(), fog=f3(),
                depth=torch.empty(shape, dtype=torch.uint16, device=device),
                normal=torch.empty(shape, dtype=torch.uint8, device=device))
