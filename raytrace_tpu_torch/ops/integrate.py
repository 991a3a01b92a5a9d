"""The staged lighting pass: primary, sun and diffuse rays traced leg by leg,
then the G-buffers.

Port of ``raytrace_tpu/ops/trace_jax.py:268-389`` (``integrate_gbuffers``),
the whole frame of the staged tracers: ``tracer="hf"`` (``ops/trace_hf.py``,
kernel K4), the staged volume frame (``ops/trace_vol.py``, K3s) and
``tracer="volume"`` (the exact DDA, ``ops/trace_dda.py``, D1).  The sun and
diffuse rays of a bounce go to the tracer as one doubled batch, so a frame
makes ``1 + bounces`` trace calls.  Two compositions share the arithmetic:

- ``stage_gbuffers``: the frame programs of the three staged tracers
  (JAX's ``render_gbuffers_hf``, ``trace_pallas.py:709-753``,
  ``render_gbuffers_vol``, ``trace_vol_pallas.py:1203-1246``, and
  ``render_gbuffers``, ``trace_jax.py:191-215``, where XLA fuses this glue
  around the tracer's calls).  The front is R1
  (``rays.frame_rays``), each tracer call returns its batch's raw hits (a
  ``Record``), ``leg_batch`` (P1) builds each bounce's ray batch from the
  last leg's hits and ``shade_staged`` (S2) writes the G-buffers.  On the
  card P1 and S2 are the kernels of ``csrc/staged.cu``, one launch each;
  ``leg_batch_plain`` and ``shade_staged_plain`` are their plain versions.
- ``integrate_gbuffers``: plain PyTorch around any ``trace`` callable that
  returns hit dicts (``hit_result``): the tools that time a tracer's
  batches alone, and the reference the staged frames are held to.

A ``Record`` holds a batch's hits as its tracer wrote them, in one of three
modes:

- ``HF`` (K4): ``air`` and ``mat`` int32, ``mat`` the packed material word;
  every ray is nudged 0.001 off its face; a ray is exhausted where it is
  not air and its packed word is 0 (``trace_pallas.py:682-706``);
- ``VOLUME`` (K3s): ``air`` and ``mat`` (done) bool; only hits (done and
  not air) are nudged, and a hit's packed material is the volume's word at
  ``floor(p + 128) mod 256`` of the position before the nudge; a ray is
  exhausted where not done (``trace_vol_pallas.py:1140-1200``);
- ``DDA`` (D1): ``air`` bool and ``mat`` int32, the hit's packed word
  (``fused & MATERIAL_MASK``, 0 where nothing was hit) or ``EXHAUSTED``
  where the ray is not done; every ray is nudged, the air and exhausted ones
  too, so an exhausted primary (not air) sends its bounce rays from the
  nudged position; the albedo is the packed word's
  (``trace_jax.py:144-165``).  The HF rule would call a solid voxel whose
  material bits are 0 exhausted; a preloaded or edited volume can hold one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._f32 import fdiv
from ..constants import LIGHTING_SCALE, NORMAL_SKY, ROOT_BLOCK_SIZE
from . import shading
from .lighting import EXHAUSTED_DEPTH, GBUFFER_KEYS, gbuffers_like
from .rays import INV_WIDTH, camera_rays, frame_noise, normalize
from .volume import MATERIAL_MASK, lookup

HF, VOLUME, DDA = "hf", "volume", "dda"
MODES = (HF, VOLUME, DDA)
# The DDA mode's ``mat`` of a ray that is not done: above every packed word.
EXHAUSTED = MATERIAL_MASK + 1
_N = ROOT_BLOCK_SIZE


class Record(NamedTuple):
    """A batch of M rays' raw hits as the tracer wrote them."""

    pos: torch.Tensor  # (M, 3) f32: where each ray stopped, before any nudge
    normal: torch.Tensor  # (M,) int32: its entry-face id
    air: torch.Tensor  # (M,) int32 (HF) or bool (VOLUME, DDA): it reached the sky
    # (M,) int32 packed material (HF; DDA, or EXHAUSTED) or bool done (VOLUME)
    mat: torch.Tensor


def length(v: torch.Tensor) -> torch.Tensor:
    """``|v|`` over the last axis of a (..., 3) tensor, summed x, y, z.

    The root is taken in float64 and rounded once to float32, which is the
    correctly rounded float32 root on every device: PyTorch's vectorized CPU
    ``sqrt`` is an ulp off it for some inputs, where XLA's and CUDA's are not.
    """
    n2 = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return torch.sqrt(n2.to(torch.float64)).to(torch.float32)


def flat_rays(origin, direction, active):
    """(N, 3) f32 origin and direction and (N,) bool active (or None) of a
    batch of rays of any leading shape, contiguous, as the kernels take
    them."""
    o = origin.reshape(-1, 3).to(torch.float32).contiguous()
    d = direction.reshape(-1, 3).to(torch.float32).contiguous()
    a = None if active is None else active.reshape(-1).to(torch.bool).contiguous()
    return o, d, a


def nudged(pos, normal, where=None):
    """``pos`` (..., 3) moved 0.001 along the face normal of ``normal``
    (only where ``where`` is True, when it is given)."""
    nx, ny, nz = shading.face_normal_vector(normal)
    step = 0.001 if where is None else torch.where(where, 0.001, 0.0)[..., None]
    return pos + step * torch.stack([nx, ny, nz], -1)


def albedo_of(packed):
    """(..., 3) f32 albedo of packed material words: each 7-bit channel / 127."""
    return torch.stack([fdiv(((packed >> sh) & 0x7F).to(torch.float32), 127.0)
                        for sh in (14, 7, 0)], -1)


def volume_packed(volume, pos, hit):
    """The packed material of ``volume``'s voxel at ``floor(pos + 128) mod
    256`` (``pos`` (..., 3) before the nudge) where ``hit``, else 0."""
    return torch.where(hit, lookup(volume, pos) & MATERIAL_MASK, 0)


def hit_result(origin, pos, normal, air, packed, exhausted, nudge=None) -> dict:
    """A tracer's hit dict (``trace_jax.py:144-165``, ``trace_pallas.py:682-706``).

    ``pos`` (..., 3) is where each ray stopped, ``normal`` its entry-face
    id, ``air`` whether it reached sky, ``packed`` the packed material of
    its hit voxel (0 for none).  Returns ``position`` nudged 0.001 off the
    face (only where ``nudge`` is True, when it is given), ``normal``,
    ``air``, ``albedo`` (..., 3), ``distance`` (before the nudge) and
    ``exhausted``.
    """
    return {
        "position": nudged(pos, normal, nudge),
        "normal": normal,
        "air": air,
        "albedo": albedo_of(packed),
        "distance": length(origin - pos),
        "exhausted": exhausted,
    }


def _air(mode: str, record: Record):
    return record.air != 0 if mode == HF else record.air


def _packed(mode: str, record: Record, air, volume):
    if mode == HF:
        return record.mat
    if mode == DDA:
        return record.mat & MATERIAL_MASK
    return volume_packed(volume, record.pos, record.mat & ~air)


def _hits(mode: str, record: Record, volume=None) -> dict:
    """Position (nudged), normal, air (bool), albedo and exhausted of a
    batch's raw ``record`` by the rules of ``mode``."""
    air = _air(mode, record)
    if mode == HF:
        where, exhausted = None, ~air & (record.mat == 0)
    elif mode == DDA:
        where, exhausted = None, (record.mat & EXHAUSTED) != 0
    else:
        where, exhausted = record.mat & ~air, ~record.mat
    return dict(position=nudged(record.pos, record.normal, where), normal=record.normal,
                air=air, albedo=albedo_of(_packed(mode, record, air, volume)),
                exhausted=exhausted)


def record_hits(mode: str, origin, record: Record, volume=None) -> dict:
    """The hit dict of ``hit_result`` from a batch's raw ``record``, shaped
    like its rays' ``origin`` (..., 3); ``volume``, the fused (256^3,) int32
    volume, in the VOLUME mode."""
    shape = origin.shape[:-1]
    record = Record(record.pos.reshape(origin.shape),
                    *(t.reshape(shape) for t in record[1:]))
    h = _hits(mode, record, volume)
    return {"position": h["position"], "normal": h["normal"], "air": h["air"],
            "albedo": h["albedo"], "distance": length(origin - record.pos),
            "exhausted": h["exhausted"]}


# ---------------------------------------------------------------------------
# The arithmetic both compositions share
# ---------------------------------------------------------------------------


def jittered_sun(nr, ng, sun):
    """The sun direction jittered by a noise texel (red ``nr``, green
    ``ng``): ``normalize(sun + (nr, ng, 0) * 0.05)`` as (x, y, z)."""
    return normalize(sun[0] + nr * 0.05, sun[1] + ng * 0.05, torch.zeros_like(nr) + sun[2])


def pair_batch(from_pos, normal, sd, sp, active):
    """One bounce's sun and diffuse rays as one doubled batch along the
    first axis: both start at ``from_pos`` (..., 3); the sun rays go along
    the jittered sun ``sd``, the diffuse rays along the sphere point ``sp``
    (tuples of (x, y, z)) about the face ``normal``; ``active`` marks the
    pixels whose bounce rays exist at all.  -> (origin, direction, active)."""
    dif = torch.stack(shading.diffuse_from_sphere(sp, normal), -1)
    return (torch.cat([from_pos, from_pos]), torch.cat([torch.stack(sd, -1), dif]),
            torch.cat([active, active]))


def gbuffers_from_hits(primary: dict, pairs: list, ray_dir, sun, cam) -> dict:
    """The six G-buffers from the primary hits and each bounce's pair.

    ``primary``: the primary batch's hit dict (position nudged, normal, air,
    albedo, exhausted); ``pairs``: per bounce (sun hits, diffuse hits, the
    diffuse directions), hit dicts holding at least ``air`` (and the first
    bounce's diffuse hits ``albedo`` when there are two bounces);
    ``ray_dir`` (..., 3) the primary directions; ``sun`` (8,) f32 the sun
    xyz and sunlight rgb (``shading.sun_vector``); ``cam`` (3,) the camera
    origin.  Returns lighting, albedo, emission and fog (..., 3) f32, depth
    (...) uint16 and normal (...) uint8.
    """
    sun_d, sunlight = (sun[0], sun[1], sun[2]), (sun[3], sun[4], sun[5])
    dev = ray_dir.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def sky(d, include_sun):
        rgb = shading.sample_sky((d[..., 0], d[..., 1], d[..., 2]), sun_d, sunlight,
                                 include_sun)
        return torch.stack(torch.broadcast_tensors(*rgb), -1)

    light_hit = torch.zeros(ray_dir.shape, dtype=torch.float32, device=dev)
    for k, (sun_r, dif_r, d) in enumerate(pairs):
        light = (torch.where(sun_r["air"][..., None], sun[3:6], zero)
                 + torch.where(dif_r["air"][..., None], sky(d, True), zero))
        if k == 0:
            light_hit = light
        else:
            dif1 = pairs[0][1]
            light_hit = light_hit + torch.where(dif1["air"][..., None], zero,
                                                light * dif1["albedo"])

    hit_mask = ~primary["air"]
    light = torch.where(hit_mask[..., None], light_hit, sky(ray_dir, True))
    dist = length(cam - primary["position"])
    depth = torch.where(
        primary["air"], 0xFFFF,
        torch.clamp(dist * 32.0, max=float(0xFFFF)).to(torch.int32))
    # Rays that exhausted their budget: pink fog (the REPORT_ERROR colour,
    # made on the device) and the near-max depth that fogs to it.
    exhausted = primary["exhausted"]
    pink = (torch.arange(3, device=dev) != 1).to(torch.float32)
    fog = torch.where(exhausted[..., None], pink, fdiv(sky(ray_dir, False), 2.0))
    depth = torch.where(exhausted, EXHAUSTED_DEPTH, depth)
    return {
        "lighting": fdiv(light, LIGHTING_SCALE),
        "depth": depth.to(torch.uint16),
        "normal": torch.where(primary["air"], NORMAL_SKY, primary["normal"]).to(torch.uint8),
        "albedo": torch.where(hit_mask[..., None], primary["albedo"], 1.0),
        "emission": torch.zeros_like(light),
        "fog": fog,
    }


# ---------------------------------------------------------------------------
# P1: one bounce's ray batch from the last leg's raw hits
# ---------------------------------------------------------------------------


def _flags(mode: str, m: int) -> list:
    """(dtype, shape) of a ``Record``'s ``air`` and ``mat`` in ``mode``, M
    rays."""
    air = torch.int32 if mode == HF else torch.bool
    mat = torch.bool if mode == VOLUME else torch.int32
    return [(air, (m,)), (mat, (m,))]


def _noise_terms(mode: str, noise, sun, bounce: int):
    """Each pixel's jittered sun direction and sphere point (tuples of (N,)
    tensors) from its noise texel of ``bounce`` (0 or 1): in the HF and DDA
    modes R1's noise word (bytes k as k / 255, the texture's own values: it
    holds exact k / 255), in the VOLUME mode R1's invariants sd, sp."""
    if mode != VOLUME:
        nr, ng = (fdiv(((noise >> (16 * bounce + 8 * c)) & 255).to(torch.float32), 255.0)
                  for c in (0, 1))
        return jittered_sun(nr, ng, sun), shading.sphere_point(nr, ng)
    k = 6 * bounce
    return (tuple(noise[:, k + c] for c in range(3)),
            tuple(noise[:, k + 3 + c] for c in range(3)))


def leg_batch_plain(mode: str, record: Record, noise, sun, bounce: int,
                    active=None):
    """P1's plain PyTorch version (see ``leg_batch``)."""
    n = noise.shape[0]
    off = record.pos.shape[0] - n
    rec = Record(*(t[off:] for t in record))
    air = _air(mode, rec)
    act = ~air if active is None else active[off:] & ~air
    sd, sp = _noise_terms(mode, noise, sun, bounce)
    from_pos = nudged(rec.pos, rec.normal, rec.mat & ~air if mode == VOLUME else None)
    return pair_batch(from_pos, rec.normal, sd, sp, act)


def leg_batch(mode: str, record: Record, noise, sun, bounce: int, active=None):
    """One bounce's sun + diffuse pair batch of 2N rays from the last leg's
    raw hits: the primary batch's (``record`` of N rays, ``active`` None)
    or the last pair's diffuse half (``record`` of 2N rays, its rays N ..
    2N; ``active`` that batch's (2N,) flags).

    ``noise``: the HF and DDA modes' (N,) int32 noise words or the VOLUME
    mode's (N, 12) f32 invariants (``rays.frame_rays``); ``sun`` (8,) f32 the
    frame's sun and sunlight; ``bounce`` 0 or 1, which noise texel.
    Returns ``(origin, direction, active)``: origin (2N, 3) f32, the
    nudged hit in both halves; direction (2N, 3) f32, the jittered sun in
    the first half, the diffuse direction about the hit's face in the
    second; active (2N,) bool, the earlier flag and not air
    (``trace_jax.py:336-378``).

    CPU tensors take ``leg_batch_plain``; CUDA tensors launch P1
    (``csrc/staged.cu``) on the current stream, writing the buffers the
    tracer reads, and ``leg_batch.launches`` counts those launches.  Any
    other device raises.
    """
    if mode not in MODES:
        raise ValueError(f"leg_batch: mode {mode!r} is not one of {MODES}")
    dev = record.pos.device
    if dev.type == "cpu":
        return leg_batch_plain(mode, record, noise, sun, bounce, active)
    if dev.type != "cuda":
        raise RuntimeError(f"leg_batch: no kernel for device {dev}")
    from .._build import check_launch, check_tensor, kernels

    n, m = noise.shape[0], record.pos.shape[0]
    if m not in (n, 2 * n) or bounce not in (0, 1):
        raise ValueError(f"leg_batch: {m} rays for {n} pixels, bounce {bounce}")
    words = mode != VOLUME  # the noise words (HF, DDA) or the invariants
    ins = list(record) + ([] if active is None else [active]) + [noise, sun]
    want = [(torch.float32, (m, 3)), (torch.int32, (m,)), *_flags(mode, m)] \
        + ([] if active is None else [(torch.bool, (m,))]) \
        + [(torch.int32, (n,)) if words else (torch.float32, (n, INV_WIDTH)),
           (torch.float32, (8,))]
    for t, (dtype, shape) in zip(ins, want):
        check_tensor("leg_batch", t, dtype, shape, dev)
    origin, direction = (torch.empty((2 * n, 3), dtype=torch.float32, device=dev)
                         for _ in range(2))
    act = torch.empty(2 * n, dtype=torch.bool, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels().rt_leg_batch(
        *(t.data_ptr() for t in record), ptr(active), ptr(noise if words else None),
        ptr(None if words else noise), sun.data_ptr(),
        shading.sphere_trig(dev).data_ptr() if words else None,
        origin.data_ptr(), direction.data_ptr(), act.data_ptr(), n, m - n, bounce,
        MODES.index(mode), stream,
    )
    check_launch("rt_leg_batch", err)
    leg_batch.launches += 1
    return origin, direction, act


leg_batch.launches = 0


# ---------------------------------------------------------------------------
# S2: the G-buffers from the raw hits of the 1 + bounces batches
# ---------------------------------------------------------------------------


def shade_staged_plain(mode: str, records: list, directions: list, sun, cam, shape,
                       volume=None) -> dict:
    """S2's plain PyTorch version (see ``shade_staged``)."""
    n = shape[0] * shape[1]
    primary = _hits(mode, records[0], volume)
    pairs = []
    for k, (rec, d) in enumerate(zip(records[1:], directions[1:])):
        air = _air(mode, rec)
        dif = {"air": air[n:]}
        if k == 0 and len(records) == 3:
            half = Record(*(t[n:] for t in rec))
            dif["albedo"] = albedo_of(_packed(mode, half, air[n:], volume))
        pairs.append(({"air": air[:n]}, dif, d[n:]))
    gb = gbuffers_from_hits(primary, pairs, directions[0], sun, cam)
    return {k: v.reshape(*shape, *v.shape[1:]) for k, v in gb.items()}


def shade_staged(mode: str, records: list, directions: list, sun, cam, shape,
                 volume=None) -> dict:
    """The G-buffers of the staged frame (``trace_jax.py:330-389``) from the
    raw hits of its 1 + ``bounces`` batches.

    ``records``: the primary batch's ``Record`` (N = ``shape[0] *
    shape[1]`` rays) and each bounce's pair batch (2N); ``directions``
    their (N, 3) and (2N, 3) f32 directions (the primary rays', then
    ``leg_batch``'s: a pair's diffuse half is the bounce direction);
    ``sun`` (8,) f32 the frame's sun and sunlight; ``cam`` (3,) f32 the
    camera origin (the depth is its float64 distance to the nudged primary
    hit); ``volume`` the fused (256^3,) int32 volume in the VOLUME mode
    (None in the others: they read no voxel).
    Returns lighting, albedo, emission and fog (rows, W, 3) f32, depth
    (rows, W) uint16 and normal (rows, W) uint8 for the (rows, W)
    ``shape``.

    CPU tensors take ``shade_staged_plain``; CUDA tensors launch S2
    (``csrc/staged.cu``) on the current stream, and
    ``shade_staged.launches`` counts those launches.  Any other device
    raises.
    """
    if mode not in MODES:
        raise ValueError(f"shade_staged: mode {mode!r} is not one of {MODES}")
    dev = records[0].pos.device
    if dev.type == "cpu":
        return shade_staged_plain(mode, records, directions, sun, cam, shape, volume)
    if dev.type != "cuda":
        raise RuntimeError(f"shade_staged: no kernel for device {dev}")
    from .._build import check_launch, check_tensor, kernels

    bounces = len(records) - 1
    if bounces not in (0, 1, 2) or len(directions) != len(records):
        raise ValueError(f"shade_staged: {len(records)} records, {len(directions)} "
                         "direction batches")
    n = shape[0] * shape[1]
    for b, (rec, d) in enumerate(zip(records, directions)):
        m = n if b == 0 else 2 * n
        want = [(torch.float32, (m, 3)), (torch.int32, (m,)), *_flags(mode, m)]
        for t, (dtype, shp) in zip((*rec, d), want + [(torch.float32, (m, 3))]):
            check_tensor(f"shade_staged: batch {b}", t, dtype, shp, dev)
    check_tensor("shade_staged: sun", sun, torch.float32, (8,), dev)
    check_tensor("shade_staged: cam", cam, torch.float32, (3,), dev)
    vol = mode == VOLUME
    if vol:
        check_tensor("shade_staged: volume", volume, torch.int32, (_N ** 3,), dev)
    at = lambda seq, b: seq[b] if b < len(seq) else None
    ptr = lambda t: None if t is None else t.data_ptr()
    pair1, pair2 = at(records, 1), at(records, 2)
    out = gbuffers_like(shape, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels().rt_shade_staged(
        *(t.data_ptr() for t in records[0]), directions[0].data_ptr(),
        ptr(pair1 and pair1.pos), ptr(pair1 and pair1.air), ptr(pair1 and pair1.mat),
        ptr(at(directions, 1)), ptr(pair2 and pair2.air), ptr(at(directions, 2)),
        sun.data_ptr(), cam.data_ptr(), volume.data_ptr() if vol else None,
        *(out[k].data_ptr() for k in GBUFFER_KEYS), n, bounces, MODES.index(mode), stream,
    )
    check_launch("rt_shade_staged", err)
    shade_staged.launches += 1
    return out


shade_staged.launches = 0


# ---------------------------------------------------------------------------
# The two compositions
# ---------------------------------------------------------------------------


def stage_gbuffers(trace, mode: str, front: dict, noise, cam, bounces: int, shape,
                   volume=None) -> dict:
    """The staged frame from its front: the primary batch, ``bounces``
    pair batches each built by ``leg_batch`` (P1) from the last leg's hits,
    then ``shade_staged`` (S2).

    ``trace(origin (M, 3), direction (M, 3), active (M,) bool or None)``
    returns the batch's ``Record`` in ``mode``; ``front`` is
    ``rays.frame_rays``'s dict (origin, direction, sun), ``noise`` its
    ``nw`` (HF, DDA) or ``inv`` (VOLUME); ``cam`` (3,) the camera origin;
    ``shape`` (rows, W).  On the card: R1 (the caller's), the tracer
    1 + ``bounces`` times, P1 ``bounces`` times and S2 once.
    """
    records = [trace(front["origin"], front["direction"], None)]
    directions = [front["direction"]]
    active = None
    for bounce in range(bounces):
        origin, direction, active = leg_batch(mode, records[-1], noise, front["sun"],
                                              bounce, active)
        records.append(trace(origin, direction, active))
        directions.append(direction)
    return shade_staged(mode, records, directions, front["sun"], cam, shape, volume)


def integrate_gbuffers(trace, blue_noise: torch.Tensor, uniforms: dict,
                       width: int, height: int, row0: int = 0,
                       rows: int | None = None, bounces: int = 2) -> dict:
    """The full lighting pass producing the six G-buffers, of the whole
    frame or of its image rows ``row0 .. row0 + rows`` (a band of the tile
    split; ``trace_jax.py:268-297``), in plain PyTorch around ``trace(origin,
    direction, active=None)``, which returns the hit dict of ``hit_result``.

    ``uniforms`` holds tensors origin, forward, up, right (3,) f32,
    sun_angle () f32, seed () int32 and lr (3,) f32.  ``bounces``: 0 =
    primary rays only (sky lighting), 1 = sun + one diffuse bounce, 2 = the
    full path.  Returns lighting, albedo, emission and fog (rows, W, 3) f32,
    depth (rows, W) uint16 and normal (rows, W) uint8.

    A band's G-buffers equal the same rows of the whole frame's bit for bit
    on CUDA tensors.  On CPU tensors they do when ``width * rows`` and
    ``width * height`` are multiples of 32: PyTorch's CPU ``pow`` and
    ``sin`` can give another last bit in the scalar tail of a vectorized
    loop than in its body, so otherwise a band's lighting and fog may differ
    by up to 4 units in the last place; depth, normal, albedo and emission
    stay equal.  The fused, volume_fast and staged passes share this.
    """
    origin, ray_dir = camera_rays(uniforms, width, height, row0, rows)
    sun = shading.sun_vector(uniforms["sun_angle"])
    noise = frame_noise(blue_noise, uniforms["seed"], width, height, row0, rows)
    primary = trace(origin, ray_dir)
    n = origin.shape[0]
    src, active, pairs = primary, None, []
    for bounce in range(bounces):
        nr, ng = noise[bounce][..., 0], noise[bounce][..., 1]
        act = ~src["air"] if active is None else active[n:] & ~src["air"]
        o, d, active = pair_batch(src["position"], src["normal"], jittered_sun(nr, ng, sun),
                                  shading.sphere_point(nr, ng), act)
        r = trace(o, d, active)
        half = lambda lo, hi: {k: (v[lo:hi] if v.dim() else v) for k, v in r.items()}
        pairs.append((half(0, n), half(n, 2 * n), d[n:]))
        src = pairs[-1][1]
    return gbuffers_from_hits(primary, pairs, ray_dir, sun, uniforms["origin"])
