"""The exact DDA's frame on the CPU: D1's plain version
(``trace_dda.march_rays_dda_plain``), the DDA mode of P1 and S2
(``integrate.leg_batch_plain``, ``integrate.shade_staged_plain``), R1's dda
form (``rays.frame_rays_plain``) and the frame program of
``tracer="volume"``, against the JAX package.

- The march with ``record_hits``: every output bit for bit against JAX's
  ``trace_jax.trace_rays`` run op by op (``jax.disable_jit()``, its
  ``_normalize`` swapped for the port's ``1 / sqrt`` form, as
  ``tests/test_torch_trace_dda.py`` does and explains), ``steps`` too, at
  ``max_steps`` 2048 and 8; an ``active`` mask leaves the active rays'
  results as they were and gives inactive rays born done.
- The staged frame (``trace_dda.render_gbuffers``: R1, the march, P1, S2)
  against JAX's ``trace_jax.render_gbuffers`` op by op at b0, b1 and b2, and
  at ``max_steps`` 8, where primaries are exhausted and their bounce rays
  leave from the nudged position: normal, albedo, depth and emission bit
  for bit, lighting and fog within 1e-6 (the two frameworks' CPU ``pow``,
  ``sin`` and ``cos``); against ``integrate_gbuffers`` over the same
  march's hit dicts bit for bit, batches and G-buffers, and over
  ``trace_rays`` (every ray traced, as in JAX) G-buffers; on seeded random
  raw records, against ``integrate_gbuffers`` over hit dicts built by the
  DDA rules.
- A volume whose solid voxels partly hold material bits 0: the DDA mode
  reports them hit (not exhausted, albedo 0), as JAX does; the HF mode's
  rule would call them exhausted.
- A band of rows against the same rows of the whole frame, the frame
  program of ``tracer="volume"`` against ``render_frame_packed``, and the
  default tracer of ``render_frame_packed`` and the tile split (the exact
  DDA, as JAX's).
- Each wrapper refuses a tensor on a device with no kernel.

Frames are 32² (bands of 16 rows; at most 2,048 rays a batch) and torch
runs on two threads, as in the other port tests under the suite's
workers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytrace_tpu.materials import PACKED_MATERIALS
from raytrace_tpu.ops import trace_jax
from raytrace_tpu.render.camera import Camera
from raytrace_tpu.utils.blue_noise import get_blue_noise_f32
from raytrace_tpu.world.chunk import minefield_from_solid
from raytrace_tpu_torch import convert
from raytrace_tpu_torch.ops import integrate, rays, trace_dda
from raytrace_tpu_torch.ops.integrate import DDA, EXHAUSTED, HF, Record
from raytrace_tpu_torch.ops.lighting import EXHAUSTED_DEPTH
from raytrace_tpu_torch.parallel import tiles
from raytrace_tpu_torch.render import frame_graph, pipeline

SIZE = 32
BAND = (8, 16)
VIEW = dict(origin=(-30.0, -100.0, 60.0), pitch=-0.3)  # the generated world's view
BOX_VIEW = dict(origin=(0.0, -80.0, 40.0), pitch=-0.4)  # the material-0 volume's view


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _as_np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _uniforms(origin, pitch, sun=0.6, seed=5):
    cam = Camera(origin=list(origin))
    cam.pitch = pitch
    fwd, up, right = cam.scaled_basis()
    return dict(
        origin=jnp.asarray(cam.origin, jnp.float32), forward=jnp.asarray(fwd, jnp.float32),
        up=jnp.asarray(up, jnp.float32), right=jnp.asarray(right, jnp.float32),
        sun_angle=jnp.float32(sun), seed=jnp.int32(seed), lr=jnp.zeros(3, jnp.float32))


def _sqrt_normalize(v):
    """The port's normalization (ops/rays.normalize), in jnp."""
    n2 = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return v * (1.0 / jnp.sqrt(jnp.maximum(n2, 1e-20)))[..., None]


@pytest.fixture(scope="module")
def blue():
    bn = get_blue_noise_f32()
    return bn, convert.blue_noise_from_jax(bn, "cpu")


@pytest.fixture(scope="module")
def world(full_world_volume):
    """The generated region around the origin: (JAX fused volume, port volume)."""
    mats, mf = full_world_volume
    fused = trace_jax.fuse_volume(jnp.asarray(mats), jnp.asarray(mf))
    return fused, convert.volume_from_jax(fused, "cpu")


@pytest.fixture(scope="module")
def zero_world():
    """A slab, a floating box and a tunnel (tests/test_path_vol.py:38-47),
    whose solid voxels hold material bits 0 where texel x < 128 (world x <
    0): (JAX fused volume, port volume)."""
    solid = np.zeros((256, 256, 256), bool)
    solid[:100] = True
    solid[140:150, 120:140, 120:140] = True
    solid[90:100, 128:132, 128:132] = False
    mats = np.where(solid, np.uint32(PACKED_MATERIALS[5]), np.uint32(0))
    mats[:, :, :128] = 0
    fused = trace_jax.fuse_volume(jnp.asarray(mats), minefield_from_solid(jnp.asarray(solid)))
    return fused, convert.volume_from_jax(fused, "cpu")


@pytest.fixture(scope="module")
def rays_np():
    """32² camera rays of the generated world's view, plus 64 rays from
    inside the terrain and upward: numpy (origin, direction), (N, 3)."""
    u = convert.uniforms_from_jax(_as_np(_uniforms(**VIEW)), "cpu")
    o, d = rays.camera_rays(u, SIZE, SIZE)
    rng = np.random.default_rng(11)
    extra_o = rng.uniform([-60, -60, -5], [60, 60, 30], (64, 3)).astype(np.float32)
    extra_d = rng.standard_normal((64, 3)).astype(np.float32)
    return (np.concatenate([o.reshape(-1, 3).numpy(), extra_o]),
            np.concatenate([d.reshape(-1, 3).numpy(), extra_d]))


def _jax_op_by_op(monkeypatch, fn, *args, **kwargs):
    monkeypatch.setattr(trace_jax, "_normalize", _sqrt_normalize)
    with jax.disable_jit():
        return _as_np(fn(*args, **kwargs))


# --- The march ----------------------------------------------------------------


@pytest.mark.parametrize("max_steps", [2048, 8])
def test_plain_march_equals_jax_op_by_op(world, rays_np, monkeypatch, max_steps):
    """``march_rays_dda_plain`` + ``record_hits`` against JAX's
    ``trace_rays``, every output and ``steps`` bit for bit."""
    fused, vol = world
    o, d = rays_np
    want = _jax_op_by_op(monkeypatch, trace_jax.trace_rays, fused, jnp.asarray(o),
                         jnp.asarray(d), jnp.zeros(3, jnp.float32), max_steps)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    record, steps = trace_dda.march_rays_dda_plain(vol, ot, dt, None, torch.zeros(3),
                                                   max_steps)
    got = {k: v.numpy() for k, v in integrate.record_hits(DDA, ot, record).items()}
    got["steps"] = steps.numpy()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], key)
    assert record.air.dtype == torch.bool and record.mat.dtype == torch.int32
    exhausted = (record.mat & EXHAUSTED) != 0
    assert torch.equal(exhausted, torch.from_numpy(np.array(want["exhausted"])))
    if max_steps == 8:
        assert int(steps) == 8 and exhausted.any()
        assert torch.equal(record.mat[exhausted], torch.full_like(record.mat[exhausted],
                                                                  EXHAUSTED))
    else:
        assert 8 < int(steps) < max_steps and not exhausted.any()


def test_active_mask_leaves_the_active_rays_and_bears_the_rest_done(world, rays_np):
    """Rays masked off are born done at their origin (normal 0, not air,
    ``mat`` 0) and count for no move; the others' outputs are those of the
    unmasked batch, and ``steps`` is theirs alone."""
    _, vol = world
    o, d = (torch.from_numpy(a) for a in rays_np)
    n = o.shape[0]
    active = torch.from_numpy(np.random.default_rng(3).random(n) < 0.5)
    lr = torch.zeros(3)
    every, _ = trace_dda.march_rays_dda(vol, o, d, None, lr)
    got, steps = trace_dda.march_rays_dda(vol, o, d, active, lr)
    _, steps_alone = trace_dda.march_rays_dda(vol, o[active], d[active], None, lr)
    for name, a, b in zip(Record._fields, got, every):
        assert torch.equal(a[active], b[active]), name
    off = ~active
    assert torch.equal(got.pos[off], o[off])
    assert not got.normal[off].any() and not got.air[off].any() and not got.mat[off].any()
    assert int(steps) == int(steps_alone)
    _, none = trace_dda.march_rays_dda(vol, o, d, torch.zeros(n, dtype=torch.bool), lr)
    assert int(none) == 0


def test_step_size_follows_torch_shifts():
    """``(1 << s) // 2`` with PyTorch's shift, the rule D1 copies: 0 below 0
    and from 32 on; 1 << 31 floor-divided; 0 for s = 0."""
    s = torch.tensor([-3, 0, 1, 2, 7, 30, 31, 32, 127], dtype=torch.int32)
    want = [0.0, 0.0, 1.0, 2.0, 64.0, 2.0 ** 29, -2.0 ** 30, 0.0, 0.0]
    assert trace_dda._step_size(s).tolist() == want


# --- The staged frame -----------------------------------------------------------


def _frames(vol_pair, blue, monkeypatch, view, bounces, max_steps=2048):
    fused, vol = vol_pair
    u = _uniforms(**view)
    want = _jax_op_by_op(monkeypatch, trace_jax.render_gbuffers, fused,
                         jnp.asarray(blue[0]), u, SIZE, SIZE, max_steps=max_steps,
                         bounces=bounces)
    got = trace_dda.render_gbuffers(vol, blue[1], convert.uniforms_from_jax(_as_np(u), "cpu"),
                                    SIZE, SIZE, max_steps, bounces=bounces)
    return {k: v.numpy() for k, v in got.items()}, want


def _assert_gbuffers_match(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
    for key in ("normal", "albedo", "depth", "emission"):
        np.testing.assert_array_equal(got[key], want[key], key)
    for key in ("lighting", "fog"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0, err_msg=key)


@pytest.mark.parametrize("bounces", [0, 1, 2])
def test_render_gbuffers_match_jax_op_by_op(world, blue, monkeypatch, bounces):
    got, want = _frames(world, blue, monkeypatch, VIEW, bounces)
    _assert_gbuffers_match(got, want)
    assert int((got["depth"] == EXHAUSTED_DEPTH).sum()) == 0
    assert (got["depth"] == 0xFFFF).any() and (got["depth"] != 0xFFFF).any()


def test_exhausted_primaries_send_bounce_rays_from_the_nudged_hit(world, blue, monkeypatch):
    """At 8 steps most primaries are exhausted: pink and at the exhausted
    depth, as in JAX, and their bounce rays are active and leave from the
    position nudged off the last face crossed."""
    got, want = _frames(world, blue, monkeypatch, VIEW, 2, max_steps=8)
    _assert_gbuffers_match(got, want)
    exhausted = got["depth"] == EXHAUSTED_DEPTH
    assert exhausted.any()
    np.testing.assert_array_equal(got["fog"][exhausted], [[1.0, 0.0, 1.0]] * int(exhausted.sum()))

    _, vol = world
    u = convert.uniforms_from_jax(_as_np(_uniforms(**VIEW)), "cpu")
    f = rays.frame_rays(u, blue[1], SIZE, SIZE, tables=None, form="dda")
    records, batches = [], []

    def trace(o, d, active):
        batches.append((o, active))
        records.append(trace_dda.march_rays_dda(vol, o, d, active, u["lr"], 8)[0])
        return records[-1]

    integrate.stage_gbuffers(trace, DDA, f, f["nw"], u["origin"], 2, (SIZE, SIZE))
    prim = records[0]
    cut = (prim.mat & EXHAUSTED) != 0
    assert torch.equal(cut, torch.from_numpy(exhausted.reshape(-1)))
    origin, active = batches[1]
    n = SIZE * SIZE
    nudged = integrate.nudged(prim.pos, prim.normal)
    for half in (slice(0, n), slice(n, 2 * n)):
        assert active[half][cut].all()
        assert torch.equal(origin[half][cut], nudged[cut])
        assert not torch.equal(origin[half][cut], prim.pos[cut])


def _recorded(trace):
    batches = []

    def recorded(o, d, active=None):
        batches.append((o.reshape(-1, 3), d.reshape(-1, 3),
                        None if active is None else active.reshape(-1)))
        return trace(o, d, active)

    return recorded, batches


def _assert_same_frame(staged, integrated):
    (gb_s, batches_s), (gb_i, batches_i) = staged, integrated
    assert len(batches_s) == len(batches_i)
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t.to(torch.int32)
    for b, (s, i) in enumerate(zip(batches_s, batches_i)):
        assert torch.equal(bits(s[0]), bits(i[0])) and torch.equal(bits(s[1]), bits(i[1])), b
        assert (s[2] is None) == (i[2] is None) and (s[2] is None or torch.equal(s[2], i[2]))
    for k in gb_i:
        assert gb_s[k].dtype == gb_i[k].dtype and torch.equal(bits(gb_s[k]), bits(gb_i[k])), k


def _staged(vol, blue, u, bounces, raw, band=None):
    row0, rows = band or (0, SIZE)
    f = rays.frame_rays(u, blue[1], SIZE, SIZE, row0, rows, tables=None, form="dda")
    recorded, batches = _recorded(raw)
    gb = integrate.stage_gbuffers(recorded, DDA, f, f["nw"], u["origin"], bounces,
                                  (rows, SIZE))
    return gb, batches


def _integrated(blue, u, bounces, hit, band=None):
    row0, rows = band or (0, SIZE)
    recorded, batches = _recorded(hit)
    gb = integrate.integrate_gbuffers(recorded, blue[1], u, SIZE, SIZE, row0, rows, bounces)
    return gb, batches


@pytest.mark.parametrize("band", [None, BAND], ids=["whole", "band"])
@pytest.mark.parametrize("bounces", [1, 2])
def test_staged_frame_equals_integrate(world, blue, bounces, band):
    """R1's dda form, the march's raw records, P1 and S2 hand the tracer the
    same batches and end in the same G-buffers, bit for bit, as
    ``integrate_gbuffers`` over the same march's hit dicts; and the same
    G-buffers as over ``trace_rays``, which traces the inactive rays too, as
    JAX does (no G-buffer reads them)."""
    _, vol = world
    u = convert.uniforms_from_jax(_as_np(_uniforms(**VIEW)), "cpu")
    raw = lambda o, d, a: trace_dda.march_rays_dda(vol, o, d, a, u["lr"])[0]

    def hit(o, d, a=None):
        flat = integrate.flat_rays(o, d, a)
        return integrate.record_hits(DDA, o, raw(*flat))

    staged = _staged(vol, blue, u, bounces, raw, band)
    _assert_same_frame(staged, _integrated(blue, u, bounces, hit, band))
    every, _ = _integrated(blue, u, bounces,
                           lambda o, d, a=None: trace_dda.trace_rays(vol, o, d, u["lr"]), band)
    assert all(torch.equal(staged[0][k], every[k]) for k in every)


def _random_record(m, seed):
    """``m`` seeded random raw DDA hits: positions over the region (some
    NaN, some on texel faces), normal ids 0-7, air, packed words (some 0)
    and exhausted rays."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-140.0, 140.0, (m, 3)).astype(np.float32)
    face = rng.random(m) < 0.1
    pos[face] = np.floor(pos[face])
    pos[rng.random(m) < 0.05] = np.nan
    normal = rng.integers(0, 8, m).astype(np.int32)
    air = rng.random(m) < 0.3
    mat = rng.integers(0, EXHAUSTED, m).astype(np.int32)
    mat[rng.random(m) < 0.2] = 0  # hits on material bits 0
    mat[air] = 0
    mat[~air & (rng.random(m) < 0.1)] = EXHAUSTED
    return Record(*map(torch.from_numpy, (pos, normal, air, mat)))


@pytest.mark.parametrize("bounces", [0, 1, 2])
def test_random_records(world, blue, bounces):
    """P1 and S2 on random raw records equal ``hit_result`` by the DDA
    rules (every ray nudged, exhausted where not done, the albedo of the
    packed word) and ``integrate_gbuffers``' arithmetic, bit for bit."""
    _, vol = world
    u = convert.uniforms_from_jax(_as_np(_uniforms(**VIEW)), "cpu")
    n = SIZE * SIZE
    records = [_random_record(n if b == 0 else 2 * n, 60 + b) for b in range(3)]
    calls = {"raw": 0, "hit": 0}

    def raw(o, d, active):
        calls["raw"] += 1
        return records[calls["raw"] - 1]

    def hit(o, d, active=None):
        calls["hit"] += 1
        rec = records[calls["hit"] - 1]
        shape = o.shape[:-1]
        normal, air, mat = (t.reshape(shape) for t in rec[1:])
        return integrate.hit_result(o, rec.pos.reshape(o.shape), normal, air,
                                    mat & integrate.MATERIAL_MASK, (mat & EXHAUSTED) != 0)

    got = _staged(vol, blue, u, bounces, raw)
    _assert_same_frame(got, _integrated(blue, u, bounces, hit))
    depth = got[0]["depth"].to(torch.int32)
    assert (depth == EXHAUSTED_DEPTH).any() and (depth == 0xFFFF).any()


# --- Material bits 0 ------------------------------------------------------------


def test_material_zero_voxels_are_hits(zero_world, blue, monkeypatch):
    """Solid voxels with material bits 0: the march reports them hit, not
    exhausted, with albedo 0, as JAX does, and the frame shades them as
    terrain; the HF mode's rule (not air and packed 0) would call them
    exhausted."""
    got, want = _frames(zero_world, blue, monkeypatch, BOX_VIEW, 2)
    _assert_gbuffers_match(got, want)
    terrain = got["depth"] != 0xFFFF
    black = terrain & (got["albedo"] == 0.0).all(-1)
    assert black.any() and (terrain & ~black).any()
    assert int((got["depth"] == EXHAUSTED_DEPTH).sum()) == 0

    _, vol = zero_world
    u = convert.uniforms_from_jax(_as_np(_uniforms(**BOX_VIEW)), "cpu")
    f = rays.frame_rays(u, blue[1], SIZE, SIZE, tables=None, form="dda")
    record, _ = trace_dda.march_rays_dda(vol, f["origin"], f["direction"], None, u["lr"])
    hits = integrate.record_hits(DDA, f["origin"], record)
    zero = ~record.air & (record.mat == 0)
    assert torch.equal(zero, torch.from_numpy(black.reshape(-1)))
    assert not hits["exhausted"].any()
    as_hf = Record(record.pos, record.normal, record.air.to(torch.int32), record.mat)
    assert torch.equal(integrate.record_hits(HF, f["origin"], as_hf)["exhausted"], zero)


# --- Bands, the frame program and the defaults -----------------------------------


def test_band_equals_the_whole_frames_rows(world, blue):
    _, vol = world
    u = convert.uniforms_from_jax(_as_np(_uniforms(**VIEW)), "cpu")
    whole = trace_dda.render_gbuffers(vol, blue[1], u, SIZE, SIZE)
    band = trace_dda.render_gbuffers(vol, blue[1], u, SIZE, SIZE, row0=BAND[0], rows=BAND[1])
    for k, v in whole.items():
        assert torch.equal(band[k], v[BAND[0]:BAND[0] + BAND[1]]), k


def test_frame_program_equals_render_frame_and_the_default_tracer(world, blue):
    """The frame program of ``tracer="volume"`` takes the volume itself as
    its world and renders ``render_frame_packed``'s frame; that and the tile
    split default to the exact DDA, as JAX's ``render_frame`` does."""
    _, vol = world
    bn = blue[1]
    u = pipeline.FrameUniforms(origin=VIEW["origin"], sun_angle=0.6, seed=3,
                               forward=(0.0, 0.955, -0.296), up=(0.0, 0.118, 0.382))
    packed = torch.from_numpy(u.packed())
    program = frame_graph.FrameProgram(vol, bn, "volume", SIZE, SIZE)
    assert program.world is vol
    frame, gb = program.run(packed)
    want, gb_want = pipeline.render_frame_packed(vol, bn, packed, SIZE, SIZE, tracer="volume")
    assert torch.equal(frame, want)
    assert all(torch.equal(gb[k], gb_want[k]) for k in gb_want)
    default, _ = pipeline.render_frame_packed(vol, bn, packed, SIZE, SIZE)
    assert torch.equal(default, want)
    tiled = tiles.render_frame_tiled(vol, bn, pipeline.unpack_uniforms(packed), SIZE, SIZE)
    assert torch.equal(tiled, want)


def test_wrappers_raise_off_cpu_without_kernel():
    """A tensor on a device with no kernel is refused, never run plain."""
    meta = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device="meta")
    n = 16
    i32, b8 = torch.int32, torch.bool
    rec = Record(meta(n, 3), meta(n, dt=i32), meta(n, dt=b8), meta(n, dt=i32))
    with pytest.raises(RuntimeError, match="no kernel"):
        trace_dda.march_rays_dda(meta(256 ** 3, dt=i32), meta(n, 3), meta(n, 3), None, meta(3))
    with pytest.raises(RuntimeError, match="no kernel"):
        integrate.leg_batch(DDA, rec, meta(n, dt=i32), meta(8), 0)
    with pytest.raises(RuntimeError, match="no kernel"):
        integrate.shade_staged(DDA, [rec], [meta(n, 3)], meta(8), meta(3), (4, 4))
    u = {k: torch.zeros(() if k in ("sun_angle", "seed") else (3,),
                        dtype=i32 if k == "seed" else torch.float32, device="meta")
         for k in ("origin", "forward", "up", "right", "sun_angle", "seed", "lr")}
    with pytest.raises(RuntimeError, match="no kernel"):
        rays.frame_rays(u, meta(8, 8, 4), 4, 4, tables=None, form="dda")
