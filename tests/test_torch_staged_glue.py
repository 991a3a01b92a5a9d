"""The glue of the staged frame programs: P1 (``integrate.leg_batch``) and S2
(``integrate.shade_staged``), whose plain versions the CPU runs.

- The staged frame (``integrate.stage_gbuffers``: R1's hf or volume form,
  the tracer's raw hits, P1, S2) hands its tracer the same batches, bit
  for bit, as ``integrate_gbuffers`` does with the hit-dict tracer
  (``trace_rays_hf`` / ``trace_rays_vol``), and ends in the same
  G-buffers, in both modes at b1 and b2, for a whole frame and a band.
- On seeded random raw records (air, exhausted rays, ``packed == 0`` hits,
  NaN positions, every normal id) the same: the staged frame against
  ``integrate_gbuffers`` over hit dicts built with ``hit_result`` by each
  mode's rules, at b0, b1 and b2.
- R1's hf form: ``iscal`` is K4's ``march_iscal``, and the rest the fused
  form's.
- ``render_gbuffers_hf`` and ``render_gbuffers_vol`` on a band against
  JAX's with their Pallas kernels in interpret mode, with the tolerances of
  ``tests/test_torch_trace_hf.py`` and ``tests/test_torch_trace_vol.py``
  (the whole frames at b0/b1/b2 are those files' tests).
- Each wrapper refuses a tensor on a device with no kernel.

Torch runs on two threads, as in the other port tests under the suite's
workers.  Frames are 32² (bands of 16 rows): pixel counts that are
multiples of 32, so PyTorch's CPU ``sin``/``pow`` take their vectorized
loops alike on both sides (``integrate.integrate_gbuffers``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytrace_tpu.materials import PACKED_MATERIALS
from raytrace_tpu.ops import trace_jax
from raytrace_tpu.ops import trace_pallas as jax_hf
from raytrace_tpu.ops import trace_vol_pallas as jax_vol
from raytrace_tpu.render.camera import Camera
from raytrace_tpu.utils.blue_noise import get_blue_noise_f32
from raytrace_tpu.world.chunk import minefield_from_solid
from raytrace_tpu_torch import convert
from raytrace_tpu_torch.ops import integrate, rays, trace_hf, trace_vol
from raytrace_tpu_torch.ops.integrate import HF, VOLUME, Record
from raytrace_tpu_torch.ops.lighting import EXHAUSTED_DEPTH

torch.set_num_threads(2)

MIN_MATCH = 0.995  # tests/test_torch_trace_vol.py's share for the volume tracer
HF_STEPS, VOL_STEPS = 2048, 4096
HF_VIEW = dict(origin=(-30.0, -100.0, 60.0), pitch=-0.3)
VOL_VIEW = dict(origin=(0.0, -80.0, 40.0), pitch=-0.4)
BAND = (8, 16)


def _as_np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _uniforms(origin, pitch, sun=0.6, seed=7):
    cam = Camera(origin=list(origin))
    cam.pitch = pitch
    fwd, up, right = cam.scaled_basis()
    return dict(
        origin=jnp.asarray(cam.origin, jnp.float32), forward=jnp.asarray(fwd, jnp.float32),
        up=jnp.asarray(up, jnp.float32), right=jnp.asarray(right, jnp.float32),
        sun_angle=jnp.float32(sun), seed=jnp.int32(seed), lr=jnp.zeros(3, jnp.float32))


@pytest.fixture(scope="module")
def blue():
    bn = get_blue_noise_f32()
    return bn, convert.blue_noise_from_jax(bn, "cpu")


@pytest.fixture(scope="module")
def hf_world():
    """The JAX region tables at lr = 0 and the port's copy of them."""
    jt = jax_hf.build_hf_tables(jnp.zeros(3, jnp.int32), seed=0)
    return jt, convert.tables_from_jax(_as_np(jt), "cpu")


@pytest.fixture(scope="module")
def vol_world():
    """Slab + floating box + cave tunnel (tests/test_path_vol.py:38-47)."""
    solid = np.zeros((256, 256, 256), bool)
    solid[:100] = True
    solid[140:150, 120:140, 120:140] = True
    solid[90:100, 128:132, 128:132] = False
    mats = np.where(solid, np.uint32(PACKED_MATERIALS[5]), np.uint32(0))
    fused = trace_jax.fuse_volume(jnp.asarray(mats), minefield_from_solid(jnp.asarray(solid)))
    tables = jax_vol.build_vol_tables(fused)
    return fused, tables, (convert.volume_from_jax(fused, "cpu"),
                           convert.vol_tables_from_jax(_as_np(tables), "cpu"))


def _bits(t):
    t = t.reshape(-1) if t.dim() <= 1 else t.reshape(-1, t.shape[-1])
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.to(torch.int32) if t.dtype == torch.uint16 else t


def _assert_bits_equal(got, want, what=""):
    assert got.dtype == want.dtype, what
    assert torch.equal(_bits(got), _bits(want)), what


class _Case:
    """One mode's world, uniforms and tracers: ``hit`` the hit-dict tracer
    ``integrate_gbuffers`` takes, ``raw`` the raw one ``stage_gbuffers``
    takes, and the front R1 gives the staged frame."""

    def __init__(self, mode, blue, hf_world, vol_world, w=32, h=32, band=None):
        self.mode, self.w, self.h = mode, w, h
        self.row0, self.rows = band or (0, h)
        self.bn = blue[1]
        view = HF_VIEW if mode == HF else VOL_VIEW
        self.u = convert.uniforms_from_jax(_as_np(_uniforms(**view)), "cpu")
        lr = self.u["lr"]
        if mode == HF:
            tables = hf_world[1]
            self.volume = None

            def hit(o, d, active=None):
                caps = () if active is None else trace_hf.COMPACT_CAPS
                return trace_hf.trace_rays_hf(tables, o, d, lr, HF_STEPS, 0, caps=caps,
                                              active=active)

            self.front = rays.frame_rays(self.u, self.bn, w, h, self.row0, self.rows,
                                         tables=tables, form="hf")
            self.noise = self.front["nw"]

            def raw(o, d, active):
                caps = () if active is None else trace_hf.COMPACT_CAPS
                return Record(*trace_hf.march_rays_hf(
                    o, d, active, self.front["iscal"], tables,
                    trace_hf.hf_budget(HF_STEPS, caps), 0))
        else:
            self.volume, tables = vol_world[2]

            def hit(o, d, active=None):
                return trace_vol.trace_rays_vol(tables, self.volume, o, d, lr, VOL_STEPS,
                                                active=active)

            self.front = rays.frame_rays(self.u, self.bn, w, h, self.row0, self.rows,
                                         tables=tables, form="volume")
            self.noise = self.front["inv"]
            rounds = trace_vol.rays_vol_rounds(VOL_STEPS)

            def raw(o, d, active):
                return Record(*trace_vol.march_rays_vol(o, d, active, self.front["iscal"],
                                                        tables, rounds))
        self.hit, self.raw = hit, raw

    def integrated(self, bounces, trace=None):
        """``integrate_gbuffers`` over ``trace`` (the hit tracer), recording
        each batch it hands the tracer, flat -> (G-buffers, batches)."""
        trace = trace or self.hit
        batches = []

        def recorded(o, d, active=None):
            batches.append((o.reshape(-1, 3), d.reshape(-1, 3),
                            None if active is None else active.reshape(-1)))
            return trace(o, d, active)

        gb = integrate.integrate_gbuffers(recorded, self.bn, self.u, self.w, self.h,
                                          self.row0, self.rows, bounces)
        return gb, batches

    def staged(self, bounces, raw=None):
        """``stage_gbuffers`` over ``raw``, recording each batch ->
        (G-buffers, batches)."""
        raw = raw or self.raw
        batches = []

        def recorded(o, d, active):
            batches.append((o, d, active))
            return raw(o, d, active)

        gb = integrate.stage_gbuffers(recorded, self.mode, self.front, self.noise,
                                      self.u["origin"], bounces, (self.rows, self.w),
                                      self.volume)
        return gb, batches


def _assert_same_frame(got, want):
    (gb_s, batches_s), (gb_i, batches_i) = got, want
    assert len(batches_s) == len(batches_i)
    for b, (s, i) in enumerate(zip(batches_s, batches_i)):
        for name, x, y in zip(("origin", "direction"), s, i):
            _assert_bits_equal(x, y, f"batch {b} {name}")
        if b == 0:
            assert s[2] is None and i[2] is None
        else:
            assert s[2].dtype == torch.bool and torch.equal(s[2], i[2]), f"batch {b} active"
    assert set(gb_s) == set(gb_i)
    for k in gb_i:
        assert gb_s[k].shape == gb_i[k].shape, k
        _assert_bits_equal(gb_s[k], gb_i[k], k)


@pytest.mark.parametrize("band", [None, BAND], ids=["whole", "band"])
@pytest.mark.parametrize("bounces", [1, 2])
@pytest.mark.parametrize("mode", [HF, VOLUME])
def test_staged_frame_equals_integrate(blue, hf_world, vol_world, mode, bounces, band):
    """P1's batches and S2's G-buffers on the tracer's own records equal
    ``integrate_gbuffers``'s bit for bit."""
    case = _Case(mode, blue, hf_world, vol_world, band=band)
    got = case.staged(bounces)
    want = case.integrated(bounces)
    _assert_same_frame(got, want)
    depth = got[0]["depth"].to(torch.int32)
    assert (depth == 0xFFFF).any() and (depth != 0xFFFF).any()


# --- Random raw records -------------------------------------------------------


def _random_record(mode, m, seed):
    """``m`` seeded random raw hits of ``mode``: positions over the region
    (some NaN, some on texel faces), normal ids 0-7, air, and packed words
    (a quarter 0) or done flags."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-140.0, 140.0, (m, 3)).astype(np.float32)
    face = rng.random(m) < 0.1
    pos[face] = np.floor(pos[face])
    pos[rng.random(m) < 0.05] = np.nan
    normal = rng.integers(0, 8, m).astype(np.int32)
    air = rng.random(m) < 0.3
    if mode == HF:
        packed = rng.integers(-2 ** 31, 2 ** 31, m, dtype=np.int64).astype(np.int32)
        packed[rng.random(m) < 0.25] = 0
        return Record(*map(torch.from_numpy, (pos, normal, air.astype(np.int32), packed)))
    done = air | (rng.random(m) < 0.8)
    done[rng.random(m) < 0.03] = False  # air and not done: the mode's rules still hold
    return Record(*map(torch.from_numpy, (pos, normal, air, done)))


def _hit_dict(mode, origin, rec, volume):
    """The JAX hit dict of a raw record through ``hit_result`` by the
    mode's rules (``trace_pallas.py:682-706``, ``trace_vol_pallas.py:
    1140-1200``)."""
    shape = origin.shape[:-1]
    pos = rec.pos.reshape(origin.shape)
    normal, air, mat = (t.reshape(shape) for t in rec[1:])
    if mode == HF:
        air = air != 0
        return integrate.hit_result(origin, pos, normal, air, mat, ~air & (mat == 0))
    hit = mat & ~air
    return integrate.hit_result(origin, pos, normal, air,
                                integrate.volume_packed(volume, pos, hit), ~mat, nudge=hit)


@pytest.mark.parametrize("bounces", [0, 1, 2])
@pytest.mark.parametrize("mode", [HF, VOLUME])
def test_random_records(blue, hf_world, vol_world, mode, bounces):
    """P1 and S2 on random raw records equal ``hit_result`` and
    ``integrate_gbuffers``' arithmetic, bit for bit, every batch and
    G-buffer."""
    case = _Case(mode, blue, hf_world, vol_world)
    n = case.w * case.h
    records = [_random_record(mode, n if b == 0 else 2 * n, 40 + b) for b in range(3)]
    calls = {"raw": 0, "hit": 0}

    def raw(o, d, active):
        calls["raw"] += 1
        return records[calls["raw"] - 1]

    def hit(o, d, active=None):
        calls["hit"] += 1
        return _hit_dict(mode, o, records[calls["hit"] - 1], case.volume)

    got = case.staged(bounces, raw)
    want = case.integrated(bounces, hit)
    _assert_same_frame(got, want)
    gb = got[0]
    depth = gb["depth"].to(torch.int32)
    assert (depth == EXHAUSTED_DEPTH).any() and (depth == 0xFFFF).any()
    assert torch.isnan(records[0].pos).any()


def test_leg_batch_reads_the_diffuse_half(blue, hf_world, vol_world):
    """P1 from a pair batch takes its rays N .. 2N and the earlier flags of
    the same rays: each half of the batch it returns holds the same origins
    and flags, the sun directions first."""
    case = _Case(HF, blue, hf_world, vol_world)
    n = case.w * case.h
    rec = _random_record(HF, 2 * n, 7)
    prev = torch.from_numpy(np.random.default_rng(8).random(2 * n) < 0.5)
    prev[n:] = prev[:n]
    o, d, a = integrate.leg_batch(HF, rec, case.noise, case.front["sun"], 1, prev)
    assert o.shape == (2 * n, 3) and d.shape == (2 * n, 3) and a.shape == (2 * n,)
    _assert_bits_equal(o[:n], o[n:])
    assert torch.equal(a[:n], a[n:])
    assert torch.equal(a[:n], prev[n:] & (rec.air[n:] == 0))
    want_o = integrate.nudged(rec.pos[n:], rec.normal[n:])
    _assert_bits_equal(o[:n], want_o)


# --- R1's hf form -------------------------------------------------------------


@pytest.mark.parametrize("band", [None, BAND], ids=["whole", "band"])
def test_frame_rays_hf_form(blue, hf_world, band):
    """R1's hf form: K4's scalars (``march_iscal``) and the fused form's
    rays, noise word and sun."""
    tables = hf_world[1]
    u = convert.uniforms_from_jax(_as_np(_uniforms(**HF_VIEW)), "cpu")
    row0, rows = band or (0, 32)
    hf = rays.frame_rays(u, blue[1], 32, 32, row0, rows, tables=tables, form="hf")
    fused = rays.frame_rays(u, blue[1], 32, 32, row0, rows, tables=tables, form="fused")
    assert set(hf) == {"origin", "direction", "sun", "nw", "iscal"}
    for k in ("origin", "direction", "sun", "nw"):
        _assert_bits_equal(hf[k], fused[k], k)
    assert torch.equal(hf["iscal"], trace_hf.march_iscal(tables, u["lr"]))


# --- The staged frames against JAX, on a band ---------------------------------


def test_render_gbuffers_hf_band_matches_jax(blue, hf_world):
    """A 16-row band of the hf frame at b2 against JAX's, with
    ``tests/test_torch_trace_hf.py``'s tolerances."""
    jt, pt = hf_world
    u = _uniforms(**HF_VIEW)
    want = _as_np(jax_hf.render_gbuffers_hf(jt, jnp.asarray(blue[0]), u, 32, 32,
                                            max_steps=HF_STEPS, seed=0, row0=BAND[0],
                                            rows=BAND[1], interpret=True, bounces=2))
    got = trace_hf.render_gbuffers_hf(pt, blue[1], convert.uniforms_from_jax(_as_np(u), "cpu"),
                                      32, 32, HF_STEPS, 0, *BAND, bounces=2)
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["normal"], want["normal"])
    np.testing.assert_array_equal(got["albedo"], want["albedo"])
    d = np.abs(got["depth"].astype(np.int64) - want["depth"].astype(np.int64))
    assert d.max() <= 1  # one quantum, 1/32 voxel
    np.testing.assert_allclose(got["lighting"], want["lighting"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["fog"], want["fog"], atol=1e-6)
    assert got["depth"].dtype == np.uint16 and got["normal"].dtype == np.uint8
    assert int((got["depth"] == EXHAUSTED_DEPTH).sum()) == 0
    np.testing.assert_array_equal(got["emission"], 0.0)


def test_render_gbuffers_vol_band_matches_jax(blue, vol_world):
    """A 16-row band of the staged volume frame at b2 against JAX's, with
    ``tests/test_torch_trace_vol.py``'s tolerances."""
    jfused, jtables, (vol, tables) = vol_world
    u = _uniforms(**VOL_VIEW)
    want = _as_np(jax_vol.render_gbuffers_vol(jfused, jtables, jnp.asarray(blue[0]), u, 32,
                                              32, VOL_STEPS, row0=BAND[0], rows=BAND[1],
                                              bounces=2, interpret=True, cascade=False))
    got = trace_vol.render_gbuffers_vol(vol, tables, blue[1],
                                        convert.uniforms_from_jax(_as_np(u), "cpu"), 32, 32,
                                        VOL_STEPS, *BAND, bounces=2, escape=True)
    got = {k: v.numpy() for k, v in got.items()}
    normal_ok = got["normal"] == want["normal"]
    albedo_ok = (got["albedo"] == want["albedo"]).all(-1)
    light_ok = np.isclose(got["lighting"], want["lighting"], atol=1e-5, rtol=1e-5).all(-1)
    assert normal_ok.mean() >= MIN_MATCH and albedo_ok.mean() >= MIN_MATCH
    assert light_ok.mean() >= MIN_MATCH
    d = np.abs(got["depth"].astype(np.int64) - want["depth"].astype(np.int64))
    assert d[normal_ok].max() <= 1
    np.testing.assert_allclose(got["fog"], want["fog"], atol=1e-6)
    assert int((got["depth"] == EXHAUSTED_DEPTH).sum()) == 0


# --- The wrappers refuse a device with no kernel ------------------------------


def test_wrappers_raise_off_cpu_without_kernel():
    """A tensor on a device with no kernel is refused, never run plain."""
    meta = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device="meta")
    n = 16
    i32, b8 = torch.int32, torch.bool
    hf_rec = Record(meta(n, 3), meta(n, dt=i32), meta(n, dt=i32), meta(n, dt=i32))
    vol_rec = Record(meta(n, 3), meta(n, dt=i32), meta(n, dt=b8), meta(n, dt=b8))
    with pytest.raises(RuntimeError, match="no kernel"):
        integrate.leg_batch(HF, hf_rec, meta(n, dt=i32), meta(8), 0)
    with pytest.raises(RuntimeError, match="no kernel"):
        integrate.leg_batch(VOLUME, vol_rec, meta(n, 12), meta(8), 0)
    with pytest.raises(RuntimeError, match="no kernel"):
        integrate.shade_staged(HF, [hf_rec], [meta(n, 3)], meta(8), meta(3), (4, 4))
    with pytest.raises(RuntimeError, match="no kernel"):
        integrate.shade_staged(VOLUME, [vol_rec], [meta(n, 3)], meta(8), meta(3), (4, 4),
                               meta(256 ** 3, dt=i32))
    with pytest.raises(RuntimeError, match="no kernel"):
        trace_hf.march_rays_hf(meta(n, 3), meta(n, 3), None, meta(8, dt=i32), {}, 8, 0)
    with pytest.raises(RuntimeError, match="no kernel"):
        trace_vol.march_rays_vol(meta(n, 3), meta(n, 3), None, meta(10, dt=i32), {}, 1)
    with pytest.raises(ValueError, match="mode"):
        integrate.leg_batch("fused", hf_rec, meta(n, dt=i32), meta(8), 0)
