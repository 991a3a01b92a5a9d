"""The port's staged volume tracer (K3s's plain version) and its G-buffer
pass against the JAX package.

Both sides get the JAX package's fused volume and occupancy tables (carried
over with ``convert``).  On the CPU the port runs K3s's plain version; the
JAX side runs ``trace_rays_vol`` with its kernel in interpret mode and its
plain round loop (``cascade=False``), as ``tests/test_trace_vol.py`` runs
it.  Scenes: the weird world of that file (slab, floating box, cave
tunnel), the generated world around the origin, and the slab world after a
``world/edit.py`` box.

Tolerances follow the port's volume tests (``tests/test_torch_path_vol.py``):
air, exhaustion, normal and albedo agree on at least 99.5% of the traced
rays, and where they agree, positions are within 1e-5 of their magnitude
and distances within 1e-5 relative.  Not on every ray: XLA's CPU ``rsqrt``
differs from the correctly rounded ``1/sqrt`` the port takes in the last
bit for about one normalization in seven (ROADMAP §3), so a direction can
differ by an ulp, a ray that grazes a voxel edge can take the other face,
and a hit 1e-4 past a face at a coordinate near a voxel boundary can read
the material of the next voxel (the second voxel index of ROADMAP §3).  Inactive rays
are born done in both (hits at their origin) and are equal on every key.
G-buffers against JAX: normal and albedo equal and lighting within 1e-5 on
at least 99.5% of pixels, depth within one quantum where the normals agree,
fog within 1e-6.  Against the port's own whole-path pass: depth and normal
equal on every pixel, the radiometric buffers within rtol 1e-5, atol 1e-6
(JAX's contract, ``tests/test_path_vol.py:87-98``).  The mismatch counts
are printed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytrace_tpu.materials import PACKED_MATERIALS
from raytrace_tpu.ops import trace_vol_pallas as jax_vol
from raytrace_tpu.ops.trace_jax import camera_rays as jax_camera_rays
from raytrace_tpu.ops.trace_jax import fuse_volume
from raytrace_tpu.render.camera import Camera
from raytrace_tpu.utils.blue_noise import get_blue_noise_f32
from raytrace_tpu.world.chunk import minefield_from_solid
from raytrace_tpu.world.edit import edit_fused_volume as jax_edit
from raytrace_tpu_torch import convert
from raytrace_tpu_torch.ops import path_vol, trace_vol
from raytrace_tpu_torch.ops.lighting import EXHAUSTED_DEPTH
from raytrace_tpu_torch.world.edit import edit_fused_volume

MIN_MATCH = 0.995
LR = np.zeros(3, np.int32)
KEYS = ("position", "normal", "air", "albedo", "distance", "exhausted")


def _as_np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _scene(fused):
    """A JAX fused volume -> (JAX volume, JAX tables, port volume, port
    tables)."""
    tables = jax_vol.build_vol_tables(fused)
    return (fused, tables, convert.volume_from_jax(fused, "cpu"),
            convert.vol_tables_from_jax(_as_np(tables), "cpu"))


def _fuse(solid):
    mats = np.where(solid, np.uint32(PACKED_MATERIALS[5]), np.uint32(0))
    return fuse_volume(jnp.asarray(mats), minefield_from_solid(jnp.asarray(solid)))


@pytest.fixture(scope="module")
def weird_world():
    """Slab + floating box + cave tunnel (tests/test_trace_vol.py:29-37)."""
    solid = np.zeros((256, 256, 256), bool)
    solid[:100] = True
    solid[140:150, 120:140, 120:140] = True
    solid[90:100, 128:132, 128:132] = False
    return _scene(_fuse(solid))


@pytest.fixture(scope="module")
def generated_world(full_world_volume):
    mats, mf = full_world_volume
    return _scene(fuse_volume(jnp.asarray(mats), jnp.asarray(mf)))


@pytest.fixture(scope="module")
def edited_world():
    """The slab world with a rock box written on top of it
    (tests/test_edit.py:78-84): JAX's edit and the port's give the same
    volume."""
    solid = np.zeros((256, 256, 256), bool)
    solid[:100] = True
    fused = _fuse(solid)
    edit = ((0, 0, 0), (-10, -10, 0), (20, 20, 20), 2)
    want = jax_edit(fused, *edit)
    got = edit_fused_volume(convert.volume_from_jax(fused, "cpu"), *edit)
    assert torch.equal(got, convert.volume_from_jax(want, "cpu"))
    return _scene(want)


def _camera(origin, pitch, size):
    cam = Camera(origin=list(origin))
    cam.pitch = pitch
    fwd, up, right = cam.scaled_basis()
    u = {k: jnp.asarray(v, jnp.float32) for k, v in
         dict(origin=cam.origin, forward=fwd, up=up, right=right).items()}
    o, d = jax_camera_rays(u, size, size)
    return np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3)


def _floating_box():
    """Rays aimed at the floating box (tests/test_trace_vol.py:86-96)."""
    o = np.tile(np.array([[2.0, -60.0, 17.0]], np.float32), (16, 1))
    d = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (16, 1))
    d[:, 0] = np.linspace(-0.12, 0.12, 16)
    return o, d


def _random(n=2048, seed=23):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-110, 110, n), rng.uniform(-110, 110, n),
                  rng.uniform(-20, 120, n)], -1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


def _from_above():
    """Rays from above at and around the edited box (tests/test_edit.py:86-91)."""
    n = 12
    xs = np.linspace(-30, 30, n, dtype=np.float32)
    o = np.stack([xs, np.full(n, 0.5, np.float32), np.full(n, 90.0, np.float32)], -1)
    return o, np.tile(np.asarray([[0.05, 0.0, -1.0]], np.float32), (n, 1))


def _half(n, seed=5):
    return np.random.default_rng(seed).random(n) < 0.5


# case -> (scene, rays, keyword arguments of both tracers, active mask or None)
CASES = {
    "camera_24px": ("weird_world", lambda: _camera((0.0, -80.0, 40.0), -0.4, 24), {}, None),
    "floating_box": ("weird_world", _floating_box, {}, None),
    "random_rounds3": ("weird_world", _random, dict(rounds=3), None),
    "random_rounds3_active": ("weird_world", _random, dict(rounds=3), _half(2048)),
    "camera_24px_active": ("weird_world", lambda: _camera((0.0, -80.0, 40.0), -0.4, 24),
                           {}, _half(576)),
    "camera_24px_no_escape": ("weird_world", lambda: _camera((0.5, -60.0, 40.0), -0.3, 24),
                              dict(escape=False), None),
    "random_rounds3_no_escape": ("weird_world", _random, dict(rounds=3, escape=False), None),
    "world_camera_24px": ("generated_world", lambda: _camera((-30.0, -100.0, 60.0), -0.3, 24),
                          {}, None),
    "edited_from_above": ("edited_world", _from_above, {}, None),
}
# Tight budgets: the cut of an exhausted ray falls mid-round, mid-resolve or
# at a round's end.
CASES.update({
    f"random_r{rounds}_cap{cap}{'_active' if masked else ''}": (
        "weird_world", _random, dict(rounds=rounds, cap=cap), _half(2048) if masked else None)
    for rounds in (1, 2, 3) for cap in (2, 8) for masked in (False, True)
})


@pytest.fixture(scope="module", params=list(CASES))
def traced_pair(request):
    """One batch through both tracers: (case, traced mask, port dict, JAX dict)."""
    scene, rays, kw, active = CASES[request.param]
    jfused, jtables, vol, tables = request.getfixturevalue(scene)
    o, d = rays()
    want = jax_vol.trace_rays_vol(
        jtables, jfused, jnp.asarray(o), jnp.asarray(d), jnp.asarray(LR),
        interpret=True, cascade=False,
        active=None if active is None else jnp.asarray(active), **kw)
    got = trace_vol.trace_rays_vol(
        tables, vol, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(LR),
        active=None if active is None else torch.from_numpy(active), **kw)
    traced = np.ones(o.shape[0], bool) if active is None else active
    return (request.param, traced, {k: v.numpy() for k, v in got.items()}, _as_np(want))


def test_trace_rays_vol_matches_jax(traced_pair):
    """Air, exhaustion, normal and albedo agree on >= 99.5% of traced rays;
    where they agree, positions and distances within 1e-5 relative (an ulp
    of rsqrt, carried along the ray).  The albedo is read at floor(p + 128)
    of the hit position, so an ulp there can pick the next voxel."""
    case, traced, got, want = traced_pair
    agree = ((got["air"] == want["air"]) & (got["exhausted"] == want["exhausted"])
             & (got["normal"] == want["normal"]) & (got["albedo"] == want["albedo"]).all(-1))
    print(f"{case}: {int((~agree[traced]).sum())} of {int(traced.sum())} traced rays "
          f"disagree; {int(want['exhausted'][traced].sum())} exhausted, "
          f"{int(want['air'][traced].sum())} air")
    assert agree[traced].mean() >= MIN_MATCH
    ok = agree & traced
    # Relative to the position's magnitude: a coordinate near 0 carries the
    # rounding of the whole ray's length.
    err = np.abs(got["position"] - want["position"]).max(-1)
    scale = np.maximum(np.abs(want["position"]).max(-1), 1.0)
    assert (err[ok] <= 1e-5 * scale[ok]).all(), float((err / scale)[ok].max())
    np.testing.assert_allclose(got["distance"][ok], want["distance"][ok], rtol=1e-5, atol=1e-5)
    hits = ok & ~want["air"] & ~want["exhausted"]
    assert hits.any()
    if "rounds" in CASES[case][2]:
        assert want["exhausted"][traced].any() and got["exhausted"][traced].any()
    else:
        assert not got["exhausted"][traced].any()


@pytest.mark.parametrize("traced_pair", [k for k, v in CASES.items() if v[3] is not None],
                         indirect=True)
def test_inactive_rays_are_born_done(traced_pair):
    """Rays with active False come back as JAX returns them: hits at their
    origin (nudged along normal 0), the material there, distance 0, not
    exhausted."""
    _, traced, got, want = traced_pair
    off = ~traced
    assert off.any()
    for k in KEYS:
        np.testing.assert_array_equal(got[k][off], want[k][off], k)
    assert not got["exhausted"][off].any() and not got["air"][off].any()
    np.testing.assert_array_equal(got["distance"][off], 0.0)


def test_hits_are_nudged_and_the_rest_keep_their_resume_position():
    """Only hits move 0.001 off their face; air and exhausted rays report
    the raw position the march stopped at."""
    o, d = _random(256, seed=3)
    solid = np.zeros((256, 256, 256), bool)
    solid[:100] = True
    _, _, vol, tables = _scene(_fuse(solid))
    lr = torch.from_numpy(LR)
    res = trace_vol.trace_rays_vol_plain(tables, vol, torch.from_numpy(o), torch.from_numpy(d),
                                         lr, rounds=1)
    pos, normal, air, done, _ = trace_vol.march_rays_vol_plain(
        torch.from_numpy(o), torch.from_numpy(d), None,
        trace_vol.rays_vol_iscal(tables, lr), tables, 1)
    hit = done & ~air
    assert hit.any() and (~done).any() and air.any()
    assert torch.equal(res["position"][~hit], pos[~hit])
    assert not torch.equal(res["position"][hit], pos[hit])
    assert torch.equal(res["normal"], normal) and torch.equal(res["exhausted"], ~done)


def _uniforms(origin, pitch, sun=0.6, seed=7):
    cam = Camera(origin=list(origin))
    cam.pitch = pitch
    fwd, up, right = cam.scaled_basis()
    return dict(
        origin=jnp.asarray(cam.origin, jnp.float32), forward=jnp.asarray(fwd, jnp.float32),
        up=jnp.asarray(up, jnp.float32), right=jnp.asarray(right, jnp.float32),
        sun_angle=jnp.float32(sun), seed=jnp.int32(seed), lr=jnp.zeros(3, jnp.float32),
    )


# max_steps for the G-buffer passes: no ray exhausts on either side
# (tests/test_path_vol.py:64-69).
STEPS = 4096


@pytest.fixture(scope="module", params=[0, 1, 2], ids=["b0", "b1", "b2"])
def gbuffer_pair(request, weird_world):
    """The 32² staged G-buffers of the weird world through both packages,
    and the port's whole-path G-buffers at the same inputs."""
    jfused, jtables, vol, tables = weird_world
    bounces = request.param
    bn = get_blue_noise_f32()
    u = _uniforms((0.0, -80.0, 40.0), -0.4)
    want = jax_vol.render_gbuffers_vol(jfused, jtables, jnp.asarray(bn), u, 32, 32, STEPS,
                                       bounces=bounces, interpret=True, cascade=False)
    args = (vol, tables, convert.blue_noise_from_jax(bn, "cpu"),
            convert.uniforms_from_jax(_as_np(u), "cpu"), 32, 32, STEPS)
    got = trace_vol.render_gbuffers_vol(*args, bounces=bounces)
    path = path_vol.render_gbuffers_path(*args, bounces=bounces)
    as_np = lambda gb: {k: v.numpy() for k, v in gb.items()}
    return as_np(got), _as_np(want), as_np(path)


def test_render_gbuffers_vol_matches_jax(gbuffer_pair):
    got, want, _ = gbuffer_pair
    normal_ok = got["normal"] == want["normal"]
    albedo_ok = (got["albedo"] == want["albedo"]).all(-1)
    light_ok = np.isclose(got["lighting"], want["lighting"], atol=1e-5, rtol=1e-5).all(-1)
    print(f"normal mismatches {int((~normal_ok).sum())}, albedo {int((~albedo_ok).sum())}, "
          f"lighting {int((~light_ok).sum())} of {normal_ok.size}")
    assert normal_ok.mean() >= MIN_MATCH and albedo_ok.mean() >= MIN_MATCH
    assert light_ok.mean() >= MIN_MATCH
    d = np.abs(got["depth"].astype(np.int64) - want["depth"].astype(np.int64))
    assert d[normal_ok].max() <= 1  # one quantum, 1/32 voxel
    np.testing.assert_allclose(got["fog"], want["fog"], atol=1e-6)
    assert got["depth"].dtype == np.uint16 and got["normal"].dtype == np.uint8
    assert int((got["depth"] == EXHAUSTED_DEPTH).sum()) == 0
    assert int((want["depth"] == EXHAUSTED_DEPTH).sum()) == 0
    assert (got["depth"] == 0xFFFF).any() and (got["depth"] != 0xFFFF).any()


def test_staged_equals_whole_path(gbuffer_pair):
    """The port's staged pass (K3s leg by leg) against its whole-path pass
    (K3): the marches are memoryless in position and direction, so every
    pixel that finishes within budget is the same."""
    got, _, path = gbuffer_pair
    for k in ("depth", "normal"):
        np.testing.assert_array_equal(got[k], path[k], err_msg=k)
    for k in ("lighting", "albedo", "emission", "fog"):
        np.testing.assert_allclose(got[k], path[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_round_budget():
    assert trace_vol.rays_vol_rounds(2048) == 22
    assert trace_vol.rays_vol_rounds(4096) == 43
    assert trace_vol.rays_vol_rounds(10) == 1
    assert trace_vol.round_steps(96) == 96 and trace_vol.round_steps(3) == 4


def test_trace_raises_off_cpu_without_kernel():
    """A tensor on a device with no kernel is refused, never run plain."""
    meta = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        trace_vol.trace_rays_vol({}, meta(256 ** 3, dt=torch.int32), meta(4, 3), meta(4, 3),
                                 meta(3))
