"""The port's exact DDA tracer and its G-buffer pass against the JAX package,
on the generated world.

Both sides trace the same fused volume (carried over with
``convert.volume_from_jax``) from the same rays and uniforms.

- Exact, against JAX run op by op (``jax.disable_jit()``): every output of
  ``trace_rays`` bit for bit, and the normal, albedo and depth G-buffers;
  lighting and fog within 1e-6, because the sky shading's ``pow``, ``sqrt``,
  ``sin`` and ``cos`` are the two frameworks' own CPU routines, which
  differ in the last bit for a few per cent of pixels.  For these the JAX
  side's ``trace_jax._normalize`` is
  swapped, inside the test, for the ``v * (1 / sqrt(|v|^2))`` form the port
  uses.  XLA's CPU ``rsqrt`` is an approximation that differs from the
  correctly rounded quotient in the last bit for about one value in seven
  (ROADMAP §3), so the swap isolates the march from that one known
  difference.
- Against jitted JAX, unchanged: XLA contracts multiply-adds and
  approximates ``rsqrt`` there, so the bounds of ``tests/test_torch_lighting.py``
  hold: hits, normals and albedo equal on at least 99.5% of rays or pixels,
  positions within 1e-4 relative where the normals agree, depth within one
  quantum, lighting within 1e-5 on 99.5% of pixels, fog within 1e-6.
- Whole frames of ``Pipeline(tracer="volume")`` against the JAX
  ``Pipeline`` on the same preloaded volume: within ``compare_images``.
- The property any reordering of D1's rays relies on (lanes that refill,
  longest first), on the plain march: a ray's record is its own whatever
  rays share its batch and in whatever order, and ``steps`` is the largest
  of the traced rays' moves.  A permuted
  masked batch gives the permuted record bit for bit and the same
  ``steps`` (unmasked, also JAX's op by op); a batch cut in two gives the
  whole batch's record and the larger half's ``steps``; an all-inactive
  batch gives born-done records and ``steps`` 0; inactive rays add nothing
  to ``steps``.

Torch runs on two threads, as in the other port tests under the suite's
workers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytrace_tpu.ops import trace_jax
from raytrace_tpu.render import pipeline as jax_pipeline
from raytrace_tpu.render.pipeline import FrameUniforms
from raytrace_tpu.utils.blue_noise import get_blue_noise_f32
from raytrace_tpu_torch import convert
from raytrace_tpu_torch.ops import integrate, trace_dda
from raytrace_tpu_torch.ops.integrate import DDA, Record
from raytrace_tpu_torch.ops.lighting import EXHAUSTED_DEPTH
from raytrace_tpu_torch.ops.rays import camera_rays
from raytrace_tpu_torch.render import pipeline
from raytrace_tpu_torch.render.camera import Camera
from raytrace_tpu_torch.testing.golden import compare_images

MIN_MATCH = 0.995
SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _uniforms():
    pitch = -0.3
    return FrameUniforms(
        origin=(-30.0, -100.0, 60.0), sun_angle=0.6, seed=5,
        forward=(0.0, float(np.cos(pitch)), float(np.sin(pitch))),
        up=(0.0, -0.4 * float(np.sin(pitch)), 0.4 * float(np.cos(pitch))),
        right=(0.4, 0.0, 0.0),
    ).as_device_dict()


def _sqrt_normalize(v):
    """The port's normalization (ops/rays.normalize), in jnp."""
    n2 = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return v * (1.0 / jnp.sqrt(jnp.maximum(n2, 1e-20)))[..., None]


@pytest.fixture(scope="module")
def world(full_world_volume):
    """The generated region around the origin: (JAX fused volume, port volume)."""
    mats, mf = full_world_volume
    fused = trace_jax.fuse_volume(jnp.asarray(mats), jnp.asarray(mf))
    return fused, convert.volume_from_jax(fused, "cpu")


@pytest.fixture(scope="module")
def rays():
    """32² camera rays of the canonical view, plus 64 rays from inside the
    terrain and upward, as numpy (origin, direction) of shape (N, 3)."""
    u = convert.uniforms_from_jax({k: np.asarray(v) for k, v in _uniforms().items()}, "cpu")
    o, d = camera_rays(u, SIZE, SIZE)
    rng = np.random.default_rng(11)
    extra_o = rng.uniform([-60, -60, -5], [60, 60, 30], (64, 3)).astype(np.float32)
    extra_d = rng.standard_normal((64, 3)).astype(np.float32)
    return (np.concatenate([o.reshape(-1, 3).numpy(), extra_o]),
            np.concatenate([d.reshape(-1, 3).numpy(), extra_d]))


def _port_trace(vol, o, d, max_steps=2048):
    got = trace_dda.trace_rays(vol, torch.from_numpy(o), torch.from_numpy(d),
                               torch.zeros(3), max_steps)
    return {k: v.numpy() for k, v in got.items()}


def _jax_trace(fused, o, d, max_steps=2048):
    want = trace_jax.trace_rays(fused, jnp.asarray(o), jnp.asarray(d),
                                jnp.zeros(3, jnp.float32), max_steps)
    return {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("max_steps", [2048, 8])
def test_trace_rays_exact_without_jit(world, rays, monkeypatch, max_steps):
    """Every output bit for bit, the step count included; at 8 steps some
    rays are cut (exhausted) and the loop runs to its budget."""
    fused, vol = world
    o, d = rays
    monkeypatch.setattr(trace_jax, "_normalize", _sqrt_normalize)
    with jax.disable_jit():
        want = _jax_trace(fused, o, d, max_steps)
    got = _port_trace(vol, o, d, max_steps)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], key)
    assert got["steps"].shape == () and got["steps"].dtype == np.int32
    if max_steps == 8:
        assert int(got["steps"]) == 8 and got["exhausted"].any()
    else:
        assert int(got["steps"]) < max_steps and not got["exhausted"].any()
        assert got["air"].any() and not got["air"].all()


def test_trace_rays_matches_jitted_jax(world, rays):
    fused, vol = world
    o, d = rays
    got, want = _port_trace(vol, o, d), _jax_trace(fused, o, d)
    same = (got["air"] == want["air"]) & (got["normal"] == want["normal"])
    print(f"hit/normal mismatches {int((~same).sum())} of {same.size}")
    assert same.mean() >= MIN_MATCH
    albedo_ok = (got["albedo"] == want["albedo"]).all(-1)
    assert albedo_ok.mean() >= MIN_MATCH
    np.testing.assert_allclose(got["position"][same], want["position"][same],
                               rtol=1e-4, atol=1e-4)
    assert not got["exhausted"].any() and not want["exhausted"].any()


@pytest.mark.parametrize("case", ["permuted", "halves", "all_inactive", "inactive_add_nothing"])
def test_records_ignore_ray_order_and_batch(world, rays, monkeypatch, case):
    """What lets D1 take rays in any order: each ray's record is its own,
    and ``steps`` the largest of the traced rays' moves."""
    fused, vol = world
    o, d = (torch.from_numpy(a) for a in rays)
    n = o.shape[0]
    rng = np.random.default_rng(29)
    active = torch.from_numpy(rng.random(n) < 0.7)
    march = lambda o, d, a: trace_dda.march_rays_dda_plain(vol, o, d, a, torch.zeros(3), 2048)
    whole, steps = march(o, d, active)
    assert 0 < int(steps) < 2048
    if case == "permuted":
        perm = torch.from_numpy(rng.permutation(n))
        got, got_steps = march(o[perm], d[perm], active[perm])
        for name, a, b in zip(Record._fields, got, whole):
            assert torch.equal(a, b[perm]), name
        assert int(got_steps) == int(steps)
        # Unmasked, as JAX traces: the permuted batch against JAX op by op.
        monkeypatch.setattr(trace_jax, "_normalize", _sqrt_normalize)
        with jax.disable_jit():
            want = _jax_trace(fused, o[perm].numpy(), d[perm].numpy())
        record, every_steps = march(o[perm], d[perm], None)
        got = {k: v.numpy() for k, v in integrate.record_hits(DDA, o[perm], record).items()}
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], key)
        assert int(every_steps) == int(want["steps"])
    elif case == "halves":
        cut = n // 2 + 17
        first, first_steps = march(o[:cut], d[:cut], active[:cut])
        second, second_steps = march(o[cut:], d[cut:], active[cut:])
        for name, a, b, w in zip(Record._fields, first, second, whole):
            assert torch.equal(torch.cat([a, b]), w), name
        assert int(steps) == max(int(first_steps), int(second_steps))
    elif case == "all_inactive":
        got, none = march(o, d, torch.zeros(n, dtype=torch.bool))
        assert int(none) == 0
        assert torch.equal(got.pos, o)
        assert not got.normal.any() and not got.air.any() and not got.mat.any()
    else:
        _, alone = march(o[active], d[active], None)
        assert int(steps) == int(alone)
        _, every = march(o, d, None)
        assert int(every) >= int(steps)


def _gbuffers(fused, vol, bounces, jit, monkeypatch):
    bn = get_blue_noise_f32()
    u = _uniforms()
    if jit:
        want = trace_jax.render_gbuffers(fused, jnp.asarray(bn), u, SIZE, SIZE,
                                         bounces=bounces)
    else:
        monkeypatch.setattr(trace_jax, "_normalize", _sqrt_normalize)
        with jax.disable_jit():
            want = trace_jax.render_gbuffers(fused, jnp.asarray(bn), u, SIZE, SIZE,
                                             bounces=bounces)
    got = trace_dda.render_gbuffers(
        vol, convert.blue_noise_from_jax(bn, "cpu"),
        convert.uniforms_from_jax({k: np.asarray(v) for k, v in u.items()}, "cpu"),
        SIZE, SIZE, bounces=bounces)
    return {k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("bounces", [0, 2])
def test_render_gbuffers_exact_without_jit(world, monkeypatch, bounces):
    got, want = _gbuffers(*world, bounces, False, monkeypatch)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
    for key in ("normal", "albedo", "depth", "emission"):
        np.testing.assert_array_equal(got[key], want[key], key)
    for key in ("lighting", "fog"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0, err_msg=key)
    assert int((got["depth"] == EXHAUSTED_DEPTH).sum()) == 0


def test_render_gbuffers_matches_jitted_jax(world, monkeypatch):
    got, want = _gbuffers(*world, 2, True, monkeypatch)
    normal_ok = got["normal"] == want["normal"]
    albedo_ok = (got["albedo"] == want["albedo"]).all(-1)
    light_ok = np.isclose(got["lighting"], want["lighting"], atol=1e-5, rtol=1e-5).all(-1)
    print(f"normal mismatches {int((~normal_ok).sum())}, albedo {int((~albedo_ok).sum())},"
          f" lighting {int((~light_ok).sum())} of {normal_ok.size}")
    assert normal_ok.mean() >= MIN_MATCH and albedo_ok.mean() >= MIN_MATCH
    assert light_ok.mean() >= MIN_MATCH
    d = np.abs(got["depth"].astype(np.int64) - want["depth"].astype(np.int64))
    assert d[normal_ok].max() <= 1
    np.testing.assert_allclose(got["fog"], want["fog"], atol=1e-6)
    assert int((got["depth"] == EXHAUSTED_DEPTH).sum()) == 0


# A view of the generated world that needs no slice move from lr = 0.
_VOL_CAM = dict(origin=[8.0, -100.0, 14.0], pitch=-0.05)


def _frames_match(ours, theirs):
    """One 32² frame through both pipelines' draw_frame, within
    compare_images, with no exhausted pixel and both sky and terrain."""
    frame = ours.draw_frame(Camera(**_VOL_CAM), 0.6)
    want = np.asarray(theirs.draw_frame(Camera(**_VOL_CAM), 0.6))
    assert ours.streamer.get_render_offset() == (0, 0, 0)
    stats = compare_images(frame.numpy(), want)
    print(stats)
    assert stats["ok"], stats
    depth = ours.gbuffers["depth"].to(torch.int32)
    assert int((depth == EXHAUSTED_DEPTH).sum()) == 0
    assert (depth == 0xFFFF).any() and (depth != 0xFFFF).any()


def test_volume_frame_matches_jax_pipeline(world):
    """Pipeline(tracer="volume") against the JAX Pipeline on the same
    preloaded volume."""
    fused, _ = world
    ours = pipeline.Pipeline(width=32, height=32, device="cpu", tracer="volume",
                             preloaded_volume=np.asarray(fused))
    theirs = jax_pipeline.Pipeline(width=32, height=32, tracer="volume",
                                   preloaded_volume=fused)
    _frames_match(ours, theirs)


def test_volume_tracer_shows_edits(world):
    fused, _ = world
    p = pipeline.Pipeline(width=16, height=16, device="cpu", tracer="volume",
                          preloaded_volume=np.asarray(fused))
    cam = Camera(**_VOL_CAM)
    p.draw_frame(cam, 0.6)
    before = p.gbuffers["depth"].to(torch.int32)
    # A rock wall across the view, 20 voxels in front of the camera.
    p.edit_box((-40, -80, 0), (80, 4, 40), 5)
    p.draw_frame(cam, 0.6)
    near = p.gbuffers["depth"].to(torch.int32) < before
    assert near.float().mean() > 0.5
    with pytest.raises(ValueError, match="cannot display volume edits"):
        pipeline.Pipeline(width=16, height=16, device="cpu", tracer="hf").edit_box(
            (0, 0, 0), (1, 1, 1), 2)
