"""The port's staged heightfield tracer (K4's plain version) and its G-buffer
pass against the JAX package.

Both sides get the JAX package's region tables (carried over with
``convert.tables_from_jax``).  On the CPU the port runs K4's plain version;
the JAX side runs ``trace_rays_hf`` with its kernel in interpret mode, as
its own tests do.  Rays: the JAX tests' own ray sets
(``tests/test_trace_pallas.py``), 32² camera rays at max_steps 256 (the
unified body, with and without the cascade) and the same rays with an
active mask (the phased cascade of bounce batches).  Air, normal, packed
albedo and exhaustion must be equal on every ray; positions and distances
within 1e-5 relative: XLA's CPU ``rsqrt`` is an approximation that differs
from the correctly rounded quotient in the last bit for about one
normalization in seven, while the port divides by ``sqrt`` (ROADMAP §3), so
a direction can differ by an ulp, and a position by a few ulps after a
ray's length.
G-buffers: normal and albedo equal, depth within one quantum, lighting
within 1e-5, fog within 1e-6 (``tests/test_lighting_fused.py``'s bounds).
Whole frames of ``Pipeline(tracer="hf")`` against the JAX ``Pipeline``:
within ``compare_images``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytrace_tpu.ops import trace_pallas as jax_hf
from raytrace_tpu.ops.trace_jax import camera_rays as jax_camera_rays
from raytrace_tpu.ops.trace_jax import fuse_volume
from raytrace_tpu.render import pipeline as jax_pipeline
from raytrace_tpu.render.pipeline import FrameUniforms
from raytrace_tpu.utils.blue_noise import get_blue_noise_f32
from raytrace_tpu_torch import convert
from raytrace_tpu_torch.ops import lighting, trace_hf
from raytrace_tpu_torch.ops.hf_tables import build_hf_tables
from raytrace_tpu_torch.ops.lighting import EXHAUSTED_DEPTH
from raytrace_tpu_torch.render import pipeline
from raytrace_tpu_torch.render.camera import Camera
from raytrace_tpu_torch.testing.golden import compare_images

LR = np.zeros(3, np.int32)


def _canonical_uniforms():
    pitch = -0.3
    return FrameUniforms(
        origin=(-30.0, -100.0, 60.0),
        sun_angle=0.6,
        forward=(0.0, float(np.cos(pitch)), float(np.sin(pitch))),
        up=(0.0, -0.4 * float(np.sin(pitch)), 0.4 * float(np.cos(pitch))),
        right=(0.4, 0.0, 0.0),
    ).as_device_dict()


@pytest.fixture(scope="module")
def tables():
    """The JAX tables at lr = 0, and the port's copy of them."""
    jt = jax_hf.build_hf_tables(jnp.asarray(LR), seed=0)
    return jt, convert.tables_from_jax({k: np.asarray(v) for k, v in jt.items()}, "cpu")


def _camera_rays(size):
    u = _canonical_uniforms()
    o, d = jax_camera_rays(u, size, size)
    return np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3)


def _straight_down():
    xs, ys = np.meshgrid(np.arange(-60, 60, 11, dtype=np.float32) + 0.5,
                         np.arange(-60, 60, 11, dtype=np.float32) + 0.5)
    o = np.stack([xs, ys, np.full_like(xs, 120.0)], -1).reshape(-1, 3)
    return o, np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (o.shape[0], 1))


def _mask(n):
    return np.random.default_rng(3).random(n) < 0.7


def _small_sets():
    """The ray sets of tests/test_trace_pallas.py, one batch (one trace)."""
    down_o, down_d = _straight_down()
    sets = {
        "upward": (np.array([[0.5, 0.5, 150.0]], np.float32),
                   np.array([[0.0, 0.0, 1.0]], np.float32)),
        "bounds_exit": (np.array([[0.5, 0.5, 125.0]], np.float32),
                        np.array([[1.0, 0.0, 0.0]], np.float32)),
        "straight_down": (down_o, down_d),
    }
    o = np.concatenate([v[0] for v in sets.values()])
    d = np.concatenate([v[1] for v in sets.values()])
    ends = np.cumsum([0] + [v[0].shape[0] for v in sets.values()])
    return o, d, {k: slice(ends[i], ends[i + 1]) for i, k in enumerate(sets)}


# batch -> (origin, direction, active, caps); max_steps 256 everywhere.
BATCHES = {
    "jax_sets": lambda: (*_small_sets()[:2], None, jax_hf.COMPACT_CAPS),
    "camera_32px": lambda: (*_camera_rays(32), None, ()),
    "camera_32px_active": lambda: (*_camera_rays(32), _mask(32 * 32), jax_hf.COMPACT_CAPS),
}


@pytest.fixture(scope="module", params=list(BATCHES))
def traced_pair(request, tables):
    """One batch through both tracers: (origin, active, port dict, JAX dict)."""
    jt, pt = tables
    o, d, active, caps = BATCHES[request.param]()
    want = jax_hf.trace_rays_hf(
        jt, jnp.asarray(o), jnp.asarray(d), jnp.asarray(LR), max_steps=256,
        seed=0, interpret=True, caps=caps,
        active=None if active is None else jnp.asarray(active))
    got = trace_hf.trace_rays_hf(
        pt, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(LR),
        max_steps=256, seed=0, caps=caps,
        active=None if active is None else torch.from_numpy(active))
    traced = np.ones(o.shape[0], bool) if active is None else active
    return (request.param, traced, {k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def test_trace_rays_hf_matches_jax(traced_pair):
    _, traced, got, want = traced_pair
    for key in ("air", "normal", "albedo", "exhausted"):
        np.testing.assert_array_equal(got[key][traced], want[key][traced], key)
    np.testing.assert_allclose(got["position"], want["position"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["distance"][traced], want["distance"][traced],
                               atol=1e-5, rtol=1e-5)
    if traced_pair[0].startswith("camera"):
        assert not got["exhausted"][traced].any()
        assert got["air"].any() and not got["air"].all()


def test_inactive_rays_are_born_done(traced_pair):
    """At their origin (distance 0), no hit, no material, no work."""
    _, traced, got, _ = traced_pair
    off = ~traced
    assert got["exhausted"][off].all() and not got["air"][off].any()
    np.testing.assert_array_equal(got["normal"][off], 0)
    np.testing.assert_array_equal(got["distance"][off], 0.0)
    np.testing.assert_array_equal(got["work"][off], 0)
    assert (got["work"][traced, 0] > 0).all()


@pytest.mark.parametrize("name", ["upward", "bounds_exit", "straight_down"])
def test_jax_ray_sets_outcome(tables, name):
    """The outcomes tests/test_trace_pallas.py asserts, on the port."""
    _, pt = tables
    o, d, where = _small_sets()
    got = trace_hf.trace_rays_hf(pt, torch.from_numpy(o[where[name]]),
                                 torch.from_numpy(d[where[name]]), torch.from_numpy(LR),
                                 max_steps=64 if name == "bounds_exit" else 256, seed=0)
    if name == "upward":
        assert got["air"].all()
    if name == "bounds_exit":
        assert got["air"].all() and abs(float(got["position"][0, 0])) >= 127.0
    if name == "straight_down":
        assert not got["air"].any() and (got["normal"] == 4).all()
        assert (got["albedo"] > 0).any()


def test_budget_follows_the_cascade():
    assert trace_hf.hf_budget(256) == 256
    assert trace_hf.hf_budget(256, trace_hf.COMPACT_CAPS) == 256 + 16 + 48 + 160
    assert trace_hf.hf_budget(32, trace_hf.COMPACT_CAPS) == 32 + 16
    assert trace_hf.COMPACT_CAPS == jax_hf.COMPACT_CAPS


def test_budget_cut_rays_are_exhausted(tables):
    """A ray out of moves is neither air nor a hit, and its work is its budget."""
    _, pt = tables
    o, d = _camera_rays(16)
    got = trace_hf.trace_rays_hf_plain(pt, torch.from_numpy(o), torch.from_numpy(d),
                                       torch.from_numpy(LR), max_steps=4, caps=())
    cut = got["exhausted"]
    assert cut.all()
    moves = got["work"][..., 0]
    assert int(moves.max()) == 4 and (moves == 4).all()
    np.testing.assert_array_equal(got["albedo"].numpy(), 0.0)


def _port_gbuffers(pt, size, bounces, caps=jax_hf.COMPACT_CAPS, max_steps=2048):
    u = _canonical_uniforms()
    got = trace_hf.render_gbuffers_hf(
        pt, convert.blue_noise_from_jax(get_blue_noise_f32(), "cpu"),
        convert.uniforms_from_jax({k: np.asarray(v) for k, v in u.items()}, "cpu"),
        size, size, max_steps=max_steps, seed=0, bounces=bounces, caps=caps)
    return {k: v.numpy() for k, v in got.items()}


def _gbuffer_pair(tables, size, bounces, caps=jax_hf.COMPACT_CAPS):
    jt, pt = tables
    bn = get_blue_noise_f32()
    want = jax_hf.render_gbuffers_hf(jt, jnp.asarray(bn), _canonical_uniforms(), size, size,
                                     max_steps=2048, seed=0, interpret=True, bounces=bounces,
                                     caps=caps)
    return _port_gbuffers(pt, size, bounces, caps), {k: np.asarray(v) for k, v in want.items()}


def _assert_gbuffers_close(got, want):
    np.testing.assert_array_equal(got["normal"], want["normal"])
    np.testing.assert_array_equal(got["albedo"], want["albedo"])
    d = np.abs(got["depth"].astype(np.int64) - want["depth"].astype(np.int64))
    assert d.max() <= 1  # one quantum, 1/32 voxel
    np.testing.assert_allclose(got["lighting"], want["lighting"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["fog"], want["fog"], atol=1e-6)
    assert got["depth"].dtype == np.uint16 and got["normal"].dtype == np.uint8
    assert int((got["depth"] == EXHAUSTED_DEPTH).sum()) == 0
    assert int((want["depth"] == EXHAUSTED_DEPTH).sum()) == 0
    np.testing.assert_array_equal(got["emission"], 0.0)


@pytest.mark.parametrize("bounces", [0, 1, 2])
def test_render_gbuffers_hf_matches_jax(tables, bounces):
    got, want = _gbuffer_pair(tables, 32, bounces)
    _assert_gbuffers_close(got, want)


@pytest.mark.parametrize("caps", [(), (8,)], ids=["no_cascade", "caps_8"])
def test_render_gbuffers_hf_caps_match_jax(tables, caps):
    """``render_gbuffers_hf``'s ``caps``, as JAX's: the bounce batches'
    cascade, whose levels add to their budget (``hf_budget``; K4 takes the
    budget whole).  Against JAX at b2 with the cascade off and at a cap JAX
    does not default to, at max_steps 2048, where no ray is cut: at budgets
    that cut bounce rays JAX traces them with its phased body (its
    ``unified``, a TPU knob the port leaves out), which counts steps
    otherwise.  At max_steps 24 the port's bounce rays are cut, and ``caps``
    changes the lighting: the parameter is live."""
    got, want = _gbuffer_pair(tables, 32, 2, caps)
    _assert_gbuffers_close(got, want)
    tight = _port_gbuffers(tables[1], 32, 2, caps, max_steps=24)
    wider = _port_gbuffers(tables[1], 32, 2, jax_hf.COMPACT_CAPS, max_steps=24)
    assert trace_hf.hf_budget(24, caps) < trace_hf.hf_budget(24, jax_hf.COMPACT_CAPS)
    assert (tight["lighting"] != wider["lighting"]).any()


def test_hf_matches_fused_gbuffers():
    """The port's two heightfield tracers agree at 64², as the JAX
    package's do (tests/test_lighting_fused.py:46-63)."""
    pt = build_hf_tables((0, 0, 0), seed=0, device="cpu")
    bn = torch.from_numpy(get_blue_noise_f32())
    u = convert.uniforms_from_jax(
        {k: np.asarray(v) for k, v in _canonical_uniforms().items()}, "cpu")
    staged = trace_hf.render_gbuffers_hf(pt, bn, u, 64, 64, max_steps=2048, seed=0)
    fused = lighting.render_gbuffers_fused(pt, bn, u, 64, 64, max_steps=2048, seed=0)
    _assert_gbuffers_close({k: v.numpy() for k, v in staged.items()},
                           {k: v.numpy() for k, v in fused.items()})


def test_trace_raises_off_cpu_without_kernel():
    """A tensor on a device with no kernel is refused, never run plain."""
    rays = torch.zeros(4, 3, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        trace_hf.trace_rays_hf({}, rays, rays, torch.zeros(3, device="meta"))


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


def test_hf_frame_matches_jax_pipeline(full_world_volume):
    """Pipeline(tracer="hf") against the JAX Pipeline (whose streamer is
    handed the generated volume, which the hf tracer does not read)."""
    mats, mf = full_world_volume
    theirs = jax_pipeline.Pipeline(width=32, height=32, tracer="hf",
                                   preloaded_volume=fuse_volume(jnp.asarray(mats),
                                                                jnp.asarray(mf)))
    ours = pipeline.Pipeline(width=32, height=32, device="cpu", tracer="hf")
    _frames_match(ours, theirs)
