"""The port's NumPy reference tracer (``testing/reference_tracer.py``).

- Against the JAX package's NumPy tracer (``raytrace_tpu/testing/
  reference_tracer.py``): both are NumPy, so ``trace_rays_np`` and
  ``render_gbuffers_np`` must give the same arrays bit for bit on the same
  inputs (camera rays, rays from inside the terrain, a budget that cuts
  rays, and the whole G-buffer pass).
- The port's exact DDA (``ops/trace_dda.py``) against the port's reference,
  within the bounds ``tests/test_trace.py`` holds the JAX tracer to
  (``:48-52`` for rays, ``:106-124`` for the G-buffers).
"""

import numpy as np
import pytest
import torch

from raytrace_tpu.testing import reference_tracer as jax_reference
from raytrace_tpu.utils.blue_noise import get_blue_noise
from raytrace_tpu_torch.ops import trace_dda
from raytrace_tpu_torch.ops.rays import camera_rays
from raytrace_tpu_torch.ops.volume import fuse_volume
from raytrace_tpu_torch.render.camera import Camera
from raytrace_tpu_torch.testing import reference_tracer
from raytrace_tpu_torch.testing.golden import compare_images
from raytrace_tpu_torch.utils.blue_noise import get_blue_noise_f32

LR = (0.0, 0.0, 0.0)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _uniforms(cam, sun_angle=0.6, seed=7):
    fwd, up, right = cam.scaled_basis()
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    return dict(origin=f32(cam.origin), forward=f32(fwd), up=f32(up), right=f32(right),
                sun_angle=f32(sun_angle), seed=torch.tensor(seed, dtype=torch.int32),
                lr=f32(LR))


def _camera(pitch):
    cam = Camera(origin=[-20.0, -50.0, 40.0])
    cam.pitch = pitch
    return cam


@pytest.fixture(scope="module")
def port_volume(world_volume):
    mats, mf = world_volume
    return fuse_volume(torch.from_numpy(mats.astype(np.int32)), torch.from_numpy(mf))


@pytest.fixture(scope="module")
def rays():
    """48² camera rays (pitch -0.4) and 64 rays from inside the terrain, as
    numpy (N, 3) origin and direction."""
    o, d = camera_rays(_uniforms(_camera(-0.4)), 48, 48)
    rng = np.random.default_rng(5)
    extra_o = rng.uniform([-50, -50, -5], [50, 50, 30], (64, 3)).astype(np.float32)
    extra_d = rng.standard_normal((64, 3)).astype(np.float32)
    return (np.concatenate([o.reshape(-1, 3).numpy(), extra_o]),
            np.concatenate([d.reshape(-1, 3).numpy(), extra_d]))


def _equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], key)


@pytest.mark.parametrize("max_steps", [512, 6])
def test_trace_rays_np_equals_jax_reference(world_volume, rays, max_steps):
    """Every output bit for bit; at 6 steps most rays are cut."""
    mats, mf = world_volume
    o, d = rays
    got = reference_tracer.trace_rays_np(mats, mf, o, d, np.array(LR), max_steps)
    want = jax_reference.trace_rays_np(mats, mf, o, d, np.array(LR), max_steps)
    _equal(got, want)
    assert got["exhausted"].any() == (max_steps == 6)


def _reference_gbuffers(module, world_volume, size, pitch):
    mats, mf = world_volume
    fwd, up, right = _camera(pitch).scaled_basis()
    return module.render_gbuffers_np(
        mats, mf, origin=_camera(pitch).origin, forward=fwd, up=up, right=right,
        sun_angle=0.6, seed=7, blue_noise=get_blue_noise(), lr=LR, width=size,
        height=size, max_steps=512)


def test_render_gbuffers_np_equals_jax_reference(world_volume):
    got = _reference_gbuffers(reference_tracer, world_volume, 32, -0.35)
    want = _reference_gbuffers(jax_reference, world_volume, 32, -0.35)
    _equal(got, want)


def test_exact_dda_rays_match_reference(world_volume, port_volume, rays):
    """The bounds of tests/test_trace.py:48-52 on the 48² camera rays."""
    mats, mf = world_volume
    o, d = rays
    n = 48 * 48
    got = trace_dda.trace_rays(port_volume, torch.from_numpy(o[:n]), torch.from_numpy(d[:n]),
                               torch.zeros(3), 512)
    want = reference_tracer.trace_rays_np(mats, mf, o[:n], d[:n], np.array(LR), 512)
    assert (got["normal"].numpy() == want["normal"]).mean() > 0.995
    assert (got["air"].numpy() == want["air"]).mean() > 0.995
    d_pos = np.abs(got["position"].numpy() - want["position"]).max(-1)
    assert (d_pos < 1e-2).mean() > 0.995
    assert (~want["air"]).mean() > 0.3  # the rays reach terrain


def test_exact_dda_gbuffers_match_reference(world_volume, port_volume):
    """The bounds of tests/test_trace.py:106-124 at 48², max_steps 512."""
    want = _reference_gbuffers(reference_tracer, world_volume, 48, -0.35)
    got = trace_dda.render_gbuffers(port_volume, torch.from_numpy(get_blue_noise_f32()),
                                    _uniforms(_camera(-0.35)), 48, 48, 512)
    got = {k: v.numpy() for k, v in got.items()}
    assert (got["normal"] == want["normal"]).all()
    assert (got["depth"] == want["depth"]).mean() > 0.995
    for key in ("albedo", "fog"):
        err = np.abs(got[key] - want[key])
        assert err.max() < 1e-3, (key, err.max())
    stats = compare_images(got["lighting"], want["lighting"], tol=1e-2, max_bad_frac=0.01,
                           max_mean_err=2e-3)
    assert stats["ok"], stats
