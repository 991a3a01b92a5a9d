"""The premise of S1's sky rule (``csrc/shade.cu``): a terrain pixel's
bounce sky is evaluated only where its weight is set, unless the frame's
sunlight has a negative component.  That is exact only if every sky is
> 0 whenever the sunlight is >= 0 componentwise (a weight of 0 times such
a sky is +0, as 0 times the +0 the kernel leaves), and it needs the guard
only if a night sun makes a negative sky (0 times it is -0, which a sum of
-0 terms keeps).  Both hold for the plain ``shading.sample_sky`` over
seeded random directions, the sun's own direction and its disk, at day
and night sun angles."""

import numpy as np
import torch

from raytrace_tpu_torch.ops import shading

# The frames' angles (0.6 + 0.01 k) and a sweep of day and night.
ANGLES = [0.6 + 0.01 * k for k in range(40)] + [-7.0 + 0.05 * k for k in range(281)]


def _directions(sun, n=2048, seed=3):
    """Seeded random unit directions, the sun's and some inside its disk."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    s = sun.numpy().astype(np.float64)
    near = s + rng.standard_normal((64, 3)) * 0.01
    d = np.concatenate([d, s[None], near])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = torch.from_numpy(d.astype(np.float32))
    return d[:, 0], d[:, 1], d[:, 2]


def test_skies_are_positive_under_a_nonnegative_sun_and_not_at_night():
    lit_frames = night_negative = 0
    for angle in ANGLES:
        vec = shading.sun_vector(torch.tensor(angle, dtype=torch.float32))
        sun, light = vec[:3], vec[3:6]
        d = _directions(sun)
        sky = torch.stack(shading.sample_sky(d, tuple(sun), tuple(light), True))
        fog = torch.stack(shading.sample_sky(d, tuple(sun), tuple(light), False))
        skies = torch.cat([sky, fog], 1)
        assert bool(torch.isfinite(skies).all())
        if bool((light >= 0).all()):
            lit_frames += 1
            assert bool((skies > 0).all()), angle
            # 0 times the sky is +0, the bits of 0 times the kernel's +0.
            assert bool(((0.0 * skies).view(torch.int32) == 0).all())
        elif bool((skies < 0).any()):
            night_negative += 1
    assert lit_frames >= 40
    # A night sun makes negative skies, so the guard is needed: 0 times one
    # is -0.
    assert night_negative > 0
    vec = shading.sun_vector(torch.tensor(-2.0, dtype=torch.float32))
    assert bool((vec[3:6] < 0).any())
    sky = torch.stack(shading.sample_sky(_directions(vec[:3]), tuple(vec[:3]), tuple(vec[3:6]),
                                         True))
    assert bool(((0.0 * sky).view(torch.int32) == np.int32(-2 ** 31)).any())
