"""Golden-image comparison.

A copy of ``raytrace_tpu/testing/golden.py:13-40``, whose package imports
JAX.

The reference validated rendering visually (SURVEY §4); here frames are
compared numerically with tolerances that absorb f32 associativity and rare
borderline DDA-axis flips between independent implementations.
"""

from __future__ import annotations

import numpy as np


def compare_images(
    got: np.ndarray,
    want: np.ndarray,
    *,
    tol: float = 1e-3,
    max_bad_frac: float = 0.005,
    max_mean_err: float = 1e-3,
) -> dict:
    """Compare two float images; returns stats dict with 'ok' bool.

    A pixel is "bad" if any channel differs by more than `tol`.  The image
    passes if at most `max_bad_frac` of pixels are bad AND the mean absolute
    error is below `max_mean_err` (borderline ray flips perturb isolated
    pixels strongly; both bounds together catch real regressions).
    """
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want)
    per_pixel = err.reshape(err.shape[0], err.shape[1], -1).max(-1)
    bad_frac = float((per_pixel > tol).mean())
    mean_err = float(err.mean())
    return {
        "ok": bad_frac <= max_bad_frac and mean_err <= max_mean_err,
        "bad_frac": bad_frac,
        "mean_err": mean_err,
        "max_err": float(err.max()),
    }
