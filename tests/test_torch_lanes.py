"""The arithmetic of the persistent-lane march kernels, checked on the CPU.

K3 (``csrc/trace_vol.cu``) takes the floor modulo of its boundary distance
as ``s - floor(s * (1/m)) * m`` where its plain version takes
``torch.remainder(s, m)``; the two must give the same distance bits for
every power-of-two modulus the march uses.  The lane-use census helper
(``raytrace_tpu_torch/testing/census.py``) is checked on move counts with
known answers, and the output equality of the measurement scripts
(``testing/measure.py``) on NaNs, shapes and types, and their choice of
profiled kernel records.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.testing.census import WARP, lane_use, static_warp_iterations
from raytrace_tpu_torch.testing.measure import launch_times, same

EPS = torch.tensor(1e-4, dtype=torch.float32)  # kEps of the kernels


def _shifted_values(rng, m: float) -> np.ndarray:
    """float32 values of ``(p + 128) * mul``: uniform up to |s| = 2^20,
    exact multiples of ``m``, their neighbours an ulp away, tiny values and
    zeros of both signs.  The tiny values stop at 1e-36, where ``s / 64`` is
    still a normal float: below 2^-120 the product ``s * (1/m)`` would
    underflow to zero and a negative ``s`` would keep its sign.  The march
    never gets there: ``p + 128`` is 0 or at least 2^-17 in magnitude, the
    spacing of float32 next to -128."""
    uniform = rng.uniform(-2.0 ** 20, 2.0 ** 20, 4096).astype(np.float32)
    small = rng.uniform(-4 * m, 4 * m, 4096).astype(np.float32)
    multiples = (rng.integers(-2 ** 14, 2 ** 14, 1024) * m).astype(np.float32)
    near = np.concatenate([np.nextafter(multiples, np.float32(np.inf)),
                           np.nextafter(multiples, np.float32(-np.inf))])
    tiny = np.array([1e-36, 1e-30, 1e-20, 1e-10, 2.0 ** -17, 1e-5], np.float32)
    return np.concatenate([uniform, small, multiples, near, tiny, -tiny,
                           np.array([0.0, -0.0], np.float32)])


@pytest.mark.parametrize("m", [1.0, 8.0, 16.0, 32.0, 64.0])
def test_floor_form_modulo_matches_remainder(m):
    rng = np.random.default_rng(int(m))
    s = torch.from_numpy(_shifted_values(rng, m))
    # 1/|v| of a unit direction: at least 1, inf on an axis it does not move.
    v = rng.uniform(-1.0, 1.0, s.numel()).astype(np.float32)
    v[:8] = 0.0
    lp = 1.0 / torch.abs(torch.from_numpy(v))
    mod = torch.tensor(m, dtype=torch.float32)
    inv = torch.tensor(1.0 / m, dtype=torch.float32)  # exact: m is a power of two
    floor_form = s - torch.floor(s * inv) * mod
    remainder = torch.remainder(s, mod)
    # The same value; only the sign of a zero may differ ...
    assert bool((floor_form == remainder).all())
    # ... which adding eps absorbs: the distances are the same bits.
    got = (EPS + floor_form) * lp
    want = (EPS + remainder) * lp
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _one_long_ray():
    moves = torch.ones(2 * WARP, dtype=torch.int32)
    moves[5] = 100
    return moves, 100 + 1


def _all_inactive():
    return torch.zeros((3 * WARP, 1), dtype=torch.int32), 0


def _ragged_last_warp():
    return torch.arange(70, dtype=torch.int32), 31 + 63 + 69


@pytest.mark.parametrize("case", [_one_long_ray, _all_inactive, _ragged_last_warp])
def test_census_static_warp_iterations_and_lane_use(case):
    moves, warp_iterations = case()
    assert static_warp_iterations(moves) == warp_iterations
    total = int(moves.sum())
    use = lane_use(total, warp_iterations)
    assert use == (total / (WARP * warp_iterations) if warp_iterations else 0.0)
    assert 0.0 <= use <= 1.0
    # The kernels' census counts at least the static warps' iterations of
    # real moves: packing lanes can only raise the use.
    assert lane_use(total, max(1, (total + WARP - 1) // WARP)) >= use


def test_census_of_a_full_warp_is_one():
    moves = torch.full((WARP,), 7, dtype=torch.int32)
    assert static_warp_iterations(moves) == 7
    assert lane_use(int(moves.sum()), 7) == 1.0


def _record(name, cid, start_us, us, device=torch.autograd.DeviceType.CUDA):
    """A stand-in for a torch.profiler event: a device record's id is the
    correlation id of its host launch record."""
    span = SimpleNamespace(start=start_us, elapsed_us=lambda: us)
    return SimpleNamespace(name=name, id=cid, device_type=device, time_range=span)


_PASS = "void denoise_pass_kernel<4, 4>(float4 const*, float4*, int, int)"
_OTHER = "void denoise_pass_kernel<8, 8>(float4 const*, float4*, int, int)"


def _launch(cid):
    return _record("cudaLaunchKernel", cid, 0.0, 5.0, torch.autograd.DeviceType.CPU)


@pytest.mark.parametrize("records, want", [
    ([_launch(5), _launch(2), _record(_PASS, 5, 20.0, 40.0), _record(_PASS, 2, 0.0, 30.0)],
     [0.03, 0.04]),
    ([_launch(2), _launch(5), _record(_PASS, 5, 20.0, 30.0)], [0.03]),  # one dropped
    ([_launch(7), _record(_PASS, 3, 0.0, 90.0), _record(_PASS, 7, 20.0, 30.0)],
     [0.03]),  # a record launched before this profile
    ([_launch(2)], None),  # none kept
    ([_launch(k) for k in (2, 5, 8)] + [_record(_PASS, k, k, 30.0) for k in (2, 5, 8)],
     None),  # more than the launches timed
    ([_launch(2), _launch(5), _record(_OTHER, 2, 0.0, 80.0), _record(_PASS, 5, 20.0, 30.0)],
     None),  # another pass's
])
def test_launch_times_keep_the_profiles_own_launches(records, want):
    if want is None:
        with pytest.raises(ValueError):
            launch_times(records, "denoise_pass_kernel", 2)
    else:
        assert launch_times(records, "denoise_pass_kernel", 2) == pytest.approx(want)


def test_same_matches_nan_with_nan_only():
    a = torch.tensor([1.0, float("nan"), 0.0])
    assert same(a, a.clone())
    assert not same(a, torch.tensor([1.0, 2.0, 0.0]))
    assert not same(a, a[:2])
    i = torch.tensor([1, 2, 3], dtype=torch.int32)
    assert same(i, i.clone())
    assert not same(i, i.to(torch.int64))
