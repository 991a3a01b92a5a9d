"""Helpers of the measurement scripts (``chip_smoke.py``, ``apps/``): device
times of a call on the card, and equality of outputs."""

from __future__ import annotations

import subprocess

import torch


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them: the
    label every number measured on it carries."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def call_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls after a
    warm-up, from CUDA events around the whole train: everything the call
    enqueues."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps: int, kernel: str) -> float:
    """Mean device milliseconds of the kernel whose name contains
    ``kernel``, launched once by each of ``reps`` calls of ``fn`` after a
    warm-up, from ``torch.profiler``: the kernel alone, without the rest of
    the call."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    # The profiler may drop records of a long train; the mean is over those
    # it kept.
    if not 0 < len(times) <= reps:
        raise RuntimeError(f"{kernel}: {len(times)} launches profiled of {reps}")
    return sum(times) / len(times)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal in shape, type and every element, a NaN matching a NaN (a
    bounce ray that rises exactly vertically through a column K4 marches
    has no finite move and goes NaN in JAX, in K4 and in the plain version
    alike)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    eq = a == b
    if a.is_floating_point():
        eq = eq | (torch.isnan(a) & torch.isnan(b))
    return bool(eq.all())
