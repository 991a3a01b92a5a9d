"""Live performance instrumentation.

A copy of ``raytrace_tpu/utils/perf.py``, whose package imports JAX.

Reproduces the reference's observability surface: the rolling avg/max
frame-time HUD (reference: src/util.rs:175-221 `RingBufferAverage`,
src/bin/main.rs:45-47) and the batch-progress ETA tracker
(reference: src/bin/generate.rs:10-69 `StatTracker`).
"""

from __future__ import annotations

import time


class RingBufferAverage:
    """Rolling average/max over the last ``capacity`` samples."""

    def __init__(self, capacity: int = 120):
        assert capacity > 0
        self._samples = [0.0] * capacity
        self._index = 0
        self._filled = 0

    def push_sample(self, sample: float) -> None:
        self._samples[self._index] = sample
        self._index = (self._index + 1) % len(self._samples)
        self._filled = min(self._filled + 1, len(self._samples))

    def average(self) -> float:
        n = self._filled or 1
        if self._filled < len(self._samples):
            return sum(self._samples[: self._filled]) / n
        return sum(self._samples) / n

    def max(self) -> float:
        if self._filled == 0:
            return 0.0
        return max(self._samples[: self._filled])


class StatTracker:
    """Progress + ETA printer for long batch jobs."""

    def __init__(self, total: int, label: str = "items"):
        self.total = total
        self.label = label
        self.done = 0
        self.start_time = time.monotonic()

    def advance(self, n: int = 1) -> None:
        self.done += n

    def status(self) -> str:
        elapsed = time.monotonic() - self.start_time
        rate = self.done / elapsed if elapsed > 0 and self.done else 0.0
        remaining = (self.total - self.done) / rate if rate > 0 else float("inf")
        pct = 100.0 * self.done / self.total if self.total else 100.0
        if remaining == float("inf"):
            eta = "??"
        else:
            eta = f"{int(remaining // 60)}m{int(remaining % 60):02d}s"
        return (
            f"{pct:5.1f}% ({self.done}/{self.total} {self.label}), "
            f"{rate:.1f}/s, ETA {eta}"
        )


class Timer:
    """Context-manager wall timer; `.ms` after exit."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self._t0) * 1000.0
        return False
