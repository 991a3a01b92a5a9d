"""Live performance instrumentation.

``RingBufferAverage``, ``StatTracker`` and ``Timer`` are a copy of
``raytrace_tpu/utils/perf.py``, whose package imports JAX.  They reproduce
the reference's observability surface: the rolling avg/max frame-time HUD
(reference: src/util.rs:175-221 `RingBufferAverage`, src/bin/main.rs:45-47)
and the batch-progress ETA tracker (reference: src/bin/generate.rs:10-69
`StatTracker`).

``Spans`` is the port's own: the spans and counts of its frame loop, which
an operator reads beside a ``torch.profiler`` trace (``recorded``).
"""

from __future__ import annotations

import dataclasses
import time

import torch
from torch._C._autograd import _profiler_enabled


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


@dataclasses.dataclass(frozen=True)
class Span:
    """A recorded span: its name, the frame's number (shared by every span
    of one frame), the name of the span that encloses it (None for the
    frame's root), its start and end in Unix ns (the time a profiler's
    trace converts its own clock to), and its counts."""

    name: str
    frame: int
    parent: str | None
    start_ns: int
    end_ns: int
    counts: dict


class Spans:
    """The frame loop's spans, recorded while a ``torch.profiler`` session
    records, and only then.

    A frame opens its root span with ``open_frame``: the one call into
    PyTorch a frame makes here, which asks whether a profiler records and
    returns the answer.  Only a recorded frame opens and closes the spans
    inside (``open``, ``close``), so an unrecorded frame costs that call
    and a counter's increment, and allocates nothing.  Each span is
    stamped in Unix ns (``time.time_ns``): the profiler converts its own
    clock to the same Unix time for its trace, whose times are µs after
    its ``trace_start_ns``.

    Counts belong to the span whose boundary they are read at: the values
    ``close`` is given, and a device counter's (``open(..., counters=,
    names=)``: a tensor the card adds to, such as the march's census),
    whose words are copied on the device's stream at the span's close and,
    unless the session's last copy was of the same counter (a span that
    closed since), at its open; the counts are the difference, read by
    ``recorded``.
    The copies go into buffers of ``CHUNK`` rows, allocated a chunk at a
    time and kept across sessions, so a recorded frame neither waits for
    the device nor allocates device memory once a chunk exists.

    Only the last session is kept: the last run of consecutive recorded
    frames (a frame recorded after one that was not starts a new one).
    """

    CHUNK = 4096

    def __init__(self):
        self.frame = 0  # root spans opened, recorded or not
        self._last = None  # the number of the last recorded frame
        self._stack = []  # the recorded frame's open spans
        self._closed = []  # the session's closed spans, raw
        self._chunks = []  # counter snapshots, CHUNK rows each
        self._rows = 0  # rows taken in the session
        self._held = None  # (counter tensor, its row at the last close)

    def open_frame(self) -> bool:
        """Open the frame's root span, ``draw_frame``, if a profiler records
        -> whether it does (and so whether this frame records its
        spans)."""
        self.frame += 1
        if not _profiler_enabled():
            return False
        if self._last != self.frame - 1:
            self._closed, self._rows, self._held = [], 0, None
        self._last = self.frame
        self._stack.clear()  # of a frame that raised before its close
        self.open("draw_frame")
        return True

    def open(self, name: str, counters: torch.Tensor | None = None,
             names: tuple = ()) -> None:
        """Open a span inside the recorded frame's innermost open span;
        ``counters``, a 1-D tensor, gives it the counts ``names`` (one a
        word) of what the device adds to it until the span closes."""
        parent = self._stack[-1][0] if self._stack else None
        row = None
        if counters is not None:
            held = self._held
            row = held[1] if held is not None and held[0] is counters \
                else self._snapshot(counters)
        self._stack.append((name, parent, time.time_ns(), counters, names, row))

    def close(self, **counts) -> None:
        """Close the innermost open span, with ``counts``."""
        name, parent, t0, counters, names, row = self._stack.pop()
        t1 = time.time_ns()
        rows = None
        if counters is not None:
            rows = (row, self._snapshot(counters))
            self._held = (counters, rows[1])
        self._closed.append((name, self.frame, parent, t0, t1, counts, names, rows))

    def _snapshot(self, counters: torch.Tensor) -> int:
        """Enqueue a copy of ``counters`` into the session's next row -> the
        row."""
        k, i = divmod(self._rows, self.CHUNK)
        if k == len(self._chunks):
            self._chunks.append(torch.zeros((self.CHUNK, counters.numel()),
                                            dtype=counters.dtype, device=counters.device))
        self._chunks[k][i].copy_(counters)
        self._rows += 1
        return self._rows - 1

    def recorded(self) -> list | None:
        """The last session's spans (``Span``), in the order they closed,
        or None before any frame was recorded.  Reads the device counters'
        copies (one wait for the device)."""
        if self._last is None:
            return None
        snaps = None
        if self._rows:
            snaps = torch.cat(self._chunks)[:self._rows].cpu()
        out = []
        for name, frame, parent, t0, t1, counts, names, rows in self._closed:
            counts = dict(counts)
            if rows is not None:
                counts.update(zip(names, (snaps[rows[1]] - snaps[rows[0]]).tolist()))
            out.append(Span(name, frame, parent, t0, t1, counts))
        return out


# The process's recorder: the profiler it follows is the process's too.
SPANS = Spans()


def recorded() -> list | None:
    """The spans of the frame loop's last recorded session
    (``Spans.recorded``)."""
    return SPANS.recorded()
