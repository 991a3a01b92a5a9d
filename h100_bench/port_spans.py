"""The port's own spans on a traced run's timeline.

The port records its frame loop's spans while a profiler records
(``raytrace_tpu_torch.utils.perf.recorded``: ``draw_frame`` a frame and,
inside it, ``stream``, ``world`` and ``replay``, with their counts),
stamped in Unix ns on the profiler's clock.  The trace's events are µs
after the profiler's own start, which the trace does not carry, so the
spans are placed by the harness's ``draw_frame`` spans
(``window.Profile``): each traced frame's harness span must hold exactly
one port ``draw_frame``, the n-th the n-th.  Each frame allows the offsets
that put its port root inside its harness span; the offset taken is the
middle of the intersection of those intervals over the frames, and the
intersection's width is how closely the two clocks are tied.  An empty
intersection means that the clocks disagree, and nothing is placed.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Placed:
    spans: list  # (name, frame, start_us, end_us, counts) on the trace's timeline
    width_us: float  # the width of the offsets' intersection

    def named(self, name: str) -> list:
        return [s for s in self.spans if s[0] == name]

    def frames(self) -> dict:
        """Each frame's spans by name: {frame: {name: (start_us, end_us, counts)}}."""
        out = {}
        for name, frame, start, end, counts in self.spans:
            out.setdefault(frame, {})[name] = (start, end, counts)
        return out


def recorded():
    """The port's last recorded session, or None where the port records
    none (a checkout without its spans, or no frame recorded)."""
    from raytrace_tpu_torch.utils import perf

    read = getattr(perf, "recorded", None)
    return read() if read is not None else None


def place(trace) -> Placed | None:
    """The port's last session placed on ``trace``'s timeline, or None: no
    device activity in the trace, no port spans, a count of port frames
    other than the harness's, or clocks that disagree."""
    if trace.span_us <= 0:
        return None
    spans = recorded()
    if not spans:
        return None
    roots = sorted((s for s in spans if s.parent is None), key=lambda s: s.start_ns)
    harness = sorted((s, e) for name, s, e in trace.host_spans if name == "draw_frame")
    if not roots or len(roots) != len(harness):
        return None
    base = roots[0].start_ns  # µs from here keep their digits as floats
    us = lambda ns: (ns - base) / 1e3
    lo = max(us(r.end_ns) - end for r, (_, end) in zip(roots, harness))
    hi = min(us(r.start_ns) - start for r, (start, _) in zip(roots, harness))
    if lo > hi:
        return None
    offset = (lo + hi) / 2
    placed = [(s.name, s.frame, us(s.start_ns) - offset, us(s.end_ns) - offset, s.counts)
              for s in spans]
    return Placed(placed, hi - lo)


def overlap_us(a, b) -> float:
    """The time two lists of disjoint, sorted ``(start, end)`` intervals
    share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        start, end = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, end - start)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def counted(placed: Placed, name: str = "replay") -> list:
    """The counts of the spans ``name`` that carry the march's."""
    return [c for _, _, _, _, c in placed.named(name) if "moves" in c]
