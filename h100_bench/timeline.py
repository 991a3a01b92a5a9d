"""Arithmetic on timelines: frame intervals, their tail, and the device's
busy and idle time from a trace's activity intervals."""

from __future__ import annotations

import statistics


def p95(values) -> float:
    """The 95th percentile of ``values`` (``statistics.quantiles``,
    inclusive method: interpolated between order statistics)."""
    values = list(values)
    if len(values) < 2:
        if not values:
            raise ValueError("p95 of no values")
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def intervals(completions) -> list:
    """Each frame's interval: the time from the previous completion (the
    first entry is the window's start) to its own."""
    return [b - a for a, b in zip(completions, completions[1:])]


def merged(spans) -> list:
    """The union of ``(start, end)`` intervals as sorted, disjoint ones."""
    out = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(s) for s in out]


def busy_and_span(spans) -> tuple:
    """(the time covered by the union of ``spans``, the time from the
    first start to the last end)."""
    union = merged(spans)
    if not union:
        return 0.0, 0.0
    return sum(e - s for s, e in union), union[-1][1] - union[0][0]


def gaps(spans) -> list:
    """The idle gaps between the merged ``spans``, as ``(start, end)``."""
    union = merged(spans)
    return [(a[1], b[0]) for a, b in zip(union, union[1:])]


def label_at(t: float, host_spans) -> str:
    """The name of the innermost host span ``(name, start, end)`` that holds
    time ``t`` (the one that started last), or "host: no span"."""
    inside = [(s, name) for name, s, e in host_spans if s <= t < e]
    return max(inside)[1] if inside else "host: no span"
