"""The window's arithmetic on synthetic timelines."""

from __future__ import annotations

import statistics

import pytest

from h100_bench import timeline
from h100_bench.trace import Trace


def test_p95_of_intervals_sees_the_hitches():
    # 95 frames of 1 ms and 5 hitches of 3 ms: the tail sits between them.
    completions = [0.0]
    for i in range(100):
        completions.append(completions[-1] + (3.0 if i % 20 == 7 else 1.0))
    iv = timeline.intervals(completions)
    assert len(iv) == 100 and sum(iv) == pytest.approx(completions[-1])
    assert timeline.p95(iv) == pytest.approx(
        statistics.quantiles(iv, n=20, method="inclusive")[18])
    assert 1.0 < timeline.p95(iv) <= 3.0
    assert timeline.p95([1.0] * 50) == 1.0


def test_p95_of_one_and_of_none():
    assert timeline.p95([2.5]) == 2.5
    with pytest.raises(ValueError):
        timeline.p95([])


def test_union_counts_overlaps_once():
    spans = [(0, 10), (5, 12), (20, 30), (29, 31), (40, 41)]
    busy, span = timeline.busy_and_span(spans)
    assert (busy, span) == (12 + 11 + 1, 41)
    assert timeline.gaps(spans) == [(12, 20), (31, 40)]
    assert timeline.busy_and_span([]) == (0.0, 0.0)


@pytest.mark.parametrize("spans, idle", [
    ([(0, 100)], 0.0),  # busy throughout
    ([(0, 25), (75, 100)], 50.0),  # a gap of half the span
    ([(0, 50), (10, 20), (50, 100)], 0.0),  # nested and touching
])
def test_idle_share_from_one_timeline(spans, idle):
    from h100_bench.layer_metrics import device_idle_pct

    trace = Trace([("k", s, e) for s, e in spans], [], 1, None, {})
    assert device_idle_pct.read(trace) == pytest.approx(idle)


def test_idle_gaps_are_named_by_the_host_span():
    ops = [("a", 0, 10), ("b", 30, 40), ("a", 45, 50)]
    host = [("draw_frame", 5, 35), ("wait_in_flight", 40, 46)]
    trace = Trace(ops, host, 2, None, {})
    got = trace.breakdown()
    assert got["idle_gaps"] == [["draw_frame", 20e-6], ["wait_in_flight", 5e-6]]
    assert [name for name, _ in got["device_ops"]] == ["a", "b"]
    assert [sec for _, sec in got["device_ops"]] == pytest.approx([15e-6, 10e-6])


def test_ms_per_frame_reads_nothing_where_nothing_matches():
    trace = Trace([("march_paths_kernel(float*)", 0, 2000)], [], 2, None, {})
    assert trace.ms_per_frame(r"\bmarch_paths_kernel\b") == pytest.approx(1.0)
    assert trace.ms_per_frame(r"\bdenoise_pass_kernel\b") is None
