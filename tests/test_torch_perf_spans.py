"""The frame loop's own spans (``utils/perf.py`` ``Spans``) on the CPU.

The recorder is on exactly while a ``torch.profiler`` session records: a
CPU ``Pipeline`` then records one ``draw_frame`` a frame with ``stream``,
``world`` and ``replay`` inside it, on the profiler's clock.  The march's
counters need the card (``chip_smoke.py`` holds them to the plain
versions); here a CPU tensor stands in for them.
"""

import pytest
import torch

from raytrace_tpu_torch.constants import SLICE_SIZE
from raytrace_tpu_torch.render.camera import Camera
from raytrace_tpu_torch.render.pipeline import Pipeline
from raytrace_tpu_torch.utils import perf

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: the suite runs several workers
    on one machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def spans(monkeypatch):
    """A fresh recorder in the pipeline's place."""
    fresh = perf.Spans()
    monkeypatch.setattr(perf, "SPANS", fresh)
    return fresh


def _frame(spans, counters=None, add=None):
    """One recorded-or-not frame of the recorder: a root, and inside it a
    ``replay`` span during which ``add`` is added to ``counters``."""
    if not spans.open_frame():
        return False
    if counters is not None:
        spans.open("replay", counters, ("a", "b"))
        counters += add
        spans.close()
    spans.close()
    return True


def test_nothing_is_recorded_without_a_profiler(spans):
    assert not _frame(spans) and not _frame(spans)
    assert spans.frame == 2 and spans.recorded() is None
    pipe = Pipeline(width=16, height=16, max_steps=8, device="cpu")
    pipe.draw_frame(Camera(origin=[-30.0, -100.0, 60.0], pitch=-0.3), 0.6)
    assert spans.frame == 3 and spans.recorded() is None


@pytest.mark.parametrize("tracer", ["fused", "volume_fast"])
def test_a_pipeline_records_its_frames_under_a_profiler(spans, tracer):
    pipe = Pipeline(width=32, height=32, max_steps=8, device="cpu", tracer=tracer)
    cam = Camera(origin=[-30.0, -100.0, 60.0], pitch=-0.3)
    pipe.draw_frame(cam, 0.6)
    pipe.converge_streaming((cam.origin[0], 0, cam.origin[2]))
    with torch.profiler.profile(activities=CPU):
        # More than a slice from the region's centre crosses one; the next
        # frame stays.
        x = pipe.streamer.get_render_offset()[0] + SLICE_SIZE + 4
        cam.origin = [float(x), cam.origin[1], cam.origin[2]]
        pipe.draw_frame(cam, 0.6)
        pipe.draw_frame(cam, 0.6)
    got = spans.recorded()
    roots = [s for s in got if s.name == "draw_frame"]
    assert [r.frame for r in roots] == [2, 3] and all(r.parent is None for r in roots)
    for root in roots:
        inner = [s for s in got if s.frame == root.frame and s is not root]
        assert [s.name for s in inner] == ["stream", "world", "replay"]
        assert all(s.parent == "draw_frame" for s in inner)
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in inner)
        assert [a.end_ns <= b.start_ns for a, b in zip(inner, inner[1:])] == [True, True]
    streams = [s.counts for s in got if s.name == "stream"]
    assert streams == [{"slices": 1}, {"slices": 0}]
    # A CPU program runs the plain marches, which count nothing.
    assert all(s.counts == {} for s in got if s.name == "replay")


def test_a_second_session_replaces_the_first(spans):
    counters = torch.zeros(2, dtype=torch.int64)
    with torch.profiler.profile(activities=CPU):
        _frame(spans, counters, torch.tensor([1, 1]))
    _frame(spans)  # unrecorded: the next recorded frame starts a session
    with torch.profiler.profile(activities=CPU):
        _frame(spans, counters, torch.tensor([2, 20]))
        _frame(spans, counters, torch.tensor([3, 30]))
    got = spans.recorded()
    assert [(s.name, s.frame) for s in got] == [
        ("replay", 3), ("draw_frame", 3), ("replay", 4), ("draw_frame", 4)]
    assert [s.counts for s in got if s.name == "replay"] == [
        {"a": 2, "b": 20}, {"a": 3, "b": 30}]


def test_device_counts_span_the_chunks(spans):
    spans.CHUNK = 2  # a new chunk every other copy
    counters = torch.zeros(2, dtype=torch.int64)
    with torch.profiler.profile(activities=CPU):
        for k in range(1, 6):
            _frame(spans, counters, torch.tensor([k, 100 * k]))
    got = [s.counts for s in spans.recorded() if s.name == "replay"]
    assert got == [{"a": k, "b": 100 * k} for k in range(1, 6)]
    assert len(spans._chunks) == 3  # six copies: the first frame's baseline and five


def test_a_span_encloses_the_profilers_event_of_its_work(spans):
    # Five spans, each around one op: every span encloses its op's event to
    # within 100 µs at each end (the two clocks agree only that closely),
    # and the median gap at each end is under 100 µs (one preempted frame
    # aside).
    a = torch.rand(384, 384)
    with torch.profiler.profile(activities=CPU) as prof:
        torch.mm(a, a)  # the op's first call, outside any span
        for _ in range(5):
            spans.open_frame()
            torch.mm(a, a)
            spans.close()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ops = [e.time_range for e in prof.events() if e.name == "aten::mm"][1:]
    roots = spans.recorded()
    assert len(ops) == len(roots) == 5
    before, after = [], []
    for op, root in zip(ops, roots):
        start_us, end_us = (root.start_ns - start_ns) / 1e3, (root.end_ns - start_ns) / 1e3
        assert op.start - start_us > -100 and end_us - op.end > -100
        before.append(op.start - start_us)
        after.append(end_us - op.end)
    assert sorted(before)[2] < 100 and sorted(after)[2] < 100
