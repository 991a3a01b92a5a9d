"""The readers of the port's own spans on a synthetic trace and session.

Two frames.  The harness's ``draw_frame`` spans are 100-300 and 1100-1300
µs; the port's roots are 180 µs long, 1002 µs apart, in Unix ns.  The
offsets that put each root inside its harness span are -120..-100 µs and
-118..-98 µs: the intersection is -118..-100 (18 µs wide), and its middle
places the roots at 109-289 and 1111-1291 µs.
"""

from __future__ import annotations

import pytest

from h100_bench import port_spans
from h100_bench.layer_metrics import (
    idle_in_draw_pct, march_gmoves_per_s, march_lane_use_pct, replay_host_ms_per_frame,
    stream_host_ms_per_crossing)
from h100_bench.trace import Trace
from raytrace_tpu_torch.utils.perf import Span

BASE = 1_760_000_000_000_000_000  # Unix ns: the first root's start
READERS = [idle_in_draw_pct, replay_host_ms_per_frame, stream_host_ms_per_crossing,
           march_lane_use_pct, march_gmoves_per_s]


def _span(name, frame, start_us, end_us, **counts):
    parent = None if name == "draw_frame" else "draw_frame"
    return Span(name, frame, parent, BASE + int(start_us * 1000), BASE + int(end_us * 1000),
                counts)


SESSION = [
    _span("stream", 1, 0, 20, slices=1), _span("world", 1, 20, 50),
    _span("replay", 1, 50, 150, warp_iterations=200, moves=3200),
    _span("draw_frame", 1, 0, 180),
    _span("stream", 2, 1002, 1007, slices=0), _span("world", 2, 1007, 1012),
    _span("replay", 2, 1012, 1112, warp_iterations=250, moves=6400),
    _span("draw_frame", 2, 1002, 1182),
]
HARNESS = [("draw_frame", 100, 300), ("frame_checks", 300, 320), ("draw_frame", 1100, 1300)]
# The march 200-1000 µs, the denoise 1150-1250: busy 900 of a 1050 µs span,
# idle 1000-1150, of which 1111-1150 inside frame 2's placed root.
DEVICE = [("(anonymous namespace)::march_paths_kernel(float const*)", 200, 1000),
          ("void (anonymous namespace)::denoise_pass_kernel<1, 1>(float const*)", 1150, 1250)]


@pytest.fixture
def session(monkeypatch):
    monkeypatch.setattr(port_spans, "recorded", lambda: SESSION)


def _trace(device=DEVICE, host=HARNESS):
    return Trace(list(device), list(host), 2, None, dict(width=32, height=32))


def test_the_spans_are_placed_by_the_harness_frames(session):
    placed = port_spans.place(_trace())
    assert placed.width_us == pytest.approx(18.0)
    assert [(s, e) for _, _, s, e, _ in placed.named("draw_frame")] == [
        pytest.approx((109.0, 289.0)), pytest.approx((1111.0, 1291.0))]


@pytest.mark.parametrize("reader, want", [
    (idle_in_draw_pct, 100.0 * 39 / 1050),
    (replay_host_ms_per_frame, 0.1),  # two replays of 100 µs
    (stream_host_ms_per_crossing, 0.05),  # frame 1: stream 20 µs + world 30 µs
    (march_lane_use_pct, 100.0 * 9600 / (32 * 450)),
    (march_gmoves_per_s, 4800 / 0.4e-3 / 1e9),  # 4800 moves a frame in 0.4 ms
])
def test_each_reader_gives_its_hand_computed_value(session, reader, want):
    assert reader.read(_trace()) == pytest.approx(want)


def test_the_idle_share_gives_the_band_its_placement_allows(session, capsys):
    # Frame 2's root, 1111-1291 as placed, holds 1120-1150 of the idle
    # 1000-1150 wherever the 18 µs interval puts it, and 1102-1150 where
    # any of it does; frame 1's root holds none.
    least, placed, most, longest = idle_in_draw_pct.shares(_trace())
    assert (least, placed, most) == pytest.approx(
        (100.0 * 30 / 1050, 100.0 * 39 / 1050, 100.0 * 48 / 1050))
    assert longest == pytest.approx(39.0)
    idle_in_draw_pct.read(_trace())
    assert "2.857143 .. 4.571429" in capsys.readouterr().err


@pytest.mark.parametrize("reader", READERS)
def test_no_device_activity_reads_nothing(session, reader):
    assert reader.read(_trace(device=[])) is None


@pytest.mark.parametrize("reader", READERS)
def test_spans_that_cannot_be_placed_read_nothing(session, reader):
    # Frame 2's harness span 60 µs later: no offset holds both roots.
    late = [HARNESS[0], HARNESS[1], ("draw_frame", 1160, 1360)]
    assert reader.read(_trace(host=late)) is None
    # A harness frame the port did not record.
    extra = HARNESS + [("draw_frame", 2100, 2300)]
    assert reader.read(_trace(host=extra)) is None


@pytest.mark.parametrize("reader", READERS)
def test_a_program_without_spans_reads_nothing(monkeypatch, reader):
    monkeypatch.setattr(port_spans, "recorded", lambda: None)
    assert reader.read(_trace()) is None
