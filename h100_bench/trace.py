"""What a per-layer metric reads: the traced frames' device activities and
host spans, and the window's host clock.

Each ``layer_metrics/<metric>.py`` has ``read(trace) -> float | None``;
``None`` means the metric found nothing to read, and the line leaves it
out.
"""

from __future__ import annotations

import re

from . import timeline

TOP = 10  # entries of each list of the breakdown


class Trace:
    def __init__(self, device_ops: list, host_spans: list, frames: int,
                 host_ms_per_frame, cell: dict):
        self.device_ops = device_ops  # (name, start_us, end_us)
        self.host_spans = host_spans  # (name, start_us, end_us)
        self.frames = frames  # frames traced
        self.host_ms_per_frame = host_ms_per_frame
        self.cell = cell  # the frame's width and height
        self.busy_us, self.span_us = timeline.busy_and_span(
            [(s, e) for _, s, e in device_ops])

    def ms_per_frame(self, pattern: str):
        """Device ms a traced frame of the activities whose name matches
        ``pattern`` (a regular expression), or None when none does."""
        rx = re.compile(pattern)
        hits = [e - s for name, s, e in self.device_ops if rx.search(name)]
        if not hits or not self.frames:
            return None
        return sum(hits) / 1e3 / self.frames

    def breakdown(self) -> dict:
        """The device operations that took the most time and the longest
        idle gaps, each named by what the host was doing then (its span),
        in seconds over the traced frames."""
        by_name = {}
        for name, s, e in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(timeline.gaps([(s, e) for _, s, e in self.device_ops]),
                      key=lambda g: g[0] - g[1])[:TOP]
        idle = [[timeline.label_at(s, self.host_spans), (e - s) / 1e6] for s, e in gaps]
        return {"device_ops": [[name[:200], sec] for name, sec in ops], "idle_gaps": idle}
