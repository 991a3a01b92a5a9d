"""Frame loop: the share of the traced frames' span (as ``device_idle_pct``
reads it) in which no activity ran on the card while the host was inside
the port's own ``draw_frame`` span: the part of the device's idle time
that is the program's host work on a frame (``port_spans``).

The spans are placed to within the offsets' interval (``Placed.width_us``,
18-32 µs on an H100's host), which is of the order of the idle gaps that
a frame's host work leaves (0.03-0.25 ms).  So ``read`` also writes the
band the placement allows on standard error: the least share, counting
only the idle time that lies inside a root wherever in the interval it
is placed, and the most, counting whatever lies inside one anywhere.  A
change inside that band is no change.  A single host stall of a
millisecond inside a frame adds 0.2 points to a 400-frame window, so the
line gives the longest idle gap inside a root too.
"""

import sys

from h100_bench import port_spans, timeline


def shares(trace):
    """(least, placed, most, the longest idle gap inside a root in µs), the
    shares in %, or None where the spans cannot be placed."""
    placed = port_spans.place(trace)
    if placed is None:
        return None
    idle = timeline.gaps([(s, e) for _, s, e in trace.device_ops])
    draws = sorted((s, e) for _, _, s, e, _ in placed.named("draw_frame"))
    half = placed.width_us / 2

    def share(grow):
        spans = [(s - grow, e + grow) for s, e in draws if e - s > -2 * grow]
        return 100.0 * port_spans.overlap_us(idle, spans) / trace.span_us

    longest = max((port_spans.overlap_us([gap], draws) for gap in idle), default=0.0)
    return share(-half), share(0.0), share(half), longest


def read(trace):
    got = shares(trace)
    if got is None:
        return None
    least, placed, most, longest = got
    print(f"idle_in_draw_pct {placed:.6f}: {least:.6f} .. {most:.6f} as placed within the "
          f"offsets' interval; the longest idle gap inside a root {longest:.3f} us",
          file=sys.stderr)
    return placed
