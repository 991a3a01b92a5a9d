"""Device: the share of the traced frames' span (first activity's start to
last activity's end, on the profiler's one timeline) in which no activity
ran on the card: 100 * (1 - union of the activity intervals / span)."""


def read(trace):
    if trace.span_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us / trace.span_us)
