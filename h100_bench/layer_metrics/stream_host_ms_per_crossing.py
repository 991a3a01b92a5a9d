"""Streaming and world tables: the host's ms of a slice crossing, the
port's ``stream`` and ``world`` spans of each traced frame whose
``stream`` applied a slice (``slices`` 1), over those frames
(``port_spans``)."""

from h100_bench import port_spans


def read(trace):
    placed = port_spans.place(trace)
    if placed is None:
        return None
    crossings = [f for f in placed.frames().values()
                 if "world" in f and f.get("stream", (0, 0, {}))[2].get("slices")]
    if not crossings:
        return None
    ms = [sum(f[k][1] - f[k][0] for k in ("stream", "world")) / 1e3 for f in crossings]
    return sum(ms) / len(ms)
