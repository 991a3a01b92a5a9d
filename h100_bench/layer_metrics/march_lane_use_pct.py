"""March: the share of the march's lane-iterations that made a move over
the traced frames, 100 x moves / (32 x warp iterations), from the counts
K1 or K3 adds up in each graphed frame (the port's ``replay`` spans:
``FrameProgram.COUNTERS``; ``port_spans``)."""

from h100_bench import port_spans


def read(trace):
    placed = port_spans.place(trace)
    counts = port_spans.counted(placed) if placed is not None else []
    iterations = sum(c["warp_iterations"] for c in counts)
    if not iterations:
        return None
    return 100.0 * sum(c["moves"] for c in counts) / (32 * iterations)
