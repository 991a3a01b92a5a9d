"""March: billions of moves a second, the moves of a traced frame (K1's or
K3's count in the port's ``replay`` spans; ``port_spans``) over the
march's device time a frame (``march_ms_per_frame``'s kernels)."""

from h100_bench import port_spans
from h100_bench.layer_metrics.march_ms_per_frame import PATTERN


def read(trace):
    placed = port_spans.place(trace)
    counts = port_spans.counted(placed) if placed is not None else []
    ms = trace.ms_per_frame(PATTERN)
    if not counts or not ms:
        return None
    moves = sum(c["moves"] for c in counts) / len(counts)
    return moves / (ms * 1e-3) / 1e9
