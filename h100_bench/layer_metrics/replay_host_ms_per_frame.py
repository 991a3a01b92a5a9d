"""Frame loop: the host's ms a traced frame in the port's ``replay`` span
(``FrameProgram.run``: the uniforms' copy in, the graph's replay, the
launch counters and the frame's copy out), the cost of handing a frame to
the card (``port_spans``).

It is a traced cost: the span is read only while the profiler records,
and the profiler records each CUDA call the span makes (the copy in, the
replay, the clone), so it reads more than an untraced frame spends there.
The untraced frame's whole host time is ``host_ms_per_frame``, of which
the replay is a part; the traced reading is an upper bound of that part,
and moves with it only as far as the profiler's own cost a call stays
put.
"""

from h100_bench import port_spans


def read(trace):
    placed = port_spans.place(trace)
    replays = placed.named("replay") if placed is not None else []
    if not replays:
        return None
    return sum(e - s for _, _, s, e, _ in replays) / 1e3 / len(replays)
