"""Frame loop: the host's ms inside each frame call (``draw_frame``), by
the harness's clock around the call, over the window's untraced frames."""


def read(trace):
    return trace.host_ms_per_frame
