"""Host utilities of the port: the blue-noise texture, clipped 3-D block
copies (``coords``), and the frame-time and progress trackers and the
frame loop's spans (``perf``)."""
