"""Host utilities of the port that need no tensors: the blue-noise texture,
clipped 3-D block copies (``coords``) and the frame-time and progress
trackers (``perf``)."""
