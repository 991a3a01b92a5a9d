"""Host utilities of the port that need no tensors (the blue-noise texture)."""
