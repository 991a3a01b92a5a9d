"""Camera, streaming control and the frame pipeline."""
