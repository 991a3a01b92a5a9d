"""Multi-device rendering: the row-band tile split (``tiles.py``)."""

from .tiles import render_frame_tiled  # noqa: F401
