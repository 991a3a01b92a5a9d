"""Where the reference stores its floats, and the control that stores them
lower.

The reference computes and stores in float32, as the configurations state.
The control (``lower(torch.bfloat16)``) rounds what each stage stores to
bfloat16 and back: the terrain heights before they are floored into voxel
columns and table words, the march's primary hit distances before the
shade quantizes them into depth, the G-buffers the shade writes, the light
after each denoise pass and the finished frame.  That is the step a faster
program would be tempted to take (bfloat16 G-buffers halve what the
bytes-bound denoiser reads), and the comparison must reject it.
"""

from __future__ import annotations

import contextlib

import torch

_STORE = [None]  # the dtype floats are rounded through; None: as computed


def store(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the reference stores it: unchanged, or under ``lower``
    rounded through the lower dtype."""
    dtype = _STORE[0]
    return x if dtype is None else x.to(dtype).to(x.dtype)


@contextlib.contextmanager
def lower(dtype: torch.dtype):
    """Run the reference as its control: every stored float rounded
    through ``dtype``."""
    _STORE[0] = dtype
    try:
        yield
    finally:
        _STORE[0] = None
