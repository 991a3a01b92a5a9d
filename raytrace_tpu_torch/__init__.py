"""raytrace_tpu_torch: the PyTorch and CUDA port of raytrace_tpu.

The frame paths of ``raytrace_tpu`` on PyTorch: the heightfield paths
(region tables; the whole-path lighting march, or the staged tracer leg by
leg) and the volume paths (worldgen, the streamed resident volume, its
occupancy tables, edits; the whole-path brick march, or the exact DDA),
then denoise and finalize, with hand-written CUDA kernels for NVIDIA Hopper
in ``csrc/``; the chunk disk cache (``world.storage``, ``native``), the
tile split over a ``torch.distributed`` group (``parallel.tiles``), the
apps (``apps/``: flythrough, capture, generate_world, debug_view,
stage_times, benchmark) and the NumPy reference tracer
(``testing.reference_tracer``).  It imports no JAX and nothing of the JAX package:
it keeps its own copies of the host modules ``constants``, ``materials``,
``utils.blue_noise``, ``utils.coords``, ``utils.perf``, ``engine`` and the
codec's C++ source.
"""

from __future__ import annotations

from . import constants  # noqa: F401
from .materials import MATERIALS, Material  # noqa: F401

__version__ = "0.1.0"


def create_instance(game=None, **pipeline_kwargs):
    """Build the renderer and return its ``Pipeline`` (the counterpart of
    ``raytrace_tpu.create_instance``, ``raytrace_tpu/__init__.py:14-23``):
    ``game`` is ignored, as there; ``pipeline_kwargs`` go to ``Pipeline``,
    which runs on the card unless given ``device``."""
    from .render.pipeline import Pipeline

    return Pipeline(**pipeline_kwargs)
