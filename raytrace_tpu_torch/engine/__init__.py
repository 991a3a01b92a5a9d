"""Fly camera, sun and key controls (copies of ``raytrace_tpu/engine``)."""

from .controls import ControlSet  # noqa: F401
from .game import Game  # noqa: F401
