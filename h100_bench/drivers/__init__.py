"""What a window drives: the port's own entry points, one module each.

``traffic["driver"]`` names a module here, ``drivers/<driver>.py``, whose
class ``Driver(config, traffic, seed, device)`` renders with ``draw()``
and tells the window and the check what the program holds: ``world()``
(the named tensors its frames read), ``gbuffers()`` (of the whole frame),
``packed()`` (the frame's packed uniforms) and ``lr()`` (the region
offset, which moves when a slice streams).
A new entry point is a new file here.
"""

from __future__ import annotations

import importlib


def load(name: str):
    """The ``Driver`` class of ``drivers/<name>.py``."""
    return importlib.import_module(f"{__name__}.{name}").Driver
