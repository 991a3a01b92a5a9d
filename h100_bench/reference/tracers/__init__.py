"""One module a tracer, ``tracers/<tracer>.py``, named as the
configuration's ``tracer``, with

- ``world(seed, lr, device) -> dict``: the world the tracer renders at
  region offset ``lr``, as named tensors, worked out from the world seed;
- ``gbuffers(world, noise, uni, width, height, max_steps, seed, bounces,
  row0, rows) -> dict``: the six G-buffers of image rows ``row0 .. row0 +
  rows`` (``rows`` None: to the last row), the floats not yet stored.

A configuration with another tracer brings its module as a new file.
"""
