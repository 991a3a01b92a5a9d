"""Camera model and view basis.

A copy of ``raytrace_tpu/render/camera.py``, whose package imports JAX.

Reference: src/render/mod.rs:14-34 (Camera: Z-up, heading from +X toward +Y,
pitch up toward +Z, default heading pi/2) and src/util.rs:164-185
(compute_triple_euler_vector).
"""

from __future__ import annotations

import dataclasses
import math

FOV_SCALE = 0.4  # up/right scale applied per frame (pipeline.rs:198-199)


def compute_triple_euler_vector(heading: float, pitch: float):
    """(forward, up, right) unit-ish basis vectors as xyz tuples."""
    forward = (
        math.cos(heading) * math.cos(pitch),
        math.sin(heading) * math.cos(pitch),
        math.sin(pitch),
    )
    p2 = pitch + math.pi / 2.0
    up = (
        math.cos(heading) * math.cos(p2),
        math.sin(heading) * math.cos(p2),
        math.sin(p2),
    )
    right = (
        forward[1] * up[2] - forward[2] * up[1],
        forward[2] * up[0] - forward[0] * up[2],
        forward[0] * up[1] - forward[1] * up[0],
    )
    return forward, up, right


@dataclasses.dataclass
class Camera:
    """Mutable fly camera state."""

    origin: list[float] = dataclasses.field(default_factory=lambda: [0.0, 0.0, 0.0])
    heading: float = math.pi * 0.5
    pitch: float = 0.0

    def basis(self):
        return compute_triple_euler_vector(self.heading, self.pitch)

    def scaled_basis(self):
        """forward, up*0.4, right*0.4 — the per-frame uniform values."""
        forward, up, right = self.basis()
        return (
            forward,
            tuple(c * FOV_SCALE for c in up),
            tuple(c * FOV_SCALE for c in right),
        )
