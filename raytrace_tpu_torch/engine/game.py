"""Game state: fly camera, sun control, world handle.

A copy of ``raytrace_tpu/engine/game.py``, whose package imports JAX; it
uses the port's own ``render/camera.py``.

Reference: src/game/mod.rs.  Movement is WASD/QE at 50 units/s along the
normalized camera basis (mod.rs:61-96); R/F move the sun at 1 rad/s; the
6-arg camera override mirrors the CLI contract of Game::new (mod.rs:45-56).
"""

from __future__ import annotations

import math

from ..render.camera import Camera, compute_triple_euler_vector
from .controls import ControlSet

MOVE_SPEED = 50.0
SUN_SPEED = 1.0
DEFAULT_ORIGIN = (-30.0, -128.0, 100.0)


def _normalize(v):
    n = math.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    return (v[0] / n, v[1] / n, v[2] / n)


class Game:
    def __init__(self, args: list[str] | None = None, storage=None):
        self.camera = Camera()
        self.controls = self._make_controls()
        self.sun_angle = 0.0
        self.world = storage  # optional ChunkStorage handle

        if args:
            # x y z heading pitch sun_angle (reference mod.rs:45-51).
            self.camera.origin = [float(args[0]), float(args[1]), float(args[2])]
            self.camera.heading = float(args[3])
            self.camera.pitch = float(args[4])
            self.sun_angle = float(args[5])
        else:
            self.camera.origin = list(DEFAULT_ORIGIN)

    @staticmethod
    def _make_controls() -> ControlSet:
        s = ControlSet()
        s.add_control("up", "e")
        s.add_control("down", "q")
        s.add_control("left", "a")
        s.add_control("right", "d")
        s.add_control("forward", "w")
        s.add_control("backward", "s")
        s.add_control("sunup", "r")
        s.add_control("sundown", "f")
        # Beyond the reference control set (mod.rs has no editing): place /
        # carve a block box ahead of the camera (consumed by the frame
        # loop, apps/flythrough.py, on volume-tracer pipelines).
        s.add_control("place", "b")
        s.add_control("carve", "x")
        return s

    def tick(self, dt: float) -> None:
        c = self.controls
        if c.is_held("sunup"):
            self.sun_angle += dt * SUN_SPEED
        elif c.is_held("sundown"):
            self.sun_angle -= dt * SUN_SPEED

        dx = -1.0 if c.is_held("left") else (1.0 if c.is_held("right") else 0.0)
        dy = -1.0 if c.is_held("backward") else (1.0 if c.is_held("forward") else 0.0)
        dz = -1.0 if c.is_held("down") else (1.0 if c.is_held("up") else 0.0)
        if dx == dy == dz == 0.0:
            return
        amount = dt * MOVE_SPEED
        forward, up, right = compute_triple_euler_vector(
            self.camera.heading, self.camera.pitch
        )
        forward, up, right = _normalize(forward), _normalize(up), _normalize(right)
        o = self.camera.origin
        for axis in range(3):
            o[axis] += amount * (forward[axis] * dy + up[axis] * dz + right[axis] * dx)

    def on_mouse_move(self, x: float, y: float) -> None:
        # Present-but-disabled in the reference (mod.rs:98-101).
        pass

    def get_sun_angle(self) -> float:
        return self.sun_angle
