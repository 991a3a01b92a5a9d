"""The one generator of traffic: a camera flight read from a traffic file.

A flight starts at ``start`` (x, y, z world voxels, Z up) looking along
``heading`` with ``pitch``.  With ``leg_voxels`` it flies back and forth
along x over that leg at ``voxels_per_frame``, with a period of
``2 * leg_voxels / voxels_per_frame`` frames; without, it holds its place
and ``period_frames`` gives the period.  Its heading swings by
``heading_swing`` radians either way over the period (a pan; 0 when not
given), and the sun angle runs ``sun[0] -> sun[1] -> sun[0]``.  The path
is periodic, so a faster program sees the same mix of frames.  Frame ``i``
of the flight is fixed by the file alone; the run's seed picks the frame a
run starts from, so every seed renders the same frames of the same world
in another order.
"""

from __future__ import annotations

import math
import random


class Flight:
    def __init__(self, traffic: dict):
        self.start = [float(v) for v in traffic["start"]]
        self.heading = float(traffic.get("heading", math.pi / 2))
        self.pitch = float(traffic["pitch"])
        self.leg = float(traffic.get("leg_voxels", 0.0))
        self.speed = float(traffic.get("voxels_per_frame", 0.0))
        self.swing = float(traffic.get("heading_swing", 0.0))
        self.sun = [float(v) for v in traffic["sun"]]
        if self.leg:
            self.period = 2.0 * self.leg / self.speed
        else:
            self.period = float(traffic["period_frames"])

    def first_frame(self, seed: int) -> int:
        """The frame of the period that a run of ``seed`` starts from."""
        return random.Random(f"flight {seed}").randrange(math.ceil(self.period))

    def origin(self, i: int) -> list:
        """The camera's world position at frame ``i``."""
        if not self.leg:
            return list(self.start)
        along = (i * self.speed) % (2.0 * self.leg)
        x = along if along < self.leg else 2.0 * self.leg - along
        return [self.start[0] + x, self.start[1], self.start[2]]

    def heading_at(self, i: int) -> float:
        return self.heading + self.swing * math.sin(2.0 * math.pi * i / self.period)

    def sun_angle(self, i: int) -> float:
        lo, hi = self.sun
        return lo + (hi - lo) * 0.5 * (1.0 - math.cos(2.0 * math.pi * i / self.period))
