"""``Pipeline.draw_frame`` of the configuration's world and tracer at the
traffic's size and bounces, the camera on the flight's path from the
frame the run's seed picks; the world streamed around the camera."""

from __future__ import annotations

import torch

from ..traffic import Flight


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from raytrace_tpu_torch.render.camera import Camera
        from raytrace_tpu_torch.render.pipeline import Pipeline

        self.device = device
        self.flight = Flight(traffic)
        self.pipeline = Pipeline(width=traffic["width"], height=traffic["height"],
                                 seed=config["world_seed"], max_steps=config["max_steps"],
                                 tracer=config["tracer"], bounces=traffic["bounces"],
                                 device=device)
        self.camera = Camera(origin=list(self.flight.start), pitch=self.flight.pitch)
        self.i = self.flight.first_frame(seed)  # the next frame of the flight

    def draw(self) -> torch.Tensor:
        self.camera.origin = self.flight.origin(self.i)
        self.camera.heading = self.flight.heading_at(self.i)
        frame = self.pipeline.draw_frame(self.camera, self.flight.sun_angle(self.i))
        self.i += 1
        return frame

    def world(self) -> dict:
        world = self.pipeline.world()
        if isinstance(world, dict):
            return world
        volume, tables = world
        return dict(volume=volume, **tables)

    def gbuffers(self) -> dict:
        return self.pipeline.gbuffers

    def packed(self):
        return self.pipeline.uniforms.packed()

    def lr(self) -> tuple:
        return self.pipeline.streamer.get_render_offset()
