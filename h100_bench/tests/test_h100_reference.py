"""The reference's frozen copy equals the port's plain versions at a
small size, and the control (the reference storing its floats in
bfloat16) fails the comparison that the program passes."""

from __future__ import annotations

import pytest
import torch
from rehearsal import SEED, small_cell

from h100_bench import check, readings
from h100_bench.reference import frame as ref
from raytrace_tpu_torch.render.camera import Camera
from raytrace_tpu_torch.render.pipeline import Pipeline


@pytest.mark.parametrize("tracer", ref.TRACERS)
@pytest.mark.parametrize("bounces", [1, 2])
def test_reference_equals_the_ports_plain_versions(tracer, bounces):
    seed = 12345  # any world: the reference follows the world seed
    pipe = Pipeline(width=32, height=24, tracer=tracer, seed=seed, bounces=bounces,
                    device="cpu")
    cam = Camera(origin=[-30.0, -100.0, 60.0], pitch=-0.1)
    for i in range(4):  # the region moves: slices stream in
        cam.origin[0] += 9.0
        frame = pipe.draw_frame(cam, 0.6 + 0.1 * i)
    packed = pipe.uniforms.packed()
    world = pipe.world()
    world = world if isinstance(world, dict) else dict(volume=world[0], **world[1])
    snap = dict(frame=frame, world=world, gbuffers=pipe.gbuffers, packed=packed)
    got = check.readings(tracer, seed, pipe.max_steps, bounces, snap, "cpu")
    assert got == dict(world_words_wrong=0, gbuffer_words_wrong=0, gbuffer_gap=0.0,
                       frame_gap=0.0)


@pytest.mark.parametrize("name", ["fused.fly_1024_b2", "volume_fast.fly_1024_b2"])
def test_control_fails_where_the_program_passes(name):
    cell = small_cell(name)
    got = readings.seed_readings(cell, SEED, 0.5, torch.device("cpu"))
    limits = cell.config["limits"]
    assert all(got["program"][k] <= limits[k] for k in check.NUMBERS), got
    assert any(got["control"][k] > limits[k] for k in check.NUMBERS), got
