"""The run with the timed path broken underneath: ``correct`` comes out
false for each fault a cell can have (at 32x32 on the CPU)."""

from __future__ import annotations

import pytest
import torch
from rehearsal import rehearse

import raytrace_tpu_torch.render.pipeline as pipeline_mod
from h100_bench.spec import load_benchmark

ONE_CARD = [w["name"] for w in load_benchmark()["workloads"] if w["chips"] == 1]


def stale_frame(monkeypatch):
    """A step that returns its state unchanged: every frame is the first."""
    draw = pipeline_mod.Pipeline.draw_frame
    first = {}

    def stale(self, camera, sun_angle):
        frame = draw(self, camera, sun_angle)
        return first.setdefault(id(self), frame).clone()

    monkeypatch.setattr(pipeline_mod.Pipeline, "draw_frame", stale)


def half_rows(monkeypatch):
    """Half of the batch left out: the G-buffer pass's second half of the
    rows is never rendered (zeros)."""
    gbuffers = pipeline_mod.frame_gbuffers

    def half(*args, **kwargs):
        gb = gbuffers(*args, **kwargs)
        rows = gb["depth"].shape[0]
        return {k: torch.cat([v[:rows // 2], torch.zeros_like(v[rows // 2:])])
                for k, v in gb.items()}

    monkeypatch.setattr(pipeline_mod, "frame_gbuffers", half)


def altered_pixel(monkeypatch):
    """An answer altered where it is produced: one channel of one pixel of
    the finished frame one 8-bit step off."""
    finalize = pipeline_mod.denoise_finalize

    def altered(*args, **kwargs):
        frame = finalize(*args, **kwargs).clone()
        frame[3, 5, 1] += 1.0 / 255.0
        return frame

    monkeypatch.setattr(pipeline_mod, "denoise_finalize", altered)


@pytest.mark.parametrize("fault", [stale_frame, half_rows, altered_pixel])
@pytest.mark.parametrize("name", ONE_CARD[:2])
def test_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    fault(monkeypatch)
    result, lines = rehearse(name, seconds=0.5)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values()), lines
