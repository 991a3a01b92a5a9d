"""A cell at 32x32 on the CPU: the run's set-up, window and check with the
port's plain versions, for the tests."""

from __future__ import annotations

import torch

from h100_bench import run as harness
from h100_bench.spec import Cell, load_benchmark

# 20 voxels a frame: every frame streams a slice, so the first frame of a
# short window is one the check takes.
SMALL = dict(width=32, height=32, warm_frames=3, check_frames=1, check_within=1,
             trace_skip=1, trace_frames=2, voxels_per_frame=20.0)
SEED = 2**31 + 12345  # larger than int32, as a run's seed may be


def small_cell(name: str) -> Cell:
    cell = Cell(load_benchmark(), name)
    cell.traffic.update(SMALL)
    return cell


def rehearse(name: str, seconds: float = 1.0, traced: bool = False, seed: int = SEED):
    """(result, closing lines) of ``name`` run at 32x32 on the CPU."""
    return harness.run(small_cell(name), seed, seconds, traced, torch.device("cpu"))
