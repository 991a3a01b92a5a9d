"""On the card, at each cell's own size: the control (the reference
storing its floats in bfloat16, in the program's place) fails the
comparison on three seeds, where the program passes it.  Each seed's
readings are printed as one JSON line (``-s`` shows them)."""

from __future__ import annotations

import json

import pytest

from h100_bench import check, readings
from h100_bench.spec import Cell, load_benchmark

CELLS = [w["name"] for w in load_benchmark()["workloads"]]
SEEDS = (3100000001, 3100000002, 3100000003)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, card):
    cell = Cell(load_benchmark(), name)
    limits = cell.config["limits"]
    for seed in SEEDS:
        got = readings.seed_readings(cell, seed, 5.0, card)
        print(json.dumps(dict(cell=name, **got)), flush=True)
        assert got["frames"], got
        assert all(got["program"][k] <= limits[k] for k in check.NUMBERS), got
        assert any(got["control"][k] > limits[k] for k in check.NUMBERS), got
