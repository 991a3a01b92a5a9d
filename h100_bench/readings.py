"""The readings the limits of ``check.py`` are set from.

For each seed: the cell's set-up and a short window of the program, then,
for each frame the window copied, the four numbers of the program against
the reference (the lower readings) and of the control against the
reference (the upper readings).  The control is the reference put in the
program's place with every float it stores rounded through bfloat16
(``reference/precision.py``).

    python -m h100_bench.readings --workload <cell> --seeds 1,2,3 [--seconds 2]
        [--no-control]

prints one JSON line a seed: ``{"seed", "frames", "program", "control"}``.
"""

from __future__ import annotations

import argparse
import json

import torch

from . import check
from .reference import frame as ref
from .reference.precision import lower
from .spec import Cell, load_benchmark
from .window import run_window

CONTROL_DTYPE = torch.bfloat16


def control_snapshot(config: dict, bounces: int, snap: dict, device) -> dict:
    """The control in the program's place for the checked frame ``snap``:
    its world, G-buffers and frame, from the reference computed with its
    floats stored in ``CONTROL_DTYPE``."""
    tracer, world_seed = config["tracer"], config["world_seed"]
    height, width = snap["frame"].shape[:2]
    noise = ref.blue_noise(device)
    with lower(CONTROL_DTYPE):
        world = ref.world(tracer, world_seed, ref.lr_of(snap["packed"]), device)
        gb = ref.gbuffers(tracer, world, noise, ref.uniforms(snap["packed"], device), width,
                          height, config["max_steps"], world_seed, bounces)
        frame = ref.finish(gb, noise)
    return dict(world=world, gbuffers=gb, frame=frame, packed=snap["packed"])


def seed_readings(cell: Cell, seed: int, seconds: float, device, control: bool = True) -> dict:
    """One seed's readings of ``cell`` (a run's set-up and window, then
    the check's numbers of the program and of the control)."""
    from .run import set_up

    tr = cell.traffic
    driver, snapshots, checker = set_up(cell, seed, device)
    out = run_window(driver, seconds, tr["in_flight"], snapshots, checker, None)
    snaps = snapshots.taken
    del driver, snapshots
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = dict(seed=seed, frames=[s["index"] for s in snaps], failed=out["failed"],
               program=check.compare(cell.config, tr["bounces"], snaps, device))
    if control:
        got["control"] = check.compare(
            cell.config, tr["bounces"],
            [control_snapshot(cell.config, tr["bounces"], snap, device) for snap in snaps],
            device)
    return got


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("h100_bench.readings needs a CUDA card")
    cell = Cell(load_benchmark(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        got = seed_readings(cell, seed, args.seconds, torch.device("cuda", 0),
                            not args.no_control)
        print(json.dumps(got), flush=True)


if __name__ == "__main__":
    main()
