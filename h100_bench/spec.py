"""``BENCHMARK.json`` and the files its names lead to."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix and
    metrics: ``config`` (``configs/<config>.json``), ``traffic``
    (``traffic/<traffic>.json``), ``end_to_end`` and ``per_layer`` (the
    metric entries that this cell reports)."""

    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.run_seconds = bench["run_seconds"]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads((ROOT / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = json.loads(
            (HERE / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def layer_reader(name: str):
    """The ``read(trace)`` of ``layer_metrics/<name>.py`` (a "." in the
    name is a "_" in the file's)."""
    module = name.replace(".", "_")
    return importlib.import_module(f"h100_bench.layer_metrics.{module}").read
