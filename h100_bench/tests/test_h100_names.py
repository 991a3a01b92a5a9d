"""BENCHMARK.json's names, units and files keep to the allowed characters
and point at files of the harness."""

from __future__ import annotations

import json
import re
from pathlib import Path

from h100_bench.spec import BENCHMARK, HERE, ROOT, Cell, layer_reader, load_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def test_names_and_units():
    bench = load_benchmark()
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[key]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((key, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(set(n for k, n in names if k in ("end_to_end", "per_layer"))) == \
        len([n for k, n in names if k in ("end_to_end", "per_layer")])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(BENCHMARK.read_bytes()) <= 64 * 1024


def test_every_name_leads_to_its_file():
    bench = load_benchmark()
    for w in bench["workloads"]:
        cell = Cell(bench, w["name"])
        assert cell.config["tracer"] and cell.traffic["driver"]
        assert set(cell.config["limits"]) == {
            "world_words_wrong", "gbuffer_words_wrong", "gbuffer_gap", "frame_gap"}
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in bench["per_layer"]:
        assert callable(layer_reader(m["name"]))
        moves = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        # Each cell that reports the metric reports what it moves.
        for cell in m.get("workloads", [w["name"] for w in bench["workloads"]]):
            assert cell in moves.get("workloads", [cell]), (m["name"], cell)
    for c in bench["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.resolve().is_relative_to(HERE)
        json.loads(path.read_text())


def test_files_under_paths_are_named_from_name_characters():
    for p in Path(HERE).rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert all(NAME.match(part) for part in rel.split("/")), rel
