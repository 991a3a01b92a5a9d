"""Every cell rehearsed at 32x32 on the CPU with the port's plain
versions: one well-formed last line, and ``correct`` true."""

from __future__ import annotations

import json

import pytest
from rehearsal import rehearse, small_cell

from h100_bench import run as harness
from h100_bench.spec import load_benchmark

CELLS = [w["name"] for w in load_benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_rehearsal_prints_one_well_formed_line(name, capsys):
    result, lines = rehearse(name, seconds=1.0)
    harness.emit(result, lines)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] >= 1
    assert set(last["metrics"]) == {m["name"] for m in small_cell(name).end_to_end}
    assert "setup_s" in last["metrics"] and len(last["metrics"]) >= 2
    assert all(m["value"] > 0 for m in last["metrics"].values())
    assert last["device"]["platform"] == "cpu"  # never a device metric from a CPU run
    checks = last["checks"]
    assert set(checks) == {"world_words_wrong", "gbuffer_words_wrong", "gbuffer_gap",
                           "frame_gap"}
    tail = err.strip().splitlines()[-len(checks):]
    assert [t.split()[1] for t in tail] == list(checks)


def test_traced_rehearsal_reads_the_host_and_leaves_device_metrics_out():
    # On the CPU the trace holds no device activity: the device readers
    # find nothing and the line leaves them out.
    result, _ = rehearse(CELLS[0], seconds=1.0, traced=True)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"host_ms_per_frame"}
    assert result["device"]["busy_s"] == 0.0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
