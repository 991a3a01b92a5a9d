"""Run one cell of the benchmark and print its result as one JSON line.

    python -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run builds the cell's configuration (its world is the configuration's
world seed), starts the traffic's flight at the frame the seed picks and
draws the frames to check from the seed, warms up every kernel and shape
the window uses (set-up, timed from the process's start to the first
timed frame), renders for ``--seconds``, then checks the frames it copied
against the reference (``check.py``) and prints ``correct``, ``attempted``
(the frames of the window), ``failed`` (those with an exhausted primary
pixel or a value that is not finite), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``, and last ``checks``: each compared number beside its limit,
which also close standard error.  Set-up's phases, each with its wall and
CPU seconds, go to standard error before them.  It needs a CUDA card
(exit code 2 without one), and refuses to print a result when JAX or the
JAX package was loaded (exit code 3).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here
CPU_START = time.process_time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# Python's compiled bytecode, PyTorch's included, goes to and comes from a
# fixed directory inside the checkout, so that only a checkout's first run
# compiles the modules it imports.
PYCACHE = Path(__file__).resolve().parent.parent / ".bench_cache" / "pycache"
if __name__ == "__main__":
    sys.pycache_prefix = str(PYCACHE)
    sys.dont_write_bytecode = False

import torch  # noqa: E402

from . import check, drivers, timeline  # noqa: E402
from .spec import ROOT, Cell, layer_reader, load_benchmark  # noqa: E402
from .trace import Trace  # noqa: E402
from .window import FrameChecks, Profile, Snapshots, run_window, sync  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "raytrace_tpu")
# Kernel caches at fixed paths inside the checkout (the port builds its own
# library into raytrace_tpu_torch/build/).
CACHES = {"TRITON_CACHE_DIR": ".bench_cache/triton",
          "TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit_w(index: int):
    """The card's power limit in W (``nvidia-smi``), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip())
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


class Phases:
    """Set-up's phases: each one's wall seconds and this process's CPU
    seconds (a phase whose wall time is far over its CPU time waited: on
    the disk, the card's driver or another process)."""

    def __init__(self, t0: float = T_START, cpu0: float = CPU_START):
        self.last = (t0, cpu0)
        self.marks = []

    def mark(self, name: str) -> None:
        now = (time.perf_counter(), time.process_time())
        self.marks.append((name, now[0] - self.last[0], now[1] - self.last[1]))
        self.last = now

    def line(self) -> str:
        parts = [f"{name} {wall:.3f} (cpu {cpu:.3f})" for name, wall, cpu in self.marks]
        return "set-up s: " + ", ".join(parts) + "; " + _host_state()


def _host_state() -> str:
    """The host's load average and this process's bytes read from disk."""
    state = []
    try:
        state.append("load " + " ".join(Path("/proc/loadavg").read_text().split()[:3]))
        io = dict(line.split(": ") for line in Path("/proc/self/io").read_text().splitlines())
        state.append(f"disk read {int(io['read_bytes']) / 2**20:.1f} MiB")
    except (OSError, KeyError, ValueError):
        pass
    return ", ".join(state) or "host state unread"


def set_up(cell: Cell, seed: int, device: torch.device, phases: Phases | None = None) -> tuple:
    """The cell's driver after set-up's frames (the traffic's first
    ``warm_frames``: the graph's capture, the first streamed slices, every
    kernel's first launch, the window's frame checks once), the
    ``Snapshots`` of the frames to check and the window's ``FrameChecks``
    -> (driver, snapshots, checks)."""
    from raytrace_tpu_torch.ops.lighting import EXHAUSTED_DEPTH

    phases = Phases() if phases is None else phases
    tr = cell.traffic
    driver = drivers.load(tr["driver"])(cell.config, tr, seed, device)
    phases.mark("driver")
    for _ in range(tr["warm_frames"]):
        frame = driver.draw()
    sync(device)
    phases.mark("warm frames")
    checks = FrameChecks(driver, frame, EXHAUSTED_DEPTH)
    snapshots = Snapshots(driver, frame, seed, tr["check_frames"], tr["check_within"])
    sync(device)
    phases.mark("checks")
    return driver, snapshots, checks


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t_start: float = T_START, phases: Phases | None = None) -> tuple:
    """One run of ``cell`` on ``device`` -> (result dict, the lines that
    close standard error)."""
    phases = Phases() if phases is None else phases
    tr = cell.traffic
    driver, snapshots, checks = set_up(cell, seed, device, phases)
    profile = None
    if traced:
        profile = Profile(tr["trace_skip"], tr["trace_frames"])
        profile.warm(driver.draw, device)
        phases.mark("profiler")
    out = run_window(driver, seconds, tr["in_flight"], snapshots, checks, profile)
    cuda = device.type == "cuda"
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=1,
               memory_peak_bytes=torch.cuda.max_memory_allocated(device) if cuda else 0,
               power_limit_w=power_limit_w(device.index or 0) if cuda else None)
    result = dict(correct=False, attempted=out["frames"], failed=out["failed"])
    if traced:
        trace = Trace(profile.device_ops, profile.host_spans, profile.count,
                      out["host_ms_per_frame"], dict(width=tr["width"], height=tr["height"]))
        metrics = {}
        for m in cell.per_layer:
            value = layer_reader(m["name"])(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=trace.busy_us / 1e6, window_s=trace.span_us / 1e6)
        breakdown = trace.breakdown()
    else:
        frame_ms = out["window_s"] * 1e3 / out["frames"]
        values = dict(frame_ms=frame_ms, frame_p95_ms=timeline.p95(out["intervals_ms"]),
                      setup_s=out["start"] - t_start)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    # The program's state goes before the reference runs.
    snaps = snapshots.taken
    del driver, snapshots, checks, profile
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = check.compare(cell.config, tr["bounces"], snaps, device)
    t_check = time.perf_counter() - t_check
    correct, checked = check.verdict(values, cell.config["limits"])
    result.update(correct=correct, metrics=metrics, device=dev)
    if traced:
        result["breakdown"] = breakdown
    result["checks"] = checked
    longest = max(range(len(out["intervals_ms"])), key=out["intervals_ms"].__getitem__)
    lines = [phases.line(),
             f"window: {out['frames']} frames in {out['window_s']:.3f} s, the longest "
             f"interval {out['intervals_ms'][longest]:.3f} ms (frame {longest})",
             f"checked {len(snaps)} of {tr['check_frames']} frames: "
             f"{[s['index'] for s in snaps]} of the window, in {t_check:.1f} s"]
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in checked.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(load_benchmark(), args.workload)
    phases = Phases()
    phases.mark("imports")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"h100_bench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)  # the CUDA context
    phases.mark("cuda")
    result, lines = run(cell, args.seed, args.seconds, bool(args.trace), device,
                        phases=phases)
    loaded = forbidden_modules()
    if loaded:
        print(f"h100_bench: the run loaded {loaded}; it may load no JAX", file=sys.stderr)
        return 3
    emit(result, lines)
    return 0


def emit(result: dict, lines: list) -> None:
    """The result as the last line of standard output; the compared
    numbers beside their limits as the last lines of standard error."""
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)


if __name__ == "__main__":
    sys.exit(main())
