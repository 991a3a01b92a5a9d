"""Helpers of the measurement scripts (``chip_smoke.py``, ``apps/``): device
times of a call on the card, the instructions of the built kernels, and
equality of outputs."""

from __future__ import annotations

import re
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them: the
    label every number measured on it carries."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


# The card's peaks (H100 SXM data sheet): float32 outside the tensor cores
# and HBM3 bandwidth.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def bound(bytes_moved: float, ops: float) -> dict:
    """The least time the card could take for work that moves
    ``bytes_moved`` (each input read once, each output written once) and
    does ``ops`` float32 operations: ``bound_ms``, the larger of the two
    times at the card's peaks, and ``bound_by``, which of them it is."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def call_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls after a
    warm-up, from CUDA events around the whole train: everything the call
    enqueues."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synced_ms(fn) -> float:
    """Host milliseconds of one ``fn()`` between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# Profiles of a train taken before kernel_ms gives up.
PROFILE_TRIES = 5
# Small launches made at the start of each profile, before the train: in a
# long process the profiler may drop a trace's first records (all ten of a
# train of one short kernel, once), and these are the ones it drops then.
PROFILE_PAD = 32


def launch_times(events, kernel: str, reps: int) -> list:
    """Device milliseconds of the profiled records (``torch.profiler``
    events) of the kernel whose name contains ``kernel``, launched in this
    profile (a device record's ``id`` is the correlation id of its host
    launch record), in launch order.  Raises ``ValueError`` unless they are
    1 to ``reps`` records of one kernel (one template instance): a record
    of another launch would bias the mean.  The profiler may drop a record
    (9 of 10 kept, in long processes on the H100); the launches of a train
    are alike, so the rest still give its mean."""
    events = list(events)
    launched = {e.id for e in events
                if e.device_type == torch.autograd.DeviceType.CPU and "Launch" in e.name}
    found = sorted((e for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name
                    and e.id in launched), key=lambda e: e.time_range.start)
    names = sorted({e.name for e in found})
    if not 1 <= len(found) <= reps or len(names) != 1:
        raise ValueError(f"{kernel}: {len(found)} records of {names}, want 1 to {reps} of one")
    return [e.time_range.elapsed_us() / 1e3 for e in found]


def kernel_times(fn, reps: int, kernel: str) -> list:
    """Device milliseconds of the kernel whose name contains ``kernel``,
    launched once by each of ``reps`` calls of ``fn`` after a warm-up, from
    ``torch.profiler``: the kernel alone, without the rest of the call, one
    entry per record ``launch_times`` keeps (1 to ``reps``; their count says
    how many records the profiler kept).  Each profile starts with
    ``PROFILE_PAD`` small launches of another kernel; a profile that
    ``launch_times`` refuses is taken again, at most ``PROFILE_TRIES``
    times."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    pad = torch.zeros(1, device="cuda")
    faults = []
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(PROFILE_PAD):
                pad.add_(1.0)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        try:
            return launch_times(prof.events(), kernel, reps)
        except ValueError as err:
            faults.append(str(err))
    raise RuntimeError(f"kernel_times: no profile kept the launches: {faults}")


def kernel_ms(fn, reps: int, kernel: str) -> float:
    """The mean of ``kernel_times``."""
    times = kernel_times(fn, reps, kernel)
    return sum(times) / len(times)


def launch_floor_ms(blocks, threads: int, cluster: bool, reps: int) -> float:
    """The launch floor of a grid: the mean ms of an empty kernel
    (``csrc/launch_floor.cu``) launched on ``blocks`` ((x, y)) blocks of
    ``threads`` threads, in clusters of four along x when ``cluster``,
    alone in the profiler as ``kernel_ms`` times a kernel (the same
    padding).  A kernel whose time is near it is bound by its launch."""
    from .. import _build

    lib = _build.kernels()

    def launch():
        _build.check_launch("rt_launch_floor", lib.rt_launch_floor(
            blocks[0], blocks[1], threads, int(cluster),
            torch.cuda.current_stream().cuda_stream))

    return kernel_ms(launch, reps, "floor_cluster_kernel" if cluster else "floor_kernel")


def worldgen_grid(w0, shape_xyz) -> dict:
    """The grid G1 launches for the box at ``w0`` with extents
    ``shape_xyz`` (either mode): ``blocks`` (x, y), the ``threads`` of a
    block and the z planes a block takes (``z_chunk``); its blocks run in
    clusters of four."""
    import ctypes

    from .. import _build
    from ..ops.hf_tables import STRIP_THREADS

    grid = (ctypes.c_int32 * 3)()
    _build.check_launch("rt_worldgen_grid", _build.kernels().rt_worldgen_grid(
        *w0[:2], *shape_xyz, ctypes.addressof(grid)))
    return dict(blocks=(grid[0], grid[1]), threads=STRIP_THREADS, z_chunk=grid[2])


def pass_keys(sizes) -> list:
    """Keys of a denoise chain's passes: the size ("8#2" for the second
    pass at 8), "fin" for the last."""
    keys = []
    for k, size in enumerate(sizes):
        key = "fin" if k + 1 == len(sizes) else str(size)
        keys.append(key + "#2" if key in keys else key)
    return keys


def denoise_pass_times(gb: dict, blue_noise, reps: int) -> dict:
    """K2 alone (``kernel_times``) for each pass of the chain on the
    G-buffers ``gb``, keyed by ``pass_keys``.  The passes are timed in the
    chain's order, each launched alone, so that each reads what the chain
    gives it."""
    from ..ops import denoise

    _, passes = denoise.chain_passes(gb, blue_noise)
    return {key: kernel_times(one_pass, reps, "denoise_pass_kernel")
            for key, one_pass in zip(pass_keys(denoise.DENOISE_SIZES), passes)}


def denoise_pass_ms(gb: dict, blue_noise, reps: int) -> dict:
    """The mean of each pass's ``denoise_pass_times``."""
    return {k: sum(t) / len(t) for k, t in denoise_pass_times(gb, blue_noise, reps).items()}


# Opcodes counted apart in sass_counts: loads, the reciprocal and the
# division's range check, and float adds, multiplies and fused multiply-adds.
SASS_OPS = ("LDG", "LDS", "STG", "MUFU.RCP", "FCHK", "FADD", "FMUL", "FFMA", "BRA")


def sass_counts(library: Path) -> dict:
    """Per kernel of a built library (``cuobjdump -sass``): its SASS
    instruction count and the counts of the opcodes of ``SASS_OPS``."""
    from .._build import _nvcc

    tool = Path(_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out, name, ops = {}, None, Counter()
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name, ops = m.group(1), Counter()
            out[name] = ops
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name is not None:
            ops["instructions"] += 1
            op = m.group(1)
            for want in SASS_OPS:
                if op == want or op.startswith(want + "."):
                    ops[want] += 1
    return {k: dict(v) for k, v in out.items()}


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal in shape, type and every element, a NaN matching a NaN (a
    bounce ray that rises exactly vertically through a column K4 marches
    has no finite move and goes NaN in JAX, in K4 and in the plain version
    alike)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    eq = a == b
    if a.is_floating_point():
        eq = eq | (torch.isnan(a) & torch.isnan(b))
    return bool(eq.all())
