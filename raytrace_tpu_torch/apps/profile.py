"""Profiling harness: where the steady frame's time goes on the GPU.

Port of ``raytrace_tpu/apps/profile.py`` with ``torch.profiler`` in place of
``jax.profiler``.  It drives ``Pipeline.draw_frame`` of the chosen tracer at the bench camera
(origin (-30,-100,60), pitch -0.3, sun 0.6 + 0.01·i) after a warm-up, and
prints for the steady frame:

- host ms/frame with a sync after every frame (median, p10, p90);
- host ms/frame over a train of frames with one sync at its end, and the
  host's enqueue time per frame within it;
- device ms/frame (the sum of the profiled device activities) and device
  activities per frame;
- the same split in two: the port's own kernels (``csrc/``: K1-K4, K3s,
  D1, T1, G1, O1, R1, S1, S3, P1, S2; ``kernels_ms``,
  ``kernel_activities_per_frame``) and
  everything else PyTorch launches, its glue and copies (``glue_ms``,
  ``glue_activities_per_frame``);
- the device activities that take the most time;
- the path of the ``torch.profiler`` trace of each path's profiled frames,
  written to OUT_DIR (``--out``; Chrome's trace format, one file a path),
  as JAX's writes its device trace there.  OUT_DIR defaults to
  ``raytrace_tpu_trace`` under ``tempfile.gettempdir()`` (``TMPDIR``), not
  to JAX's fixed ``/tmp`` path, so that two checkouts profiled with their
  own ``TMPDIR`` do not write over each other's traces.

``draw_frame`` renders every tracer ("fused", "hf", "volume",
"volume_fast") through a CUDA graph, so it measures two paths on the same
pipeline, in turns (graphed, eager, eager, graphed): ``graphed``,
``draw_frame`` itself, and ``eager``, the same frame through
``render_frame_packed`` op by op (``eager_frame``).  Each printed key then
carries its path's prefix.  It then times, in the same turns, CROSSINGS
frames that each cross a slice (on the volume tracers each streams a slab:
G1, and on "volume_fast" O1), each alone and synced (``crossing_ms``), and
TELEPORTS teleports, each ``Pipeline.teleport`` alone and synced
(``teleport_ms``; on the volume tracers G1 regenerates the region in
place) and the frame after it (``after_teleport_ms``).  On the
heightfield tracers ("fused", "hf") it times the crossing's region tables
through ``build_hf_tables`` as ``Pipeline.tables()`` builds them
(``tables.call_ms``, synced; on the card one T1 launch) and T1 alone
(``tables.t1_kernel_ms``, ``torch.profiler``).

``--tracer volume_staged`` profiles the staged volume frame instead:
``render_gbuffers_vol`` (R1, then K3s leg by leg with P1 between the legs,
then S2) and the denoise chain on the
volume_fast pipeline's volume and tables, uniforms filled as draw_frame
fills them.

Usage: python -m raytrace_tpu_torch.apps.profile [--out DIR]
[--frames 5] [--tracer fused|hf|volume|volume_fast|volume_staged]
[--size 1024x1024] (needs a CUDA GPU; ``--frames 30`` for steadier medians)
"""

from __future__ import annotations

import argparse
import re
import statistics
import tempfile
import time
from pathlib import Path

import torch

from ..ops.denoise import denoise_finalize
from ..ops.hf_tables import build_hf_tables
from ..ops.trace_vol import render_gbuffers_vol
from ..render.camera import Camera
from ..render.pipeline import TRACERS, Pipeline, render_frame_packed, unpack_uniforms
from ..testing.measure import kernel_ms, synced_ms

PROFILED_FRAMES = 10
CROSSINGS = 5  # slice-crossing frames timed alone per turn
TELEPORTS = 3  # teleports (and the frames after them) timed alone per turn
TELEPORT_DZ = -300.0  # z step of each timed teleport
TOP = 12  # device activities listed
STAGED = "volume_staged"  # the staged volume frame on the volume_fast pipeline
CSRC = Path(__file__).resolve().parent.parent / "csrc"


def port_kernels() -> frozenset:
    """The names of the port's own kernels: every ``__global__`` function of
    ``csrc/``."""
    names = set()
    for src in CSRC.glob("*.cu"):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__(?:launch_bounds|cluster_dims)__\([^)]*\)\s+)*(\w+)",
            src.read_text()))
    return frozenset(names)


def is_port_kernel(activity: str, names: frozenset) -> bool:
    """Whether a profiled device activity is one of the port's kernels (its
    demangled name holds ``<name>(`` or ``<name><``)."""
    return any(re.search(rf"\b{n}[(<]", activity) for n in names)


def staged_frame(pipe: Pipeline, camera: Camera, sun_angle: float) -> torch.Tensor:
    """One staged volume frame: the uniforms as draw_frame fills them, then
    render_gbuffers_vol and the denoise chain on the pipeline's world."""
    pipe.fill_uniforms(camera, sun_angle)
    packed = torch.from_numpy(pipe.uniforms.packed()).pin_memory().to(
        pipe.device, non_blocking=True)
    volume, tables = pipe.world()
    pipe.gbuffers = render_gbuffers_vol(volume, tables, pipe.blue_noise,
                                        unpack_uniforms(packed), pipe.width, pipe.height,
                                        pipe.max_steps, bounces=pipe.bounces)
    return denoise_finalize(pipe.gbuffers, pipe.blue_noise)


def eager_frame(pipe: Pipeline, camera: Camera, sun_angle: float) -> torch.Tensor:
    """``draw_frame``'s frame rendered eagerly, op by op: the streaming
    step and the uniforms as draw_frame makes them, then
    ``render_frame_packed`` on the pipeline's world."""
    pipe.streamer.request_move_towards((camera.origin[0], 0, camera.origin[2]))
    pipe.streamer.setup_next_request()
    pipe.fill_uniforms(camera, sun_angle)
    packed = torch.from_numpy(pipe.uniforms.packed())
    if pipe.device.type == "cuda":
        packed = packed.pin_memory()
    frame, pipe.gbuffers = render_frame_packed(
        pipe.world(), pipe.blue_noise, packed.to(pipe.device, non_blocking=True), pipe.width, pipe.height, pipe.max_steps,
        pipe.seed, pipe.bounces, pipe.tracer)
    return frame


def default_out_dir() -> Path:
    """The traces' directory when none is given: ``raytrace_tpu_trace``
    under the temporary directory (``TMPDIR``)."""
    return Path(tempfile.gettempdir()) / "raytrace_tpu_trace"


def run(out_dir: str | None = None, frames: int = 5, width: int = 1024,
        height: int = 1024, tracer: str = "fused") -> dict:
    """Profile the tracer's frame -> ``{path: results}`` (paths
    ``graphed`` and ``eager`` for the tracers, ``eager`` for the staged
    volume frame); each path's ``trace`` is the file under ``out_dir``
    (None: ``default_out_dir()``) that holds its profiled frames'
    ``torch.profiler`` trace."""
    if not torch.cuda.is_available():
        raise RuntimeError("the profile needs a CUDA GPU")
    staged = tracer == STAGED
    pipe = Pipeline(width=width, height=height, tracer="volume_fast" if staged else tracer)
    if staged:
        paths = dict(eager=lambda c, a: staged_frame(pipe, c, a))
    else:
        paths = dict(graphed=pipe.draw_frame, eager=lambda c, a: eager_frame(pipe, c, a))
    cam = Camera(origin=[-30.0, -100.0, 60.0])
    cam.pitch = -0.3
    pipe.teleport(cam)
    # Warm-up: kernel build and load, tables, allocator, the graph's capture.
    for draw in paths.values():
        for i in range(3):
            draw(cam, 0.6 + 0.01 * i)
    torch.cuda.synchronize()
    order = list(paths) + list(reversed(paths))
    res = {}
    out_dir = Path(default_out_dir() if out_dir is None else out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for turn, name in enumerate(order):
        trace = out_dir / f"{tracer}_{name}.json" if turn >= len(paths) else None
        got = _measure(paths[name], cam, frames, trace)
        acc = res.setdefault(name, dict(synced=[], train=[]))
        acc["synced"] += got.pop("synced")
        acc["train"] += got.pop("train")
        acc.update(got)
    if not staged:
        for name in order:
            res[name].setdefault("crossing_ms", []).extend(
                _crossings(paths[name], pipe, cam, CROSSINGS))
            for key, ms in _teleports(paths[name], pipe, cam, TELEPORTS).items():
                res[name].setdefault(key, []).extend(ms)
    for name, got in res.items():
        _report(name, got, tracer, width, height, pipe.bounces)
    if tracer in ("fused", "hf"):
        res["tables"] = _tables(pipe)
        for key, val in res["tables"].items():
            print(f"tables.{key} {val}")
    return res


def _crossings(draw, pipe: Pipeline, cam: Camera, n: int) -> list:
    """Host ms of ``n`` frames that each cross a slice, each alone and
    synced."""
    out = []
    for _ in range(n):
        cam.origin[0] += 25.0  # past the slice that the region follows
        lr = pipe.streamer.get_render_offset()
        out.append(synced_ms(lambda: draw(cam, 0.6)))
        if pipe.streamer.get_render_offset() == lr:
            raise RuntimeError("profile: a crossing frame moved no slice")
    return out


def _teleports(draw, pipe: Pipeline, cam: Camera, n: int) -> dict:
    """Host ms of ``n`` teleports (``Pipeline.teleport``) and of the frame
    after each, each alone and synced."""
    out = dict(teleport_ms=[], after_teleport_ms=[])
    for _ in range(n):
        cam.origin[2] += TELEPORT_DZ
        out["teleport_ms"].append(synced_ms(lambda: pipe.teleport(cam)))
        out["after_teleport_ms"].append(synced_ms(lambda: draw(cam, 0.6)))
    return out


def _tables(pipe: Pipeline) -> dict:
    """A crossing's region tables as ``Pipeline.tables()`` builds them (a
    host lr one slice on; with the column table for "fused"): the call
    synced, and T1 alone."""
    lr = pipe.streamer.get_render_offset()
    lr = (lr[0] + 16, lr[1], lr[2])
    build = lambda: build_hf_tables(lr, seed=pipe.seed, device=pipe.device,
                                    hcol=pipe.tracer == "fused")
    calls = [synced_ms(build) for _ in range(5)]
    return dict(call_ms=calls, call_ms_median=statistics.median(calls),
                t1_kernel_ms=kernel_ms(build, 20, "hf_tables_kernel"))


def _measure(draw, cam: Camera, frames: int, trace: Path | None) -> dict:
    """One turn of a path: its synced frames and its train, and with a
    ``trace`` path the profile, written there.  A path's two turns each add
    their samples (``synced``, ``train``), so its medians span both."""
    sun = lambda i: 0.6 + 0.01 * i
    synced = []
    for i in range(frames):
        t0 = time.perf_counter()
        draw(cam, sun(i))
        torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for i in range(frames):
        draw(cam, sun(i))
    t_enqueued = time.perf_counter()
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3 / frames
    enqueue_ms = (t_enqueued - t0) * 1e3 / frames
    got = dict(synced=synced, train=[(train_ms, enqueue_ms)])
    if trace is None:
        return got

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for i in range(PROFILED_FRAMES):
            draw(cam, sun(i))
        torch.cuda.synchronize()
    per_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            entry = per_name.setdefault(e.name, [0.0, 0])
            entry[0] += e.time_range.elapsed_us() / 1e3
            entry[1] += 1
    prof.export_chrome_trace(str(trace))
    print(f"{PROFILED_FRAMES} profiled frames; trace written to {trace}")
    return dict(got, per_name=per_name, trace=str(trace))


def _report(name: str, got: dict, tracer: str, width: int, height: int,
            bounces: int) -> None:
    """Print one path's results (each key prefixed with the path's name)
    and its top device activities; put the summary into ``got``."""
    synced, per_name = got.pop("synced"), got.pop("per_name")
    trains = got.pop("train")
    for key in ("crossing_ms", "teleport_ms", "after_teleport_ms"):
        if key in got:
            got[f"{key}_median"] = statistics.median(got[key])
    train_ms = statistics.median(t for t, _ in trains)
    device_ms = sum(ms for ms, _ in per_name.values()) / PROFILED_FRAMES
    launches = sum(n for _, n in per_name.values()) / PROFILED_FRAMES
    names = port_kernels()
    ours = {k: v for k, v in per_name.items() if is_port_kernel(k, names)}
    kernels_ms = sum(ms for ms, _ in ours.values()) / PROFILED_FRAMES
    kernel_launches = sum(n for _, n in ours.values()) / PROFILED_FRAMES
    deciles = statistics.quantiles(synced, n=10)
    got.update(
        tracer=tracer, size=[width, height], frames=len(synced),
        synced_ms_median=statistics.median(synced),
        synced_ms_p10=deciles[0], synced_ms_p90=deciles[-1],
        train_ms=train_ms, train_ms_turns=[t for t, _ in trains],
        enqueue_ms=statistics.median(e for _, e in trains),
        device_ms=device_ms, device_activities_per_frame=launches,
        kernels_ms=kernels_ms, kernel_activities_per_frame=kernel_launches,
        glue_ms=device_ms - kernels_ms, glue_activities_per_frame=launches - kernel_launches,
        mrays_per_s=width * height * (1 + 2 * bounces) / (train_ms * 1e3),
    )
    for key, val in got.items():
        print(f"{name}.{key} {val}")
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    for kernel, (ms, n) in ranked[:TOP]:
        print(f"  {ms / PROFILED_FRAMES:8.4f} ms/frame  x {n / PROFILED_FRAMES:5.1f}"
              f"  {kernel[:100]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None, help="directory of the torch.profiler traces "
                    "(default: raytrace_tpu_trace under TMPDIR)")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--tracer", choices=TRACERS + (STAGED,), default="fused")
    ap.add_argument("--size", default="1024x1024", help="WxH, e.g. 3840x2160 (config 5)")
    args = ap.parse_args()
    width, height = (int(v) for v in args.size.split("x"))
    run(args.out, args.frames, width, height, tracer=args.tracer)


if __name__ == "__main__":
    main()
