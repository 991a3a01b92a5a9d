#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (raytrace_tpu_torch) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It builds the
CUDA kernels from ``raytrace_tpu_torch/csrc``, holds each kernel against its
plain PyTorch version at the shapes the frame gives it, renders the 64²
golden frame, then drives both frame paths through ``create_instance`` ->
``teleport`` -> 20 ``draw_frame`` calls at 1024²: the heightfield path
(``tracer="fused"``: K1, K2) and the volume path (``tracer="volume_fast"``:
the streamed volume, its occupancy tables, K3, K2), then an edit of the
volume, and times the kernels against their plain versions.  It imports no
JAX.  Any failure raises and the script exits non-zero; with no CUDA GPU,
or outside a checkout, it exits non-zero before printing any result.  The
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W = H = 1024
FRAMES = 20
CANON = dict(origin=(-30.0, -100.0, 60.0), pitch=-0.3, sun=0.6)
K1_ATOL = 1e-5  # shaded lighting, kernel against plain
VOL_DX = 1.2  # camera x step per frame on the volume path: crosses a slice
WEIRD = dict(origin=(0.0, -80.0, 40.0), pitch=-0.4, sun=0.6)  # weird scene view


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def _canonical_uniforms(rt, view=CANON, seed=0):
    """The canonical terrain view of the JAX package's golden tests (or
    another view looking along +y)."""
    p = view["pitch"]
    return rt.render.pipeline.FrameUniforms(
        origin=view["origin"], sun_angle=view["sun"], seed=seed,
        forward=(0.0, math.cos(p), math.sin(p)),
        up=(0.0, -0.4 * math.sin(p), 0.4 * math.cos(p)), right=(0.4, 0.0, 0.0),
    )


def _exhausted(gb, torch, lighting) -> int:
    return int((gb["depth"].to(torch.int32) == lighting.EXHAUSTED_DEPTH).sum())


def _cuda_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds per call over ``reps`` calls after a warm-up."""
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


def phase_k1(torch, tables, blue, packed, size, max_steps, seed, bounces):
    """K1 against its plain version on the march inputs the frame gives it.

    Both are built without FMA contraction, so every meta word must be
    equal, and with it the normal, albedo and shaded lighting."""
    from raytrace_tpu_torch.ops import lighting
    from raytrace_tpu_torch.render.pipeline import unpack_uniforms

    frame = lighting.march_inputs(tables, blue, unpack_uniforms(packed), size, size)
    budget = (max_steps, seed, 1 + 2 * bounces)
    meta_k, pd_k = lighting.march_paths(*frame["march"], *budget)
    meta_p, pd_p = lighting.march_paths_plain(*frame["march"], *budget)
    gk = lighting.shade(meta_k, pd_k, **frame["shade"])
    gp = lighting.shade(meta_p, pd_p, **frame["shade"])
    dd = torch.abs(gk["depth"].to(torch.int32) - gp["depth"].to(torch.int32))
    res = dict(
        size=size, bounces=bounces, lr=[int(v) for v in frame["march"][3][2:5]],
        meta_equal=float((meta_k == meta_p).float().mean()),
        max_abs_err=float(torch.abs(gk["lighting"] - gp["lighting"]).max()),
        max_depth_diff=int(dd.max()),
        exhausted_kernel=_exhausted(gk, torch, lighting),
        exhausted_plain=_exhausted(gp, torch, lighting),
    )
    ok = (res["meta_equal"] == 1.0 and res["max_abs_err"] <= K1_ATOL
          and res["max_depth_diff"] <= 1
          and res["exhausted_kernel"] == 0 and res["exhausted_plain"] == 0)
    return ok, res


def phase_k3(torch, volume, tables, blue, packed, size, max_steps, bounces):
    """K3 against its plain version on the march inputs the frame gives it.

    Both are built without FMA contraction, so the four outputs (meta word,
    primary and dif1 hit voxels, primary distance) must be equal on every
    pixel, and neither may cut a primary."""
    from raytrace_tpu_torch.ops import lighting, path_vol, trace_vol
    from raytrace_tpu_torch.render.pipeline import unpack_uniforms

    legs = path_vol.legs_of(bounces)
    frame = path_vol.march_inputs(tables, blue, unpack_uniforms(packed), size, size)
    got = trace_vol.march_paths_vol(*frame["march"], max_steps, legs)
    want = trace_vol.march_paths_vol_plain(*frame["march"], max_steps, legs)
    gk = path_vol.shade(volume, *got, legs=legs, **frame["shade"])
    gp = path_vol.shade(volume, *want, legs=legs, **frame["shade"])
    names = ("meta", "prim_lin", "dif1_lin", "prim_dist")
    res = dict(
        size=size, bounces=bounces, lr=[int(v) for v in frame["march"][3][:3]],
        equal={n: float((a == b).float().mean()) for n, a, b in zip(names, got, want)},
        max_abs_err=float(torch.abs(gk["lighting"] - gp["lighting"]).max()),
        sky_px=int((gk["depth"].to(torch.int32) == 0xFFFF).sum()),
        exhausted_kernel=_exhausted(gk, torch, lighting),
        exhausted_plain=_exhausted(gp, torch, lighting),
    )
    ok = (all(v == 1.0 for v in res["equal"].values()) and res["max_abs_err"] == 0.0
          and res["exhausted_kernel"] == 0 and res["exhausted_plain"] == 0)
    return ok, res


def _volumes(torch, dev):
    """The weird scene (slab, floating box, cave tunnel; the JAX package's
    volume tests) and the generated world around the origin, as fused
    volumes at lr = 0."""
    from raytrace_tpu_torch.ops.volume import fuse_volume
    from raytrace_tpu_torch.world.chunk import minefield_from_solid
    from raytrace_tpu_torch.world.generate import PACKED_ROCK, generate_box

    solid = torch.zeros((256, 256, 256), dtype=torch.bool, device=dev)
    solid[:100] = True
    solid[140:150, 120:140, 120:140] = True
    solid[90:100, 128:132, 128:132] = False
    mats = torch.where(solid, PACKED_ROCK, 0).to(torch.int32)
    weird = fuse_volume(mats, minefield_from_solid(solid))
    box = generate_box((-128,) * 3, (256,) * 3, seed=0, device=dev)
    return {"weird": (weird, WEIRD), "world": (fuse_volume(box["materials"],
                                                         box["minefield"]), CANON)}


def phase_volume_main(rt, torch):
    """The volume path: 20 frames at 1024² through create_instance/
    draw_frame with tracer="volume_fast", the camera moving +VOL_DX in x per
    frame so that slices stream in and the occupancy tables update."""
    from raytrace_tpu_torch.ops import denoise, lighting, trace_vol
    from raytrace_tpu_torch.ops.vol_tables import build_vol_tables
    from raytrace_tpu_torch.render.camera import Camera

    pipe = rt.create_instance(width=W, height=H, tracer="volume_fast")
    cam = Camera(origin=list(CANON["origin"]))
    cam.pitch = CANON["pitch"]
    pipe.teleport(cam)
    base = list(cam.origin)
    drained = []
    drain = pipe.streamer.drain_slab_log

    def counting_drain():
        log = drain()
        drained.append(log)
        return log

    pipe.streamer.drain_slab_log = counting_drain
    pipe.vol_tables()  # the teleported volume's full build, outside the count
    drained.clear()
    torch.cuda.synchronize()
    trace_vol.march_paths_vol.launches = 0
    denoise.denoise_pass.launches = 0
    finite, exhausted = [], []
    t0 = time.perf_counter()
    for t in range(FRAMES):
        cam.origin = [base[0] + VOL_DX * t, base[1], base[2]]
        frame = pipe.draw_frame(cam, CANON["sun"] + 0.01 * t)
        finite.append(torch.isfinite(frame).all())
        exhausted.append((pipe.gbuffers["depth"].to(torch.int32)
                          == lighting.EXHAUSTED_DEPTH).sum())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    k3, k2 = trace_vol.march_paths_vol.launches, denoise.denoise_pass.launches
    rebuilt = build_vol_tables(pipe.streamer.volume)
    tables = pipe.vol_tables()
    res = dict(
        frames=FRAMES, shape=list(frame.shape), ms_per_frame=ms,
        all_finite=bool(torch.stack(finite).all()),
        exhausted_px=int(torch.stack(exhausted).sum()),
        k3_launches=k3, k2_launches=k2, lr=list(pipe.uniforms.lr),
        slabs_drained=sum(len(log) for log in drained if log),
        full_rebuilds=sum(log is None for log in drained),
        tables_equal_rebuild={k: bool(torch.equal(tables[k], rebuilt[k])) for k in rebuilt},
    )
    ok = (res["all_finite"] and res["exhausted_px"] == 0 and k3 >= FRAMES
          and k2 == len(denoise.DENOISE_SIZES) * FRAMES and tuple(frame.shape) == (H, W, 3)
          and res["slabs_drained"] >= 1 and res["full_rebuilds"] == 0
          and all(res["tables_equal_rebuild"].values()))
    return ok, res, pipe


def phase_volume_edit(torch, pipe):
    """One edit of the resident volume, then a frame: the tables rebuild
    and the primary depth changes where the new box stands."""
    from raytrace_tpu_torch.ops.vol_tables import build_vol_tables
    from raytrace_tpu_torch.render.camera import Camera

    cam = Camera(origin=list(pipe.uniforms.origin))
    cam.pitch = CANON["pitch"]
    before = pipe.gbuffers["depth"].to(torch.int32)
    x, y, z = (int(v) for v in cam.origin)
    # A snow wall 24 voxels ahead of the camera, over the right half of the
    # view.
    pipe.edit_box((x, y + 24, z - 40), (40, 4, 60), 6)
    frame = pipe.draw_frame(cam, CANON["sun"])
    after = pipe.gbuffers["depth"].to(torch.int32)
    rebuilt = build_vol_tables(pipe.streamer.volume)
    tables = pipe.vol_tables()
    res = dict(
        finite=bool(torch.isfinite(frame).all()),
        nearer_px=int((after < before).sum()),
        unchanged_px=int((after == before).sum()),
        tables_equal_rebuild=all(torch.equal(tables[k], rebuilt[k]) for k in rebuilt),
    )
    ok = (res["finite"] and res["nearer_px"] > 0 and res["unchanged_px"] > 0
          and res["tables_equal_rebuild"])
    return ok, res


def _blue_noise(torch, dev):
    from raytrace_tpu_torch.render.pipeline import get_blue_noise_f32

    return torch.from_numpy(get_blue_noise_f32()).to(dev)


def _random_gbuffers(torch, dev, h, w, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    normal = rng.integers(0, 6, (h, w)).astype(np.int32)
    depth = (rng.random((h, w)) * 65000).astype(np.int32)
    normal[: h // 16] = 16  # a sky band
    depth[: h // 16] = 0xFFFF
    t = lambda a: torch.from_numpy(a).to(dev)
    return dict(
        lighting=t(rng.random((h, w, 3), np.float32)),
        depth=t(depth).to(torch.uint16),
        normal=t(normal).to(torch.uint8),
        albedo=t(rng.random((h, w, 3), np.float32)),
        emission=t(rng.random((h, w, 3), np.float32) * 0.1),
        fog=t(rng.random((h, w, 3), np.float32)),
    )


def phase_k2(torch, dev, blue):
    """K2's chain (6 passes, finalize fused) against the plain chain."""
    from raytrace_tpu_torch.ops import denoise

    gb = _random_gbuffers(torch, dev, H, W, seed=7)
    got = denoise.denoise_finalize(gb, blue)
    want = denoise.denoise_finalize_plain(gb, blue)
    err = float(torch.abs(got - want).max())
    return err <= 3e-5, dict(size=H, max_abs_err=err, atol=3e-5), gb


def phase_golden(rt, torch, dev):
    """The committed 64² golden frame through the port's kernel path."""
    import numpy as np

    from raytrace_tpu_torch.ops.hf_tables import build_hf_tables
    from raytrace_tpu_torch.render.pipeline import render_frame
    from raytrace_tpu_torch.testing.golden import compare_images

    u = _canonical_uniforms(rt)
    packed = torch.from_numpy(u.packed()).to(dev)
    frame, _ = render_frame(build_hf_tables((0, 0, 0), device=dev),
                            _blue_noise(torch, dev), packed, 64, 64)
    want = np.load(ROOT / "tests" / "goldens" / "terrain_frame_64.npz")["frame"]
    stats = compare_images(frame.cpu().numpy(), want)
    return bool(stats["ok"]), stats


def phase_main(rt, torch):
    """The main path: 20 frames at 1024² through create_instance/draw_frame."""
    from raytrace_tpu_torch.ops import denoise, lighting
    from raytrace_tpu_torch.render.camera import Camera

    pipe = rt.create_instance(width=W, height=H)
    cam = Camera(origin=list(CANON["origin"]))
    cam.pitch = CANON["pitch"]
    pipe.teleport(cam)
    base = list(cam.origin)
    pipe.converge_streaming((base[0], 0, base[2]), max_moves=32)
    torch.cuda.synchronize()
    lighting.march_paths.launches = 0
    denoise.denoise_pass.launches = 0
    finite, exhausted = [], []
    t0 = time.perf_counter()
    for t in range(FRAMES):
        cam.origin = [base[0] + 0.03 * t, base[1] + 0.03 * t, base[2]]
        frame = pipe.draw_frame(cam, CANON["sun"] + 0.01 * t)
        finite.append(torch.isfinite(frame).all())
        exhausted.append((pipe.gbuffers["depth"].to(torch.int32)
                          == lighting.EXHAUSTED_DEPTH).sum())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    k1, k2 = lighting.march_paths.launches, denoise.denoise_pass.launches
    res = dict(
        frames=FRAMES, shape=list(frame.shape), ms_per_frame=ms,
        all_finite=bool(torch.stack(finite).all()),
        exhausted_px=int(torch.stack(exhausted).sum()),
        k1_launches=k1, k2_launches=k2, lr=list(pipe.uniforms.lr),
    )
    ok = (res["all_finite"] and res["exhausted_px"] == 0 and k1 >= FRAMES
          and k2 == len(denoise.DENOISE_SIZES) * FRAMES and tuple(frame.shape) == (H, W, 3))
    return ok, res, pipe


def phase_times(rt, torch, dev, pipe, gb_rand, blue):
    """Kernel against plain at 1024²: whole frame, K1 alone, K2 alone, on
    the main path's own tables and uniforms."""
    from raytrace_tpu_torch.ops import denoise, lighting
    from raytrace_tpu_torch.render.pipeline import render_frame, unpack_uniforms

    packed = torch.from_numpy(pipe.uniforms.packed()).to(dev)
    tables = pipe.tables()
    budget = (pipe.max_steps, pipe.seed, 1 + 2 * pipe.bounces)
    frame_ms = _cuda_ms(torch, lambda: render_frame(
        tables, pipe.blue_noise, packed, W, H, *budget[:2], pipe.bounces), reps=10)
    inputs = lighting.march_inputs(
        tables, pipe.blue_noise, unpack_uniforms(packed), W, H)

    def plain_frame():
        inputs = lighting.march_inputs(
            tables, pipe.blue_noise, unpack_uniforms(packed), W, H)
        meta, pd = lighting.march_paths_plain(*inputs["march"], *budget)
        gb = lighting.shade(meta, pd, **inputs["shade"])
        return denoise.denoise_finalize_plain(gb, pipe.blue_noise)

    return dict(
        frame_ms=frame_ms, plain_frame_ms=_cuda_ms(torch, plain_frame, reps=1),
        k1_ms=_cuda_ms(
            torch, lambda: lighting.march_paths(*inputs["march"], *budget), reps=10),
        k1_plain_ms=_cuda_ms(
            torch, lambda: lighting.march_paths_plain(*inputs["march"], *budget),
            reps=1),
        k2_chain_ms=_cuda_ms(
            torch, lambda: denoise.denoise_finalize(gb_rand, blue), reps=10),
        k2_chain_plain_ms=_cuda_ms(
            torch, lambda: denoise.denoise_finalize_plain(gb_rand, blue), reps=2),
    )


def phase_volume_times(torch, dev, pipe):
    """K3 against its plain version at 1024² on the volume path's own
    volume, tables and uniforms (plain: one rep), and the whole
    volume_fast frame."""
    from raytrace_tpu_torch.ops import path_vol, trace_vol
    from raytrace_tpu_torch.render.pipeline import render_frame, unpack_uniforms

    packed = torch.from_numpy(pipe.uniforms.packed()).to(dev)
    world = pipe.world()
    legs = path_vol.legs_of(pipe.bounces)
    inputs = path_vol.march_inputs(
        world[1], pipe.blue_noise, unpack_uniforms(packed), W, H)
    return dict(
        vol_frame_ms=_cuda_ms(torch, lambda: render_frame(
            world, pipe.blue_noise, packed, W, H, pipe.max_steps, pipe.seed,
            pipe.bounces, "volume_fast"), reps=10),
        k3_ms=_cuda_ms(torch, lambda: trace_vol.march_paths_vol(
            *inputs["march"], pipe.max_steps, legs), reps=10),
        k3_plain_ms=_cuda_ms(torch, lambda: trace_vol.march_paths_vol_plain(
            *inputs["march"], pipe.max_steps, legs), reps=1),
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    if not (ROOT / "raytrace_tpu_torch" / "csrc").is_dir() \
            or not (ROOT / "raytrace_tpu" / "constants.py").is_file():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import raytrace_tpu_torch as rt
    import raytrace_tpu_torch.render.pipeline  # noqa: F401
    from raytrace_tpu_torch import _build
    from raytrace_tpu_torch.ops import denoise
    from raytrace_tpu_torch.ops.hf_tables import build_hf_tables
    from raytrace_tpu_torch.render.pipeline import get_blue_noise_f32

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed = []

    def report(name, ok, res):
        print(f"[{name}] {'PASS' if ok else 'FAIL'} {json.dumps(res)}", flush=True)
        if not ok:
            failed.append(name)

    card = _card()
    name = torch.cuda.get_device_name(0)
    bn_sha = hashlib.sha256(get_blue_noise_f32().tobytes()).hexdigest()
    print(card, flush=True)
    report("device", True, dict(card=card, torch_name=name,
                                torch=torch.__version__, cuda=torch.version.cuda,
                                blue_noise_sha256=bn_sha))

    t0 = time.perf_counter()
    _build.build()
    build = dict(_build.build_info)
    _build.kernels()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in build.get("log", "").splitlines() if "registers" in ln]
    report("build", True, dict(seconds=build_s, nvcc_seconds=build["seconds"],
                               cached=build["cached"], ptxas=regs))

    if "jax" in sys.modules:
        raise RuntimeError("chip_smoke imported jax")

    blue = _blue_noise(torch, dev)
    canon = torch.from_numpy(_canonical_uniforms(rt).packed()).to(dev)
    canon_tables = build_hf_tables((0, 0, 0), seed=0, device=dev)
    for bounces in (2, 1):
        ok, res = phase_k1(torch, canon_tables, blue, canon, 256, 2048, 0, bounces)
        report(f"k1_vs_plain_b{bounces}", ok, res)
    ok, k2_res, gb_rand = phase_k2(torch, dev, blue)
    report("k2_vs_plain", ok, k2_res)
    ok, res = phase_golden(rt, torch, dev)
    report("golden_64", ok, res)
    ok, main_res, pipe = phase_main(rt, torch)
    report("main_path", ok, main_res)
    # K1 once more at the main path's own size, region and uniforms.
    ok, k1_res = phase_k1(
        torch, pipe.tables(), pipe.blue_noise,
        torch.from_numpy(pipe.uniforms.packed()).to(dev), W,
        pipe.max_steps, pipe.seed, pipe.bounces)
    report("k1_vs_plain_main", ok, k1_res)
    times = phase_times(rt, torch, dev, pipe, gb_rand, blue)

    # The volume path: K3 at 256² on two scenes, then the main path.
    from raytrace_tpu_torch.ops.vol_tables import build_vol_tables

    for scene, (volume, view) in _volumes(torch, dev).items():
        tables = build_vol_tables(volume)
        packed = torch.from_numpy(_canonical_uniforms(rt, view, seed=7).packed()).to(dev)
        for bounces in (0, 1, 2):
            ok, res = phase_k3(torch, volume, tables, blue, packed, 256, 2048, bounces)
            report(f"k3_vs_plain_{scene}_b{bounces}", ok, res)
    ok, vol_res, vpipe = phase_volume_main(rt, torch)
    report("volume_main", ok, vol_res)
    # K3 once more at the volume path's own size, volume, tables and uniforms.
    ok, k3_res = phase_k3(
        torch, vpipe.streamer.volume, vpipe.vol_tables(), vpipe.blue_noise,
        torch.from_numpy(vpipe.uniforms.packed()).to(dev), W, vpipe.max_steps,
        vpipe.bounces)
    report("k3_vs_plain_main", ok, k3_res)
    times.update(phase_volume_times(torch, dev, vpipe))
    report("times", True, dict(card=card, size=H, **times))
    ok, res = phase_volume_edit(torch, vpipe)
    report("volume_edit", ok, res)
    if "jax" in sys.modules:
        raise RuntimeError("chip_smoke imported jax")

    passes = len(denoise.DENOISE_SIZES)  # K2's ms is the mean of one chain's passes
    kernels = [
        dict(name="K1 march_paths (whole-path lighting march)", route="cuda",
             source="raytrace_tpu_torch/csrc/lighting.cu",
             replaces="raytrace_tpu/ops/lighting_pallas.py:143",
             launches=main_res["k1_launches"], max_abs_err=k1_res["max_abs_err"],
             ms=times["k1_ms"], plain_ms=times["k1_plain_ms"]),
        dict(name="K2 denoise_pass (a-trous pass, finalize fused)", route="cuda",
             source="raytrace_tpu_torch/csrc/denoise.cu",
             replaces="raytrace_tpu/ops/denoise_pallas.py:132",
             launches=main_res["k2_launches"], max_abs_err=k2_res["max_abs_err"],
             ms=times["k2_chain_ms"] / passes,
             plain_ms=times["k2_chain_plain_ms"] / passes),
        dict(name="K3 march_paths_vol (whole-path volume_fast march)", route="cuda",
             source="raytrace_tpu_torch/csrc/trace_vol.cu",
             replaces="raytrace_tpu/ops/trace_vol_pallas.py:254",
             launches=vol_res["k3_launches"], max_abs_err=k3_res["max_abs_err"],
             ms=times["k3_ms"], plain_ms=times["k3_plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    if failed:
        raise SystemExit(f"chip_smoke: failed phases: {failed}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
