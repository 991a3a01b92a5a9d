"""Build and load the CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together) and links the objects into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use and again whenever a file under ``csrc/`` (a source or a
header such as ``heightfield.cuh``) or the flags change: the library's
name carries a hash of all of them.  It lands in ``build/`` beside this
file, which ``.gitignore`` lists.  Nothing includes PyTorch's headers, so a
build takes seconds.

``--fmad=false`` keeps every multiply and add a separate rounding, as the
plain PyTorch versions compute them, so the marches K1, K3, K3s and K4 and
the exact DDA D1 agree with their plain versions step for step, T1's table
words and G1's voxel words are the plain versions', K2's sums round as the
plain pass's, and the frame's rays (R1), shades (S1, S3), the staged
frames' leg batches (P1) and shade (S2) and finalize alone (F1) are the
plain glue's bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_ROOT = Path(__file__).parent
_CSRC = _ROOT / "csrc"
BUILD_DIR = _ROOT / "build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "--fmad=false",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # origin, direction, nw, iscal, fscal, trig, hsub, h3, hcol, meta, pd,
    # n, max_steps, seed, legs, census, stream
    "rt_march_paths": [_P] * 11 + [_I] * 4 + [_P] * 2,
    # light, depth, normal, in, out, frame, h, w, size, r0, rows,
    # dither_row0, albedo, emission, fog, noise, nh, nw, nch, stream
    "rt_denoise_pass": [_P] * 6 + [_I] * 6 + [_P] * 4 + [_I] * 3 + [_P],
    # albedo, emission, fog, light, lstride, depth, noise, frame, h, w, row0,
    # flip, nh, nw, nch, stream
    "rt_finalize": [_P] * 4 + [_I] + [_P] * 3 + [_I] * 7 + [_P],
    # origin, direction, inv, iscal, fscal, any8, all8, any_hi, detail,
    # meta, prim_lin, dif1_lin, prim_dist, n, budget, legs, next, census,
    # stream
    "rt_march_paths_vol": [_P] * 13 + [_I] * 3 + [_P] * 3,
    # origin, direction, active, iscal, hsub, h3, cA, cB, cC, cD, pos,
    # normal, air, packed, n, budget, seed, next, census, stream
    "rt_trace_hf": [_P] * 14 + [_I] * 3 + [_P] * 3,
    # origin, direction, active, iscal, any8, all8, any_hi, detail, pos,
    # normal, air, done, n, rounds, steps, next, census, stream
    "rt_trace_rays_vol": [_P] * 12 + [_I] * 3 + [_P] * 3,
    # origin, direction, active, volume, lr, pos, normal, air, mat, n,
    # max_steps, steps, census, touched, stream
    "rt_trace_dda": [_P] * 9 + [_I] * 2 + [_P] * 4,
    # packed, lr, seed, key, h3, hsub, cA, cB, cC, cD, r0, hcol, stream
    "rt_hf_tables": [_P] * 2 + [_I] + [_P] * 10,
    # volume, x0, y0, z0, sx, sy, sz, seed, grass, rock, snow, stream
    "rt_worldgen": [_P] + [_I] * 10 + [_P],
    # materials, minefield, solid, x0, y0, z0, sx, sy, sz, seed, grass,
    # rock, snow, stream
    "rt_worldgen_box": [_P] * 3 + [_I] * 10 + [_P],
    # x0, y0, sx, sy, sz, grid (3,) int32 out
    "rt_worldgen_grid": [_I] * 5 + [_P],
    # blocks_x, blocks_y, threads, cluster, stream
    "rt_launch_floor": [_I] * 4 + [_P],
    # volume, detail, any8b, all8b, any8, all8, any_hi, bz0, nbz, by0, nby,
    # bx0, nbx, stream
    "rt_vol_tables": [_P] * 7 + [_I] * 6 + [_P],
    # cam, forward, up, right, sun_angle, seed, lr, blue, trig, h3, r0,
    # any8b, origin, direction, nw, inv, iscal, fscal, sun, width, height,
    # row0, rows, nh, nw, nch, form, grass, rock, snow, stream
    "rt_frame_rays": [_P] * 19 + [_I] * 11 + [_P],
    # meta, pd, direction, nw, sun, trig, table, lighting, albedo, emission,
    # fog, depth, normal, n, grass, rock, snow, stream
    "rt_shade_fused": [_P] * 13 + [_I] * 4 + [_P],
    # meta, prim_lin, dif1_lin, prim_dist, direction, inv, sun, volume,
    # lighting, albedo, emission, fog, depth, normal, n, legs, stream
    "rt_shade_vol": [_P] * 14 + [_I] * 2 + [_P],
    # pos, normal, air, mat, prev_active, nw, inv, sun, trig, origin,
    # direction, active, n, off, bounce, mode, stream
    "rt_leg_batch": [_P] * 12 + [_I] * 4 + [_P],
    # pos0, normal0, air0, mat0, dir0, pos1, air1, mat1, dir1, air2, dir2,
    # sun, cam, volume, lighting, albedo, emission, fog, depth, normal, n,
    # bounces, mode, stream
    "rt_shade_staged": [_P] * 20 + [_I] * 3 + [_P],
}

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources() -> list[Path]:
    """The translation units: every ``csrc/*.cu``."""
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    """The library's path, named by a hash of the flags and of every file
    under ``csrc/`` (sources and the headers they include)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in _CSRC.rglob("*") if p.is_file()):
        h.update(f.relative_to(_CSRC).as_posix().encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libraytrace_kernels_{h.hexdigest()[:16]}.so"


def _run_together(cmds: list[list[str]]) -> list[tuple[int, str]]:
    """Start every command at once; -> (return code, output) of each, in
    order."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    outputs = [p.communicate()[0] for p in procs]
    return [(p.returncode, output) for p, output in zip(procs, outputs)]


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    steps = [[[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
              for src, o in zip(sources(), objs)],
             [[nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]]]
    t0 = time.perf_counter()
    log = ""
    try:
        for cmds in steps:
            for cmd, (rc, output) in zip(cmds, _run_together(cmds)):
                log += " ".join(cmd) + "\n" + output
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n{log}")
    finally:
        out.with_suffix(".log").write_text(log)
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      cached=False, log=log)
    return out


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: the only layout a kernel's raw pointer can take."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want {dtype} {tuple(shape)} contiguous on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}"
        )


def check_launch(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError`` from a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
