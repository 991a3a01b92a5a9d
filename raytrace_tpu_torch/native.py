"""ctypes bindings for the host codec and block copy (``native/raytrace_native.cpp``).

Port of ``raytrace_tpu/native.py:37-137``, with its own copy of the C++
source (``raytrace_tpu_torch/native/raytrace_native.cpp``): the LZ4 block
codec of the chunk disk cache and a strided clipped 3-D copy for host-side
slab assembly.  The library is built at first use with the system ``g++``
and the flags of the JAX package's ``native/Makefile``, into ``build/``
beside this file (which ``.gitignore`` lists), under a name hashed from the
source and the flags, as ``_build.py`` does for the CUDA kernels.

When no compiler can build it, ``lz4_available()`` is false and the cache
writes zlib (``RTZL``) containers, as the JAX package does; ``copy3d``
then falls back to ``utils.coords.copy_3d_clipped``.  This is host code,
not a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).parent
SOURCE = _ROOT / "native" / "raytrace_native.cpp"
BUILD_DIR = _ROOT / "build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
_lock = threading.Lock()
_lib = None
_tried = False
build_error: str | None = None  # why the last build failed, if it did


def library_path() -> Path:
    """The library's path, named by a hash of the source and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libraytrace_native_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Compile the library into ``out`` (a temporary name, then a rename, so
    that processes building at once never load a half-written file)."""
    global build_error
    cxx = shutil.which("g++")
    if cxx is None:
        build_error = "no C++ compiler (g++) on PATH"
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, text=True, timeout=120)
    except subprocess.CalledProcessError as err:
        build_error = f"{cxx} failed ({err.returncode}): {err.stderr}"
        return False
    except (OSError, subprocess.SubprocessError) as err:
        build_error = f"{cxx} did not run: {err}"
        return False
    os.replace(tmp, out)
    return True


def _load():
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as err:
            build_error = f"cannot load {path}: {err}"
            return None
        lib.rt_lz4_compress_bound.restype = ctypes.c_int
        lib.rt_lz4_compress_bound.argtypes = [ctypes.c_int]
        lib.rt_lz4_compress.restype = ctypes.c_int
        lib.rt_lz4_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.rt_lz4_decompress.restype = ctypes.c_int
        lib.rt_lz4_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.rt_copy3d.restype = None
        lib.rt_copy3d.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                  *[ctypes.POINTER(ctypes.c_int64)] * 5]
        _lib = lib
        return _lib


def lz4_available() -> bool:
    """True when the library built and loaded: the cache then writes LZ4
    (``RTL4``) containers, else zlib (``RTZL``) ones."""
    return _load() is not None


def lz4_compress(data: bytes) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native LZ4 unavailable: {build_error}")
    cap = lib.rt_lz4_compress_bound(len(data))
    out = (ctypes.c_uint8 * cap)()
    n = lib.rt_lz4_compress(data, len(data), out, cap)
    if n < 0:
        raise RuntimeError("LZ4 compression failed")
    return bytes(bytearray(out)[:n])


def lz4_decompress(data: bytes, decompressed_size: int) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native LZ4 unavailable: {build_error}")
    out = (ctypes.c_uint8 * decompressed_size)()
    n = lib.rt_lz4_decompress(data, len(data), out, decompressed_size)
    if n != decompressed_size:
        raise ValueError(f"LZ4 decompression failed (got {n})")
    return bytes(out)


def copy3d(src: np.ndarray, dst: np.ndarray, size, src_start=(0, 0, 0),
           dst_start=(0, 0, 0)) -> None:
    """Clipped 3-D block copy between C-contiguous (Z, Y, X) numpy arrays of
    one dtype, in place.  Coordinates in (x, y, z) order.  Uses the native
    memcpy loop when the library is loaded, else the numpy version in
    ``utils.coords``."""
    lib = _load()
    if lib is None or not src.flags.c_contiguous or not dst.flags.c_contiguous:
        from .utils.coords import copy_3d_clipped

        copy_3d_clipped(src, dst, tuple(size), tuple(src_start), tuple(dst_start))
        return
    if src.dtype != dst.dtype:
        raise ValueError(f"copy3d: {src.dtype} source, {dst.dtype} destination")
    arr3 = lambda t: (ctypes.c_int64 * 3)(*[int(v) for v in t])
    sdim = (src.shape[2], src.shape[1], src.shape[0])
    ddim = (dst.shape[2], dst.shape[1], dst.shape[0])
    lib.rt_copy3d(src.ctypes.data, dst.ctypes.data, int(src.dtype.itemsize), arr3(sdim),
                  arr3(ddim), arr3(size), arr3(src_start), arr3(dst_start))
