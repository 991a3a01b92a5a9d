"""Golden-image comparison and PNG files.

``compare_images`` is a copy of ``raytrace_tpu/testing/golden.py:13-40``,
whose package imports JAX.  ``save_png`` ports ``:43-55`` without Pillow,
which the GPU machine does not have: it writes the PNG with the standard
library (8-bit RGB, one IDAT, filter 0 on every row, zlib at
``compress_level``).  ``read_png`` reads such files back.

The reference validated rendering visually (SURVEY §4); here frames are
compared numerically with tolerances that absorb f32 associativity and rare
borderline DDA-axis flips between independent implementations.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def compare_images(
    got: np.ndarray,
    want: np.ndarray,
    *,
    tol: float = 1e-3,
    max_bad_frac: float = 0.005,
    max_mean_err: float = 1e-3,
) -> dict:
    """Compare two float images; returns stats dict with 'ok' bool.

    A pixel is "bad" if any channel differs by more than `tol`.  The image
    passes if at most `max_bad_frac` of pixels are bad AND the mean absolute
    error is below `max_mean_err` (borderline ray flips perturb isolated
    pixels strongly; both bounds together catch real regressions).
    """
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want)
    per_pixel = err.reshape(err.shape[0], err.shape[1], -1).max(-1)
    bad_frac = float((per_pixel > tol).mean())
    mean_err = float(err.mean())
    return {
        "ok": bad_frac <= max_bad_frac and mean_err <= max_mean_err,
        "bad_frac": bad_frac,
        "mean_err": mean_err,
        "max_err": float(err.max()),
    }


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path, image: np.ndarray, compress_level: int = 6) -> None:
    """Save a float [0,1] (or already-uint8) (H, W, 3) image as PNG.

    compress_level: zlib level (6 is Pillow's default).  Level 1 is ~4x
    cheaper to encode for ~15% bigger files: the right trade where
    encoding, not rendering, bounds dataset-capture throughput.
    """
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"save_png wants an (H, W, 3) image, got {arr.shape}")
    h, w, _ = arr.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0, then the row
    rows[:, 1:] = arr.reshape(h, 3 * w)
    png = (_PNG_SIGNATURE
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), compress_level))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def read_png(path) -> np.ndarray:
    """The (H, W, 3) uint8 pixels of a PNG that ``save_png`` wrote (8-bit
    RGB, not interlaced, filter 0 on every row); raises on any other."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, header, idat = 8, None, []
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", blob[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: want 8-bit RGB without interlace, got {header}")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row uses a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()
