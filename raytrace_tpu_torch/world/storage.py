"""Chunk disk cache: generate-or-load packed chunk data.

Port of ``raytrace_tpu/world/storage.py:50-130``: ``default_storage_dir``,
``ChunkStorage.path_for`` (16-digit hex names), the container (magic
``RTL4`` for an LZ4 block body from ``native``, ``RTZL`` for the zlib
fallback, then the little-endian raw length) over the payload
``[materials: <u4 x 64^3][minefield: u8 x 64^3]``, and generate-or-load
with warn-and-regenerate on a corrupt file.  The files are byte-identical
to the JAX package's, and the directory is the same, so a cache written by
one package is read by the other.

A miss generates the chunk with the port's ``world.generate.generate_chunk``
on the storage's ``device``: "cuda" (the default) raises without a GPU, as
``Pipeline`` does; "cpu" generates on the host.  The port holds packed
materials as int32 words: they are viewed as uint32 to be written and read
back as int32, never converted.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

import numpy as np

from .._device import default_device
from ..constants import CHUNK_SIZE, CHUNK_VOLUME
from ..native import lz4_available, lz4_compress, lz4_decompress

_MAGIC_LZ4 = b"RTL4"
_MAGIC_ZLIB = b"RTZL"
_MAT_BYTES = CHUNK_VOLUME * 4
_MIN_BYTES = CHUNK_VOLUME
_RAW_BYTES = _MAT_BYTES + _MIN_BYTES
_SHAPE = (CHUNK_SIZE,) * 3


def default_storage_dir() -> Path:
    """``$RAYTRACE_TPU_HOME/world``, else ``$XDG_CONFIG_HOME/raytrace_tpu/world``
    (``~/.config`` when unset): the JAX package's directory."""
    base = os.environ.get("RAYTRACE_TPU_HOME")
    if base:
        return Path(base) / "world"
    config = os.environ.get("XDG_CONFIG_HOME", str(Path.home() / ".config"))
    return Path(config) / "raytrace_tpu" / "world"


def _words_u32(materials: np.ndarray) -> np.ndarray:
    """The packed-material words as a contiguous uint32 array: int32 words
    (the port's) are viewed, not converted."""
    words = np.ascontiguousarray(materials)
    if words.dtype == np.int32:
        words = words.view(np.uint32)
    if words.dtype != np.uint32:
        raise ValueError(f"materials must hold int32 or uint32 words, got {words.dtype}")
    return words


class ChunkStorage:
    """Generate-or-load packed chunk data with an on-disk cache."""

    def __init__(self, storage_dir: str | Path | None = None, seed: int = 0,
                 device="cuda"):
        self.device = default_device(device, "ChunkStorage")
        self.storage_dir = Path(storage_dir) if storage_dir else default_storage_dir()
        self.storage_dir.mkdir(parents=True, exist_ok=True)
        self.seed = seed

    def path_for(self, coord) -> Path:
        """The file of a chunk (reference chunk_storage.rs:37-40)."""
        x, y, z = (int(c) & 0xFFFFFFFFFFFFFFFF for c in coord)
        return self.storage_dir / f"{x:016X}{y:016X}{z:016X}"

    def has_chunk(self, coord) -> bool:
        return self.path_for(coord).exists()

    @staticmethod
    def _encode(materials: np.ndarray, minefield: np.ndarray) -> bytes:
        """The container of one chunk: (Z, Y, X) packed materials (int32 or
        uint32 words) and the uint8 minefield."""
        raw = _words_u32(materials).astype("<u4", copy=False).tobytes() \
            + minefield.astype(np.uint8, copy=False).tobytes()
        if lz4_available():
            body, magic = lz4_compress(raw), _MAGIC_LZ4
        else:
            body, magic = zlib.compress(raw, 4), _MAGIC_ZLIB
        return magic + struct.pack("<I", len(raw)) + body

    @staticmethod
    def _decode(blob: bytes) -> tuple[np.ndarray, np.ndarray]:
        """-> (materials int32 (Z, Y, X), minefield uint8 (Z, Y, X))."""
        magic, (raw_len,) = blob[:4], struct.unpack("<I", blob[4:8])
        body = blob[8:]
        if magic == _MAGIC_LZ4:
            raw = lz4_decompress(body, raw_len)
        elif magic == _MAGIC_ZLIB:
            raw = zlib.decompress(body)
        else:
            raise ValueError(f"bad chunk magic {magic!r}")
        if len(raw) != _RAW_BYTES:
            raise ValueError(f"bad chunk payload size {len(raw)}")
        materials = np.frombuffer(raw[:_MAT_BYTES], dtype="<u4").view(np.int32)
        minefield = np.frombuffer(raw[_MAT_BYTES:], dtype=np.uint8)
        return materials.reshape(_SHAPE).copy(), minefield.reshape(_SHAPE).copy()

    def _generate(self, coord) -> tuple[np.ndarray, np.ndarray]:
        from .generate import generate_chunk

        materials, minefield = generate_chunk(coord, seed=self.seed, device=self.device)
        return materials.cpu().numpy(), minefield.cpu().numpy()

    def _generate_and_store(self, coord):
        materials, minefield = self._generate(coord)
        try:
            self.path_for(coord).write_bytes(self._encode(materials, minefield))
        except OSError as err:
            # Warn-and-continue (reference chunk_storage.rs:84-90).
            print(f"WARNING: Failed to write chunk data for {coord}: {err}")
        return materials, minefield

    def borrow_packed_chunk_data(self, coord) -> tuple[np.ndarray, np.ndarray]:
        """(materials int32 (Z, Y, X), minefield uint8 (Z, Y, X)) of a chunk:
        read from its file, or generated and stored on a miss; a corrupt
        file warns and is regenerated (reference chunk_storage.rs:95-151)."""
        path = self.path_for(coord)
        if path.exists():
            try:
                return self._decode(path.read_bytes())
            except (ValueError, OSError, zlib.error) as err:
                print(f"WARNING: Failed to read chunk data for {coord}: {err}")
        return self._generate_and_store(coord)
