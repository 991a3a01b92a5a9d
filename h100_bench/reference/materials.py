"""[Frozen copy of ``raytrace_tpu_torch/materials.py`` for the benchmark's reference:
its plain PyTorch code only, without the kernel wrappers.]

Material system.

The port's own copy of ``raytrace_tpu/materials.py``, reading its own copy
of the CSV (``data/materials.csv``); a test holds the tables equal to the
JAX package's.  The reference generates its material table at build time
from a CSV (reference: build.rs:17-209, misc/materials.csv, generated
src/render/GEN_MATERIALS.rs).  Here the CSV is parsed at import time into
arrays instead of codegen.

Packing format (bit-faithful to reference GEN_MATERIALS.rs:44-51):
  packed u32 = (solid << 15) | (albedo_r << 14) | (albedo_g << 7) | albedo_b
where each albedo channel is 7 bits (the CSV's 8-bit value divided by 2,
reference build.rs:186-207).  Note the documented quirk: the solid bit at
bit 15 overlaps bit 1 of albedo_r's field (albedo_r occupies bits 14-20).
Unpack drops emission entirely (reference GEN_MATERIALS.rs:53-66); the
tracer reads albedo from bits and zeroes emission (raytrace.comp:155-158).
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path

import numpy as np

_CSV_PATH = Path(__file__).parent / "data" / "materials.csv"


@dataclasses.dataclass(frozen=True)
class Material:
    """One material: 7-bit albedo channels, emission, solidity."""

    albedo: tuple[int, int, int]
    emission: tuple[int, int, int]
    solid: bool

    @staticmethod
    def air() -> "Material":
        return Material((0, 0, 0), (0, 0, 0), False)

    @staticmethod
    def black() -> "Material":
        return Material((0, 0, 0), (0, 0, 0), True)

    def pack(self) -> int:
        ar, ag, ab = self.albedo
        albedo = (ar << 14) | (ag << 7) | ab
        return ((1 << 15) | albedo) if self.solid else albedo

    @staticmethod
    def unpack(packed: int) -> "Material":
        albedo = ((packed >> 14) & 0x7F, (packed >> 7) & 0x7F, packed & 0x7F)
        solid = (packed >> 15) & 1 != 0
        return Material(albedo, (0, 0, 0), solid)


def _load_csv(path: Path = _CSV_PATH) -> list[Material]:
    materials = []
    with open(path) as f:
        rows = list(csv.reader(f))
    for row in rows[1:]:
        row = [c.strip() for c in row]
        if len(row) < 8 or not row[0]:
            continue
        _id = int(row[0])
        # 8-bit CSV albedo is pre-divided by 2 into 7-bit storage
        # (reference build.rs:186-207); emission channels are scaled by
        # strength/2 the same way.
        albedo = tuple(int(row[i]) // 2 for i in (1, 2, 3))
        strength = int(row[7])
        emission = tuple(int(row[i]) * strength // 2 for i in (4, 5, 6))
        # Material 0 is air; everything else is solid.
        materials.append(Material(albedo, emission, _id != 0))
    return materials


MATERIALS: list[Material] = _load_csv()
NUM_MATERIALS = len(MATERIALS)

# Tables (numpy; turned into tensors where used).
PACKED_MATERIALS = np.array([m.pack() for m in MATERIALS], dtype=np.uint32)
ALBEDO_TABLE = np.array(
    [[c / 127.0 for c in m.albedo] for m in MATERIALS], dtype=np.float32
)
EMISSION_TABLE = np.array(
    [[c / 127.0 for c in m.emission] for m in MATERIALS], dtype=np.float32
)
SOLID_TABLE = np.array([m.solid for m in MATERIALS], dtype=bool)


def unpack_albedo_np(packed: np.ndarray) -> np.ndarray:
    """Vectorized unpack of the 7-bit albedo channels to [0,1] floats.

    Mirrors the in-kernel decode (reference raytrace.comp:156-158).
    """
    packed = packed.astype(np.uint32)
    r = ((packed >> 14) & 0x7F).astype(np.float32) / 127.0
    g = ((packed >> 7) & 0x7F).astype(np.float32) / 127.0
    b = (packed & 0x7F).astype(np.float32) / 127.0
    return np.stack([r, g, b], axis=-1)
