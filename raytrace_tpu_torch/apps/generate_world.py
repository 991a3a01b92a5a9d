"""Offline world pre-generation CLI.

Port of ``raytrace_tpu/apps/generate_world.py:25-55``.  Reference:
src/bin/generate.rs: iterate a RADIUS=32 cube of chunks (64^3 chunks),
force each into the disk cache, print % complete and ETA.

Chunks are generated on the card one x-row of chunks per ``generate_box``
call and written through ``ChunkStorage`` (LZ4 when the codec builds); a
64^3-chunk world is ~16.7 G voxels, so the default radius here is smaller:
pass --radius 32 for the full reference sweep.  The cache directory is the
JAX package's (``world.storage.default_storage_dir``).

Usage: python -m raytrace_tpu_torch.apps.generate_world [--radius N] [--dir PATH]
(needs a CUDA GPU)
"""

from __future__ import annotations

import argparse

from ..constants import CHUNK_SIZE
from ..utils.perf import StatTracker
from ..world.generate import generate_box
from ..world.storage import ChunkStorage


def run(radius: int = 4, storage_dir=None, seed: int = 0, print_every: int = 64,
        device="cuda") -> StatTracker:
    """Write every chunk of the cube [-radius, radius)^3 that the cache lacks.
    ``device``: where the chunks are generated ("cuda" raises without a
    GPU; "cpu" for tests)."""
    storage = ChunkStorage(storage_dir, seed=seed, device=device)
    side = radius * 2
    tracker = StatTracker(side * side * side, "chunks")
    for cz in range(-radius, radius):
        for cy in range(-radius, radius):
            # A whole x-row of chunks in one call.
            box = generate_box(
                (-radius * CHUNK_SIZE, cy * CHUNK_SIZE, cz * CHUNK_SIZE),
                (side * CHUNK_SIZE, CHUNK_SIZE, CHUNK_SIZE),
                seed=seed, device=storage.device,
            )
            mats = box["materials"].cpu().numpy()
            mf = box["minefield"].cpu().numpy()
            for ci in range(side):
                coord = (ci - radius, cy, cz)
                if not storage.has_chunk(coord):
                    sl = (slice(None), slice(None),
                          slice(ci * CHUNK_SIZE, (ci + 1) * CHUNK_SIZE))
                    blob = storage._encode(mats[sl], mf[sl])
                    try:
                        storage.path_for(coord).write_bytes(blob)
                    except OSError as err:
                        print(f"WARNING: failed to write {coord}: {err}")
                tracker.advance()
                if tracker.done % print_every == 0:
                    print(f"\r{tracker.status()}   ", end="", flush=True)
    print(f"\n{tracker.status()}")
    return tracker


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--radius", type=int, default=4)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ns = ap.parse_args()
    run(ns.radius, ns.dir, ns.seed)


if __name__ == "__main__":
    main()
