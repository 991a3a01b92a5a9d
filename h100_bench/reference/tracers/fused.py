"""The heightfield world: the region's tables with the column table
(``build_hf_tables_plain`` + ``with_column_heights``), the whole-path
heightfield march and its shade."""

from __future__ import annotations

from ..ops import lighting
from ..ops.hf_tables import build_hf_tables_plain, with_column_heights
from ..precision import store


def world(seed: int, lr, device) -> dict:
    return with_column_heights(build_hf_tables_plain(lr, seed, device), seed)


def gbuffers(world_: dict, noise, uni: dict, width: int, height: int, max_steps: int,
             seed: int, bounces: int, row0: int = 0, rows: int | None = None) -> dict:
    f = lighting.march_inputs(world_, noise, uni, width, height, row0, rows)
    meta, pdist = lighting.march_paths_plain(*f["march"], max_steps, seed,
                                             1 + 2 * bounces)[:2]
    return lighting.shade_plain(meta, store(pdist), **f["shade"])
