"""The resident 256^3 volume of the region (world box ``lr - 128 .. lr +
128`` on each axis, world voxel ``w`` at texel ``(w + 128) & 255``), its
occupancy tables, the brick-pyramid march and its shade."""

from __future__ import annotations

import torch

from ..constants import ROOT_BLOCK_SIZE
from ..ops import path_vol, trace_vol
from ..ops.vol_tables import build_vol_tables_plain
from ..ops.worldgen import generate_into_plain
from ..precision import store

_HALF = ROOT_BLOCK_SIZE // 2


def world(seed: int, lr, device) -> dict:
    volume = torch.zeros(ROOT_BLOCK_SIZE ** 3, dtype=torch.int32, device=device)
    generate_into_plain(volume, [v - _HALF for v in lr], (ROOT_BLOCK_SIZE,) * 3, seed)
    return dict(volume=volume, **build_vol_tables_plain(volume))


def gbuffers(world_: dict, noise, uni: dict, width: int, height: int, max_steps: int,
             seed: int, bounces: int, row0: int = 0, rows: int | None = None) -> dict:
    legs = 1 + 2 * bounces
    tables = {k: v for k, v in world_.items() if k != "volume"}
    f = path_vol.march_inputs(tables, noise, uni, width, height, row0, rows)
    meta, prim_lin, dif1_lin, prim_dist = trace_vol.march_paths_vol_plain(
        *f["march"], max_steps, legs)[:4]
    return path_vol.shade_plain(world_["volume"], meta, prim_lin, dif1_lin, store(prim_dist),
                                legs=legs, **f["shade"])
