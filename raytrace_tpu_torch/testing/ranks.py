"""The tile split on ``ranks`` CPU processes over gloo.

``render_tiled_gloo(ranks, work_dir, **kwargs)`` spawns one process per
rank (``torch.multiprocessing.spawn``), each on one thread, joins them in a
gloo group through a file store in ``work_dir`` (no port), runs
``parallel.tiles.render_frame_tiled(**kwargs, group=None)`` on CPU tensors
and returns every rank's frame.  The arguments and the frames pass through
files in ``work_dir``.
"""

from __future__ import annotations

from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, ranks: int, work_dir: str) -> None:
    from ..parallel.tiles import render_frame_tiled

    torch.set_num_threads(1)
    work = Path(work_dir)
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            world_size=ranks, rank=rank)
    try:
        kwargs = torch.load(work / "inputs.pt", weights_only=True)
        frame = render_frame_tiled(**kwargs)
        torch.save(frame, work / f"frame_{rank}.pt")
    finally:
        dist.destroy_process_group()


def render_tiled_gloo(ranks: int, work_dir, **kwargs) -> list:
    """Every rank's (H, W, 3) frame of ``render_frame_tiled(**kwargs)`` run
    on ``ranks`` gloo processes; ``work_dir`` must be a fresh directory."""
    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    torch.save(kwargs, work / "inputs.pt")
    mp.spawn(_rank_main, args=(ranks, str(work)), nprocs=ranks, join=True)
    return [torch.load(work / f"frame_{r}.pt", weights_only=True) for r in range(ranks)]
