"""The tile split: a frame rendered as row bands over the ranks of a
``torch.distributed`` process group.

Port of ``raytrace_tpu/parallel/tiles.py`` (``make_tile_mesh``,
``_exchange_halo``, ``_denoise_band_pallas``, ``render_frame_tiled``,
``:45-74, 106-295``), with the group's ranks in place of the 1-D device
mesh:

- the world and the blue noise are replicated: every rank holds them;
- rank ``r`` of ``n`` renders image rows ``r * band .. (r + 1) * band``,
  ``band = height // n``, with its tracer's G-buffer pass and kernel;
- the denoise chain (K2) runs on a region that holds the band and the halo
  rows of its neighbours, then finalizes the band alone with the dither of
  its own image rows;
- the bands' frames are gathered and assembled into the whole frame,
  flipped once, which every rank returns.

The chain's influence radius is ``3 * sum(DENOISE_SIZES) = 117`` rows, so a
band's rows depend only on image rows at most 117 away.  Three plans give
the whole frame's pixels bit for bit:

- one rank: the whole chain on the whole frame;
- bands of at least ``ROW_HALO = 128`` rows: one exchange of ``ROW_HALO``
  rows of lighting, depth and normal with each neighbour; the region
  ``[max(0, row0 - ROW_HALO), min(height, row0 + band + ROW_HALO))`` puts
  K2's edge clamp on the true image border and every other region edge
  more than 117 rows from the band;
- narrower bands: every rank gathers the three G-buffers and runs the
  chain on the whole frame, finalizing its own band.

JAX's third plan (six per-pass exchanges through an XLA stencil,
``_denoise_pass_banded``) exists because the TPU's VMEM chain could not run
on mid-size bands; K2 runs on any region, so it has no counterpart.

On CUDA tensors the tiled frame equals the whole frame bit for bit at any
size.  On CPU tensors it does when the band's and the frame's pixel counts
are multiples of 32: PyTorch's CPU ``pow`` and ``sin`` can give another
last bit in the scalar tail of a vectorized loop than in its body, and a
band's tail falls on other pixels than the whole frame's.  The G-buffer
passes' bands share this condition (``ops/integrate.integrate_gbuffers``
states the bound).

The exchange is kept apart from the band math: ``halo_rows``,
``band_region``, ``denoise_band`` and ``assemble`` are plain functions of
tensors, which ``denoise_tiled`` calls with what the collectives received
and ``denoise_in_turn`` calls band after band in one process with each
halo cut from its neighbour (``chip_smoke.py`` runs the multi-band plans
so on one card, since NCCL takes one rank per GPU).  Depth crosses the
wire as bytes: NCCL and gloo carry no uint16.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..constants import DENOISE_SIZES, MAX_TRACE_STEPS
from ..ops.denoise import denoise_finalize
from ..render.pipeline import frame_gbuffers

# Rows of halo a band takes from each neighbour: the JAX package's
# STRIP_HALO (denoise_pallas.py:68-69).  It must exceed the chain's reach.
ROW_HALO = 128
REACH = 3 * sum(DENOISE_SIZES)  # 117 rows
assert REACH < ROW_HALO, (REACH, ROW_HALO)

# The G-buffers the chain reads around a band (the finalize inputs stay
# with the band).
CHAIN_KEYS = ("lighting", "depth", "normal")


def plan(ranks: int, band: int) -> str:
    """The denoise plan of ``ranks`` bands of ``band`` rows: "whole" (one
    rank), "halo" (one exchange with each neighbour) or "gather"."""
    if ranks == 1:
        return "whole"
    return "halo" if band >= ROW_HALO else "gather"


def halo_rows(gb: dict, side: str) -> dict:
    """The chain's G-buffers of the band's first ("top") or last
    ("bottom") ``ROW_HALO`` rows: what its neighbour above or below needs."""
    rows = slice(0, ROW_HALO) if side == "top" else slice(-ROW_HALO, None)
    return {k: gb[k][rows] for k in CHAIN_KEYS}


def join_rows(parts) -> dict:
    """The chain's G-buffers of consecutive row blocks (``None`` skipped),
    joined in order."""
    parts = [p for p in parts if p is not None]
    return {k: torch.cat([p[k] for p in parts]) for k in CHAIN_KEYS}


def band_region(how: str, rank: int, own: dict, above=None, below=None,
                bands=None) -> tuple:
    """(region, first): the chain's G-buffers of the image rows that band
    ``rank`` is denoised over, and the band's first row in them.  Plan
    "halo": the band ``own`` between the ``ROW_HALO`` rows ``above`` and
    ``below`` it (None at the image border); "gather": every band's
    (``bands``, in rank order)."""
    if how == "halo":
        return join_rows([above, own, below]), 0 if above is None else ROW_HALO
    if how == "gather":
        return join_rows(bands), rank * own["depth"].shape[0]
    raise ValueError(f"plan {how!r} denoises no band region")


def denoise_band(region: dict, first: int, gb: dict, blue_noise: torch.Tensor,
                 row0: int) -> torch.Tensor:
    """The band's finalized (rows, W, 3) frame, flipped over its rows:
    the chain on ``region`` (lighting, depth, normal of consecutive image
    rows that hold the band from region row ``first``), finalized on the
    band with ``gb``'s albedo, emission and fog and the dither of image rows
    ``row0 ..``.  K2 on CUDA tensors, the plain chain on CPU ones."""
    rows = gb["albedo"].shape[0]
    inputs = dict(region, albedo=gb["albedo"], emission=gb["emission"], fog=gb["fog"])
    return denoise_finalize(inputs, blue_noise, window=(first, rows), dither_row0=row0)


def assemble(frames) -> torch.Tensor:
    """The whole frame from the bands' frames in rank order: each is
    flipped over its own rows, so the flipped frame lists them last first."""
    return torch.cat(list(frames)[::-1])


def _empty_like(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor like ``t`` to receive into (``_wire`` of it is a
    view of it)."""
    return torch.empty_like(t, memory_format=torch.contiguous_format)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the collectives carry it: contiguous, uint16 as bytes (a
    view, so a received tensor fills ``t`` when ``t`` is contiguous)."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.uint16 else t


def _exchange(gb: dict, rank: int, ranks: int, group) -> tuple:
    """(rows from above, rows from below) of the band: ``ROW_HALO`` rows of
    the chain's G-buffers from each neighbour (None at the image border),
    in one batch of point-to-point transfers."""
    ops, recv = [], {}
    for side, peer in (("above", rank - 1), ("below", rank + 1)):
        if not 0 <= peer < ranks:
            continue
        mine = halo_rows(gb, "top" if side == "above" else "bottom")
        recv[side] = {k: _empty_like(v) for k, v in mine.items()}
        dst = dist.get_global_rank(group, peer) if group is not None else peer
        for k in CHAIN_KEYS:
            ops.append(dist.P2POp(dist.isend, _wire(mine[k]), dst, group))
            ops.append(dist.P2POp(dist.irecv, _wire(recv[side][k]), dst, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.get("above"), recv.get("below")


def gather_ranks(t: torch.Tensor, ranks: int, group) -> list:
    """Every rank's ``t`` (same shape and type on each), in rank order."""
    parts = [_empty_like(t) for _ in range(ranks)]
    dist.all_gather([_wire(p) for p in parts], _wire(t), group=group)
    return parts


def _ranks(group) -> tuple:
    """(rank, ranks) in ``group``; one rank when no process group is set up."""
    if group is None and not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def render_frame_tiled(world, blue_noise: torch.Tensor, uniforms: dict, width: int,
                       height: int, *, group=None, max_steps: int = MAX_TRACE_STEPS,
                       tracer: str = "volume", seed: int = 0,
                       bounces: int = 2) -> torch.Tensor:
    """The (H, W, 3) frame in window orientation, rendered as row bands
    over the ranks of ``group`` (the default group; one rank when no
    process group is set up) and returned on every rank.

    ``world`` as for ``render/pipeline.render_frame``: the
    ``build_hf_tables`` dict for ``tracer="fused"``/``"hf"``, the (fused
    volume, ``build_vol_tables`` dict) pair for ``"volume_fast"``, the fused
    volume for ``"volume"`` (the default, as JAX's); ``uniforms`` the dict of
    ``render_gbuffers_*``.  The device follows ``blue_noise``: the kernels
    for CUDA tensors, the plain versions for CPU ones.  Equals
    ``denoise_finalize`` of the whole frame's G-buffers bit for bit (on
    CPU tensors when the band's and the frame's pixel counts are multiples
    of 32: see the module's docstring).  ``group`` stands where JAX's
    ``mesh`` does, which has no counterpart, so it and what follows are
    keyword-only.
    """
    gb = band_gbuffers(world, blue_noise, uniforms, width, height, group, max_steps,
                       tracer, seed, bounces)
    return denoise_tiled(gb, blue_noise, height, group)


def _band(height: int, group) -> tuple:
    """(rank, ranks, band rows, the band's first image row)."""
    rank, ranks = _ranks(group)
    if height % ranks:
        raise ValueError(f"height {height} is not a multiple of the {ranks} ranks")
    band = height // ranks
    return rank, ranks, band, rank * band


def band_gbuffers(world, blue_noise: torch.Tensor, uniforms: dict, width: int,
                  height: int, group=None, max_steps: int = MAX_TRACE_STEPS,
                  tracer: str = "volume", seed: int = 0, bounces: int = 2) -> dict:
    """This rank's band's G-buffers (the first half of
    ``render_frame_tiled``, arguments as there)."""
    _, _, band, row0 = _band(height, group)
    return frame_gbuffers(world, blue_noise, uniforms, width, height, max_steps, seed,
                          bounces, tracer, row0=row0, rows=band)


def denoise_tiled(gb: dict, blue_noise: torch.Tensor, height: int,
                  group=None) -> torch.Tensor:
    """The whole frame from every rank's band G-buffers ``gb`` (the second
    half of ``render_frame_tiled``): the halo exchange or the gather, the
    band's chain and finalize, and the frame's assembly."""
    rank, ranks, band, row0 = _band(height, group)
    how = plan(ranks, band)
    if how == "whole":
        return denoise_finalize(gb, blue_noise)
    above = below = bands = None
    if how == "halo":
        above, below = _exchange(gb, rank, ranks, group)
    else:
        gathered = {k: gather_ranks(gb[k], ranks, group) for k in CHAIN_KEYS}
        bands = [{k: v[r] for k, v in gathered.items()} for r in range(ranks)]
    region, first = band_region(how, rank, gb, above, below, bands)
    frame = denoise_band(region, first, gb, blue_noise, row0)
    return assemble(gather_ranks(frame, ranks, group))


def denoise_in_turn(bands, blue_noise: torch.Tensor) -> torch.Tensor:
    """The whole frame from every band's G-buffers (``bands``, in rank
    order) in this process: ``denoise_tiled``'s plan, band regions, band
    chains and assembly, with each halo cut from the neighbouring band where
    the collectives would receive it."""
    ranks, band = len(bands), bands[0]["depth"].shape[0]
    how = plan(ranks, band)
    if how == "whole":
        return denoise_finalize(bands[0], blue_noise)
    frames = []
    for r, own in enumerate(bands):
        above = below = None
        if how == "halo":
            above = halo_rows(bands[r - 1], "bottom") if r > 0 else None
            below = halo_rows(bands[r + 1], "top") if r + 1 < ranks else None
        region, first = band_region(how, r, own, above, below, bands)
        frames.append(denoise_band(region, first, own, blue_noise, r * band))
    return assemble(frames)
