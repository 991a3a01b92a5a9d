"""The exact DDA tracer over the fused volume, and its G-buffer pass
(``tracer="volume"``).

Port of ``raytrace_tpu/ops/trace_jax.py:59-165`` (``trace_rays``) and
``:194-217`` (``render_gbuffers``).  The JAX package runs this march in XLA,
not in a Pallas kernel, so the port runs it in plain PyTorch on every
device; it is the reference for the volume tracers, not a fast path.

Each ray steps through the resident volume by its minefield: from a voxel
whose step field is ``s``, it moves to the next boundary of the
``(1 << s) // 2`` grid (by ``1e-4`` per unit of length along the ray where
that is 0), looks up the fused word there (``volume.lookup``) and hits where
the word's step is 0; leaving the 256-voxel window is air.  Each ray has
``max_steps`` moves.  Lanes whose ray is done are compacted away every 16
moves; the loop stops when none is live, and ``steps`` counts the moves the
JAX loop would run (its ``while`` ends when every ray is done).
"""

from __future__ import annotations

import torch

from ..constants import MAX_TRACE_STEPS, ROOT_BLOCK_SIZE
from .integrate import hit_result, integrate_gbuffers
from .rays import normalize
from .volume import MATERIAL_MASK, STEP_SHIFT, lookup

_HALF = ROOT_BLOCK_SIZE // 2
_EPS = 1e-4
_CHECK_EVERY = 16


def _step_size(step: torch.Tensor) -> torch.Tensor:
    """``((1 << step) // 2)`` as float32: 0 for step 0, else 2^(step-1)."""
    return torch.floor_divide(torch.bitwise_left_shift(torch.ones_like(step), step),
                              2).to(torch.float32)


def trace_rays(fused_flat: torch.Tensor, origin: torch.Tensor,
               direction: torch.Tensor, lr: torch.Tensor,
               max_steps: int = MAX_TRACE_STEPS) -> dict:
    """Trace a batch of rays (..., 3) f32 through the fused (256^3,) int32
    volume of the region centred at ``lr`` (3,) f32.

    Returns the hit dict of ``integrate.hit_result`` (position nudged 0.001
    off the hit face, distance before the nudge) and ``steps``, a 0-d int32
    tensor: the moves made until every ray was done, at most ``max_steps``.
    """
    shape = origin.shape[:-1]
    dev = origin.device
    o = origin.reshape(-1, 3).to(torch.float32)
    d = direction.reshape(-1, 3).to(torch.float32)
    d = torch.stack(normalize(d[:, 0], d[:, 1], d[:, 2]), -1)
    lrf = [float(v) for v in lr.tolist()]
    n = o.shape[0]
    ax = torch.arange(3, dtype=torch.int32, device=dev)

    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    zb = torch.zeros(n, dtype=torch.bool, device=dev)
    out = dict(pos=o.clone(), normal=zi.clone(), air=zb.clone(), done=zb.clone(),
               packed=zi.clone())
    step0 = lookup(fused_flat, o) >> STEP_SHIFT
    s = dict(idx=torch.arange(n, device=dev), pos=o, d=d, lp=1.0 / torch.abs(d),
             normals=torch.where(d > 0, 2 * ax + 1, 2 * ax).to(torch.int32),
             muls=torch.where(d > 0, -1.0, 1.0).to(torch.float32),
             normal=zi, air=zb, done=zb, packed=zi, step=_step_size(step0))
    # The JAX loop's move count: one past the last move that completed a ray
    # (or max_steps while a ray is live), kept on the device.
    steps = torch.zeros((), dtype=torch.int32, device=dev)

    def flush(s, sel):
        j = s["idx"][sel]
        for k in out:
            out[k][j] = s[k][sel]

    cut = True
    for i in range(max_steps):
        if i % _CHECK_EVERY == 0:
            live = ~s["done"]
            flush(s, ~live)
            if not bool(live.any()):
                cut = False
                break
            s = {k: v[live] for k, v in s.items()}
        active = ~s["done"]
        shifted = (s["pos"] + float(_HALF)) * s["muls"]
        ss = s["step"][:, None]
        m = torch.where(ss > 0, torch.remainder(shifted, torch.where(ss > 0, ss, 1.0)), 0.0)
        lvec = (_EPS + m) * s["lp"]
        lx, ly, lz = lvec[:, 0], lvec[:, 1], lvec[:, 2]
        use_x = (lx < ly) & (lx < lz)
        use_y = ~(lx < ly) & (ly < lz)
        lmin = torch.where(use_x, lx, torch.where(use_y, ly, lz))
        nrm = s["normals"]
        axis_normal = torch.where(use_x, nrm[:, 0], torch.where(use_y, nrm[:, 1], nrm[:, 2]))
        p = torch.where(active[:, None], s["pos"] + s["d"] * lmin[:, None], s["pos"])
        fused = lookup(fused_flat, p)
        oob = ((torch.abs(p[:, 0] - lrf[0]) >= _HALF) | (torch.abs(p[:, 1] - lrf[1]) >= _HALF)
               | (torch.abs(p[:, 2] - lrf[2]) >= _HALF))
        new_air = active & oob
        new_hit = active & ~oob & ((fused >> STEP_SHIFT) <= 0)
        s["pos"] = p
        s["normal"] = torch.where(active, axis_normal, s["normal"])
        s["air"] = s["air"] | new_air
        s["done"] = s["done"] | new_air | new_hit
        s["packed"] = torch.where(new_hit, fused & MATERIAL_MASK, s["packed"])
        s["step"] = torch.where(s["done"], s["step"], _step_size(fused >> STEP_SHIFT))
        steps = torch.where((new_air | new_hit).any(), i + 1, steps)
    if cut:
        flush(s, torch.ones_like(s["done"]))
        if not bool(out["done"].all()):
            steps = torch.full((), max_steps, dtype=torch.int32, device=dev)

    res = hit_result(origin, out["pos"].reshape(origin.shape), out["normal"].reshape(shape),
                     out["air"].reshape(shape), out["packed"].reshape(shape),
                     ~out["done"].reshape(shape))
    res["steps"] = steps.to(torch.int32)
    return res


def render_gbuffers(fused_flat: torch.Tensor, blue_noise: torch.Tensor,
                    uniforms: dict, width: int, height: int,
                    max_steps: int = MAX_TRACE_STEPS, bounces: int = 2,
                    row0: int = 0, rows: int | None = None) -> dict:
    """G-buffers of one frame (or of its rows ``row0 .. row0 + rows``)
    through the exact DDA:
    ``integrate.integrate_gbuffers`` with ``trace_rays``.  Every ray is
    traced, including the bounce rays of sky pixels, as in JAX
    (``trace_jax.py:210-213``)."""

    def trace(o, d, active=None):
        return trace_rays(fused_flat, o, d, uniforms["lr"], max_steps)

    return integrate_gbuffers(trace, blue_noise, uniforms, width, height, bounces, row0,
                              rows)
