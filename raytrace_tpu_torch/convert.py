"""Carry the JAX package's frame state into the port.

The renderer has no weights; the state a frame reads is the region-table
dict (``build_hf_tables``) or the resident fused volume and its occupancy
tables (``build_vol_tables``), the uniforms dict and the blue-noise texture.
These take the JAX package's arrays as numpy (``np.asarray`` of a JAX
array) and return the port's tensors on ``device``, so a test can drive the
port's kernels with exactly the JAX inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import vol_tables
from .ops.hf_tables import TABLE_KEYS

_UNIFORM_DTYPES = {
    "origin": torch.float32, "forward": torch.float32, "up": torch.float32,
    "right": torch.float32, "sun_angle": torch.float32, "seed": torch.int32,
    "lr": torch.float32,
}


def tables_from_jax(tables: dict, device) -> dict:
    """JAX ``build_hf_tables`` output -> the port's flat int32 tables."""
    out = {
        k: torch.from_numpy(np.asarray(tables[k], np.int32).reshape(-1).copy())
        .to(device)
        for k in TABLE_KEYS
    }
    out["r0"] = torch.from_numpy(np.asarray(tables["r0"], np.int32).copy()).to(device)
    return out


def uniforms_from_jax(uniforms: dict, device) -> dict:
    """JAX uniforms dict (``FrameUniforms.as_device_dict``) -> tensors."""
    return {
        k: torch.tensor(np.asarray(uniforms[k]), dtype=dt, device=device)
        for k, dt in _UNIFORM_DTYPES.items()
    }


def blue_noise_from_jax(blue_noise, device) -> torch.Tensor:
    """(H, W, C) float32 blue-noise texture -> tensor."""
    return torch.from_numpy(np.asarray(blue_noise, np.float32).copy()).to(device)


def volume_from_jax(fused, device) -> torch.Tensor:
    """JAX fused (256^3,) uint32 volume -> the port's int32 tensor (same
    bits)."""
    words = np.asarray(fused, np.uint32).reshape(-1)
    return torch.from_numpy(words.view(np.int32).copy()).to(device)


def vol_tables_from_jax(tables: dict, device) -> dict:
    """JAX ``build_vol_tables`` output -> the port's tables (same keys,
    shapes and dtypes)."""
    return {k: torch.from_numpy(np.asarray(tables[k]).copy()).to(device)
            for k in vol_tables.TABLE_KEYS}
