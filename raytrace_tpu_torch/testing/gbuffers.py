"""G-buffers of random values: inputs of the denoise chain (K2) apart from
any frame."""

from __future__ import annotations

import numpy as np
import torch


def random_gbuffers(h: int, w: int, seed: int, dev) -> dict:
    """G-buffers of random values from numpy's ``seed``, a sky band on top."""
    rng = np.random.default_rng(seed)
    normal = rng.integers(0, 6, (h, w)).astype(np.int32)
    depth = (rng.random((h, w)) * 65000).astype(np.int32)
    normal[: h // 16] = 16  # a sky band
    depth[: h // 16] = 0xFFFF
    t = lambda a: torch.from_numpy(a).to(dev)
    return dict(
        lighting=t(rng.random((h, w, 3), np.float32)),
        depth=t(depth).to(torch.uint16), normal=t(normal).to(torch.uint8),
        albedo=t(rng.random((h, w, 3), np.float32)),
        emission=t(rng.random((h, w, 3), np.float32) * 0.1),
        fog=t(rng.random((h, w, 3), np.float32)),
    )
