"""[Frozen copy of ``raytrace_tpu_torch/_f32.py`` for the benchmark's reference:
its plain PyTorch code only, without the kernel wrappers.]

float32 helpers shared by the plain PyTorch versions."""

from __future__ import annotations

import torch


def fdiv(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true float32 division on every device.

    PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
    which can be an ulp off the quotient; dividing by a 0-d tensor on the
    same device keeps the correctly rounded quotient that XLA and the CUDA
    kernels compute.
    """
    return x / torch.full((), c, dtype=torch.float32, device=x.device)
