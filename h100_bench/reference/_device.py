"""The device of a reference call: the one given, else the current CUDA
device."""

from __future__ import annotations

import torch


def default_device(device, what: str) -> torch.device:
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
