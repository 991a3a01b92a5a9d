"""Where an entry point runs when its caller names no device.

JAX's calls run on JAX's default device, the accelerator; the port's run
on the card in the same way: ``device=None`` is the current CUDA device,
and with no GPU the call raises rather than build on the CPU unasked.
"""

from __future__ import annotations

import torch


def default_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``, None the current CUDA device;
    raises ``RuntimeError`` when that device is the card and there is no
    GPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who} runs on the card unless given a device and "
                               "needs a CUDA GPU; pass device='cpu' for the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}(device={str(device)!r}) needs a CUDA GPU")
    return device
