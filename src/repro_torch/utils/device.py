"""Where the port runs: the CUDA card unless the caller asks otherwise."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """None means the CUDA card. A CUDA device with none present raises
    rather than fall back, so a run on the CPU is always one the caller
    asked for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return device
