"""The device policy of every entry point: the caller's device, "cuda"
unless the caller asks for the CPU, and no silent move to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The caller's device; "cuda" without a card raises rather than moving
    the work to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev
