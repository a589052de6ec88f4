"""The device policy of every entry point: the caller's device, "cuda"
unless the caller asks for the CPU, and no silent move to the CPU."""
from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device) -> torch.device:
    """The caller's device; "cuda" without a card raises rather than moving
    the work to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def compute_autocast(device: torch.device, dtype: Optional[torch.dtype]):
    """bf16 (or `dtype`) compute over the parameters' dtype on `device`,
    flax's dtype / param_dtype split; None computes in the parameters'
    own dtype."""
    return torch.autocast(device.type, dtype=dtype or torch.bfloat16,
                          enabled=dtype is not None)
