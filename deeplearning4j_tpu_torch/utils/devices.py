"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to ``"cuda"``;
without a CUDA device it raises unless the caller asked for the CPU.  There
is no silent fall back to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; want 'cuda' or 'cpu'")
    return dev
