"""Single dispatch layer for the port's kernel tier.

Every kernel in ``ops/kernels`` ships two implementations: a kernel written
by hand for Hopper, and a plain PyTorch version beside it that is the
definition of correctness.  Call sites ask :func:`resolve` which one runs:

* ``reference`` mode runs the plain version on any device (how a run holds
  the kernel against its spec on the card);
* ``auto`` (the default) runs the plain version for CPU tensors, and the
  kernel for CUDA tensors;
* ``kernel`` runs the kernel and refuses CPU tensors.

A CUDA tensor under ``auto`` or ``kernel`` never reaches the plain version:
an input the kernel does not take, or a card it was not built for, raises.
The kernels are compiled for ``sm_90a``, so a CUDA device must have compute
capability (9, 0).  There is no size threshold below which ``auto`` prefers
the plain version; such thresholds come from measurements on the card.

The mode comes from ``DL4J_TORCH_KERNEL_TIER`` or :func:`set_dispatch_mode`.
Each kernel is compiled for one tile (``tiles.DEFAULT_TILES``), so there is
no run-time tile table yet.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict

import torch

MODES = ("auto", "kernel", "reference")
KERNEL_CAPABILITY = (9, 0)

_lock = threading.Lock()
_mode: str = os.environ.get("DL4J_TORCH_KERNEL_TIER", "auto")


def dispatch_mode() -> str:
    if _mode not in MODES:
        raise ValueError(
            f"DL4J_TORCH_KERNEL_TIER={_mode!r} is not one of {MODES}")
    return _mode


def set_dispatch_mode(mode: str) -> str:
    """Set the tier mode; returns the previous mode (for try/finally)."""
    global _mode
    if mode not in MODES:
        raise ValueError(f"unknown kernel-tier mode {mode!r}; want one of {MODES}")
    with _lock:
        prev, _mode = _mode, mode
    return prev


#: kernel name -> its hard constraints; a CUDA call that fails them raises
_supports: Dict[str, Callable[..., bool]] = {}
#: CUDA device -> compute capability, read once per device
_capabilities: Dict[torch.device, tuple] = {}


def register(name: str, supports: Callable[..., bool]) -> None:
    _supports[name] = supports


def _devices(args, kwargs):
    return {a.device for a in (*args, *kwargs.values())
            if isinstance(a, torch.Tensor)}


def resolve(name: str, *args: Any, **kwargs: Any) -> str:
    """``"kernel"`` or ``"reference"`` for one call of kernel ``name``."""
    supports = _supports[name]
    mode = dispatch_mode()
    if mode == "reference":
        return "reference"
    devices = _devices(args, kwargs)
    cuda = [d for d in devices if d.type == "cuda"]
    if not cuda:
        if mode == "kernel":
            raise RuntimeError(
                f"{name}: kernel mode needs CUDA tensors, got tensors on "
                f"{sorted(str(d) for d in devices)}")
        return "reference"
    if len(devices) != 1:
        raise ValueError(
            f"{name}: tensors on several devices "
            f"{sorted(str(d) for d in devices)}")
    if not supports(*args, **kwargs):
        raise ValueError(f"{name}: the kernel does not take these inputs")
    cap = _capabilities.get(cuda[0])
    if cap is None:
        cap = _capabilities[cuda[0]] = tuple(torch.cuda.get_device_capability(cuda[0]))
    if cap != KERNEL_CAPABILITY:
        raise RuntimeError(
            f"{name}: the kernel is built for sm_90a (capability "
            f"{KERNEL_CAPABILITY}); {cuda[0]} has capability {tuple(cap)}")
    return "kernel"
