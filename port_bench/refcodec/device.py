"""The port's device rule: CUDA unless the caller names another device.

Every public function that places state on a device takes `device=None`
and resolves it here, so that no entry point quietly works on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None means CUDA, and raises when there is no CUDA device; a named
    device is taken as given.  A CUDA device gets its index, so that it
    compares equal to the `.device` of the tensors placed on it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the port's plain versions on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_device(t: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise unless `t` lies on `device`: state is never moved silently."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
