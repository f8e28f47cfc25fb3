"""Distortion measures: SSE, SAD, Hadamard SATD — batched, integer.

PyTorch counterpart of `vvc_mm_tpu/common/rdcost.py` (reference:
source/Lib/CommonLib/RdCost.cpp — xGetSAD/xGetSSE/xGetHADs).  The JAX
package takes the Hadamard transform as two +-1 matrix products; integer
matrix products do not exist on a CUDA device, so here it is the same
transform as log2(n) add/subtract butterflies per direction, exact in
int32 on every device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def first_argmin(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Index of the FIRST minimum along `dim` (int64), as jnp.argmin gives
    it.  The search relies on this tie rule (a tie keeps the centre, the
    earlier model, the earlier candidate), so it is taken explicitly
    rather than left to a device's reduction order."""
    n = t.shape[dim]
    shape = [1] * t.dim()
    shape[dim] = n
    idx = torch.arange(n, device=t.device).reshape(shape)
    mn = t.min(dim=dim, keepdim=True).values
    return torch.where(t == mn, idx, n).min(dim=dim).values
