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


@functools.lru_cache(maxsize=None)
def hadamard_matrix(n: int) -> np.ndarray:
    """The (n, n) Sylvester Hadamard matrix, n a power of two."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"hadamard_matrix: {n} is not a power of two")
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def sse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of squared error over the trailing 2 dims."""
    d = (a - b).to(torch.int32)
    return (d * d).sum(dim=(-2, -1), dtype=torch.int32)


def sad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().sum(dim=(-2, -1), dtype=torch.int32)


def _hadamard_last(x: torch.Tensor) -> torch.Tensor:
    """x @ hadamard_matrix(n).T along the last dim, by butterflies."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    m = n // 2
    while m >= 1:
        x = x.reshape(*lead, n // (2 * m), 2, m)
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2)
        m //= 2
    return x.reshape(*lead, n)


def satd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hadamard SATD over the trailing (h, w) dims (any leading batch dims,
    broadcast between a and b; h, w powers of two), scaled to be
    SAD-comparable: sum|H_h D H_w^T| >> ((log2 h + log2 w + 2) // 2)."""
    d = (a - b).to(torch.int32)
    h, w = d.shape[-2], d.shape[-1]
    if h & (h - 1) or w & (w - 1):
        raise ValueError(f"satd: block {h}x{w} is not a power of two")
    t = _hadamard_last(d)
    t = _hadamard_last(t.transpose(-1, -2))
    shift = (h.bit_length() - 1 + w.bit_length() - 1 + 2) // 2
    return t.abs().sum(dim=(-2, -1), dtype=torch.int32) >> shift


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
