"""LMCS — luma mapping (reshaper).

PyTorch-port copy of `vvc_mm_tpu/common/reshape.py` (reference:
source/Lib/CommonLib/Reshape.{cpp,h} — 16-segment piecewise-linear
forward and inverse luma mapping LUTs, Reshape.h:54+; estimation in
EncoderLib/EncReshape.cpp).

As in the JAX package the whole pipeline runs in the mapped domain: the
encoder forward-maps each source luma plane once, every coding stage (and
the decoded-picture hash) works on mapped samples, and the inverse map is
applied only at output.  Chroma residual scaling is not modelled.  The 16
codeword counts ride the SPS; both sides rebuild the same integer LUTs,
which live as int64 tensors on the caller's device so that mapping a plane
is one indexing operation there (`map_plane`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

N_SEGMENTS = 16


def _inv_lut_np(cw, bit_depth: int) -> np.ndarray:
    rng = 1 << bit_depth
    seg = rng // N_SEGMENTS
    lut = np.zeros(rng, dtype=np.int64)
    pivot = 0
    for i in range(N_SEGMENTS):
        c = int(cw[i])
        ms = np.arange(pivot, pivot + c, dtype=np.int64)
        lut[pivot:pivot + c] = i * seg + ((ms - pivot) * seg + c // 2) // c
        pivot += c
    if pivot < rng:                      # clamp tail (cw sums to rng)
        lut[pivot:] = rng - 1
    return np.clip(lut, 0, rng - 1)


def build_inv_lut(cw, bit_depth: int = 8, device=None) -> torch.Tensor:
    """Inverse mapping LUT mapped -> original (the piecewise-linear inverse
    in the same integer arithmetic), on `device`."""
    return torch.from_numpy(_inv_lut_np(cw, bit_depth)).to(
        resolve_device(device))


def map_plane(lut: torch.Tensor, plane):
    """A plane through a LUT on the LUT's device: a tensor comes back as an
    int32 tensor there, a host array as an int32 host array."""
    if torch.is_tensor(plane):
        return lut[plane.long()].to(torch.int32)
    t = torch.from_numpy(np.ascontiguousarray(plane, dtype=np.int64))
    return lut[t.to(lut.device)].to(torch.int32).cpu().numpy()
