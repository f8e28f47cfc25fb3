"""LFNST — the low-frequency non-separable secondary transform, batched.

PyTorch counterpart of `vvc_mm_tpu/common/lfnst.py` (reference:
source/Lib/CommonLib/TrQuant.cpp:238 fwdLfnstNxN / :262 invLfnstNxN): after
the primary transform, the top-left 4x4 coefficients of an intra block pass
through a non-separable 16x16 transform chosen by intra-mode class and a
signalled index (0 off, 1..2 the kernel candidates).

The kernels are the JAX package's: KLTs of a first-order Gauss-Markov
residual field oriented along the mode class's direction (numpy `eigh` of
its covariance), rounded to 7-bit integers once.  The quantized pair (K,
K^T) is the normative transform.  The JAX package contracts in int32;
here the 16-term products run in float64, which is exact (a 16-bit value
times a 7-bit weight, 16 terms), and CUDA has no int32 matrix product.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

N_LFNST_CAND = 2      # signalled index 0 (off) / 1 / 2
SHIFT = 7             # kernel fixed-point bits
REG = 4               # transform region: top-left 4x4


@functools.lru_cache(maxsize=None)
def _kernels() -> np.ndarray:
    """(4 classes, 2 candidates, 16, 16) int32 kernels.  Class c in {0:
    planar/DC, 1: horizontal-ish, 2: vertical-ish, 3: MIP}; candidate k
    changes the model's correlations to give two bases per class."""
    out = np.zeros((4, N_LFNST_CAND, REG * REG, REG * REG))
    angles = {0: 45.0, 1: 0.0, 2: 90.0, 3: 45.0}
    for c in range(4):
        th = np.deg2rad(angles[c])
        dy, dx = np.sin(th), np.cos(th)
        for k in range(N_LFNST_CAND):
            rho_a = 0.95 - 0.2 * k          # along-direction correlation
            rho_b = 0.5 + 0.2 * k           # across
            yy, xx = np.mgrid[0:REG, 0:REG]
            p = np.stack([yy.ravel(), xx.ravel()], 1).astype(np.float64)
            d = p[:, None, :] - p[None, :, :]
            along = d[:, :, 0] * dy + d[:, :, 1] * dx
            across = -d[:, :, 0] * dx + d[:, :, 1] * dy
            cov = (rho_a ** np.abs(along)) * (rho_b ** np.abs(across))
            w, v = np.linalg.eigh(cov)
            # basis vectors by decreasing eigenvalue, rows = basis functions
            out[c, k] = v[:, ::-1].T
    return np.round(out * (1 << SHIFT)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _kernels_t(device: torch.device) -> torch.Tensor:
    """_kernels() as float64 on `device` (read-only)."""
    return torch.as_tensor(_kernels(), dtype=torch.float64, device=device)


def mode_class(mode: torch.Tensor) -> torch.Tensor:
    """Intra mode -> kernel class (reference: TrQuant lfnstIdx mode
    mapping); 67+ (MIP) -> class 3."""
    return ((mode >= 2).long() + (mode > 34).long()
            + (mode > 66).long())


def _apply(coeff: torch.Tensor, cls: torch.Tensor, idx, transpose: bool
           ) -> torch.Tensor:
    """K (or K^T) of candidate `idx` (an int, or a (P,) tensor of them
    against a leading P axis of `coeff`) on each block's top-left 4x4
    raster vector, rounded back by SHIFT bits."""
    table = _kernels_t(coeff.device)
    k = (table[cls, idx - 1] if isinstance(idx, int)
         else table[cls[None, :], (idx - 1)[:, None]])
    if transpose:
        k = k.transpose(-1, -2)
    x = coeff[..., :REG, :REG].reshape(coeff.shape[:-2] + (REG * REG, 1))
    y = torch.matmul(k, x.to(torch.float64)).to(torch.int64)
    y = ((y + (1 << (SHIFT - 1))) >> SHIFT).to(torch.int32)
    out = coeff.clone()
    out[..., :REG, :REG] = y.reshape(coeff.shape[:-2] + (REG, REG))
    return out


def inverse(coeff: torch.Tensor, cls: torch.Tensor, idx) -> torch.Tensor:
    """The transposed kernel (the normative inverse, exact up to the 7-bit
    rounding)."""
    return _apply(coeff, cls, idx, True)
