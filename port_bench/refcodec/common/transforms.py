"""Batched integer transforms (DCT-II / DST-VII / DCT-VIII).

PyTorch counterpart of `vvc_mm_tpu/common/transforms.py` (reference:
source/Lib/CommonLib/TrQuant.cpp:715 xT, :799 xIT).
Each pass is a matrix product over a batch of blocks.  The products run in
float64, which is exact here: every partial sum is an integer below 2^38
(16-bit coefficients times 8-bit basis values over at most 64 terms), and
CUDA has no int32 matrix product.
  forward:  shift1 = log2W + bitDepth - 9, shift2 = log2H + 6
  inverse:  shift1 = 7 (clip to 16 bit), shift2 = 20 - bitDepth
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import rom

MAX_COEFF = (1 << 15) - 1
MIN_COEFF = -(1 << 15)


def _rshift_round(x: torch.Tensor, shift: int) -> torch.Tensor:
    if shift <= 0:
        return x << (-shift)
    return (x + (1 << (shift - 1))) >> shift


def _clip16(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, MIN_COEFF, MAX_COEFF)


@functools.lru_cache(maxsize=None)
def _matrix_np(tr_type: int, n: int) -> np.ndarray:
    return np.asarray(rom.tr_matrix(tr_type, n), dtype=np.float64)


@functools.lru_cache(maxsize=None)
def _matrix(tr_type: int, n: int, device: torch.device) -> torch.Tensor:
    """The transform matrix on `device`, copied there once: a copy per
    call makes the host wait for the device.  Read-only: every caller gets
    the same tensor."""
    return torch.as_tensor(_matrix_np(tr_type, n), device=device)


def forward_transform(resid: torch.Tensor, tr_h: int = rom.DCT2,
                      tr_v: int = rom.DCT2, bit_depth: int = 8
                      ) -> torch.Tensor:
    """(B, H, W) int32 residuals -> (B, H, W) int32 coefficients, clipped
    to the 16-bit dynamic range."""
    _, h, w = resid.shape
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    th = _matrix(tr_h, w, resid.device)
    tv = _matrix(tr_v, h, resid.device)
    # horizontal: contract W with rows of th
    tmp = torch.matmul(resid.to(torch.float64), th.t()).to(torch.int64)
    tmp = _clip16(_rshift_round(tmp, log2w + bit_depth - 9))
    # vertical: contract H with rows of tv
    out = torch.matmul(tv, tmp.to(torch.float64)).to(torch.int64)
    return _clip16(_rshift_round(out, log2h + 6)).to(torch.int32)


def inverse_transform(coeff: torch.Tensor, tr_h: int = rom.DCT2,
                      tr_v: int = rom.DCT2, bit_depth: int = 8
                      ) -> torch.Tensor:
    """(B, H, W) int32 dequantized coefficients -> (B, H, W) int32
    residuals (normative path)."""
    _, h, w = coeff.shape
    th = _matrix(tr_h, w, coeff.device)
    tv = _matrix(tr_v, h, coeff.device)
    # vertical inverse: sum_k coeff[k][x] * tv[k][y]
    tmp = torch.matmul(tv.t(), coeff.to(torch.float64)).to(torch.int64)
    tmp = _clip16(_rshift_round(tmp, 7))
    # horizontal inverse: sum_k tmp[y][k] * th[k][x]
    out = torch.matmul(tmp.to(torch.float64), th).to(torch.int64)
    return _clip16(_rshift_round(out, 20 - bit_depth)).to(torch.int32)


def inverse_transform_pairs(coeff: torch.Tensor, pairs, bit_depth: int = 8
                            ) -> torch.Tensor:
    """inverse_transform of (P, B, H, W) coefficients, slice p under
    pairs[p], as one product over the stacked matrices."""
    h, w = coeff.shape[-2:]
    th = _stacked(tuple(p[0] for p in pairs), w, coeff.device)
    tv = _stacked(tuple(p[1] for p in pairs), h, coeff.device)
    tmp = torch.matmul(tv.transpose(1, 2)[:, None],
                       coeff.to(torch.float64)).to(torch.int64)
    tmp = _clip16(_rshift_round(tmp, 7))
    out = torch.matmul(tmp.to(torch.float64), th[:, None]).to(torch.int64)
    return _clip16(_rshift_round(out, 20 - bit_depth)).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _stacked(types: tuple, n: int, device: torch.device) -> torch.Tensor:
    """The (P, n, n) float64 matrices of `types` on `device` (read-only)."""
    return torch.as_tensor(np.stack([_matrix_np(t, n) for t in types]),
                           device=device)


def transform_shift(log2w: int, log2h: int, bit_depth: int
                    ) -> tuple[int, bool]:
    """VVC transformShift and the odd-size flag (reference: Quant.cpp)."""
    s = log2w + log2h
    t = 15 - bit_depth - ((s + 1) // 2)
    return t, (s & 1) == 1
