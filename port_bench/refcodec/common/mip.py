"""MIP — matrix-based intra prediction, batched — PyTorch port.

Counterpart of `vvc_mm_tpu/common/mip.py` (reference:
source/Lib/CommonLib/MatrixIntraPrediction.{cpp,h}): a block is predicted
as clip(mean + (W_k @ (reduced_boundary - mean)) >> 6) followed by a fixed
linear upsample, VVC's three MIP stages.  The JAX package derives its
matrix family deterministically in numpy float64 (anisotropic smoothers
and least-squares plane extrapolators) and rounds it to 6-bit integers;
`_matrices` and `_upsampler` run the same recipe here, so the integer
tables are equal (tests/test_torch_intra_pred_tools.py holds them).

Both products are integer: CUDA has no int32 matmul, so each is an int64
broadcast-and-sum, exact at every bit depth (the JAX package's int32
einsum does not overflow: |W| < 2^7, |boundary - mean| < 2^10, 8 terms;
the upsample's rows sum to 64).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

N_MIP_MODES = 8
RED_BDRY = 4          # reduced boundary samples per side (VVC: 2 or 4)
SHIFT = 6             # weight fixed point (VVC MIP: 6-bit weights)


@functools.lru_cache(maxsize=None)
def _matrices(red: int) -> np.ndarray:
    """(modes, red*red, 2*RED_BDRY) int32 weight matrices (6-bit fixed
    point): modes 0-3 anisotropic inverse-distance smoothers at 4 angles,
    modes 4-7 least-squares plane extrapolators (full, y only, x only,
    half blended with mode 0)."""
    n = 2 * RED_BDRY
    out = np.zeros((N_MIP_MODES, red * red, n), np.float64)
    bx = (np.arange(RED_BDRY) + 0.5) * (red / RED_BDRY)
    bpos = np.concatenate([
        np.stack([np.full(RED_BDRY, -0.5), bx], 1),          # top (y, x)
        np.stack([bx, np.full(RED_BDRY, -0.5)], 1),          # left
    ])
    yy, xx = np.mgrid[0:red, 0:red]
    ppos = np.stack([yy.ravel() + 0.5, xx.ravel() + 0.5], 1)
    for k in range(4):
        th = k * np.pi / 4
        c, s = np.cos(th), np.sin(th)
        d = ppos[:, None, :] - bpos[None, :, :]
        along = d[..., 0] * s + d[..., 1] * c
        across = -d[..., 0] * c + d[..., 1] * s
        dist = np.sqrt(0.1 * along ** 2 + 5.0 * across ** 2)
        w = np.exp(-dist / (0.5 * red))
        w /= w.sum(1, keepdims=True)
        out[k] = w
    a = np.stack([np.ones(n), bpos[:, 0], bpos[:, 1]], 1)
    pinv = np.linalg.pinv(a)
    basis = np.stack([np.ones(red * red), ppos[:, 0], ppos[:, 1]], 1)
    full = basis @ pinv
    out[4] = full
    out[5] = basis @ (np.diag([1.0, 1.0, 0.0]) @ pinv)
    out[6] = basis @ (np.diag([1.0, 0.0, 1.0]) @ pinv)
    out[7] = 0.5 * full + 0.5 * out[0]
    return np.round(out * (1 << SHIFT)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _upsampler(s: int, red: int) -> np.ndarray:
    """(s*s, red*red) int32 bilinear upsample matrix, rows sum 64."""
    f = s / red
    w = np.zeros((s * s, red * red), np.float64)
    for y in range(s):
        for x in range(s):
            gy = min(max((y + 0.5) / f - 0.5, 0.0), red - 1.0)
            gx = min(max((x + 0.5) / f - 0.5, 0.0), red - 1.0)
            y0, x0 = int(gy), int(gx)
            y1, x1 = min(y0 + 1, red - 1), min(x0 + 1, red - 1)
            fy, fx = gy - y0, gx - x0
            w[y * s + x, y0 * red + x0] += (1 - fy) * (1 - fx)
            w[y * s + x, y0 * red + x1] += (1 - fy) * fx
            w[y * s + x, y1 * red + x0] += fy * (1 - fx)
            w[y * s + x, y1 * red + x1] += fy * fx
    return np.round(w * (1 << SHIFT)).astype(np.int32)


def _reduce_boundary(cref: torch.Tensor, s: int) -> torch.Tensor:
    """cref layout per intra.py: [left reversed (2s), corner, top (2s)].
    Returns (B, 2*RED_BDRY) int32 [top_reduced, left_reduced]."""
    top = cref[:, 2 * s + 1: 3 * s + 1]          # nearest s top samples
    left = torch.flip(cref[:, :2 * s], [1])[:, :s]
    g = s // RED_BDRY
    topr = top.reshape(-1, RED_BDRY, g).sum(2)
    leftr = left.reshape(-1, RED_BDRY, g).sum(2)
    return torch.cat([torch.div(topr + g // 2, g, rounding_mode="floor"),
                      torch.div(leftr + g // 2, g, rounding_mode="floor")],
                     1).to(torch.int32)


def predict_mip_all(cref: torch.Tensor, s: int, bit_depth: int = 8
                    ) -> torch.Tensor:
    """All MIP modes for a batch of blocks: (B, 4s+1) refs -> (B, M, s, s)
    int32."""
    red = min(s, 8)
    dev = cref.device
    w = torch.as_tensor(_matrices(red), device=dev).to(torch.int64)
    u = torch.as_tensor(_upsampler(s, red), device=dev).to(torch.int64)
    bdry = _reduce_boundary(cref, s).to(torch.int64)        # (B, n)
    mean = (bdry.sum(1, keepdim=True) + RED_BDRY) >> RED_BDRY.bit_length()
    centered = bdry - mean
    r = (w[None] * centered[:, None, None, :]).sum(-1)       # (B, M, red2)
    r = (r + (1 << (SHIFT - 1))) >> SHIFT
    up = (u[None, None] * r[:, :, None, :]).sum(-1)          # (B, M, s2)
    up = (up + (1 << (SHIFT - 1))) >> SHIFT
    p = up + mean[:, :, None]
    b, m = p.shape[0], p.shape[1]
    return torch.clamp(p, 0, (1 << bit_depth) - 1).to(torch.int32) \
        .reshape(b, m, s, s)


def predict_mip_mode(cref: torch.Tensor, mip_mode: torch.Tensor, s: int,
                     bit_depth: int = 8) -> torch.Tensor:
    """The signalled MIP mode of each block (decoder path): (B,) modes."""
    allp = predict_mip_all(cref, s, bit_depth)
    idx = mip_mode.long().reshape(-1, 1, 1, 1).expand(-1, 1, s, s)
    return torch.gather(allp, 1, idx)[:, 0]
