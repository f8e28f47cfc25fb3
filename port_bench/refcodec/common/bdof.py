"""BDOF — bi-directional optical flow refinement of bi-prediction.

PyTorch counterpart of `vvc_mm_tpu/common/bdof.py` (reference:
source/Lib/CommonLib/InterPrediction.cpp — xCalcBIOPar/applyBiOptFlow
around :928; a per-4x4-subblock flow (vx, vy) from the two internal
predictions' gradients, its correction added before the bi average; luma
only; nearest-neighbour border padding per block,
InterPrediction.cpp:858 xNearestNeighborPaddingForBDOF).

Normative and signalling-free: encoder and decoder derive the same
correction from the two motion-compensated internal-precision
predictions.  Every 4x4 subblock of every block is one lane of a batched
integer pipeline.  `>>` on int32 is an arithmetic shift, as in the JAX
package, and its `//` (floor division, also for negative numerators) is
written out as torch.div(..., rounding_mode="floor").
"""
from __future__ import annotations

import torch

from . import interp


def _grad(p: torch.Tensor):
    """Central-difference gradients with edge padding, per block.
    p: (B, s, s) internal precision."""
    px = torch.cat([p[:, :, :1], p, p[:, :, -1:]], 2)
    py = torch.cat([p[:, :1, :], p, p[:, -1:, :]], 1)
    gx = (px[:, :, 2:] - px[:, :, :-2]) >> 4
    gy = (py[:, 2:, :] - py[:, :-2, :]) >> 4
    return gx, gy


def _to_sub(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, s, s) -> (B * (s/4)^2, 4, 4) subblock batch."""
    b = x.shape[0]
    n = s // 4
    return (x.reshape(b, n, 4, n, 4).permute(0, 1, 3, 2, 4)
            .reshape(b * n * n, 4, 4))


def _from_sub(x: torch.Tensor, b: int, s: int) -> torch.Tensor:
    n = s // 4
    return (x.reshape(b, n, n, 4, 4).permute(0, 1, 3, 2, 4)
            .reshape(b, s, s))


def _flow(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """where(den > 0, clip((num << 3) // max(den, 1), -32, 32), 0) with
    floor division."""
    q = torch.div(num << 3, torch.clamp(den, min=1), rounding_mode="floor")
    return torch.where(den > 0, torch.clamp(q, -32, 32),
                       torch.zeros_like(q))


def _signed_sum(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sum over a subblock of v * sign(g)."""
    return torch.where(g > 0, v, torch.where(g < 0, -v, torch.zeros_like(v))
                       ).sum(dim=(1, 2), dtype=torch.int32)


def bdof_bi(int0: torch.Tensor, int1: torch.Tensor, bit_depth: int
            ) -> torch.Tensor:
    """BDOF-refined bi-prediction of block-batched internal predictions.

    Args:
      int0/int1: (B, s, s) int32 internal (14-bit) L0/L1 predictions.
    Returns (B, s, s) pixel-domain bi prediction with per-4x4 flow.
    """
    b, s, _ = int0.shape
    gx0, gy0 = _grad(int0)
    gx1, gy1 = _grad(int1)
    d = (int0 >> 4) - (int1 >> 4)            # reduced-precision difference
    gxs = _to_sub((gx0 + gx1) >> 1, s)
    gys = _to_sub((gy0 + gy1) >> 1, s)
    ds = _to_sub(d, s)
    # simplified VVC normal equations with sign/abs sums (integer)
    s1 = gxs.abs().sum(dim=(1, 2), dtype=torch.int32)
    s3 = _signed_sum(gxs, ds)
    vx = _flow(s3, s1)
    s5 = gys.abs().sum(dim=(1, 2), dtype=torch.int32)
    # remove the vx-explained part before solving vy (vx is s3/s1 in 1/8
    # units, so its d-contribution is (vx * gxs) >> 3)
    rem = ds - ((vx[:, None, None] * gxs) >> 3)
    s6 = _signed_sum(gys, rem)
    vy = _flow(s6, s5)
    # correction in the internal P0+P1 sum domain: -(vx*dgx + vy*dgy) >> 1
    # (the JAX package's derivation: half the first-order flow term)
    dgx = _to_sub(gx0 - gx1, s)
    dgy = _to_sub(gy0 - gy1, s)
    corr = -((vx[:, None, None] * dgx + vy[:, None, None] * dgy) >> 1)
    corr = _from_sub(corr, b, s)
    shift = interp.IF_INTERNAL_PREC + 1 - bit_depth
    off = 1 << (shift - 1)
    return torch.clamp((int0 + int1 + corr + off) >> shift, 0,
                       (1 << bit_depth) - 1)


def combine_bi_bdof(int0, int1, dirs, nby, nbx, bit_depth: int):
    """inter_frame._combine_bi with BDOF applied to the bi-predicted
    (dirs == 2) luma blocks."""
    from .inter_frame import _from_blocks
    d = dirs.reshape(-1)[:, None, None]
    uni0 = interp.finalize_uni(int0, bit_depth)
    uni1 = interp.finalize_uni(int1, bit_depth)
    bi = bdof_bi(int0, int1, bit_depth)
    sel = torch.where(d == 2, bi, torch.where(d == 1, uni1, uni0))
    return _from_blocks(sel, nby, nbx)
