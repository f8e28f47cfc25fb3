"""Fractional-pel interpolation for motion compensation — torch.

PyTorch counterpart of `vvc_mm_tpu/common/interp.py` (reference:
source/Lib/CommonLib/InterpolationFilter.cpp).  The filter tables are the
published H.266 coefficients; precision follows the VVC scheme: the
horizontal pass stays at 14-bit internal precision (IF_INTERNAL_PREC), the
vertical pass >> 6, and `finalize_uni` / `finalize_bi` round back to the
pixel domain (MM bi-prediction averages in the pixel domain, see
mm/frame_codec.py).  `mc_luma` / `mc_chroma` predict whole blocks at one
MV each, the classic inter path.  All math is int32 on whatever device the
tensors live on.
"""
from __future__ import annotations

import numpy as np
import torch

from .typedefs import NTAPS_CHROMA, NTAPS_LUMA

IF_INTERNAL_PREC = 14                # reference: CommonDef.h IF_INTERNAL_PREC
IF_INTERNAL_OFFS = 1 << (IF_INTERNAL_PREC - 1)

# H.266 Table 8-11 — 8-tap luma interpolation filter, 16 phases (1/16-pel)
LUMA_FILTER = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [0, 1, -3, 63, 4, -2, 1, 0],
    [-1, 2, -5, 62, 8, -3, 1, 0],
    [-1, 3, -8, 60, 13, -4, 1, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 52, 26, -8, 3, -1],
    [-1, 3, -9, 47, 31, -10, 4, -1],
    [-1, 4, -11, 45, 34, -10, 4, -1],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [-1, 4, -10, 34, 45, -11, 4, -1],
    [-1, 4, -10, 31, 47, -9, 3, -1],
    [-1, 3, -8, 26, 52, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
    [0, 1, -4, 13, 60, -8, 3, -1],
    [0, 1, -3, 8, 62, -5, 2, -1],
    [0, 1, -2, 4, 63, -3, 1, 0],
], dtype=np.int32)

# H.266 Table 8-13 — 4-tap chroma filter, 32 phases (1/32-pel)
CHROMA_FILTER = np.array([
    [0, 64, 0, 0], [-1, 63, 2, 0], [-2, 62, 4, 0], [-2, 60, 7, -1],
    [-2, 58, 10, -2], [-3, 57, 12, -2], [-4, 56, 14, -2], [-4, 55, 15, -2],
    [-4, 54, 16, -2], [-5, 53, 18, -2], [-6, 52, 20, -2], [-6, 49, 24, -3],
    [-6, 46, 28, -4], [-5, 44, 29, -4], [-4, 42, 30, -4], [-4, 39, 33, -4],
    [-4, 36, 36, -4], [-4, 33, 39, -4], [-4, 30, 42, -4], [-4, 29, 44, -5],
    [-4, 28, 46, -6], [-3, 24, 49, -6], [-2, 20, 52, -6], [-2, 18, 53, -5],
    [-2, 16, 54, -4], [-2, 15, 55, -4], [-2, 14, 56, -4], [-2, 12, 57, -3],
    [-2, 10, 58, -2], [-1, 7, 60, -2], [0, 4, 62, -2], [0, 2, 63, -1],
], dtype=np.int32)



def gather_patches_t(plane: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                     ph: int, pw: int) -> torch.Tensor:
    """Gather B patches in (ph, pw, B) layout from a padded plane.  The
    caller clamps the coordinates into range first."""
    dev = plane.device
    ar_y = torch.arange(ph, dtype=torch.int64, device=dev)[:, None, None]
    ar_x = torch.arange(pw, dtype=torch.int64, device=dev)[None, :, None]
    ys = y0.to(torch.int64)[None, None, :] + ar_y
    xs = x0.to(torch.int64)[None, None, :] + ar_x
    return plane[ys, xs]                       # (ph, pw, B)


def _separable_filter_t(patch: torch.Tensor, fx: torch.Tensor,
                        fy: torch.Tensor, filt: np.ndarray, h: int, w: int,
                        bit_depth: int) -> torch.Tensor:
    """patch (h+T-1, w+T-1, B) int32 + per-patch phases -> (h, w, B) int32
    in internal precision."""
    taps = filt.shape[1]
    table = torch.as_tensor(filt, dtype=torch.int32, device=patch.device)
    cx = table[fx.to(torch.int64)]             # (B, T)
    cy = table[fy.to(torch.int64)]
    shift1 = bit_depth - 8
    offset1 = (1 << (shift1 - 1)) if shift1 > 0 else 0
    hsum = sum(patch[:, t:t + w, :] * cx[:, t][None, None, :]
               for t in range(taps))           # (h+T-1, w, B)
    hval = (hsum + offset1) >> shift1 if shift1 > 0 else hsum
    vsum = sum(hval[t:t + h, :, :] * cy[:, t][None, None, :]
               for t in range(taps))           # (h, w, B)
    return vsum >> 6


def interp_luma_t(patch, fx, fy, h, w, bit_depth: int = 8):
    return _separable_filter_t(patch, fx, fy, LUMA_FILTER, h, w, bit_depth)


def interp_chroma_t(patch, fx, fy, h, w, bit_depth: int = 8):
    return _separable_filter_t(patch, fx, fy, CHROMA_FILTER, h, w,
                               bit_depth)


def finalize_uni(val: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """Internal-precision -> pixel domain for uni-prediction."""
    shift = IF_INTERNAL_PREC - bit_depth
    offset = 1 << (shift - 1)
    return torch.clamp((val + offset) >> shift, 0, (1 << bit_depth) - 1)



def finalize_bi(val0: torch.Tensor, val1: torch.Tensor, bit_depth: int = 8
                ) -> torch.Tensor:
    """Average two internal-precision predictions (bi-prediction rounding,
    reference: InterPrediction xWeightedAverage default path)."""
    shift = IF_INTERNAL_PREC + 1 - bit_depth
    offset = 1 << (shift - 1)
    return torch.clamp((val0 + val1 + offset) >> shift, 0,
                       (1 << bit_depth) - 1)


def mc_luma(ref_padded: torch.Tensor, mv: torch.Tensor, y_blk: torch.Tensor,
            x_blk: torch.Tensor, h: int, w: int, margin: int,
            bit_depth: int = 8) -> torch.Tensor:
    """Motion-compensate B luma blocks from a margin-padded reference plane.

    Args:
      ref_padded: (H+2m, W+2m) int32 with edge-extended margins m >= search
        range + 4 taps.
      mv: (B, 2) int32 motion vectors in 1/16-pel (mv[:,0]=mvx, mv[:,1]=mvy).
      y_blk/x_blk: (B,) block top-left coords in unpadded frame space.
    Returns:
      (B, h, w) int32 prediction in internal 14-bit precision.
    """
    mvx, mvy = mv[:, 0], mv[:, 1]
    ix = x_blk + margin + (mvx >> 4) - (NTAPS_LUMA // 2 - 1)
    iy = y_blk + margin + (mvy >> 4) - (NTAPS_LUMA // 2 - 1)
    ix = torch.clamp(ix, 0, ref_padded.shape[1] - (w + NTAPS_LUMA - 1))
    iy = torch.clamp(iy, 0, ref_padded.shape[0] - (h + NTAPS_LUMA - 1))
    patch = gather_patches_t(ref_padded, iy, ix, h + NTAPS_LUMA - 1,
                             w + NTAPS_LUMA - 1)
    val = interp_luma_t(patch, mvx & 15, mvy & 15, h, w, bit_depth)
    return val.permute(2, 0, 1)


def mc_chroma(ref_padded: torch.Tensor, mv: torch.Tensor,
              y_blk: torch.Tensor, x_blk: torch.Tensor, h: int, w: int,
              margin: int, bit_depth: int = 8) -> torch.Tensor:
    """Motion-compensate B chroma blocks (4:2:0): the luma 1/16-pel MV is
    read as 1/32-pel at chroma resolution (reference: InterPrediction
    xPredInterBlk chroma path).  Coords in chroma space."""
    mvx, mvy = mv[:, 0], mv[:, 1]
    ix = x_blk + margin + (mvx >> 5) - (NTAPS_CHROMA // 2 - 1)
    iy = y_blk + margin + (mvy >> 5) - (NTAPS_CHROMA // 2 - 1)
    ix = torch.clamp(ix, 0, ref_padded.shape[1] - (w + NTAPS_CHROMA - 1))
    iy = torch.clamp(iy, 0, ref_padded.shape[0] - (h + NTAPS_CHROMA - 1))
    patch = gather_patches_t(ref_padded, iy, ix, h + NTAPS_CHROMA - 1,
                             w + NTAPS_CHROMA - 1)
    val = interp_chroma_t(patch, mvx & 31, mvy & 31, h, w, bit_depth)
    return val.permute(2, 0, 1)
