"""Position-based subblock motion compensation — the MM hot path.

PyTorch counterpart of `vvc_mm_tpu/common/mm/mc.py` (reference:
source/Lib/CommonLib/InterPrediction.cpp:683-860 xPredInterBlkMM).  Every
4x4 luma (2x2 chroma) subblock has an absolute 1/16-pel target position;
the MC itself is kernels K1/K2 in ops/mc_kernel.py and the search's
decision SADs are K3-K6 there (K6, sad_bilinear_positions, is the 2-tap
bilinear one); all take their plain versions for CPU tensors.  Out-of-range subblocks clamp into the padded
reference, as in the JAX package.
"""
from __future__ import annotations

import torch

from ...ops.mc_kernel import (mc_chroma_positions, mc_luma_positions,
                              sad_bilinear_positions, sad_block_positions,
                              sad_luma_positions)

__all__ = ["mc_luma_positions", "mc_chroma_positions", "classic_positions",
           "sad_block_positions", "mc_block_positions",
           "sad_positions_multi", "sad_bilinear_positions"]

# Multi-candidate exact (8-tap) per-subblock SAD, under the JAX package's
# name for it: kernel K5.
sad_positions_multi = sad_luma_positions


def classic_positions(width: int, height: int, mvs: torch.Tensor,
                      block_size: int, row_step: int = 1) -> torch.Tensor:
    """Per-subblock absolute positions for CLASSIC translation, in exact
    integer math (equivalent to reproject_frame(CLASSIC, ...)).  row_step
    keeps every row_step-th subblock row (search-time SADs)."""
    nsx, nsy = width // 4, height // 4
    rep = block_size // 4
    dev = mvs.device
    gx = torch.arange(nsx, dtype=torch.int32, device=dev) * (4 * 16)
    gy = torch.arange(0, nsy, row_step, dtype=torch.int32,
                      device=dev) * (4 * 16)
    base_x = gx[None, :].expand(gy.shape[0], nsx)
    base_y = gy[:, None].expand(gy.shape[0], nsx)
    mv = mvs.to(torch.int32)
    mv_x = mv[..., 0].repeat_interleave(rep, 0).repeat_interleave(
        rep, 1)[::row_step]
    mv_y = mv[..., 1].repeat_interleave(rep, 0).repeat_interleave(
        rep, 1)[::row_step]
    return torch.stack([base_x + mv_x, base_y + mv_y], -1).to(torch.int32)
