"""Quadtree helpers of the multi-model encoder and decoder paths.

PyTorch counterpart of `node_sizes`, `_up2`, `_coeff_bits_est` and
`qt_boundary_strengths` in `vvc_mm_tpu/common/qtree.py`.  The classic
quadtree codec is ROADMAP queue 1 item 11.
"""
from __future__ import annotations

import torch


def node_sizes(top: int, depth: int) -> list[int]:
    return [top >> d for d in range(depth + 1)]


def _up2(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    """Nearest-neighbor upsample of the leading two axes by f."""
    return x.repeat_interleave(f, 0).repeat_interleave(f, 1)


def _coeff_bits_est(lev: torch.Tensor) -> torch.Tensor:
    """Per-block coefficient bit estimate for the split decision (the real
    rate comes from the CABAC pass).  lev (nby, nbx, s, s) -> float32
    (nby, nbx).  The formula is the JAX package's, in float32: at a
    magnitude of 2^k - 1 one ulp of log2 decides between k and k + 1."""
    a = lev.abs().to(torch.float32)
    bits = torch.where(a > 0, 2.0 * torch.ceil(torch.log2(a + 1.0)) + 1.0,
                       torch.zeros_like(a))
    return bits.sum(dim=(2, 3))


def qt_boundary_strengths(mv_unit, has_resid_unit, leaf_id_unit):
    """Deblock boundary strengths on the unit grid, masked to actual leaf
    boundaries (no edges interior to a transform block — reference:
    DeblockingFilter.cpp xDeblockCU)."""
    from . import deblock
    mv_unit = torch.as_tensor(mv_unit).to(torch.int32)
    has_resid_unit = torch.as_tensor(has_resid_unit)
    leaf_id_unit = torch.as_tensor(leaf_id_unit)
    bs_v, bs_h = deblock.boundary_strengths_inter(mv_unit, has_resid_unit)
    edge_v = leaf_id_unit[:, 1:] != leaf_id_unit[:, :-1]
    edge_h = leaf_id_unit[1:] != leaf_id_unit[:-1]
    return bs_v * edge_v, bs_h * edge_h
