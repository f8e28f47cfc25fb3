"""Quadtree inter partitioning: the classic (single-model) P and B
quadtree and the helpers the multi-model quadtree shares.

PyTorch counterpart of `vvc_mm_tpu/common/qtree.py` (reference: the QTBT
partitioner, UnitPartitioner.h:56-64 CU_QUAD_SPLIT, driven by the recursive
per-CU RD search EncCu.cpp:499 xCompressCU, :1118 xCheckModeSplit).  The
serial recursion becomes one batched pass per node size:

  1. one ME + residual pass per node size (top, top/2, ... unit) over the
     whole frame,
  2. per-block RD costs as float32 tensors (SSD + lambda * bit estimates),
  3. a bottom-up min-reduction resolves the split tree,
  4. the tree is resolved to the unit grid: a per-unit MV field drives ONE
     motion-compensation pass (separable MC is position-invariant, so
     unit-granularity MC of a merged leaf equals leaf-granularity MC),
     while the residuals stay per leaf size.

The decisions are float32 and follow the JAX package's XLA CPU numerics.
Its quadtree encoders are jitted programs: there the cost
`ssd + lam * bits` is one fused multiply-add and the MV bit estimate
2 log2(x) + 2 one too (`fused=True`).  Its MTT encoders (common/mtt.py)
run operation by operation, each operation rounded on its own
(`fused=False`).  `_sum2x2` adds the two row pairs first either way.  Ties
keep the node (a split must be strictly cheaper).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import quant, transforms
from .inter_frame import (_combine_bi, _dmvr, _luma_combine,
                          _mc_planes_internal, mc_predict)


def node_sizes(top: int, depth: int) -> list[int]:
    return [top >> d for d in range(depth + 1)]


def resid_plane(grids, qp: int, h: int, w: int, bit_depth: int,
                offsets=None) -> torch.Tensor:
    """Sum of the inverse-transformed residuals of level grids
    (gy, gx, sy, sx), each placed at its (y, x) offset in an (h, w) plane
    (zero offsets by default).  Blocks off the leaves carry zero levels,
    so their contribution is exactly zero."""
    total = torch.zeros((h, w), dtype=torch.int32, device=grids[0].device)
    for i, g in enumerate(grids):
        gy, gx, sy, sx = g.shape
        lw, lh = sx.bit_length() - 1, sy.bit_length() - 1
        dq = quant.dequantize(g.reshape(-1, sy, sx), qp, lw, lh, bit_depth)
        r = transforms.inverse_transform(dq, bit_depth=bit_depth)
        plane = (r.reshape(gy, gx, sy, sx).permute(0, 2, 1, 3)
                 .reshape(gy * sy, gx * sx))
        yo, xo = offsets[i] if offsets is not None else (0, 0)
        total[yo:yo + gy * sy, xo:xo + gx * sx] += plane
    return total


def _recon(pred, sq_levels, qp: int, bit_depth: int, rect=()):
    """Prediction planes + the residual sum of every shape grid, clipped.
    rect: (levels trio, (y_off, x_off) in luma) per rectangular grid."""
    maxv = (1 << bit_depth) - 1
    out = {}
    for c, key in enumerate("yuv"):
        div = 1 if c == 0 else 2
        h, w = pred[c].shape
        grids = [t[c] for t in sq_levels] + [t[c] for t, _ in rect]
        offs = ([(0, 0)] * len(sq_levels)
                + [(yo // div, xo // div) for _, (yo, xo) in rect])
        out[key] = torch.clamp(
            pred[c] + resid_plane(grids, qp, h, w, bit_depth, offs), 0,
            maxv)
    return out


def reconstruct_qt(mv_unit, levels, ref_y, ref_u, ref_v, qp: int, top: int,
                   depth: int, bit_depth: int, wrap_around: bool):
    """Shared encoder/decoder reconstruction: one unit-granularity MC pass
    + the sum of per-size inverse transforms.

    Args:
      mv_unit: (H/u, W/u, 2) resolved 1/16-pel MV field, u = top >> depth.
      levels: list over sizes [top .. u] of (lev_y, lev_u, lev_v) grids.
    Returns recon dict(y=, u=, v=)."""
    pred = mc_predict(ref_y, ref_u, ref_v, mv_unit, top >> depth, bit_depth,
                      wrap_around)
    return _recon(pred, levels, qp, bit_depth)


def reconstruct_qt_b(mv0_unit, mv1_unit, dirs_unit, levels, ref0, ref1,
                     qp: int, top: int, depth: int, bit_depth: int,
                     wrap_around: bool, bdof: bool = False,
                     dmvr: bool = False):
    """Shared B reconstruction at unit granularity: per-unit uni/bi combine
    (dirs 0=L0, 1=L1, 2=BI; BDOF on bi luma, DMVR refining the unit
    fields — a merged leaf's units share one MV pair) + the per-size
    residual sum."""
    u = top >> depth
    h, w = ref0[0].shape
    if dmvr:
        mv0_unit, mv1_unit = _dmvr(ref0, ref1, mv0_unit, mv1_unit,
                                   dirs_unit, u, wrap_around)
    pred = _pred_b(ref0, ref1, mv0_unit, mv1_unit, dirs_unit, u, bit_depth,
                   wrap_around, bdof)
    return _recon(pred, levels, qp, bit_depth)


def _pred_b(ref0, ref1, mv0, mv1, dirs, s: int, bit_depth: int,
            wrap_around: bool, bdof: bool = False):
    h, w = ref0[0].shape
    nby, nbx = h // s, w // s
    i0 = _mc_planes_internal(*ref0, mv0, s, bit_depth, wrap_around)
    i1 = _mc_planes_internal(*ref1, mv1, s, bit_depth, wrap_around)
    return (_luma_combine(i0[0], i1[0], dirs, nby, nbx, bit_depth, bdof),
            _combine_bi(i0[1], i1[1], dirs, nby, nbx, bit_depth),
            _combine_bi(i0[2], i1[2], dirs, nby, nbx, bit_depth))


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
