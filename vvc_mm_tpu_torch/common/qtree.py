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

from . import interp, quant, transforms
from .inter_frame import (MC_MARGIN, _block_coords, _combine_bi, _dmvr,
                          _luma_combine, _mc_planes_internal, _residual_pass,
                          _to_blocks, mc_predict, pad_ref)
from .rdcost import first_argmin


def node_sizes(top: int, depth: int) -> list[int]:
    return [top >> d for d in range(depth + 1)]


def _up2(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    """Nearest-neighbor upsample of the leading two axes by f."""
    return x.repeat_interleave(f, 0).repeat_interleave(f, 1)


def _sum2x2(x: torch.Tensor) -> torch.Tensor:
    """float32 sum of each 2x2 cell, in XLA's CPU order: the two row pairs
    first, then their sum."""
    return ((x[0::2, 0::2] + x[0::2, 1::2])
            + (x[1::2, 0::2] + x[1::2, 1::2]))


def _coeff_bits_est(lev: torch.Tensor) -> torch.Tensor:
    """Per-block coefficient bit estimate for the split decision (the real
    rate comes from the CABAC pass).  lev (nby, nbx, s, s) -> float32
    (nby, nbx).  The formula is the JAX package's, in float32: at a
    magnitude of 2^k - 1 one ulp of log2 decides between k and k + 1
    (XLA's and torch's log2 agree on every level below 2^17); the sum is
    of small integers, exact in any order."""
    a = lev.abs().to(torch.float32)
    bits = torch.where(a > 0, 2.0 * torch.ceil(torch.log2(a + 1.0)) + 1.0,
                       torch.zeros_like(a))
    return bits.sum(dim=(2, 3))


@functools.lru_cache(maxsize=None)
def _mv_bits_unfused_np() -> np.ndarray:
    """float32 2 log2(d + 1) + 2 for d in [0, LOG2_LEVELS), operation by
    operation as XLA's CPU backend runs it: its log2 is its log times
    float32(1 / ln 2), rounded, then doubled, then 2 added and rounded
    (equal to XLA's below d = 11,047)."""
    x = np.arange(1, quant.LOG2_LEVELS + 1, dtype=np.float32)
    l2 = (quant._xla_log_f32(x) * np.float32(1.0 / np.log(2.0))).astype(
        np.float32)
    return (np.float32(2.0) * l2 + np.float32(2.0)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mv_bits_table(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_mv_bits_unfused_np()).to(device)


def _mv_bits_est(mv: torch.Tensor, pred: torch.Tensor,
                 fused: bool = True) -> torch.Tensor:
    """EG1-ish float32 bit estimate 2 log2(|mvd|_1 + 1) + 2 of an MVD given
    a predictor grid, XLA's value of it: in a jitted program its log, the
    product fused with the add (quant.log2_rate); operation by operation,
    _mv_bits_unfused_np."""
    d = (mv - pred).abs().sum(dim=-1)
    if fused:
        return quant.log2_rate(d, 2.0)
    return _mv_bits_table(d.device)[d.long()]


def rd_cost_f32(a: torch.Tensor, lam: float, b: torch.Tensor,
                fused: bool = True) -> torch.Tensor:
    """float32 a + float32(lam) * b.  fused: rounded once, as XLA's CPU
    backend contracts the product and the add of a jitted program into
    one fused multiply-add (the product of two float32 values is exact in
    float64); else the product and the sum each rounded to float32."""
    lam32 = float(np.float32(lam))
    if not fused:
        return a + lam32 * b
    return (a.to(torch.float64) + lam32 * b.to(torch.float64)).to(
        torch.float32)


def _bsum(x: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    h, w = x.shape
    return x.reshape(h // sy, sy, w // sx, sx).sum(dim=(1, 3))


def _ssd_planes(orig, rec, s: int) -> torch.Tensor:
    """Per-block integer SSD of the three planes at luma block size s."""
    return (_bsum((orig[0] - rec[0]) ** 2, s, s)
            + _bsum((orig[1] - rec[1]) ** 2, s // 2, s // 2)
            + _bsum((orig[2] - rec[2]) ** 2, s // 2, s // 2))


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


def _me(orig_y, ref_pad, s: int, search_range: int, lam16: int,
        bit_depth: int):
    from ..encoder import me as me_mod
    mv_int, _ = me_mod.hierarchical_search(orig_y, ref_pad, s, search_range,
                                           MC_MARGIN, lam16)
    return me_mod.fractional_refine(orig_y, ref_pad, mv_int, s, MC_MARGIN,
                                    bit_depth)


def _residuals(orig, pred, s: int, qp: int, bit_depth: int):
    """_residual_pass of the three planes -> (levels trio, recon planes)."""
    ly, ry = _residual_pass(orig[0], pred[0], s, qp, bit_depth)
    lu, ru = _residual_pass(orig[1], pred[1], s // 2, qp, bit_depth)
    lv, rv = _residual_pass(orig[2], pred[2], s // 2, qp, bit_depth)
    return (ly, lu, lv), (ry, ru, rv)


def _coeff_bits(levels, hdr: float) -> torch.Tensor:
    return (_coeff_bits_est(levels[0]) + _coeff_bits_est(levels[1])
            + _coeff_bits_est(levels[2]) + hdr)


def encode_p_frame_qt(orig_y, orig_u, orig_v, ref_y, ref_u, ref_v, qp: int,
                      top: int = 32, depth: int = 2, bit_depth: int = 8,
                      search_range: int = 24, wrap_around: bool = False):
    """Batched quadtree P encode.  Returns a dict with:
      splits: list of depth bool grids (split decision per node level),
      mvs: list of depth+1 per-size MV grids (1/16-pel),
      levels: list of per-size (lev_y, lev_u, lev_v), zeroed off-leaf,
      leaf: list of per-size bool leaf masks,
      mv_unit: resolved (H/u, W/u, 2) field, recon dict,
      has_resid_unit / leaf_id_unit: deblock inputs at unit granularity.
    """
    sizes = node_sizes(top, depth)
    u = sizes[-1]
    lam = quant.lambda_from_qp(qp, intra=False)
    lam16 = int(lam ** 0.5 * 16)
    orig = (orig_y, orig_u, orig_v)
    ry_pad = pad_ref(ref_y, MC_MARGIN, wrap_around)

    per_mv, per_lev, per_cost = [], [], []
    parent_mv = None
    for s in sizes:
        mv, _ = _me(orig_y, ry_pad, s, search_range, lam16, bit_depth)
        pred = mc_predict(ref_y, ref_u, ref_v, mv, s, bit_depth, wrap_around)
        lev, rec = _residuals(orig, pred, s, qp, bit_depth)
        pred_grid = (torch.zeros_like(mv) if parent_mv is None
                     else _up2(parent_mv))
        bits = _coeff_bits(lev, 6.0) + _mv_bits_est(mv, pred_grid)
        per_mv.append(mv)
        per_lev.append(lev)
        ssd = _ssd_planes(orig, rec, s).to(torch.float32)
        per_cost.append(rd_cost_f32(ssd, lam, bits))
        parent_mv = mv

    splits, leaf = _resolve_tree(per_cost, lam, depth)
    masked_levels, has_resid_unit, leaf_id_unit = _mask_and_locate(
        per_lev, leaf, sizes, u)
    mv_unit = _field_to_unit(per_mv, leaf, sizes, u)
    recon = reconstruct_qt(mv_unit, masked_levels, ref_y, ref_u, ref_v, qp,
                           top, depth, bit_depth, wrap_around)
    return dict(splits=splits, mvs=per_mv, levels=masked_levels, leaf=leaf,
                mv_unit=mv_unit, recon=recon,
                has_resid_unit=has_resid_unit, leaf_id_unit=leaf_id_unit)


def _resolve_tree(per_cost, lam: float, depth: int):
    """Bottom-up tree resolve: min(cost of keeping a node, cost of its four
    children + one split-flag bit) — the batched analog of
    EncCu::xCheckModeSplit — followed by the top-down leaf masks."""
    lam32 = float(np.float32(lam))
    splits = [None] * depth
    best = per_cost[depth]
    for d in range(depth - 1, -1, -1):
        agg = _sum2x2(best) + lam32
        splits[d] = agg < per_cost[d]
        best = torch.where(splits[d], agg, per_cost[d])
    leaf = []
    alive = torch.ones(per_cost[0].shape, dtype=torch.bool,
                       device=per_cost[0].device)
    for d in range(depth):
        sp = splits[d] & alive
        splits[d] = sp
        leaf.append(alive & ~sp)
        alive = _up2(sp)
    leaf.append(alive)
    return splits, leaf


def _field_to_unit(fields, leaf, sizes, u: int):
    """Resolve a per-size per-block field (trailing dims broadcast) onto
    the unit grid via the leaf masks."""
    out = fields[-1]
    extra = out.dim() - 2
    for d, s in enumerate(sizes[:-1]):
        f = s // u
        lm = _up2(leaf[d], f)
        lm = lm.reshape(lm.shape + (1,) * extra)
        out = torch.where(lm, _up2(fields[d], f), out)
    return out


def _mask_and_locate(per_lev, leaf, sizes, u: int):
    """Zero levels off-leaf; derive unit-granularity has-residual and
    leaf-id (top-left unit index) grids for deblocking."""
    nuy, nux = leaf[-1].shape
    dev = leaf[-1].device
    has_resid_unit = torch.zeros((nuy, nux), dtype=torch.bool, device=dev)
    leaf_id_unit = torch.zeros((nuy, nux), dtype=torch.int32, device=dev)
    masked_levels = []
    for d, s in enumerate(sizes):
        f = s // u
        lmask = leaf[d]
        ml = tuple(lev * lmask[:, :, None, None] for lev in per_lev[d])
        masked_levels.append(ml)
        hr = torch.zeros(lmask.shape, dtype=torch.bool, device=dev)
        for lev in ml:
            hr = hr | (lev != 0).any(3).any(2)
        lm_u = _up2(lmask, f)
        has_resid_unit = has_resid_unit | (lm_u & _up2(hr, f))
        by = torch.arange(lmask.shape[0], dtype=torch.int32,
                          device=dev)[:, None] * f
        bx = torch.arange(lmask.shape[1], dtype=torch.int32,
                          device=dev)[None, :] * f
        leaf_id_unit = torch.where(lm_u, _up2(by * nux + bx, f),
                                   leaf_id_unit)
    return masked_levels, has_resid_unit, leaf_id_unit


def _uni_bi_dirs(sads, sad_bi, mv_bits: int) -> torch.Tensor:
    """Per-block direction (0 L0, 1 L1, 2 BI) by SAD, bi paying mv_bits;
    ties take the first (jnp.argmin)."""
    return first_argmin(torch.stack([sads[0], sads[1], sad_bi + mv_bits]),
                        0).to(torch.int32)


def encode_b_frame_qt(orig_y, orig_u, orig_v, ref0, ref1, qp: int,
                      top: int = 32, depth: int = 2, bit_depth: int = 8,
                      search_range: int = 24, wrap_around: bool = False,
                      bdof: bool = False, dmvr: bool = False):
    """Batched quadtree B encode: per-size per-list ME + the uni/bi
    direction decision, then the same lattice RD resolve as the P path
    (reference: InterSearch::predInterSearch L0/L1/bi inside the EncCu
    QTMT recursion).  The per-size passes combine without BDOF/DMVR; the
    final reconstruction applies them."""
    sizes = node_sizes(top, depth)
    u = sizes[-1]
    lam = quant.lambda_from_qp(qp, intra=False)
    lam16 = int(lam ** 0.5 * 16)
    mv_bits = int(lam ** 0.5 * 8)
    orig = (orig_y, orig_u, orig_v)
    pads = (pad_ref(ref0[0], MC_MARGIN, wrap_around),
            pad_ref(ref1[0], MC_MARGIN, wrap_around))
    h, w = orig_y.shape

    per_mv0, per_mv1, per_dirs, per_lev, per_cost = [], [], [], [], []
    parents = (None, None)
    for s in sizes:
        nby, nbx = h // s, w // s
        yb, xb = _block_coords(nby, nbx, s, orig_y.device)
        mvs, sads, ipreds = [], [], []
        for rp in pads:
            mv, sad = _me(orig_y, rp, s, search_range, lam16, bit_depth)
            mvs.append(mv)
            sads.append(sad)
            ipreds.append(interp.mc_luma(rp, mv.reshape(-1, 2), yb, xb, s,
                                         s, MC_MARGIN, bit_depth))
        bi_pix = interp.finalize_bi(ipreds[0], ipreds[1], bit_depth)
        sad_bi = (bi_pix - _to_blocks(orig_y, s)).abs().sum(
            dim=(1, 2)).reshape(nby, nbx)
        dirs = _uni_bi_dirs(sads, sad_bi, mv_bits)
        pred = _pred_b(ref0, ref1, mvs[0], mvs[1], dirs, s, bit_depth,
                       wrap_around)
        lev, rec = _residuals(orig, pred, s, qp, bit_depth)
        bits = _coeff_bits(lev, 8.0)                 # skip/dir/cbf bins
        for li, mv in enumerate(mvs):
            pg = (torch.zeros_like(mv) if parents[li] is None
                  else _up2(parents[li]))
            used = (dirs != 1) if li == 0 else (dirs != 0)
            bits = bits + torch.where(used, _mv_bits_est(mv, pg), 0.0)
        per_mv0.append(mvs[0])
        per_mv1.append(mvs[1])
        per_dirs.append(dirs)
        per_lev.append(lev)
        ssd = _ssd_planes(orig, rec, s).to(torch.float32)
        per_cost.append(rd_cost_f32(ssd, lam, bits))
        parents = (mvs[0], mvs[1])

    splits, leaf = _resolve_tree(per_cost, lam, depth)
    masked_levels, has_resid_unit, leaf_id_unit = _mask_and_locate(
        per_lev, leaf, sizes, u)
    mv0_unit = _field_to_unit(per_mv0, leaf, sizes, u)
    mv1_unit = _field_to_unit(per_mv1, leaf, sizes, u)
    dirs_unit = _field_to_unit(per_dirs, leaf, sizes, u)
    recon = reconstruct_qt_b(mv0_unit, mv1_unit, dirs_unit, masked_levels,
                             ref0, ref1, qp, top, depth, bit_depth,
                             wrap_around, bdof, dmvr)
    return dict(splits=splits, mv0=per_mv0, mv1=per_mv1, dirs=per_dirs,
                levels=masked_levels, leaf=leaf, mv0_unit=mv0_unit,
                mv1_unit=mv1_unit, dirs_unit=dirs_unit, recon=recon,
                has_resid_unit=has_resid_unit, leaf_id_unit=leaf_id_unit)


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
