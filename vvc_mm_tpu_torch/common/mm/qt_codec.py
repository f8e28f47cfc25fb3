"""Multi-model motion inside the quadtree lattice (MM x partitioning).

PyTorch counterpart of `vvc_mm_tpu/common/mm/qt_codec.py` (reference:
EncCu.cpp:775-798 — the per-model mode loop at every evaluated CU).  The
per-block model search runs frame-batched at EACH node size
(mm/frame_codec), the split tree resolves bottom-up on the host, and the
winning (model, MV) pairs resolve to the UNIT grid.  MM target positions
depend only on (subblock center, MV, model), not on the partition, so one
merged-positions MC pass at unit granularity predicts the mixed-size,
mixed-model frame and the per-size residuals are added on top.
"""
from __future__ import annotations

import torch

from ..qtree import (_coeff_bits, _mask_and_locate, _recon, _residuals,
                     _ssd_planes, node_sizes)
from . import frame_codec as fc
from .reprojection import MVReprojection, SUBBLK


def reconstruct_qt_mm(reproj: MVReprojection, active_models: list[int],
                      midx_unit, mv_unit, levels, ref_y, ref_u, ref_v,
                      qp: int, top: int, depth: int, bit_depth: int,
                      epipoles: dict | None = None,
                      wrap_around: bool = False, positions=None,
                      _preds=None):
    """Unit-granularity merged positions -> one MC pass -> per-size
    residual sum.  midx_unit (nuy, nux) model index, mv_unit (nuy, nux, 2)
    the selected model's MV per unit, levels one (y, u, v) trio per node
    size.  _preds: the encoder tail's already computed predictions."""
    u = top >> depth
    assert u >= SUBBLK
    dev = ref_y.device
    if _preds is not None:
        pred_y, pred_u, pred_v = _preds
    else:
        if positions is None:
            midx_unit = torch.as_tensor(midx_unit, device=dev)
            mv_unit = torch.as_tensor(mv_unit, device=dev)
            # stack with each unit's MV in its selected model's layer
            stack = fc._to_stack(midx_unit, mv_unit, len(active_models))
            positions = fc.merged_positions(reproj, active_models,
                                            midx_unit, stack, u, epipoles)
        pred_y, pred_u, pred_v = fc.predict_from_positions(
            positions, ref_y, ref_u, ref_v, bit_depth, wrap_around)

    levels = [tuple(torch.as_tensor(lev, device=dev) for lev in trio)
              for trio in levels]
    return _recon((pred_y, pred_u, pred_v), levels, qp, bit_depth)


def search_qt_mm(reproj: MVReprojection, active_models: list[int],
                 orig_y, ref_y, qp: int, top: int, depth: int,
                 bit_depth: int, search_range: int,
                 epipoles: dict | None = None, wrap_around: bool = False,
                 seed=None):
    """Per-size merge-aware MM search for the quadtree lattice.

    The UNIT size runs the full flat-path search
    (frame_codec.search_p_mm_merge — identical decisions to the fixed
    grid, so the tree's worst case is the grid plus split bins); each
    parent size is evaluated from its children's selections
    (search_qt_parent_mm), the batched analog of the QTMT recursion's
    information reuse (reference: EncCu.cpp:499 xCompressCU).

    Returns (per_size list ordered [top .. unit] of tuples
    (idx, mv_sel, sad_sel, cand_idx, cand_mv, cand_sads), unit_stack)
    — unit_stack is the per-model MV stack for temporal seeding."""
    sizes = node_sizes(top, depth)
    u = sizes[-1]
    idx, stack, sad, cidx, cmv, csad = fc.search_p_mm_merge(
        reproj, active_models, orig_y, ref_y, qp, u, bit_depth,
        search_range, epipoles, wrap_around, seed=seed)
    mv_sel = fc._take0(stack, idx)
    per = {u: (idx, mv_sel, sad, cidx, cmv, csad)}
    idx_c, mv_c = idx, mv_sel
    for s in reversed(sizes[:-1]):
        # this size's own flat search — without it a noisy child level
        # would degrade every ancestor and the tree could lose to the
        # fixed grid
        oidx, ostack = fc.search_p_mm(reproj, active_models, orig_y,
                                      ref_y, qp, s, bit_depth,
                                      search_range, epipoles, wrap_around)
        omv = fc._take0(ostack, oidx)
        out = fc.search_qt_parent_mm(reproj, active_models, orig_y, ref_y,
                                     idx_c, mv_c, oidx, omv, qp, s,
                                     bit_depth, epipoles, wrap_around)
        per[s] = out
        idx_c, mv_c = out[0], out[1]
    return [per[s] for s in sizes], stack


def qt_rd_stats(reproj: MVReprojection, active_models: list[int],
                midx, mv_sel, orig_y, orig_u, orig_v, ref_y, ref_u,
                ref_v, qp: int, block_size: int, bit_depth: int,
                epipoles: dict | None = None, wrap_around: bool = False):
    """Per-block RD statistics for one tree level's selection: full-frame
    prediction from (model, mv) grids, residual transform/quant at this
    block size, per-block SSD of the reconstruction and a coefficient-bit
    estimate.  The split resolve compares levels in the SSD + lambda*bits
    domain the reference's xCheckModeSplit uses (EncCu.cpp:1118), not raw
    SAD.  Returns (ssd (nby,nbx) int32, coeff_bits (nby,nbx) int32)."""
    s = block_size
    stack = fc._to_stack(midx, mv_sel, len(active_models))
    pos = fc.merged_positions(reproj, active_models, midx, stack, s,
                              epipoles)
    pred_y, pred_u, pred_v = fc.predict_from_positions(
        pos, ref_y, ref_u, ref_v, bit_depth, wrap_around)
    lev, rec = _residuals((orig_y, orig_u, orig_v), (pred_y, pred_u, pred_v),
                          s, qp, bit_depth)
    ssd = _ssd_planes((orig_y, orig_u, orig_v), rec, s).to(torch.int32)
    return ssd, _coeff_bits(lev, 0.0).to(torch.int32)


def enc_finish_qt_mm(reproj: MVReprojection, active_models: list[int],
                     midx_unit, mv_unit, leaf_masks, orig_y, orig_u,
                     orig_v, ref_y, ref_u, ref_v, qp: int, top: int,
                     depth: int, bit_depth: int,
                     epipoles: dict | None = None,
                     wrap_around: bool = False):
    """Encoder tail for the merge-aware MM quadtree: ONE unit-granularity
    MC pass from the FINAL (post-merge-selection) grids, then per-size
    residual transforms masked to the resolved leaves (MM positions
    depend only on (subblock center, MV, model), so unit-granularity MC
    of a merged leaf is bit-identical to leaf-granularity MC).

    Returns (levels [per size (ly, lu, lv)], recon dict,
    has_resid_unit, leaf_id_unit)."""
    sizes = node_sizes(top, depth)
    stack = fc._to_stack(midx_unit, mv_unit, len(active_models))
    positions = fc.merged_positions(reproj, active_models, midx_unit,
                                    stack, sizes[-1], epipoles)
    preds = fc.predict_from_positions(positions, ref_y, ref_u, ref_v,
                                      bit_depth, wrap_around)
    per_lev = [_residuals((orig_y, orig_u, orig_v), preds, s, qp,
                          bit_depth)[0] for s in sizes]
    # levels masked to the leaves, and the unit-granularity deblock inputs
    levels, has_resid_unit, leaf_id_unit = _mask_and_locate(
        per_lev, leaf_masks, sizes, sizes[-1])
    recon = reconstruct_qt_mm(
        reproj, active_models, midx_unit, mv_unit, levels, ref_y, ref_u,
        ref_v, qp, top, depth, bit_depth, epipoles, wrap_around,
        _preds=preds)
    return levels, recon, has_resid_unit, leaf_id_unit
