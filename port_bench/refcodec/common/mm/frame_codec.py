"""Multi-model P/B frames: per-block model search, merged positions + one
MC pass.

PyTorch counterpart of `vvc_mm_tpu/common/mm/frame_codec.py` (reference:
EncCu.cpp:775-798 per-model mode loop, InterSearch.cpp:2695 predInterSearch;
decoder side DecCu.cpp + InterPrediction.cpp:520-528 model dispatch).

Reconstruction: every model's per-subblock positions are computed
frame-wide, merged per block by the signalled model index, and ONE
position-based MC pass (kernels K1/K2) predicts the frame.

Search: every model's motion search runs frame-batched (a diamond
refinement whose every step evaluates all blocks at once through the
decision-SAD kernels K3/K5), one argmin picks the per-block model, and the
merge candidates' SADs are measured by the same kernels (K3, K4 for the B
bands).  The search only picks MVs and models: float drift in its
positions can change a decision, never break decode.  The JAX package
traces each search as one program; here they are plain functions.

The P reconstruct functions take an optional `positions=` argument, the
merged positions tensor to use instead of computing it; the B ones, whose
projected DMVR (the signalling-free bilateral refinement of bi blocks)
computes positions of its own, a `positions_fn` that replaces every
positions computation.  The positions are float32 sphere math rounded to
1/16 pel, and this lets a caller reconstruct from positions computed
elsewhere (the JAX package's in the tests, the card's in a CPU check).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import quant, transforms
from ...device import check_device
from ..inter_frame import (MC_MARGIN, _from_blocks, _to_blocks, first_argmin,
                           pad_ref)
from ..typedefs import MotionModelID as M
from . import mc as mm_mc
from .reprojection import MVReprojection

# The codec's calls of the K-field positions (MVReprojection.positions and
# .centers): each a merged-positions call, a merge-search or decision step
# of K fields, or a diamond step of K candidates.  On the card each that
# reaches a sphere model is one kernel launch.
POSITION_CALLS = {"sphere_positions": 0, "sphere_centers": 0}


def _up(t: torch.Tensor, rep: int) -> torch.Tensor:
    return t.repeat_interleave(rep, 0).repeat_interleave(rep, 1)


def _positions(reproj: MVReprojection, model_ids: list[int], model_idx,
               mvs, block_size: int, row_step: int, col_step: int,
               form: str | None, epipoles: dict | None) -> torch.Tensor:
    """reproj.positions of K fields, counted in POSITION_CALLS."""
    POSITION_CALLS["sphere_positions"] += 1
    return reproj.positions(model_ids, model_idx, mvs, block_size, row_step,
                            col_step, form, epipoles)


def _centers(reproj: MVReprojection, model_ids: list[int], model_idx, mvs,
             block_size: int, epipoles: dict | None) -> torch.Tensor:
    """reproj.centers of K fields in the form of the JAX codec's search
    jits, counted in POSITION_CALLS."""
    POSITION_CALLS["sphere_centers"] += 1
    return reproj.centers(model_ids, model_idx, mvs, block_size, epipoles,
                          "search")


def _model_positions(reproj: MVReprojection, model_id: int,
                     mvs: torch.Tensor, block_size: int, epipole,
                     row_step: int, form: str | None = "merged"
                     ) -> torch.Tensor:
    """One model's per-subblock positions for a (nby, nbx, 2) MV field:
    integer math for CLASSIC, the reprojection otherwise."""
    mvs = torch.as_tensor(mvs, device=reproj.device)
    return _positions(reproj, [model_id], None, mvs[None, None], block_size,
                      row_step, 1, form, {model_id: epipole})[0]


def merged_positions(reproj: MVReprojection, active_models: list[int],
                     model_idx: torch.Tensor, mvs_stack: torch.Tensor,
                     block_size: int, epipoles: dict | None = None,
                     row_step: int = 1, form: str | None = "merged"
                     ) -> torch.Tensor:
    """Merge per-subblock target positions across models.

    Args:
      model_idx: (nby, nbx) index into active_models per block.
      mvs_stack: (n_models, nby, nbx, 2) MV of each model for each block.
      row_step: optional subblock-row subsampling (search-time SADs).
      form: the float32 form of the JAX codec's jit that computes these
        positions (reproject_frame's `form`).
    Returns (nsy, nsx, 2) int32 positions on the reprojection's device."""
    dev = reproj.device
    model_idx = torch.as_tensor(model_idx, device=dev)
    mvs_stack = torch.as_tensor(mvs_stack, device=dev)
    return _positions(reproj, active_models, model_idx[None],
                      mvs_stack[None], block_size, row_step, 1, form,
                      epipoles)[0]


def predict_from_positions(positions: torch.Tensor, ref_y, ref_u, ref_v,
                           bit_depth: int, wrap_around: bool = False):
    """One MC pass for all models: luma (K1) + both chroma planes (K2)
    from the merged per-subblock position tensor."""
    ry = pad_ref(ref_y, MC_MARGIN, wrap_around)
    ru = pad_ref(ref_u, MC_MARGIN // 2, wrap_around)
    rv = pad_ref(ref_v, MC_MARGIN // 2, wrap_around)
    check_device(positions, ry.device, "positions")
    positions = positions.to(torch.int32)
    pred_y = mm_mc.mc_luma_positions(ry, positions, MC_MARGIN, bit_depth)
    # chroma: 2x2 subblocks; position tensor reinterpreted at 1/32 chroma
    pred_u = mm_mc.mc_chroma_positions(ru, positions, MC_MARGIN // 2,
                                       bit_depth)
    pred_v = mm_mc.mc_chroma_positions(rv, positions, MC_MARGIN // 2,
                                       bit_depth)
    return pred_y, pred_u, pred_v


def _rec_plane(pred, lev, size, nby, nbx, qp, bit_depth):
    log2s = size.bit_length() - 1
    pb = _to_blocks(pred, size)
    lev = torch.as_tensor(lev, device=pred.device)
    dq = quant.dequantize(lev.reshape(-1, size, size), qp, log2s, log2s,
                          bit_depth)
    r = transforms.inverse_transform(dq, bit_depth=bit_depth)
    rec = torch.clamp(pb + r, 0, (1 << bit_depth) - 1)
    return _from_blocks(rec, nby, nbx)


def reconstruct_p_frame_mm(reproj: MVReprojection, active_models: list[int],
                           model_idx, mvs_stack, lev_y, lev_u, lev_v,
                           ref_y, ref_u, ref_v, qp: int, block_size: int,
                           bit_depth: int = 8, epipoles: dict | None = None,
                           wrap_around: bool = False, positions=None):
    """Decoder reconstruction of a fixed-grid multi-model P frame."""
    s = block_size
    h, w = ref_y.shape
    nby, nbx = h // s, w // s
    if positions is None:
        positions = merged_positions(reproj, active_models, model_idx,
                                     mvs_stack, s, epipoles)
    pred_y, pred_u, pred_v = predict_from_positions(
        positions, ref_y, ref_u, ref_v, bit_depth, wrap_around)
    return dict(y=_rec_plane(pred_y, lev_y, s, nby, nbx, qp, bit_depth),
                u=_rec_plane(pred_u, lev_u, s // 2, nby, nbx, qp, bit_depth),
                v=_rec_plane(pred_v, lev_v, s // 2, nby, nbx, qp, bit_depth))


def _bi_combine_px(p0, p1, dirs, block_size, sub, bit_depth):
    """Per-block uni/bi select of two pixel-domain MM predictions: dirs 0
    list 0, 1 list 1, 2 the rounded average (normative for this codec)."""
    d = _up(dirs, block_size // sub)
    avg = (p0 + p1 + 1) >> 1
    return torch.where(d == 0, p0, torch.where(d == 1, p1, avg))


def make_eval_bilateral(reproj: MVReprojection, model0: int, model1: int,
                        block_size: int, bit_depth: int, ep0=None, ep1=None,
                        positions_fn=None):
    """Bilateral cost (ref0_padded, ref1_padded, mv0, mv1, offsets (K, 2),
    blocks) -> (K, len(blocks)): for each listed block (flat index into
    the (nby, nbx) grid), the SAD between the two list predictions under
    mirrored candidate offsets — the projected-DMVR matching function
    (reference: InterPrediction.cpp:2442 xProcessDMVRProjected; offsets
    applied in each model's own MV domain and taken through the
    reprojection).  The predictions are K1 on the row-subsampled subblock
    grid (SAD_ROW_STEP) and the SAD is _block_sad_sub's, as in the JAX
    package, which costs every block of the frame; here K1 predicts only
    the listed blocks' subblocks, laid out as one row (a block's SAD reads
    only its own subblocks, so the costs are the same).

    ep0/ep1 are the lists' {GEODESIC_CAMPOSE: epipole} dicts or None.
    `positions_fn(active_models, model_idx, mvs_stack, block_size,
    epipoles, row_step)`, when given, computes each prediction's positions
    as merged_positions would for the one-model list [model]."""
    s = block_size
    row_step = SAD_ROW_STEP if s // 4 >= SAD_ROW_STEP else 1
    rows_pb = s // 4 // row_step          # kept subblock rows a block

    def pos_of(model_id, mvs, eps):
        if positions_fn is None:
            return _model_positions(reproj, model_id, mvs, s,
                                    (eps or {}).get(model_id), row_step)
        zero = torch.zeros(mvs.shape[:2], dtype=torch.int32,
                           device=mvs.device)
        return torch.as_tensor(positions_fn(
            [model_id], zero, mvs[None], s, eps, row_step),
            dtype=torch.int32, device=mvs.device)

    def listed(pos, blocks):
        """(nsy_sub, nsx, 2) positions -> the listed blocks' subblocks as
        one row (1, len(blocks) * rows_pb * s/4, 2), block by block."""
        nby, nbx = pos.shape[0] // rows_pb, pos.shape[1] // (s // 4)
        per_block = pos.reshape(nby, rows_pb, nbx, s // 4, 2).permute(
            0, 2, 1, 3, 4).reshape(nby * nbx, rows_pb * (s // 4), 2)
        return per_block[blocks].reshape(1, -1, 2)

    def eval_cands(ref0_padded, ref1_padded, mv0, mv1, offsets, blocks):
        out = []
        for k in range(offsets.shape[0]):
            d = offsets[k][None, None, :]
            p0 = mm_mc.mc_luma_positions(
                ref0_padded, listed(pos_of(model0, mv0 + d, ep0), blocks),
                MC_MARGIN, bit_depth)
            p1 = mm_mc.mc_luma_positions(
                ref1_padded, listed(pos_of(model1, mv1 - d, ep1), blocks),
                MC_MARGIN, bit_depth)
            diff = (p0 - p1).abs().reshape(4, blocks.shape[0], -1)
            out.append((diff.sum(dim=(0, 2)) * row_step).to(torch.int32))
        return torch.stack(out)

    return eval_cands


_DMVR_OFFS = np.array([(0, 0), (-4, 0), (4, 0), (0, -4), (0, 4)],
                      dtype=np.int32)     # quarter-pel plus pattern


def _host(a) -> np.ndarray:
    return np.asarray(a.cpu() if torch.is_tensor(a) else a)


def dmvr_pairs(active_models: list[int], model_idx0, model_idx1,
               dirs) -> list[tuple[int, int]]:
    """The (list-0, list-1) model-index pairs projected DMVR evaluates, in
    the JAX package's loop order: pairs of the same model and pairs with
    CLASSIC on one side, and of those only the pairs some bi block
    selected (a pair without one changes no MV, so it is skipped).  The
    grids are read on the host."""
    i0, i1, d = _host(model_idx0), _host(model_idx1), _host(dirs)
    n = len(active_models)
    bi = d == 2
    used = set(zip(i0[bi].tolist(), i1[bi].tolist()))
    return [(a, b) for a in range(n) for b in range(n)
            if (a, b) in used and (a == b or M.CLASSIC in
                                   (active_models[a], active_models[b]))]


def projected_dmvr(reproj: MVReprojection, active_models: list[int],
                   model_idx0, model_idx1, mvs0_stack, mvs1_stack, dirs,
                   ref0_y, ref1_y, block_size: int, bit_depth: int,
                   epipoles0=None, epipoles1=None, wrap_around=False,
                   positions_fn=None):
    """Signalling-free bilateral refinement of bi-predicted MM blocks
    (projected DMVR).  Encoder and decoder run it identically on the
    signalled MVs; returns the refined (mvs0_stack, mvs1_stack), where only
    each block's SELECTED model entry changes, and only where dirs == 2.
    For every pair of dmvr_pairs the five quarter-pel mirrored offsets
    (centre first) are costed on the pair's bi blocks and the first
    minimum wins.  The model and direction grids are read on the host."""
    dev = reproj.device
    r0 = pad_ref(ref0_y, MC_MARGIN, wrap_around)
    r1 = pad_ref(ref1_y, MC_MARGIN, wrap_around)
    i0h, i1h, dh = _host(model_idx0), _host(model_idx1), _host(dirs)
    st0 = torch.as_tensor(mvs0_stack, device=dev).to(torch.int32)
    st1 = torch.as_tensor(mvs1_stack, device=dev).to(torch.int32)
    offs = torch.as_tensor(_DMVR_OFFS, device=dev)
    out0, out1 = st0.clone(), st1.clone()
    for i0, i1 in dmvr_pairs(active_models, i0h, i1h, dh):
        m0, m1 = active_models[i0], active_models[i1]
        blocks = torch.as_tensor(np.flatnonzero(
            (dh == 2) & (i0h == i0) & (i1h == i1)), device=dev)
        ev = make_eval_bilateral(reproj, m0, m1, block_size, bit_depth,
                                 epipoles0, epipoles1, positions_fn)
        sads = ev(r0, r1, st0[i0], st1[i1], offs, blocks)
        d = offs[first_argmin(sads, 0)]                     # (n, 2)
        out0[i0].view(-1, 2)[blocks] = st0[i0].view(-1, 2)[blocks] + d
        out1[i1].view(-1, 2)[blocks] = st1[i1].view(-1, 2)[blocks] - d
    return out0, out1


def predict_b_mm(reproj, active_models, model_idx0, model_idx1, mvs0_stack,
                 mvs1_stack, dirs, ref0, ref1, block_size, bit_depth,
                 epipoles0=None, epipoles1=None, wrap_around=False,
                 dmvr=False, positions_fn=None):
    """Mixed-model bi-prediction: per-list merged positions -> two MC
    passes -> per-block uni/bi combine.  With `dmvr` the bi blocks first
    go through projected DMVR (shared by encoder and decoder).
    `positions_fn(active_models, model_idx, mvs_stack, block_size,
    epipoles, row_step)`, when given, replaces every positions
    computation: each list's merged positions (row step 1) and projected
    DMVR's candidates."""
    if dmvr:
        mvs0_stack, mvs1_stack = projected_dmvr(
            reproj, active_models, model_idx0, model_idx1, mvs0_stack,
            mvs1_stack, dirs, ref0[0], ref1[0], block_size, bit_depth,
            epipoles0, epipoles1, wrap_around, positions_fn)

    def positions(idx, stack, eps):
        if positions_fn is None:
            return merged_positions(reproj, active_models, idx, stack,
                                    block_size, eps)
        return torch.as_tensor(
            positions_fn(active_models, idx, stack, block_size, eps, 1),
            dtype=torch.int32, device=reproj.device)

    p0 = predict_from_positions(positions(model_idx0, mvs0_stack, epipoles0),
                                *ref0, bit_depth, wrap_around)
    p1 = predict_from_positions(positions(model_idx1, mvs1_stack, epipoles1),
                                *ref1, bit_depth, wrap_around)
    dirs = torch.as_tensor(dirs, device=p0[0].device)
    py = _bi_combine_px(p0[0], p1[0], dirs, block_size, 1, bit_depth)
    pu = _bi_combine_px(p0[1], p1[1], dirs, block_size, 2, bit_depth)
    pv = _bi_combine_px(p0[2], p1[2], dirs, block_size, 2, bit_depth)
    return py, pu, pv


def reconstruct_b_frame_mm(reproj, active_models, model_idx0, model_idx1,
                           mvs0_stack, mvs1_stack, dirs, lev_y, lev_u,
                           lev_v, ref0, ref1, qp, block_size,
                           bit_depth=8, epipoles0=None, epipoles1=None,
                           wrap_around=False, dmvr=False, positions_fn=None):
    """Decoder reconstruction of a multi-model B frame (predict_b_mm, then
    the residual)."""
    s = block_size
    h, w = ref0[0].shape
    nby, nbx = h // s, w // s
    py, pu, pv = predict_b_mm(
        reproj, active_models, model_idx0, model_idx1, mvs0_stack,
        mvs1_stack, dirs, ref0, ref1, s, bit_depth, epipoles0, epipoles1,
        wrap_around, dmvr, positions_fn)
    return dict(y=_rec_plane(py, lev_y, s, nby, nbx, qp, bit_depth),
                u=_rec_plane(pu, lev_u, s // 2, nby, nbx, qp, bit_depth),
                v=_rec_plane(pv, lev_v, s // 2, nby, nbx, qp, bit_depth))


# ------------------------------------------------------------ the search

SAD_ROW_STEP = 4     # search-time SAD subsampling: keep 1-of-4 4-px row
                     # bands (reference: RdCost subShift; non-normative —
                     # only steers the model/MV choice, never the
                     # signalled reconstruction)
SAD_COL_STEP = 2     # and 1-of-2 4-px column bands in the model-search
                     # evals

# Search-eval mode: "block" ranks diamond candidates by the
# block-translational decision SAD (one patch per block, kernel K3 — good
# when blocks subtend small angles, i.e. real frame sizes); "subblock"
# keeps the exact per-subblock reprojection in the diamonds (kernel K5;
# used below a minimum frame height, where a block spans a large latitude
# range and the translational approximation misranks).
BLOCK_EVAL_MIN_HEIGHT = 512

P_SEED_STEPS = (32, 16, 8, 4)   # temporally-seeded P-anchor model search
B_SEED_STEPS = (8, 4)           # temporally-seeded B model search

_NEIGHBOR_SHIFTS = ((0, -1), (-1, 0), (-1, 1))   # left, above, above-right


def _subsample_rows(plane: torch.Tensor, row_step: int,
                    col_step: int = 1) -> torch.Tensor:
    """Keep every row_step-th 4-pixel row band (and every col_step-th
    4-pixel column band) of a frame."""
    h, w = plane.shape
    x = plane.reshape(h // 4, 4, w)[::row_step]
    if col_step > 1:
        x = x.reshape(-1, 4, w // 4, 4)[:, :, ::col_step]
        return x.reshape(-1, (w // 4 // col_step) * 4)
    return x.reshape(-1, w)


def _sad_fields_bilin(ref_padded, orig_sub, pos_k, block_size: int,
                      row_step: int, col_step: int = 1,
                      exact: bool = False, bit_depth: int = 8
                      ) -> torch.Tensor:
    """Per-BLOCK decision SADs for K candidate position fields over the
    row/col-subsampled subblock grid: pos_k (K, nsy_sub, nsx_sub, 2) ->
    (K, nby, nbx) scaled back to full-SAD range.  exact=False takes the
    2-tap bilinear SAD (kernel K6, sad_bilinear_positions; it only ranks
    candidates), exact=True the fused 8-tap SAD (kernel K5) — for
    RD-critical field SADs, where bilinear's blur would favour
    integer-position candidates.  Every caller in the codec asks for the
    exact arm, as in the JAX package."""
    if exact:
        sads = mm_mc.sad_positions_multi(ref_padded, orig_sub, pos_k,
                                         MC_MARGIN, bit_depth)
    else:
        sads = mm_mc.sad_bilinear_positions(ref_padded, orig_sub, pos_k,
                                            MC_MARGIN)
    k, ny, nx = sads.shape
    rows_pb = block_size // 4 // row_step
    cols_pb = block_size // 4 // col_step
    return (sads.reshape(k, ny // rows_pb, rows_pb, nx // cols_pb,
                         cols_pb).sum(dim=(2, 4))
            * (row_step * col_step)).to(torch.int32)


def _to_stack(idx_f: torch.Tensor, mv_f: torch.Tensor, n: int
              ) -> torch.Tensor:
    """(model index, MV) grids -> (n, nby, nbx, 2) stack with each block's
    MV in its selected model's layer, zero elsewhere."""
    onehot = idx_f[None] == torch.arange(
        n, dtype=idx_f.dtype, device=idx_f.device)[:, None, None]
    return torch.where(onehot[..., None], mv_f[None],
                       torch.zeros_like(mv_f)[None])


def _block_bands(plane: torch.Tensor, s: int) -> torch.Tensor:
    """Each block row's first 4-pixel band, stacked: (nby*4, W)."""
    h, w = plane.shape
    return plane.reshape(h // s, s, w)[:, 0:4].reshape(-1, w).contiguous()


def _make_eval_multi_uncached(reproj: MVReprojection, model_id: int,
                              block_size: int, bit_depth: int, epipole=None):
    """(orig, ref_padded, mv_cands (K,nby,nbx,2)) -> (K,nby,nbx) SADs — all
    K candidates of a refinement step in ONE launch."""
    s = block_size
    if reproj.height < BLOCK_EVAL_MIN_HEIGHT:
        return _make_eval_subblock(reproj, model_id, s, bit_depth, epipole)

    def eval_cands(orig, ref_padded, mv_cands):
        # block-translational decision SAD: each block's first 4-pixel
        # row band, sampled at the block-center's reprojected displacement
        # with the exact 8-tap filter — one patch per (candidate, BLOCK)
        bands = _block_bands(orig, s)
        pos_k = _centers(reproj, [model_id], None, mv_cands[:, None], s,
                         {model_id: epipole})
        sads = mm_mc.sad_block_positions(ref_padded, bands, pos_k,
                                         MC_MARGIN, s, bit_depth)
        return sads * (s // 4)            # scale to full-block SAD range

    return eval_cands


make_eval_multi = _make_eval_multi_uncached   # nothing to cache: no tracing


def _make_eval_subblock(reproj: MVReprojection, model_id: int,
                        block_size: int, bit_depth: int, epipole=None):
    """Exact per-subblock diamond eval (the multi-candidate 8-tap SAD,
    kernel K5, on the row/col-subsampled subblock grid)."""
    row_step = SAD_ROW_STEP if block_size // 4 >= SAD_ROW_STEP else 1
    col_step = SAD_COL_STEP if block_size // 4 >= 2 * SAD_COL_STEP else 1

    def eval_cands(orig, ref_padded, mv_cands):
        orig_sub = _subsample_rows(orig, row_step, col_step).contiguous()
        # every candidate's positions op by op (the JAX package's form
        # outside the merged jit), CLASSIC by its integer formula
        pos_k = _positions(reproj, [model_id], None, mv_cands[:, None],
                           block_size, row_step, col_step, None,
                           {model_id: epipole})
        return _sad_fields_bilin(ref_padded, orig_sub, pos_k, block_size,
                                 row_step, col_step, exact=True,
                                 bit_depth=bit_depth)

    return eval_cands


_PLUS = np.array([(0, -1), (-1, 0), (1, 0), (0, 1)], dtype=np.int32)
_PLUS_C = np.array([(0, 0), (0, -1), (-1, 0), (1, 0), (0, 1)],
                   dtype=np.int32)


