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
from ...utils import profiling
from ..inter_frame import (MC_MARGIN, _from_blocks, _residual_pass,
                           _to_blocks, first_argmin, pad_ref)
from ..typedefs import MotionModelID as M
from . import mc as mm_mc
from .reprojection import MVReprojection

# The codec's calls of the K-field positions (MVReprojection.positions and
# .centers): each a merged-positions call, a merge-search or decision step
# of K fields, or a diamond step of K candidates.  On the card each that
# reaches a sphere model is one kernel launch.
POSITION_CALLS = profiling.counters("frame_codec.position_calls",
                                    ("sphere_positions", "sphere_centers"))


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


def _fields_positions(reproj: MVReprojection, active_models: list[int],
                      fields, block_size: int, epipoles: dict | None,
                      row_step: int, form: str | None) -> torch.Tensor:
    """merged_positions of K (model_idx, mvs_stack) fields in one call:
    (K, nsy_sub, nsx, 2)."""
    return _positions(reproj, active_models,
                      torch.stack([i for i, _ in fields]),
                      torch.stack([st for _, st in fields]), block_size,
                      row_step, 1, form, epipoles)


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


def _block_sad(diff_abs: torch.Tensor, s: int) -> torch.Tensor:
    h, w = diff_abs.shape
    return diff_abs.reshape(h // s, s, w // s, s).sum(dim=(1, 3)) \
        .to(torch.int32)


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


def _block_sad_sub(diff_abs: torch.Tensor, s: int, row_step: int,
                   col_step: int = 1) -> torch.Tensor:
    """Per-block SAD from a row/column-subsampled |diff| plane: each
    block keeps s//4//row_step of its 4-px row bands (and s//4//col_step
    column bands); scaled back to full-SAD range."""
    h, w = diff_abs.shape
    rows_per_block = (s // 4 // row_step) * 4
    cols_per_block = (s // 4 // col_step) * 4
    return (diff_abs.reshape(h // rows_per_block, rows_per_block,
                             w // cols_per_block, cols_per_block
                             ).sum(dim=(1, 3)) * (row_step * col_step)
            ).to(torch.int32)


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


def _take0(stack: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """stack[idx[y, x], y, x(, :)] — the per-block entry of a stack."""
    i = idx.to(torch.int64)[None]
    if stack.dim() == 4:
        i = i[..., None].expand(1, *idx.shape, stack.shape[-1])
    return torch.gather(stack, 0, i)[0]


def _shift2(f: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """The field of the neighbour at (dy, dx): zero-pad and slice, so a
    neighbour outside the picture is model index 0 (CLASSIC) with MV 0 —
    not an edge copy and not a wrap.  dy, dx in [-1, 1] keeps the slice
    inside the padded field (the JAX package's dynamic_slice never has to
    clamp here either)."""
    nby, nbx = f.shape[:2]
    p = f.new_zeros((nby + 2, nbx + 2) + tuple(f.shape[2:]))
    p[1:-1, 1:-1] = f
    return p[1 + dy:1 + dy + nby, 1 + dx:1 + dx + nbx]


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


def _merged_center_positions(reproj: MVReprojection,
                             active_models: list[int], s: int,
                             epipoles: dict | None, idx_f, stack_f
                             ) -> torch.Tensor:
    """Block-translational analog of merged_positions: per-block center
    reprojection of each model, selected by idx_f -> (nby, nbx, 2)."""
    return _fields_centers(reproj, active_models, s, epipoles,
                           [(idx_f, stack_f)])[0]


def _fields_centers(reproj: MVReprojection, active_models: list[int],
                    s: int, epipoles: dict | None, fields) -> torch.Tensor:
    """_merged_center_positions of K (idx_f, stack_f) fields in one call:
    (K, nby, nbx, 2)."""
    return _centers(reproj, active_models,
                    torch.stack([i for i, _ in fields]),
                    torch.stack([st for _, st in fields]), s, epipoles)


def _sad_fields_block(reproj: MVReprojection, active_models: list[int],
                      ref_padded, orig_bands, s: int,
                      epipoles: dict | None, fields, bit_depth: int
                      ) -> torch.Tensor:
    """Block-translational field SADs: ONE kernel launch for all
    (idx_f, stack_f) fields; scaled to full-block SAD range."""
    pos_k = _fields_centers(reproj, active_models, s, epipoles, fields)
    return mm_mc.sad_block_positions(ref_padded, orig_bands, pos_k,
                                     MC_MARGIN, s, bit_depth) * (s // 4)


def _band_sad_blocks(bands: torch.Tensor, orig_bands: torch.Tensor,
                     s: int) -> torch.Tensor:
    """Per-block SAD from predicted/original band planes (nby*4, nbx*s),
    scaled to full-block range."""
    d = (bands - orig_bands).abs()
    hb, w = d.shape
    return (d.reshape(hb // 4, 4, w // s, s).sum(dim=(1, 3)) * (s // 4)
            ).to(torch.int32)


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


def diamond_search(eval_multi, orig, ref_padded, mv_init: torch.Tensor,
                   steps=(64, 32, 16, 8, 4, 2)):
    """Batched diamond refinement in 1/16-pel units (steps 64..16 are
    integer-pel, below is fractional).  All blocks refine simultaneously;
    the first step evaluates center + plus (5 candidates), every later
    step the 4-point plus pattern with the center's SAD carried over.  The
    center comes FIRST in the argmin, so a tie keeps it."""
    mv = mv_init.to(torch.int32)
    dev = mv.device
    best = None
    for step in steps:
        if best is None:
            offs = torch.as_tensor(_PLUS_C * step, device=dev)
            cands = mv[None] + offs[:, None, None, :]
            sads = eval_multi(orig, ref_padded, cands)   # (5, nby, nbx)
        else:
            offs = torch.as_tensor(_PLUS * step, device=dev)
            cands = mv[None] + offs[:, None, None, :]
            sads = eval_multi(orig, ref_padded, cands)   # (4, nby, nbx)
            cands = torch.cat([mv[None], cands])
            sads = torch.cat([best[None], sads])
        k = first_argmin(sads, 0)                        # (nby, nbx)
        mv = _take0(cands, k)
        best = sads.min(dim=0).values
    return mv, best


def search_models(reproj: MVReprojection, active_models: list[int],
                  orig_y: torch.Tensor, ref_y: torch.Tensor,
                  classic_mv: torch.Tensor, classic_sad: torch.Tensor,
                  block_size: int, bit_depth: int, lam_bits: float,
                  epipoles: dict | None = None, wrap_around: bool = False,
                  steps=(64, 32, 16, 8, 4),  # stops at quarter-pel
                  seed_stack=None):
    """Search every active non-classic model and pick the per-block best
    model by SAD + lambda*bits(model index).  Diamonds seed from zero MV
    or, when seed_stack (n_models, nby, nbx, 2) is given, from the
    previous frame's per-model MV field.

    Returns (model_idx_grid (nby, nbx) int32 index into active_models,
             mvs_per_model dict, sad_per_model dict)."""
    refp = pad_ref(ref_y, MC_MARGIN, wrap_around)
    mvs = {M.CLASSIC: classic_mv}
    # re-evaluate the classic candidate through the same decision-SAD
    # path the model diamonds use, so the per-block model argmin compares
    # one domain (classic_sad comes from the fractional refine)
    ev_cl = make_eval_multi(reproj, M.CLASSIC, block_size, bit_depth)
    sads = {M.CLASSIC: ev_cl(orig_y, refp, classic_mv[None])[0]}
    for i, model_id in enumerate(active_models):
        if model_id == M.CLASSIC:
            continue
        ep = (epipoles or {}).get(model_id)
        ev = make_eval_multi(reproj, model_id, block_size, bit_depth, ep)
        mv0 = (torch.zeros_like(classic_mv) if seed_stack is None
               else seed_stack[i].to(torch.int32))
        mv, sad = diamond_search(ev, orig_y, refp, mv0, steps)
        mvs[model_id] = mv
        sads[model_id] = sad
    # model cost: unary index bins (reference: CABACReader.cpp:2300 unary
    # over the active-model list); lam_bits is a host float on purpose
    costs = []
    for i, model_id in enumerate(active_models):
        bits = i + 1 if i < len(active_models) - 1 else i
        costs.append(sads[model_id] + int(lam_bits * bits))
    idx = first_argmin(torch.stack(costs), 0).to(torch.int32)
    return idx, mvs, sads


def _search_list(reproj, active_models, orig_y, ref_y, qp, s, bit_depth,
                 search_range, epipoles, wrap_around, steps, seed):
    """Classic hierarchical ME + fractional refine + every model's diamond
    + the model argmin against one reference.  Returns (idx, stack, sads
    dict, padded reference)."""
    from ...encoder import me as me_mod
    lam = quant.lambda_from_qp(qp, intra=False)
    lam_bits = lam ** 0.5 * 4.0
    lam16 = int(lam ** 0.5 * 16)
    refp = pad_ref(ref_y, MC_MARGIN, wrap_around)
    mv_int, _ = me_mod.hierarchical_search(orig_y, refp, s, search_range,
                                           MC_MARGIN, lam16)
    cmv, csad = me_mod.fractional_refine(orig_y, refp, mv_int, s, MC_MARGIN,
                                         bit_depth)
    idx, mvs, sads = search_models(
        reproj, active_models, orig_y, ref_y, cmv, csad, s, bit_depth,
        lam_bits, epipoles, wrap_around, steps, seed)
    stack = torch.stack([mvs[m] for m in active_models])
    return idx, stack, sads, refp


def search_p_mm(reproj: MVReprojection, active_models: list[int],
                orig_y, ref_y, qp: int, block_size: int, bit_depth: int,
                search_range: int, epipoles: dict | None = None,
                wrap_around: bool = False, seed=None):
    """P-frame motion/model search.  Returns (model_idx (nby,nbx),
    mvs_stack (n_models,nby,nbx,2)).  With `seed` (the previous frame's
    per-model MV stack), diamonds start from the temporal predictor and
    run the reduced step ladder."""
    steps = P_SEED_STEPS if seed is not None else (64, 32, 16, 8, 4)
    idx, stack, _, _ = _search_list(
        reproj, active_models, orig_y, ref_y, qp, block_size, bit_depth,
        search_range, epipoles, wrap_around, steps, seed)
    return idx, stack


def _field_sads(reproj, active_models, refp, orig_y, s, epipoles, fields,
                bit_depth):
    """Decision SADs of (idx, stack) candidate fields applied at the
    CURRENT block's location: block-translational bands (K3) at real
    frame sizes, the row-subsampled exact per-subblock SAD (K5) below."""
    if reproj.height >= BLOCK_EVAL_MIN_HEIGHT:
        return _sad_fields_block(reproj, active_models, refp,
                                 _block_bands(orig_y, s), s, epipoles,
                                 fields, bit_depth)
    row_step = SAD_ROW_STEP if s // 4 >= SAD_ROW_STEP else 1
    oy_sub = _subsample_rows(orig_y, row_step).contiguous()
    pos_fields = _fields_positions(reproj, active_models, fields, s,
                                   epipoles, row_step, "search")
    return _sad_fields_bilin(refp, oy_sub, pos_fields, s, row_step,
                             exact=True, bit_depth=bit_depth)


def search_p_mm_merge(reproj: MVReprojection, active_models: list[int],
                      orig_y, ref_y, qp: int, block_size: int,
                      bit_depth: int, search_range: int,
                      epipoles: dict | None = None,
                      wrap_around: bool = False, seed=None):
    """P-frame MM search with merge-candidate SADs: search_p_mm plus, for
    each candidate field (neighbor shifts of the selected (model, mv) grid
    and zero-CLASSIC), a reprojection + SAD pass.  Candidates applied at
    the CURRENT block's location go through the reprojection there — a
    neighbor's (model, mv) produces different target positions at this
    block (reference: merge candidates carry their motion model,
    UnitTools.cpp:872-885).

    Returns (model_idx, mvs_stack, sad_sel, cand_idx (K,nby,nbx),
    cand_mv (K,nby,nbx,2), cand_sads (K,nby,nbx))."""
    s = block_size
    steps = P_SEED_STEPS if seed is not None else (64, 32, 16, 8, 4)
    idx, stack, _, refp = _search_list(
        reproj, active_models, orig_y, ref_y, qp, s, bit_depth,
        search_range, epipoles, wrap_around, steps, seed)
    mv_sel = _take0(stack, idx)
    fields = [(idx, stack)]
    cand_idx, cand_mv = [], []
    for (dy, dx) in _NEIGHBOR_SHIFTS:
        idx_s = _shift2(idx, dy, dx)
        stack_s = torch.stack([_shift2(stack[i], dy, dx)
                               for i in range(stack.shape[0])])
        cand_idx.append(idx_s)
        cand_mv.append(_shift2(mv_sel, dy, dx))
        fields.append((idx_s, stack_s))
    # zero-CLASSIC candidate (active_models[0] is CLASSIC)
    cand_idx.append(torch.zeros_like(idx))
    cand_mv.append(torch.zeros_like(mv_sel))
    fields.append((torch.zeros_like(idx), torch.zeros_like(stack)))
    all_sads = _field_sads(reproj, active_models, refp, orig_y, s, epipoles,
                           fields, bit_depth)
    return (idx, stack, all_sads[0], torch.stack(cand_idx),
            torch.stack(cand_mv), all_sads[1:])


def search_b_mm(reproj: MVReprojection, active_models: list[int],
                orig_y, ref0_y, ref1_y, qp: int, block_size: int,
                bit_depth: int, search_range: int, epipoles0=None,
                epipoles1=None, wrap_around: bool = False,
                small_range: bool = True, seed=None):
    """B-frame per-list model search + uni/bi decision, for B pictures
    without merge.  Returns (idx0, idx1, stack0, stack1, dirs)."""
    s = block_size
    lam = quant.lambda_from_qp(qp, intra=False)
    mv_bits = int(lam ** 0.5 * 8)
    # models stop at quarter-pel; a temporal seed shrinks the ladder
    steps = (B_SEED_STEPS if seed is not None else (16, 8, 4)) \
        if small_range else (64, 32, 16, 8, 4)
    idx0, stack0, sads0, r0p = _search_list(
        reproj, active_models, orig_y, ref0_y, qp, s, bit_depth,
        search_range, epipoles0, wrap_around, steps, seed)
    idx1, stack1, sads1, r1p = _search_list(
        reproj, active_models, orig_y, ref1_y, qp, s, bit_depth,
        search_range, epipoles1, wrap_around, steps, seed)
    if reproj.height >= BLOCK_EVAL_MIN_HEIGHT:
        # bi decision on block-translational bands (decision-only; the
        # normative prediction runs per subblock in the finish): one band
        # per list through K4
        ob = _block_bands(orig_y, s)
        c0 = _merged_center_positions(reproj, active_models, s, epipoles0,
                                      idx0, stack0)
        c1 = _merged_center_positions(reproj, active_models, s, epipoles1,
                                      idx1, stack1)
        b0 = mm_mc.mc_block_positions(r0p, c0[None], MC_MARGIN, s,
                                      bit_depth)[0]
        b1 = mm_mc.mc_block_positions(r1p, c1[None], MC_MARGIN, s,
                                      bit_depth)[0]
        sad_bi = _band_sad_blocks((b0 + b1 + 1) >> 1, ob, s) + mv_bits
        u0 = _band_sad_blocks(b0, ob, s)
        u1 = _band_sad_blocks(b1, ob, s)
        dirs = first_argmin(torch.stack([u0, u1, sad_bi]), 0)
        return idx0, idx1, stack0, stack1, dirs.to(torch.int32)
    # bi decision on row-subsampled MC (K1); the uni costs are each list's
    # best model SAD of the search
    row_step = SAD_ROW_STEP if s // 4 >= SAD_ROW_STEP else 1
    oy_sub = _subsample_rows(orig_y, row_step)
    pos0 = merged_positions(reproj, active_models, idx0, stack0, s,
                            epipoles0, row_step)
    pos1 = merged_positions(reproj, active_models, idx1, stack1, s,
                            epipoles1, row_step)
    p0 = mm_mc.mc_luma_positions(r0p, pos0, MC_MARGIN, bit_depth)
    p1 = mm_mc.mc_luma_positions(r1p, pos1, MC_MARGIN, bit_depth)
    sad_bi = _block_sad_sub((oy_sub - ((p0 + p1 + 1) >> 1)).abs(), s,
                            row_step) + mv_bits
    sad0 = torch.stack([sads0[m] for m in active_models]).min(dim=0).values
    sad1 = torch.stack([sads1[m] for m in active_models]).min(dim=0).values
    dirs = first_argmin(torch.stack([sad0, sad1, sad_bi]), 0)
    return idx0, idx1, stack0, stack1, dirs.to(torch.int32)


def search_qt_parent_mm(reproj: MVReprojection, active_models: list[int],
                        orig_y, ref_y, idx_child, mv_child, idx_own,
                        mv_own, qp: int, block_size: int, bit_depth: int,
                        epipoles: dict | None = None,
                        wrap_around: bool = False):
    """Parent-level MM evaluation for the quadtree lattice (reference: the
    QTMT recursion reuses child information through EncModeCtrl caching,
    EncCu.cpp:499).

    Candidates for each parent block are the four child-quadrant
    selections, zero-CLASSIC AND this size's own flat-search selection
    (idx_own/mv_own from search_p_mm); the best becomes this level's
    selection and three neighbor shifts of it are evaluated for merge.

    idx_child/mv_child: (2*nby, 2*nbx[, 2]) child-level selected grids.
    Returns (idx, mv_sel, sad_sel, cand_idx (9,nby,nbx),
    cand_mv (9,nby,nbx,2), cand_sads (9,nby,nbx)) — candidate fields are
    [3 neighbor shifts, zero, 4 child quadrants, own-search]."""
    s = block_size
    n = len(active_models)
    refp = pad_ref(ref_y, MC_MARGIN, wrap_around)

    def field_sads(pairs):
        fields = [(i, _to_stack(i, m, n)) for i, m in pairs]
        return _field_sads(reproj, active_models, refp, orig_y, s,
                           epipoles, fields, bit_depth)

    quads = [(idx_child[dy::2, dx::2], mv_child[dy::2, dx::2])
             for dy in (0, 1) for dx in (0, 1)]
    zi = torch.zeros_like(quads[0][0])
    zm = torch.zeros_like(quads[0][1])
    own = quads + [(zi, zm), (idx_own, mv_own)]
    own_sads = field_sads(own)
    k = first_argmin(own_sads, 0)
    idx = _take0(torch.stack([i for i, _ in own]), k)
    mv_sel = _take0(torch.stack([m for _, m in own]), k)
    sad_sel = own_sads.min(dim=0).values
    cand_idx, cand_mv, shifted = [], [], []
    for (dy, dx) in _NEIGHBOR_SHIFTS:
        i_s = _shift2(idx, dy, dx)
        m_s = _shift2(mv_sel, dy, dx)
        cand_idx.append(i_s)
        cand_mv.append(m_s)
        shifted.append((i_s, m_s))
    shift_sads = field_sads(shifted)
    cand_sads = [shift_sads[i] for i in range(3)]
    for (i_q, m_q), sd in zip(own, own_sads):
        cand_idx.append(i_q)
        cand_mv.append(m_q)
        cand_sads.append(sd)
    return (idx, mv_sel, sad_sel, torch.stack(cand_idx),
            torch.stack(cand_mv), torch.stack(cand_sads))


def search_b_mm_merge(reproj: MVReprojection, active_models: list[int],
                      orig_y, ref0_y, ref1_y, qp: int, block_size: int,
                      bit_depth: int, search_range: int, epipoles0=None,
                      epipoles1=None, wrap_around: bool = False,
                      small_range: bool = True, seed=None):
    """B-frame per-list model search + uni/bi decision + whole-motion
    merge-candidate SADs: for each neighbor shift of the selected per-list
    (model, mv) grids and dirs, one positions+MC+combine+SAD pass per list
    (candidates applied at the current block go through the reprojection
    there).  Returns
    (idx0, idx1, stack0, stack1, dirs, sad_sel,
     cand_idx0/idx1 (K,..), cand_mv0/mv1 (K,..,2), cand_dirs, cand_sads).
    """
    s = block_size
    lam = quant.lambda_from_qp(qp, intra=False)
    mv_bits = int(lam ** 0.5 * 8)          # a host float, as lam_bits is
    # models stop at quarter-pel; a temporal seed shrinks the ladder
    steps = (B_SEED_STEPS if seed is not None else (16, 8, 4)) \
        if small_range else (64, 32, 16, 8, 4)
    idx0, stack0, _, r0p = _search_list(
        reproj, active_models, orig_y, ref0_y, qp, s, bit_depth,
        search_range, epipoles0, wrap_around, steps, seed)
    idx1, stack1, _, r1p = _search_list(
        reproj, active_models, orig_y, ref1_y, qp, s, bit_depth,
        search_range, epipoles1, wrap_around, steps, seed)
    mv_sel0 = _take0(stack0, idx0)
    mv_sel1 = _take0(stack1, idx1)

    def shifted_fields(idx_f, stack_f):
        return [(_shift2(idx_f, dy, dx),
                 torch.stack([_shift2(stack_f[i], dy, dx)
                              for i in range(stack_f.shape[0])]))
                for (dy, dx) in _NEIGHBOR_SHIFTS]

    if reproj.height >= BLOCK_EVAL_MIN_HEIGHT:
        # block-translational bands: per list ONE multi-candidate band-MC
        # launch (kernel K4) for (selection + 3 neighbor shifts)
        ob = _block_bands(orig_y, s)

        def list_bands(rp, eps, idx_f, stack_f):
            fields = [(idx_f, stack_f)] + shifted_fields(idx_f, stack_f)
            pos = _fields_centers(reproj, active_models, s, eps, fields)
            return mm_mc.mc_block_positions(rp, pos, MC_MARGIN, s,
                                            bit_depth)

        preds0 = list_bands(r0p, epipoles0, idx0, stack0)
        preds1 = list_bands(r1p, epipoles1, idx1, stack1)
        rep_y = 4

        def block_sad(x):
            return _band_sad_blocks(x, ob, s)
    else:
        # decision-only: bi choice + selected-SAD on row-subsampled MC
        row_step = SAD_ROW_STEP if s // 4 >= SAD_ROW_STEP else 1
        ob = _subsample_rows(orig_y, row_step)

        def list_preds(rp, eps, idx_f, stack_f):
            fields = [(idx_f, stack_f)] + shifted_fields(idx_f, stack_f)
            pos = _fields_positions(reproj, active_models, fields, s, eps,
                                    row_step, "merged")
            return [mm_mc.mc_luma_positions(rp, p, MC_MARGIN, bit_depth)
                    for p in pos]

        preds0 = list_preds(r0p, epipoles0, idx0, stack0)
        preds1 = list_preds(r1p, epipoles1, idx1, stack1)
        rep_y = s if row_step == 1 else (s // 4 // row_step) * 4

        def block_sad(x):
            return _block_sad_sub((ob - x).abs(), s, row_step)

    def sel_pred(p0x, p1x, d):
        dd = d.repeat_interleave(rep_y, 0).repeat_interleave(s, 1)
        avg = (p0x + p1x + 1) >> 1
        return torch.where(dd == 0, p0x, torch.where(dd == 1, p1x, avg))

    sad_bi = block_sad((preds0[0] + preds1[0] + 1) >> 1) + mv_bits
    dirs = first_argmin(torch.stack(
        [block_sad(preds0[0]), block_sad(preds1[0]), sad_bi]), 0
    ).to(torch.int32)
    sad_sel = block_sad(sel_pred(preds0[0], preds1[0], dirs))
    ci0, ci1, cm0, cm1, cd, cs = [], [], [], [], [], []
    for j, (dy, dx) in enumerate(_NEIGHBOR_SHIFTS):
        ds = _shift2(dirs, dy, dx)
        cs.append(block_sad(sel_pred(preds0[j + 1], preds1[j + 1], ds)))
        ci0.append(_shift2(idx0, dy, dx))
        ci1.append(_shift2(idx1, dy, dx))
        cm0.append(_shift2(mv_sel0, dy, dx))
        cm1.append(_shift2(mv_sel1, dy, dx))
        cd.append(ds)
    return (idx0, idx1, stack0, stack1, dirs, sad_sel,
            torch.stack(ci0), torch.stack(ci1), torch.stack(cm0),
            torch.stack(cm1), torch.stack(cd), torch.stack(cs))


def enc_finish_p_mm_fused(reproj, active_models, model_idx, mvs_stack,
                          orig, ref, qp: int, block_size: int,
                          bit_depth: int, epipoles=None,
                          wrap_around: bool = False,
                          deblocking: bool = True):
    """Encoder tail for flat MM P frames: the merged positions, then
    enc_finish_p_mm's prediction -> residual -> recon -> deblock.  Returns
    (lev_y, lev_u, lev_v, rec dict post-deblock)."""
    positions = merged_positions(reproj, active_models, model_idx,
                                 mvs_stack, block_size, epipoles)
    ly, lu, lv, ry, ru, rv = _p_finish_body(
        model_idx, mvs_stack, positions, *orig, *ref, qp, block_size,
        bit_depth, wrap_around, deblocking)
    return ly, lu, lv, dict(y=ry, u=ru, v=rv)


def _p_finish_body(model_idx, mvs_stack, positions, oy, ou, ov, ry, ru,
                   rv, qp, block_size, bit_depth, wrap_around, deblocking):
    from .. import deblock as deblock_mod
    s = block_size
    h, w = oy.shape
    nby, nbx = h // s, w // s
    pred_y, pred_u, pred_v = predict_from_positions(
        positions, ry, ru, rv, bit_depth, wrap_around)
    lev_y, _ = _residual_pass(oy, pred_y, s, qp, bit_depth)
    lev_u, _ = _residual_pass(ou, pred_u, s // 2, qp, bit_depth)
    lev_v, _ = _residual_pass(ov, pred_v, s // 2, qp, bit_depth)
    rec_y = _rec_plane(pred_y, lev_y, s, nby, nbx, qp, bit_depth)
    rec_u = _rec_plane(pred_u, lev_u, s // 2, nby, nbx, qp, bit_depth)
    rec_v = _rec_plane(pred_v, lev_v, s // 2, nby, nbx, qp, bit_depth)
    if deblocking:
        sel = _take0(mvs_stack, model_idx)
        has_resid = ((lev_y != 0).any(dim=3).any(dim=2)
                     | (lev_u != 0).any(dim=3).any(dim=2)
                     | (lev_v != 0).any(dim=3).any(dim=2))
        bs_v, bs_h = deblock_mod.boundary_strengths_inter(
            sel.to(torch.int32), has_resid)
        rec_y, rec_u, rec_v = deblock_mod.deblock_frame(
            rec_y, rec_u, rec_v, bs_v, bs_h, s, qp, bit_depth)
    return lev_y, lev_u, lev_v, rec_y, rec_u, rec_v


def enc_finish_p_mm(model_idx, mvs_stack, positions, orig_y, orig_u, orig_v,
                    ref_y, ref_u, ref_v, qp: int, block_size: int,
                    bit_depth: int, wrap_around: bool = False,
                    deblocking: bool = True):
    """Encoder tail for MM P frames from a given positions tensor:
    prediction (K1/K2) -> residual/levels -> reconstruction -> deblock,
    all integer math downstream of `positions`, so the reconstruction is
    bit-exact with the decoder's.  Returns (lev_y, lev_u, lev_v, rec dict
    post-deblock)."""
    ly, lu, lv, ry, ru, rv = _p_finish_body(
        model_idx, mvs_stack, positions, orig_y, orig_u, orig_v, ref_y,
        ref_u, ref_v, qp, block_size, bit_depth, wrap_around, deblocking)
    return ly, lu, lv, dict(y=ry, u=ru, v=rv)


def enc_finish_b_mm_fused(reproj, active_models, idx0, idx1, stack0,
                          stack1, rstack0, rstack1, dirs, orig, ref0,
                          ref1, qp: int, block_size: int, bit_depth: int,
                          epipoles0=None, epipoles1=None,
                          wrap_around: bool = False,
                          deblocking: bool = True):
    """Encoder tail for MM B frames: both per-list merged positions, then
    bi combine -> residual -> recon -> deblock (integer math downstream of
    the positions, so the reconstruction is bit-exact with the decoder's).
    rstack0/rstack1 drive the PREDICTION; stack0/stack1 stay the
    signalled ones (deblock MV field).  Returns (lev_y, lev_u, lev_v, rec
    dict post-deblock)."""
    pos0 = merged_positions(reproj, active_models, idx0, rstack0,
                            block_size, epipoles0)
    pos1 = merged_positions(reproj, active_models, idx1, rstack1,
                            block_size, epipoles1)
    return _b_finish_body(idx0, idx1, stack0, stack1, dirs, pos0, pos1,
                          *orig, *ref0, *ref1, qp, block_size, bit_depth,
                          wrap_around, deblocking)


def _b_finish_body(idx0, idx1, stack0, stack1, dirs, pos0, pos1, oy, ou,
                   ov, r0y, r0u, r0v, r1y, r1u, r1v, qp, block_size,
                   bit_depth, wrap_around, deblocking):
    from .. import deblock as deblock_mod
    s = block_size
    h, w = oy.shape
    nby, nbx = h // s, w // s
    p0 = predict_from_positions(pos0, r0y, r0u, r0v, bit_depth,
                                wrap_around)
    p1 = predict_from_positions(pos1, r1y, r1u, r1v, bit_depth,
                                wrap_around)
    py = _bi_combine_px(p0[0], p1[0], dirs, s, 1, bit_depth)
    pu = _bi_combine_px(p0[1], p1[1], dirs, s, 2, bit_depth)
    pv = _bi_combine_px(p0[2], p1[2], dirs, s, 2, bit_depth)
    lev_y, _ = _residual_pass(oy, py, s, qp, bit_depth)
    lev_u, _ = _residual_pass(ou, pu, s // 2, qp, bit_depth)
    lev_v, _ = _residual_pass(ov, pv, s // 2, qp, bit_depth)
    rec_y = _rec_plane(py, lev_y, s, nby, nbx, qp, bit_depth)
    rec_u = _rec_plane(pu, lev_u, s // 2, nby, nbx, qp, bit_depth)
    rec_v = _rec_plane(pv, lev_v, s // 2, nby, nbx, qp, bit_depth)
    if deblocking:
        sel0 = _take0(stack0, idx0)
        sel1 = _take0(stack1, idx1)
        sel = torch.where(dirs[..., None] == 1, sel1, sel0)
        has_resid = ((lev_y != 0).any(dim=3).any(dim=2)
                     | (lev_u != 0).any(dim=3).any(dim=2)
                     | (lev_v != 0).any(dim=3).any(dim=2))
        bs_v, bs_h = deblock_mod.boundary_strengths_inter(
            sel.to(torch.int32), has_resid)
        rec_y, rec_u, rec_v = deblock_mod.deblock_frame(
            rec_y, rec_u, rec_v, bs_v, bs_h, s, qp, bit_depth)
    return lev_y, lev_u, lev_v, dict(y=rec_y, u=rec_u, v=rec_v)
