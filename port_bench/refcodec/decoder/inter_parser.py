"""Inter slice entropy decoding: the exact inverse of
encoder/inter_coder.py.

PyTorch-port copy of `vvc_mm_tpu/decoder/inter_parser.py` (reference:
source/Lib/DecoderLib/CABACReader.cpp — cu_skip_flag, merge_idx,
ref_idx, inter_pred_idc, motion_model, mvd_coding, residual_coding): the
classic P slice (one or two references, merge on or off) and B slice,
and the multi-model ones (the flat and the quadtree MM P slice and the MM
B slice, with MM-MVP where the SPS turns it on), with the classic
random-access tools: TMVP/HMVP, AMVR, GPM/CIIP and the affine P slice,
and the classic quadtree and multi-type-tree P and B slices (one tree
walker and one leaf parser, `_decode_tree`).  Host numpy code over the
native CABAC decoder.  Under WPP the classic P and B slices (merge on)
carry one substream a block-row group (`decode_p_slice_wpp`,
`decode_b_slice_wpp`), parsed in row order into shared grids.
"""
from __future__ import annotations

import numpy as np

from ..common import mtt as mtt_mod
from ..common.cabac import BinDecoder
from ..common.contexts import ctx_id
from ..common.inter_frame import AMVR_SHIFTS, round_mv_amvr
from .candidates import (MERGE_MAX, HmvpList, _b_dir_pred, _mm_mvp,
                         amvp_list, inherited_model, merge_candidates,
                         merge_candidates_b, merge_candidates_b_mm,
                         merge_candidates_mm, merge_candidates_qt_mm,
                         merge_candidates_ref, merge_candidates_unit,
                         merge_candidates_unit_b, mvp_median, mvp_unit_grid,
                         mvp_unit_grid_mm, walk_tree, wpp_bounds)
from ..utils.trace import label, make_decoder
from .intra_parser import parse_wpp_frame


def decode_mvd_comp(dec: BinDecoder, ctx_base: str = "Mvd") -> int:
    if not dec.decode_bin(ctx_id(ctx_base, 0)):
        return 0
    a = 1
    if dec.decode_bin(ctx_id(ctx_base, 1)):
        a = 2 + dec.decode_eg(1)
    return -a if dec.decode_bin_ep() else a


def decode_merge_idx(dec: BinDecoder, n: int = MERGE_MAX) -> int:
    """Inverse of encoder.inter_coder.encode_merge_idx (reference:
    CABACReader::merge_idx — first bin context, rest bypass TU)."""
    if n <= 1 or not dec.decode_bin(ctx_id("MergeIdx")):
        return 0
    idx = 1
    while idx < n - 1 and dec.decode_bin_ep():
        idx += 1
    return idx


def decode_motion_model(dec: BinDecoder, n_active: int) -> int:
    """Inverse of encoder.inter_coder.encode_motion_model (reference:
    CABACReader.cpp:2300 unary over the active-model list)."""
    idx = 0
    while idx < n_active - 1 and dec.decode_bin(
            ctx_id("MotionModel", min(idx, 10))):
        idx += 1
    return idx


def _decode_residual(dec: BinDecoder, levs, sizes, by: int, bx: int
                     ) -> None:
    for ci, (lev, size) in enumerate(zip(levs, sizes)):
        label(dec, "cbf")
        if dec.decode_bin(ctx_id("QtCbf", (0, 4, 5)[ci])):
            label(dec, "residual_" + "yuv"[ci])
            lev[by, bx] = dec.decode_coeffs(size, size, chroma=(ci != 0))


def _new_levels(nby: int, nbx: int, s: int):
    sc = s // 2
    return (np.zeros((nby, nbx, s, s), dtype=np.int32),
            np.zeros((nby, nbx, sc, sc), dtype=np.int32),
            np.zeros((nby, nbx, sc, sc), dtype=np.int32))


def _decode_mvd(dec: BinDecoder) -> np.ndarray:
    return np.array([decode_mvd_comp(dec), decode_mvd_comp(dec)],
                    dtype=np.int64)


def _decode_amvp_mv(dec: BinDecoder, cands, use_tmvp: bool,
                    use_amvr: bool) -> np.ndarray:
    """The mvp index (TMVP), the AMVR precision and the mvd of an AMVP
    block -> its MV (inverse of inter_coder._code_amvp_mvd)."""
    idx = 0
    if use_tmvp:
        label(dec, "mvp_idx")
        idx = dec.decode_bin(ctx_id("MvpIdx"))
    if not use_amvr:
        label(dec, "mvd")
        return cands[idx] + _decode_mvd(dec)
    label(dec, "amvr_mode")
    m = 0
    if dec.decode_bin(ctx_id("Amvr", 0)):
        m = 1 + dec.decode_bin(ctx_id("Amvr", 1))
    sh = AMVR_SHIFTS[m]
    label(dec, "mvd")
    return round_mv_amvr(cands[idx], sh) + (_decode_mvd(dec) << sh)


def decode_p_slice(data: bytes, nby: int, nbx: int, s: int,
                   col_mvs: np.ndarray | None = None,
                   use_tmvp: bool = False, use_amvr: bool = False,
                   use_merge: bool = False, mer_blocks_log2: int = 0,
                   rows: tuple | None = None, state=None, stats=None):
    """Exact inverse of encoder.inter_coder.encode_p_slice.  Returns (mvs
    (nby,nbx,2) 1/16-pel, lev_y, lev_u, lev_v).  With use_merge, skip
    means merge+no-residual and non-skip blocks carry a merge_flag; merge
    blocks take candidate merge_idx of the shared list (reference:
    CABACReader merge_data / merge_idx).  With use_tmvp the merge and AMVP
    lists carry the co-located MV (`col_mvs`) and the HMVP FIFO; with
    use_amvr each AMVP block's precision scales its mvd.  `rows` (r0, r1)
    parses only those block rows (one WPP substream, a fresh HMVP FIFO)
    into `state`, the (mvs, lev_y, lev_u, lev_v) grids of the slice."""
    dec = make_decoder(data, stats)
    if state is None:
        state = (np.zeros((nby, nbx, 2), dtype=np.int64),) + _new_levels(
            nby, nbx, s)
    mvs, levs = state[0], state[1:]
    sizes = (s, s // 2, s // 2)
    hist = HmvpList() if use_tmvp else None
    r0, r1 = rows if rows is not None else (0, nby)
    for by in range(r0, r1):
        for bx in range(nbx):
            col = (col_mvs[by, bx]
                   if (use_tmvp and col_mvs is not None) else None)
            mrg = False
            if use_merge:
                label(dec, "skip_flag")
                skip = bool(dec.decode_bin(ctx_id("SkipFlag")))
                mrg = skip or bool(label(dec, "merge_flag") or dec.decode_bin(
                    ctx_id("MergeFlag")))
                if mrg:
                    mcands = merge_candidates(
                        mvs, by, bx, col, hist,
                        mer_blocks_log2=mer_blocks_log2)
                    label(dec, "merge_idx")
                    mvs[by, bx] = mcands[decode_merge_idx(dec)]
                    if not skip:
                        _decode_residual(dec, levs, sizes, by, bx)
            if not mrg:
                cands = (amvp_list(mvs, by, bx, col, hist) if use_tmvp
                         else [mvp_median(mvs, by, bx)])
                if not use_merge and (label(dec, "skip_flag")
                                      or dec.decode_bin(ctx_id("SkipFlag"))):
                    mvs[by, bx] = cands[0]
                else:
                    mvs[by, bx] = _decode_amvp_mv(dec, cands, use_tmvp,
                                                  use_amvr)
                    _decode_residual(dec, levs, sizes, by, bx)
            if hist is not None:
                hist.push(mvs[by, bx])
    return (mvs,) + tuple(levs)


def decode_p_slice_2ref(data: bytes, nby: int, nbx: int, s: int,
                        col_mvs: np.ndarray | None = None,
                        use_tmvp: bool = False, use_amvr: bool = False,
                        mer_blocks_log2: int = 0, stats=None):
    """Exact inverse of encoder.inter_coder.encode_p_slice_2ref.  Returns
    (ref_idx, mvs, lev_y, lev_u, lev_v)."""
    dec = make_decoder(data, stats)
    ref_idx = np.zeros((nby, nbx), dtype=np.int32)
    mvs = np.zeros((nby, nbx, 2), dtype=np.int64)
    levs = _new_levels(nby, nbx, s)
    sizes = (s, s // 2, s // 2)
    hist = HmvpList() if use_tmvp else None
    for by in range(nby):
        for bx in range(nbx):
            col = (col_mvs[by, bx]
                   if (use_tmvp and col_mvs is not None) else None)
            label(dec, "skip_flag")
            skip = bool(dec.decode_bin(ctx_id("SkipFlag")))
            if skip or (label(dec, "merge_flag")
                        or dec.decode_bin(ctx_id("MergeFlag"))):
                mcands = merge_candidates_ref(
                    ref_idx, mvs, by, bx, col, hist,
                    mer_blocks_log2=mer_blocks_log2)
                label(dec, "merge_idx")
                ref_idx[by, bx], mvs[by, bx] = mcands[decode_merge_idx(dec)]
            else:
                label(dec, "ref_idx")
                ref_idx[by, bx] = dec.decode_bin(ctx_id("RefPic", 0))
                cands = (amvp_list(mvs, by, bx, col, hist) if use_tmvp
                         else [mvp_median(mvs, by, bx)])
                mvs[by, bx] = _decode_amvp_mv(dec, cands, use_tmvp,
                                              use_amvr)
            if not skip:
                _decode_residual(dec, levs, sizes, by, bx)
            if hist is not None:
                hist.push(mvs[by, bx])
    return (ref_idx, mvs) + levs


def decode_p_slice_affine(data: bytes, nby: int, nbx: int, s: int,
                          stats=None):
    """Exact inverse of encoder.inter_coder.encode_p_slice_affine.
    Returns (mvs, aff, dmv, lev_y, lev_u, lev_v)."""
    dec = make_decoder(data, stats)
    mvs = np.zeros((nby, nbx, 2), dtype=np.int64)
    aff = np.zeros((nby, nbx), dtype=bool)
    dmv = np.zeros((nby, nbx, 2), dtype=np.int64)
    levs = _new_levels(nby, nbx, s)
    sizes = (s, s // 2, s // 2)
    for by in range(nby):
        for bx in range(nbx):
            pred = mvp_median(mvs, by, bx)
            label(dec, "skip_flag")
            if dec.decode_bin(ctx_id("SkipFlag")):
                mvs[by, bx] = pred
                continue
            label(dec, "affine_flag")
            aff[by, bx] = bool(dec.decode_bin(ctx_id("AffineFlag", 0)))
            label(dec, "mvd")
            mvs[by, bx] = pred + _decode_mvd(dec)
            if aff[by, bx]:
                dmv[by, bx] = _decode_mvd(dec)
            _decode_residual(dec, levs, sizes, by, bx)
    return (mvs, aff, dmv) + levs


def decode_b_slice(data: bytes, nby: int, nbx: int, s: int,
                   use_gpm: bool = False, use_ciip: bool = False,
                   use_merge: bool = False, mer_blocks_log2: int = 0,
                   rows: tuple | None = None, state=None, stats=None):
    """Exact inverse of encoder.inter_coder.encode_b_slice.  Returns (mv0,
    mv1, dirs, lev_y, lev_u, lev_v, gpm_modes): dirs 3 (GPM, its mask in
    gpm_modes) and 4 (CIIP) are read where the SPS gates their bins in.
    `rows` (r0, r1) parses only those block rows (one WPP substream) into
    `state`, a tuple of those seven grids."""
    dec = make_decoder(data, stats)
    if state is None:
        state = (np.zeros((nby, nbx, 2), dtype=np.int64),
                 np.zeros((nby, nbx, 2), dtype=np.int64),
                 np.zeros((nby, nbx), dtype=np.int32)) + _new_levels(
            nby, nbx, s) + (np.zeros((nby, nbx), dtype=np.int32),)
    mv0, mv1, dirs, *levs, gpm_modes = state
    sizes = (s, s // 2, s // 2)
    r0, r1 = rows if rows is not None else (0, nby)
    for by in range(r0, r1):
        for bx in range(nbx):
            pred0 = mvp_median(mv0, by, bx)
            pred1 = mvp_median(mv1, by, bx)
            if use_merge:
                label(dec, "skip_flag")
                skip = bool(dec.decode_bin(ctx_id("SkipFlag")))
                if skip or (label(dec, "merge_flag")
                            or dec.decode_bin(ctx_id("MergeFlag"))):
                    mcands = merge_candidates_b(
                        dirs, mv0, mv1, by, bx,
                        mer_blocks_log2=mer_blocks_log2)
                    label(dec, "merge_idx")
                    cd, c0, c1 = mcands[decode_merge_idx(dec)]
                    dirs[by, bx] = cd
                    # entropy convention: the unused list takes its MVP
                    mv0[by, bx] = pred0 if cd == 1 else c0
                    mv1[by, bx] = pred1 if cd == 0 else c1
                    if not skip:
                        _decode_residual(dec, levs, sizes, by, bx)
                    continue
            elif label(dec, "skip_flag") or dec.decode_bin(
                    ctx_id("SkipFlag")):
                d_pred = (int(dirs[by, bx - 1]) if bx > 0
                          else int(dirs[by - 1, bx]) if by > 0 else 0)
                dirs[by, bx] = min(d_pred, 2)
                mv0[by, bx] = pred0
                mv1[by, bx] = pred1
                continue
            if dec.decode_bin(ctx_id("InterDir", 0)):
                d = 2
                if use_gpm and use_ciip:
                    label(dec, "geo_flag")
                    if dec.decode_bin(ctx_id("GeoFlag")):
                        d = 4 if dec.decode_bin(ctx_id("CiipFlag")) else 3
                elif use_gpm:
                    label(dec, "geo_flag")
                    if dec.decode_bin(ctx_id("GeoFlag")):
                        d = 3
                elif use_ciip:
                    label(dec, "ciip_flag")
                    if dec.decode_bin(ctx_id("CiipFlag")):
                        d = 4
                if d == 3:
                    label(dec, "gpm_mode")
                    g = 0
                    for _ in range(4):
                        g = (g << 1) | dec.decode_bin_ep()
                    gpm_modes[by, bx] = g
            else:
                d = dec.decode_bin(ctx_id("InterDir", 1))
            dirs[by, bx] = d
            smvd = d == 2 and bool(label(dec, "smvd_flag") or dec.decode_bin(
                ctx_id("SmvdFlag")))
            mvd = _decode_mvd(dec) if d != 1 else np.zeros(2, np.int64)
            mv0[by, bx] = pred0 + mvd
            if d == 0:
                mv1[by, bx] = pred1
            elif smvd:
                # sym_mvd: mvd1 = -mvd0 (reference: smvd_mode)
                mv1[by, bx] = pred1 - mvd
            else:
                mv1[by, bx] = pred1 + _decode_mvd(dec)
            _decode_residual(dec, levs, sizes, by, bx)
    return (mv0, mv1, dirs, *levs, gpm_modes)


def decode_p_slice_wpp(data: bytes, nby: int, nbx: int, s: int, **kw):
    """Inter WPP parse of a P slice (decode_p_slice's arguments and
    result): one independently decodable substream a row group, with
    fresh contexts and HMVP, over grids that evolve across substreams."""
    subs = parse_wpp_frame(data)
    bounds = wpp_bounds(nby, len(subs))
    state = None
    for i, sub in enumerate(subs):
        state = decode_p_slice(sub, nby, nbx, s,
                               rows=(bounds[i], bounds[i + 1]),
                               state=state, **kw)
    return state


def decode_b_slice_wpp(data: bytes, nby: int, nbx: int, s: int, **kw):
    """Inter WPP parse of a B slice (decode_b_slice's arguments and
    result)."""
    subs = parse_wpp_frame(data)
    bounds = wpp_bounds(nby, len(subs))
    state = None
    for i, sub in enumerate(subs):
        state = decode_b_slice(sub, nby, nbx, s,
                               rows=(bounds[i], bounds[i + 1]),
                               state=state, **kw)
    return state


def decode_p_slice_mm(data: bytes, nby: int, nbx: int, s: int,
                      active_models: list[int], conv=None, epipole=None,
                      use_merge: bool = False, mer_blocks_log2: int = 0,
                      stats=None):
    """Exact inverse of encoder.inter_coder.encode_p_slice_mm (flat grid).
    Returns (model_idx, mvs (nby,nbx,2), lev_y, lev_u, lev_v) — mvs holds
    each block's MV in its model."""
    dec = make_decoder(data, stats)
    sc = s // 2
    model_idx = np.zeros((nby, nbx), dtype=np.int32)
    models_sel = np.zeros((nby, nbx), dtype=np.int32)
    mvs = np.zeros((nby, nbx, 2), dtype=np.int64)
    lev_y = np.zeros((nby, nbx, s, s), dtype=np.int32)
    lev_u = np.zeros((nby, nbx, sc, sc), dtype=np.int32)
    lev_v = np.zeros((nby, nbx, sc, sc), dtype=np.int32)
    levs, sizes = (lev_y, lev_u, lev_v), (s, sc, sc)
    model_to_idx = {m: i for i, m in enumerate(active_models)}
    for by in range(nby):
        for bx in range(nbx):
            if use_merge:
                label(dec, "skip_flag")
                skip = bool(dec.decode_bin(ctx_id("SkipFlag")))
                if not skip:
                    label(dec, "merge_flag")
                if skip or dec.decode_bin(ctx_id("MergeFlag")):
                    mcands = merge_candidates_mm(
                        model_idx, mvs, by, bx,
                        mer_blocks_log2=mer_blocks_log2)
                    label(dec, "merge_idx")
                    ci, cmv = mcands[decode_merge_idx(dec)]
                    model_idx[by, bx] = ci
                    models_sel[by, bx] = active_models[ci]
                    mvs[by, bx] = cmv
                    if not skip:
                        _decode_residual(dec, levs, sizes, by, bx)
                    continue
            elif label(dec, "skip_flag") or dec.decode_bin(
                    ctx_id("SkipFlag")):
                model = inherited_model(models_sel, by, bx)
                models_sel[by, bx] = model
                model_idx[by, bx] = model_to_idx[model]
                mvs[by, bx] = _mm_mvp(mvs, models_sel, by, bx, model, s,
                                      conv, epipole)
                continue
            label(dec, "motion_model")
            midx = decode_motion_model(dec, len(active_models))
            model = active_models[midx]
            model_idx[by, bx] = midx
            models_sel[by, bx] = model
            label(dec, "mvd")
            mvd = np.array([decode_mvd_comp(dec), decode_mvd_comp(dec)],
                           dtype=np.int64)
            pred = _mm_mvp(mvs, models_sel, by, bx, model, s, conv, epipole)
            mvs[by, bx] = pred + mvd
            _decode_residual(dec, levs, sizes, by, bx)
    return model_idx, mvs, lev_y, lev_u, lev_v


def decode_p_slice_qt_mm(data: bytes, h: int, w: int, top: int,
                         depth: int, n_active: int, stats=None):
    """Exact inverse of encoder.inter_coder.encode_p_slice_qt_mm (the
    merge-aware leaf syntax: skip(=merge+no-residual) / merge /
    motion_model+mvd, then cbf+coeffs; candidates on the causal unit
    grid via merge_candidates_qt_mm).  Returns (midx_unit, mv_unit,
    levels [per size (ly,lu,lv)], has_resid_unit, leaf_id_unit)."""
    dec = make_decoder(data, stats)
    u = top >> depth
    nuy, nux = h // u, w // u
    nty, ntx = h // top, w // top
    sizes = [top >> d for d in range(depth + 1)]
    levels = []
    for s in sizes:
        ny, nx = h // s, w // s
        levels.append((np.zeros((ny, nx, s, s), dtype=np.int32),
                       np.zeros((ny, nx, s // 2, s // 2), dtype=np.int32),
                       np.zeros((ny, nx, s // 2, s // 2), dtype=np.int32)))
    coded = np.zeros((nuy, nux, 2), dtype=np.int64)
    models_u = np.zeros((nuy, nux), dtype=np.int32)
    avail = np.zeros((nuy, nux), dtype=bool)
    has_resid = np.zeros((nuy, nux), dtype=bool)
    leaf_id = np.zeros((nuy, nux), dtype=np.int32)

    def parse_resid(d, by, bx, s):
        hr = False
        for ci, lev in enumerate(levels[d]):
            label(dec, "cbf")
            if dec.decode_bin(ctx_id("QtCbf", (0, 4, 5)[ci])):
                label(dec, "residual_" + "yuv"[ci])
                sz = s if ci == 0 else s // 2
                lev[by, bx] = dec.decode_coeffs(sz, sz,
                                                chroma=(ci != 0))
                hr = True
        return hr

    def parse_leaf(d, by, bx):
        s = sizes[d]
        k = s // u
        uy, ux = by * k, bx * k
        hr = False
        label(dec, "skip_flag")
        if dec.decode_bin(ctx_id("SkipFlag")):
            cands = merge_candidates_qt_mm(models_u, coded, avail, uy, ux,
                                           k)
            label(dec, "merge_idx")
            midx, mv = cands[decode_merge_idx(dec)]
            mv = np.asarray(mv, dtype=np.int64)
        else:
            label(dec, "merge_flag")
            if dec.decode_bin(ctx_id("MergeFlag")):
                cands = merge_candidates_qt_mm(models_u, coded, avail, uy,
                                               ux, k)
                label(dec, "merge_idx")
                midx, mv = cands[decode_merge_idx(dec)]
                mv = np.asarray(mv, dtype=np.int64)
            else:
                label(dec, "motion_model")
                midx = decode_motion_model(dec, n_active)
                pred = mvp_unit_grid_mm(coded, models_u, avail, uy, ux, k,
                                        midx)
                label(dec, "mvd")
                mvd = np.array([decode_mvd_comp(dec),
                                decode_mvd_comp(dec)], dtype=np.int64)
                mv = pred + mvd
            hr = parse_resid(d, by, bx, s)
        has_resid[uy:uy + k, ux:ux + k] = hr
        coded[uy:uy + k, ux:ux + k] = mv
        models_u[uy:uy + k, ux:ux + k] = midx
        avail[uy:uy + k, ux:ux + k] = True
        leaf_id[uy:uy + k, ux:ux + k] = uy * nux + ux

    def parse_node(d, by, bx):
        if d < depth:
            label(dec, "split_flag")
            if dec.decode_bin(ctx_id("SplitFlag", min(d, 8))):
                for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    parse_node(d + 1, 2 * by + dy, 2 * bx + dx)
                return
        parse_leaf(d, by, bx)

    for by in range(nty):
        for bx in range(ntx):
            parse_node(0, by, bx)
    return models_u, coded, levels, has_resid, leaf_id


def decode_b_slice_mm(data: bytes, nby: int, nbx: int, s: int,
                      active_models: list[int], conv=None, epipole0=None,
                      epipole1=None, use_merge: bool = False,
                      mer_blocks_log2: int = 0, stats=None):
    """Exact inverse of encoder.inter_coder.encode_b_slice_mm.  Returns
    (model_idx0, model_idx1, mv0, mv1, dirs, lev_y, lev_u, lev_v) — mv
    grids carry the selected model's MV per block."""
    dec = make_decoder(data, stats)
    sc = s // 2
    n_active = len(active_models)
    midx0 = np.zeros((nby, nbx), dtype=np.int32)
    midx1 = np.zeros((nby, nbx), dtype=np.int32)
    models0 = np.zeros((nby, nbx), dtype=np.int32)
    models1 = np.zeros((nby, nbx), dtype=np.int32)
    mv0 = np.zeros((nby, nbx, 2), dtype=np.int64)
    mv1 = np.zeros((nby, nbx, 2), dtype=np.int64)
    dirs = np.zeros((nby, nbx), dtype=np.int32)
    lev_y = np.zeros((nby, nbx, s, s), dtype=np.int32)
    lev_u = np.zeros((nby, nbx, sc, sc), dtype=np.int32)
    lev_v = np.zeros((nby, nbx, sc, sc), dtype=np.int32)
    model_to_idx = {m: i for i, m in enumerate(active_models)}
    if use_merge:
        for by in range(nby):
            for bx in range(nbx):
                mcands = merge_candidates_b_mm(
                    dirs, midx0, mv0, midx1, mv1, by, bx,
                    mer_blocks_log2=mer_blocks_log2)

                def apply_cand(c):
                    d, (i0, m0), (i1, m1) = c
                    dirs[by, bx] = d
                    midx0[by, bx] = i0
                    models0[by, bx] = active_models[i0]
                    mv0[by, bx] = m0
                    midx1[by, bx] = i1
                    models1[by, bx] = active_models[i1]
                    mv1[by, bx] = m1
                    _unused_override(d)

                def _unused_override(d):
                    # unused lists take the inherited model + its MVP
                    # (select_merge_b_mm / encode_b_slice_mm convention)
                    if d == 1:
                        inh0 = inherited_model(models0, by, bx)
                        models0[by, bx] = inh0
                        midx0[by, bx] = model_to_idx[inh0]
                        mv0[by, bx] = _mm_mvp(mv0, models0, by, bx, inh0,
                                              s, conv, epipole0)
                    if d == 0:
                        inh1 = inherited_model(models1, by, bx)
                        models1[by, bx] = inh1
                        midx1[by, bx] = model_to_idx[inh1]
                        mv1[by, bx] = _mm_mvp(mv1, models1, by, bx, inh1,
                                              s, conv, epipole1)

                label(dec, "skip_flag")
                skip = bool(dec.decode_bin(ctx_id("SkipFlag")))
                mrg = skip
                if not skip:
                    label(dec, "merge_flag")
                    mrg = bool(dec.decode_bin(ctx_id("MergeFlag")))
                if mrg:
                    label(dec, "merge_idx")
                    apply_cand(mcands[decode_merge_idx(dec)])
                    if skip:
                        continue
                else:
                    if dec.decode_bin(ctx_id("InterDir", 0)):
                        d = 2
                    else:
                        d = dec.decode_bin(ctx_id("InterDir", 1))
                    dirs[by, bx] = d
                    if d != 1:
                        label(dec, "motion_model")
                        mi = decode_motion_model(dec, n_active)
                        midx0[by, bx] = mi
                        models0[by, bx] = active_models[mi]
                        label(dec, "mvd")
                        mvd = np.array([decode_mvd_comp(dec),
                                        decode_mvd_comp(dec)], np.int64)
                        p = _mm_mvp(mv0, models0, by, bx,
                                    active_models[mi], s, conv, epipole0)
                        mv0[by, bx] = p + mvd
                    if d != 0:
                        label(dec, "motion_model")
                        mi = decode_motion_model(dec, n_active)
                        midx1[by, bx] = mi
                        models1[by, bx] = active_models[mi]
                        label(dec, "mvd")
                        mvd = np.array([decode_mvd_comp(dec),
                                        decode_mvd_comp(dec)], np.int64)
                        p = _mm_mvp(mv1, models1, by, bx,
                                    active_models[mi], s, conv, epipole1)
                        mv1[by, bx] = p + mvd
                    _unused_override(d)
                for ci, (lev, size) in enumerate(((lev_y, s), (lev_u, sc),
                                                 (lev_v, sc))):
                    label(dec, "cbf")
                    if dec.decode_bin(ctx_id("QtCbf", (0, 4, 5)[ci])):
                        label(dec, "residual_" + "yuv"[ci])
                        lev[by, bx] = dec.decode_coeffs(size, size,
                                                        chroma=(ci != 0))
        return midx0, midx1, mv0, mv1, dirs, lev_y, lev_u, lev_v
    for by in range(nby):
        for bx in range(nbx):
            d_pred = (int(dirs[by, bx - 1]) if bx > 0
                      else int(dirs[by - 1, bx]) if by > 0 else 0)
            inh0 = inherited_model(models0, by, bx)
            inh1 = inherited_model(models1, by, bx)
            label(dec, "skip_flag")
            if dec.decode_bin(ctx_id("SkipFlag")):
                d = d_pred
                dirs[by, bx] = d
                models0[by, bx] = inh0
                midx0[by, bx] = model_to_idx[inh0]
                mv0[by, bx] = _mm_mvp(mv0, models0, by, bx, inh0, s,
                                      conv, epipole0)
                models1[by, bx] = inh1
                midx1[by, bx] = model_to_idx[inh1]
                mv1[by, bx] = _mm_mvp(mv1, models1, by, bx, inh1, s,
                                      conv, epipole1)
                continue
            if dec.decode_bin(ctx_id("InterDir", 0)):
                d = 2
            else:
                d = dec.decode_bin(ctx_id("InterDir", 1))
            dirs[by, bx] = d
            if d != 1:
                label(dec, "motion_model")
                mi = decode_motion_model(dec, n_active)
                midx0[by, bx] = mi
                models0[by, bx] = active_models[mi]
                label(dec, "mvd")
                mvd = np.array([decode_mvd_comp(dec),
                                decode_mvd_comp(dec)], dtype=np.int64)
                p = _mm_mvp(mv0, models0, by, bx, active_models[mi], s,
                            conv, epipole0)
                mv0[by, bx] = p + mvd
            if d != 0:
                label(dec, "motion_model")
                mi = decode_motion_model(dec, n_active)
                midx1[by, bx] = mi
                models1[by, bx] = active_models[mi]
                label(dec, "mvd")
                mvd = np.array([decode_mvd_comp(dec),
                                decode_mvd_comp(dec)], dtype=np.int64)
                p = _mm_mvp(mv1, models1, by, bx, active_models[mi], s,
                            conv, epipole1)
                mv1[by, bx] = p + mvd
            for ci, (lev, size) in enumerate(((lev_y, s), (lev_u, sc),
                                             (lev_v, sc))):
                label(dec, "cbf")
                if dec.decode_bin(ctx_id("QtCbf", (0, 4, 5)[ci])):
                    label(dec, "residual_" + "yuv"[ci])
                    lev[by, bx] = dec.decode_coeffs(size, size,
                                                    chroma=(ci != 0))
            # unused-list entries: inherited model + its MVP (mirrors the
            # encoder's grid evolution)
            if d == 1:
                models0[by, bx] = inh0
                midx0[by, bx] = model_to_idx[inh0]
                mv0[by, bx] = _mm_mvp(mv0, models0, by, bx, inh0, s,
                                      conv, epipole0)
            if d == 0:
                models1[by, bx] = inh1
                midx1[by, bx] = model_to_idx[inh1]
                mv1[by, bx] = _mm_mvp(mv1, models1, by, bx, inh1, s,
                                      conv, epipole1)
    return midx0, midx1, mv0, mv1, dirs, lev_y, lev_u, lev_v



# ------------------------------------------------ classic quadtree / MTT

def _parse_split_syntax(dec: BinDecoder, d: int, s: int, u: int,
                        mtt: bool) -> int:
    """Inverse of inter_coder._code_split_syntax: the split code."""
    label(dec, "split_flag")
    if not dec.decode_bin(ctx_id("SplitFlag", min(d, 8))):
        return mtt_mod.LEAF
    if not mtt or (label(dec, "split_qt_flag")
                   or dec.decode_bin(ctx_id("QtSplitFlag", min(d, 2)))):
        return mtt_mod.QUAD
    bt_ok = mtt_mod.bt_allowed(s, u)
    if bt_ok and mtt_mod.tt_allowed(s, u):
        label(dec, "mtt_binary_flag")
        bt = bool(dec.decode_bin(ctx_id("BtFlag", min(d, 2))))
    else:
        bt = bt_ok
    label(dec, "mtt_vertical_flag")
    vert = bool(dec.decode_bin(ctx_id("MttVert", min(d, 2))))
    if bt:
        return mtt_mod.BTV if vert else mtt_mod.BTH
    return mtt_mod.TTV if vert else mtt_mod.TTH


def _alloc_tree_levels(h: int, w: int, top: int, depth: int, mtt: bool):
    """Zero level grids of every shape of the lattice, filled while
    parsing: {d: trio} for the squares, {(kind, d): trio} for the rect
    grids (none without MTT)."""
    def trio(gy, gx, sy, sx):
        return (np.zeros((gy, gx, sy, sx), dtype=np.int32),
                np.zeros((gy, gx, sy // 2, sx // 2), dtype=np.int32),
                np.zeros((gy, gx, sy // 2, sx // 2), dtype=np.int32))
    sq = {d: trio(h // s, w // s, s, s)
          for d, s in enumerate(top >> i for i in range(depth + 1))}
    rect = {}
    if mtt:
        for info in mtt_mod.rect_shapes(top, depth):
            rect[info[:2]] = trio(*mtt_mod.rect_grid(h, w, info),
                                  info[2], info[3])
    return sq, rect


def _decode_tree(data: bytes, h: int, w: int, top: int, depth: int,
                 mtt: bool, use_merge: bool, bi: bool, stats=None):
    """Exact inverse of inter_coder._encode_tree.  Returns (coded grids —
    (mv_unit,) for P, (mv0_unit, mv1_unit, dirs_unit) for B —, square
    levels [per size (ly, lu, lv)], rect levels {(kind, d): trio},
    has_resid_unit, leaf_id_unit)."""
    dec = make_decoder(data, stats)
    u = top >> depth
    nuy, nux = h // u, w // u
    sq, rect = _alloc_tree_levels(h, w, top, depth, mtt)
    levels = {**sq, **rect}
    coded0 = np.zeros((nuy, nux, 2), dtype=np.int64)
    coded1 = np.zeros((nuy, nux, 2), dtype=np.int64)
    dirs_u = np.zeros((nuy, nux), dtype=np.int32)
    avail = np.zeros((nuy, nux), dtype=bool)
    has_resid = np.zeros((nuy, nux), dtype=bool)
    leaf_id = np.zeros((nuy, nux), dtype=np.int32)

    # the JAX parsers' labels: a classic quadtree B slice without merge
    # counts its residual bins under "cbf"
    resid_label = mtt or use_merge or not bi

    def parse_resid(levs):
        hr = False
        for ci, lev in enumerate(levs):
            label(dec, "cbf")
            if dec.decode_bin(ctx_id("QtCbf", (0, 4, 5)[ci])):
                if resid_label:
                    label(dec, "residual_" + "yuv"[ci])
                lev[...] = dec.decode_coeffs(*lev.shape, chroma=(ci != 0))
                hr = True
        return hr

    def dir_and_mvds(pred0, pred1):
        dv = (2 if dec.decode_bin(ctx_id("InterDir", 0))
              else dec.decode_bin(ctx_id("InterDir", 1)))
        mv0 = pred0 + _decode_mvd(dec) if dv != 1 else pred0
        mv1 = pred1 + _decode_mvd(dec) if dv != 0 else pred1
        return dv, mv0, mv1

    def leaf(key, gy, gx, uy, ux, ky, kx):
        levs = tuple(levels[key][c][gy, gx] for c in range(3))
        pred0 = mvp_unit_grid(coded0, avail, uy, ux, kx)
        if bi:
            pred1 = mvp_unit_grid(coded1, avail, uy, ux, kx)
            cands = (merge_candidates_unit_b(coded0, coded1, dirs_u, avail,
                                             uy, ux, kx) if use_merge
                     else None)
        else:
            cands = (merge_candidates_unit(coded0, avail, uy, ux, kx)
                     if use_merge else None)
        label(dec, "skip_flag")
        skip = bool(dec.decode_bin(ctx_id("SkipFlag")))
        if use_merge:
            mrg = skip or bool(label(dec, "merge_flag") or dec.decode_bin(
                ctx_id("MergeFlag")))
            if mrg:
                label(dec, "merge_idx")
                c = cands[decode_merge_idx(dec)]
                if bi:
                    dv, mv0, mv1 = (c[0], np.asarray(c[1], np.int64),
                                    np.asarray(c[2], np.int64))
                else:
                    mv0 = np.asarray(c, np.int64)
        else:
            mrg = skip
            if skip:
                if bi:
                    dv, mv0, mv1 = (_b_dir_pred(dirs_u, avail, uy, ux),
                                    pred0, pred1)
                else:
                    mv0 = pred0
        if not mrg:
            if bi:
                dv, mv0, mv1 = dir_and_mvds(pred0, pred1)
            else:
                label(dec, "mvd")
                mv0 = pred0 + _decode_mvd(dec)
        hr = False if skip else parse_resid(levs)
        span = (slice(uy, uy + ky), slice(ux, ux + kx))
        coded0[span] = mv0
        if bi:
            coded1[span] = mv1
            dirs_u[span] = dv
        avail[span] = True
        has_resid[span] = hr
        leaf_id[span] = uy * nux + ux

    walk_tree(h // top, w // top, top, depth,
              lambda d, by, bx, s: _parse_split_syntax(dec, d, s, u, mtt),
              leaf)
    coded = (coded0, coded1, dirs_u) if bi else (coded0,)
    return (coded, [sq[d] for d in range(depth + 1)], rect, has_resid,
            leaf_id)


def decode_p_slice_qt(data: bytes, h: int, w: int, top: int, depth: int,
                      use_merge: bool = False, stats=None):
    """Exact inverse of encoder.inter_coder.encode_p_slice_qt.  Returns
    (mv_unit (nuy,nux,2), levels [per size (ly,lu,lv)], has_resid_unit,
    leaf_id_unit), the resolved outputs of qtree.encode_p_frame_qt."""
    (mv_u,), sq, _, hr, lid = _decode_tree(data, h, w, top, depth, False,
                                           use_merge, False, stats)
    return mv_u, sq, hr, lid


def decode_b_slice_qt(data: bytes, h: int, w: int, top: int, depth: int,
                      use_merge: bool = False, stats=None):
    """Exact inverse of encoder.inter_coder.encode_b_slice_qt.  Returns
    (mv0_unit, mv1_unit, dirs_unit, levels, has_resid_unit,
    leaf_id_unit)."""
    coded, sq, _, hr, lid = _decode_tree(data, h, w, top, depth, False,
                                         use_merge, True, stats)
    return (*coded, sq, hr, lid)


def decode_p_slice_mtt(data: bytes, h: int, w: int, top: int, depth: int,
                       use_merge: bool = False, stats=None):
    """Exact inverse of encoder.inter_coder.encode_p_slice_mtt.  Returns
    (mv_unit, sq_levels, rect_levels, has_resid_unit, leaf_id_unit)."""
    (mv_u,), sq, rect, hr, lid = _decode_tree(data, h, w, top, depth, True,
                                              use_merge, False, stats)
    return mv_u, sq, rect, hr, lid


def decode_b_slice_mtt(data: bytes, h: int, w: int, top: int, depth: int,
                       use_merge: bool = False, stats=None):
    """Exact inverse of encoder.inter_coder.encode_b_slice_mtt.  Returns
    (mv0_unit, mv1_unit, dirs_unit, sq_levels, rect_levels,
    has_resid_unit, leaf_id_unit)."""
    coded, sq, rect, hr, lid = _decode_tree(data, h, w, top, depth, True,
                                            use_merge, True, stats)
    return (*coded, sq, rect, hr, lid)
