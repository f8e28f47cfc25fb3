"""Inter slices on the host: candidate lists, the encoder's merge/split
selection and the CABAC slice writers.

Copied from `vvc_mm_tpu/encoder/inter_coder.py` (numpy host code; reference:
source/Lib/EncoderLib/CABACWriter.cpp cu_skip_flag, merge_idx,
ref_idx, inter_pred_idc, motion_model():1854, mvd_coding:1575, cbf +
residual_coding; UnitTools.cpp:1059 getInterMergeCandidates, :872-885
model inheritance through merge, fillMvpCand).  The candidate lists are
shared bit-exactly by encoder and decoder.  Here are the classic paths
(the P slice with one or two references, merge on or off, and the B
slice) and the multi-model ones (the flat P slice and the B slice, merge
on or off, the quadtree P slice, and MM-MVP: cross-model candidates
converted by common/mm/mvp_convert.py).  The classic paths carry the
random-access tools: TMVP/HMVP (the co-located field and the history FIFO
in the merge and AMVP lists), AMVR (the per-block MVD precision), GPM and
CIIP (B block modes) and the affine P slice.  The classic quadtree and
its multi-type tree (BT/TT) code P and B slices through one tree walker
(`walk_tree`) and one leaf syntax per slice type, over the causal unit
grid.  Under WPP the classic P and B slices (merge on) code each block
row group as its own substream (`encode_p_slice_wpp`,
`encode_b_slice_wpp`: fresh contexts and a fresh HMVP FIFO, the row
ranges of `encode_p_slice` / `encode_b_slice`), and the P merge selection
resets its HMVP FIFO at the same rows.
"""
from __future__ import annotations

import numpy as np

from ..common import mtt as mtt_mod
from ..common.cabac import BinEncoder
from ..common.inter_frame import AMVR_SHIFTS, round_mv_amvr
from ..common.contexts import ctx_id
from ..utils import trace as trace_mod
from ..utils.native import NativeBinEncoder
from .intra_coder import encode_substreams, wpp_bounds


MERGE_MAX = 6     # merge candidate list size (reference: CommonDef.h
                  # MRG_MAX_NUM_CANDS = 6)


def _mvd_bits(v: np.ndarray) -> int:
    """Cheap mvd bit estimate for AMVP index choice (encoder only)."""
    return sum(1 + (2 * int(abs(int(c))).bit_length() if c else 0)
               for c in v)


def _median3(a: int, b: int, c: int) -> int:
    """Middle value of three ints (equals np.median for 3 samples)."""
    return a + b + c - min(a, b, c) - max(a, b, c)


def mvp_median(mvs: np.ndarray, by: int, bx: int) -> np.ndarray:
    """Median MV predictor from decoded neighbours (host, shared enc/dec):
    candidates (left, above, above-right | above-left); 3 -> component
    median, 2 -> rounding average, 1 -> copy, 0 -> zero."""
    nbx = mvs.shape[1]
    if by == 0:
        if bx == 0:
            return np.zeros(2, dtype=np.int64)
        v = mvs[by, bx - 1]
        return np.array([int(v[0]), int(v[1])], np.int64)
    a = mvs[by - 1, bx]
    ax, ay = int(a[0]), int(a[1])
    if bx + 1 < nbx:
        c = mvs[by - 1, bx + 1]
    elif bx > 0:
        c = mvs[by - 1, bx - 1]
    else:
        return np.array([ax, ay], np.int64)
    cx, cy = int(c[0]), int(c[1])
    if bx == 0:
        # no left: rounding average of (above, above-right)
        return np.array([(ax + cx + 1) >> 1, (ay + cy + 1) >> 1], np.int64)
    lft = mvs[by, bx - 1]
    lx, ly = int(lft[0]), int(lft[1])
    return np.array([_median3(lx, ax, cx), _median3(ly, ay, cy)], np.int64)


HMVP_SIZE = 5


class HmvpList:
    """History-based MVP FIFO (reference: HMVP LUT, UnitTools.cpp:3178
    addAMVPHMVPCand; redundancy-checked append, size 5).  Updated in block
    coding order identically by encoder and decoder."""

    def __init__(self) -> None:
        self.lut: list[tuple[int, int]] = []

    def push(self, mv) -> None:
        t = (int(mv[0]), int(mv[1]))
        if t in self.lut:
            self.lut.remove(t)
        self.lut.append(t)
        if len(self.lut) > HMVP_SIZE:
            self.lut.pop(0)

    def cands(self) -> list[np.ndarray]:
        return [np.array(t, np.int64) for t in reversed(self.lut)]


def amvp_list(mvs: np.ndarray, by: int, bx: int, col_mv=None,
              hist: HmvpList | None = None, n: int = 2) -> list[np.ndarray]:
    """AMVP candidate list: spatial median, TMVP co-located MV, HMVP
    entries, zero — deduped, padded with zero to n (reference:
    UnitTools.cpp:2172 fillMvpCand — spatial, :2272 TMVP, :3178 HMVP)."""
    cands = [mvp_median(mvs, by, bx)]
    if col_mv is not None:
        cands.append(np.asarray(col_mv, dtype=np.int64))
    if hist is not None:
        cands.extend(hist.cands())
    cands.append(np.zeros(2, dtype=np.int64))
    out: list[np.ndarray] = []
    for c in cands:
        if not any(c[0] == o[0] and c[1] == o[1] for o in out):
            out.append(c)
        if len(out) == n:
            break
    while len(out) < n:
        out.append(np.zeros(2, dtype=np.int64))
    return out


def _in_other_mer(by: int, bx: int, y: int, x: int,
                  mer_blocks_log2: int) -> bool:
    """Whether (y, x) lies outside the merge-estimation region of block
    (by, bx): spatial candidates inside it are excluded (reference:
    isDiffMER, UnitTools.cpp:857)."""
    if mer_blocks_log2 <= 0:
        return True
    return ((y >> mer_blocks_log2) != (by >> mer_blocks_log2)
            or (x >> mer_blocks_log2) != (bx >> mer_blocks_log2))


def _spatial_neighbours(nby: int, nbx: int, by: int, bx: int,
                        mer_blocks_log2: int) -> list[tuple[int, int]]:
    """A1, B1, B0, B2 of block (by, bx) that are decoded before it and lie
    outside its merge-estimation region."""
    return [(y, x) for (y, x) in ((by, bx - 1), (by - 1, bx),
                                  (by - 1, bx + 1), (by - 1, bx - 1))
            if (0 <= y < nby and 0 <= x < nbx and (y, x) < (by, bx)
                and _in_other_mer(by, bx, y, x, mer_blocks_log2))]


def merge_candidates(coded: np.ndarray, by: int, bx: int, col_mv=None,
                     hist: HmvpList | None = None, n: int = MERGE_MAX,
                     mer_blocks_log2: int = 0) -> list[tuple[int, int]]:
    """Merge candidate list from the causally-decoded MV grid, shared
    bit-exactly by encoder and decoder (reference: UnitTools.cpp:1059
    getInterMergeCandidates — spatial A1/B1/B0/B2, TMVP, HMVP,
    pairwise-average, zero).  `mer_blocks_log2`: the merge-estimation
    region's side in blocks (log2)."""
    nby, nbx = coded.shape[:2]
    cands = [(int(coded[y, x, 0]), int(coded[y, x, 1]))
             for (y, x) in _spatial_neighbours(nby, nbx, by, bx,
                                               mer_blocks_log2)]
    if col_mv is not None:
        cands.append((int(col_mv[0]), int(col_mv[1])))
    if hist is not None:
        cands += [(int(c[0]), int(c[1])) for c in hist.cands()]
    out: list[tuple[int, int]] = []
    for c in cands:
        if c not in out:
            out.append(c)
        if len(out) == n:
            break
    if len(out) >= 2 and len(out) < n:
        # pairwise average of the first two DISTINCT candidates
        pw = ((out[0][0] + out[1][0] + 1) >> 1,
              (out[0][1] + out[1][1] + 1) >> 1)
        if pw not in out:
            out.append(pw)
    if len(out) < n and (0, 0) not in out:
        out.append((0, 0))
    while len(out) < n:
        out.append((0, 0))
    return out


def select_merge_p(mv_me: np.ndarray, sad_me: np.ndarray,
                   cand_mvs: np.ndarray, cand_sads: np.ndarray,
                   col_mvs: np.ndarray | None, lam_sqrt: float,
                   use_tmvp: bool, mer_blocks_log2: int = 0,
                   snap: bool = True,
                   substream_starts: tuple[int, ...] = ()):
    """Encoder merge decision in coding order (the host pass between the
    two device programs; reference analog: EncCu::xCheckRDCostMerge2Nx2N).

    For each block, the decoder-mirrored candidate list is derived from
    the evolving FINAL MV grid; candidates whose SAD is known (they match
    one of the device-evaluated candidate fields, or the ME MV itself)
    compete against the AMVP coding of the ME MV on SAD + lambda*bits.  A
    tie keeps the earlier candidate, and a tie with AMVP merges.  With
    use_tmvp the lists carry the co-located MV (`col_mvs`, None when the
    reference has no field) and the HMVP FIFO, pushed in coding order.
    With snap=False only candidates equal to the ME MV are taken, so the
    MV field stays as searched (MCTS: a neighbour's MV can leave this
    block's tile).

    substream_starts: the block rows at which the entropy pass starts a
    new WPP substream.  The HMVP FIFO resets there exactly as in the
    syntax pass (encode_p_slice rows= / the decoder's WPP parse), so the
    list this selection derives is the one the decoder derives (reference:
    the per-CTU-row HMVP reset under WPP).

    Returns (final_mvs, merge_flag, merge_idx)."""
    nby, nbx = mv_me.shape[:2]
    final = mv_me.astype(np.int64).copy()
    merge_flag = np.zeros((nby, nbx), dtype=bool)
    merge_idx = np.zeros((nby, nbx), dtype=np.int32)
    hist = HmvpList() if use_tmvp else None
    n_fields = cand_mvs.shape[0]
    # plain-list views: python-int indexing is ~10x cheaper than numpy
    # scalar reads in this per-block host loop
    mv_l = np.asarray(mv_me).tolist()
    sad_l = np.asarray(sad_me).tolist()
    cmv_l = np.asarray(cand_mvs).tolist()
    csad_l = np.asarray(cand_sads).tolist()
    for by in range(nby):
        if hist is not None and by in substream_starts:
            hist = HmvpList()
        for bx in range(nbx):
            col = (col_mvs[by, bx] if (use_tmvp and col_mvs is not None)
                   else None)
            cands = merge_candidates(final, by, bx, col, hist,
                                     mer_blocks_log2=mer_blocks_log2)
            me_mv = (mv_l[by][bx][0], mv_l[by][bx][1])
            best = None                       # (cost, idx, mv)
            for i, c in enumerate(cands):
                if c == me_mv:
                    sad = sad_l[by][bx]
                elif not snap:
                    continue
                else:
                    sad = None
                    for k in range(n_fields):
                        ck = cmv_l[k][by][bx]
                        if ck[0] == c[0] and ck[1] == c[1]:
                            sad = csad_l[k][by][bx]
                            break
                    if sad is None:
                        continue
                cost = sad + lam_sqrt * (i + 2)
                if best is None or cost < best[0]:
                    best = (cost, i, c)
            pred = mvp_median(final, by, bx)
            mvd = np.asarray(me_mv, dtype=np.int64) - pred
            amvp_cost = sad_l[by][bx] + lam_sqrt * (2 + _mvd_bits(mvd))
            if best is not None and best[0] <= amvp_cost:
                merge_flag[by, bx] = True
                merge_idx[by, bx] = best[1]
                final[by, bx] = best[2]
            if hist is not None:
                hist.push(final[by, bx])
    return final, merge_flag, merge_idx


def merge_candidates_ref(refs_g: np.ndarray, coded: np.ndarray, by: int,
                         bx: int, col_mv=None, hist: HmvpList | None = None,
                         n: int = MERGE_MAX, mer_blocks_log2: int = 0
                         ) -> list[tuple[int, tuple[int, int]]]:
    """Multi-reference merge candidates (ref_idx, mv): spatial neighbours
    carry their reference; TMVP and HMVP ride ref 0, the pairwise average
    of the first two (when they share one) rides it, the zero candidate
    rides ref 0 (reference: merge candidates carry mvField incl. refIdx,
    UnitTools.cpp:1059)."""
    nby, nbx = refs_g.shape
    cands = [(int(refs_g[y, x]), (int(coded[y, x, 0]), int(coded[y, x, 1])))
             for (y, x) in _spatial_neighbours(nby, nbx, by, bx,
                                               mer_blocks_log2)]
    if col_mv is not None:
        cands.append((0, (int(col_mv[0]), int(col_mv[1]))))
    if hist is not None:
        cands += [(0, (int(c[0]), int(c[1]))) for c in hist.cands()]
    out = []
    for c in cands:
        if c not in out:
            out.append(c)
        if len(out) == n:
            break
    if len(out) >= 2 and len(out) < n and out[0][0] == out[1][0]:
        pw = (out[0][0], ((out[0][1][0] + out[1][1][0] + 1) >> 1,
                          (out[0][1][1] + out[1][1][1] + 1) >> 1))
        if pw not in out:
            out.append(pw)
    zero = (0, (0, 0))
    if len(out) < n and zero not in out:
        out.append(zero)
    while len(out) < n:
        out.append(zero)
    return out


def select_merge_p_2ref(ref_me: np.ndarray, mv_me: np.ndarray,
                        sad_me: np.ndarray, cand_ref: np.ndarray,
                        cand_mvs: np.ndarray, cand_sads: np.ndarray,
                        col_mvs: np.ndarray | None, lam_sqrt: float,
                        use_tmvp: bool, mer_blocks_log2: int = 0):
    """Two-reference merge decision in coding order (TMVP/HMVP as in
    select_merge_p).  Returns (final_ref, final_mvs, merge_flag,
    merge_idx)."""
    nby, nbx = ref_me.shape
    f_ref = ref_me.astype(np.int32).copy()
    f_mv = mv_me.astype(np.int64).copy()
    merge_flag = np.zeros((nby, nbx), dtype=bool)
    merge_idx = np.zeros((nby, nbx), dtype=np.int32)
    hist = HmvpList() if use_tmvp else None
    n_fields = cand_ref.shape[0]
    for by in range(nby):
        for bx in range(nbx):
            col = (col_mvs[by, bx] if (use_tmvp and col_mvs is not None)
                   else None)
            cands = merge_candidates_ref(f_ref, f_mv, by, bx, col, hist,
                                         mer_blocks_log2=mer_blocks_log2)
            me = (int(ref_me[by, bx]),
                  (int(mv_me[by, bx, 0]), int(mv_me[by, bx, 1])))
            best = None
            for i, c in enumerate(cands):
                if c == me:
                    sad = int(sad_me[by, bx])
                else:
                    sad = None
                    for k in range(n_fields):
                        if (int(cand_ref[k, by, bx]) == c[0]
                                and int(cand_mvs[k, by, bx, 0]) == c[1][0]
                                and int(cand_mvs[k, by, bx, 1]) == c[1][1]):
                            sad = int(cand_sads[k, by, bx])
                            break
                    if sad is None:
                        continue
                cost = sad + lam_sqrt * (i + 2)
                if best is None or cost < best[0]:
                    best = (cost, i, c)
            pred = mvp_median(f_mv, by, bx)
            mvd = np.asarray(me[1], dtype=np.int64) - pred
            amvp_cost = (int(sad_me[by, bx])
                         + lam_sqrt * (3 + _mvd_bits(mvd)))
            if best is not None and best[0] <= amvp_cost:
                merge_flag[by, bx] = True
                merge_idx[by, bx] = best[1]
                f_ref[by, bx] = best[2][0]
                f_mv[by, bx] = best[2][1]
            if hist is not None:
                hist.push(f_mv[by, bx])
    return f_ref, f_mv, merge_flag, merge_idx


def merge_candidates_b(dirs_g: np.ndarray, mv0_g: np.ndarray,
                       mv1_g: np.ndarray, by: int, bx: int,
                       n: int = MERGE_MAX, mer_blocks_log2: int = 0
                       ) -> list[tuple[int, tuple[int, int],
                                       tuple[int, int]]]:
    """Whole-motion B merge candidates (inter_dir, mv0, mv1) from the
    causally-decoded grids, shared bit-exactly by encoder and decoder
    (reference: getInterMergeCandidates carries interDirNeighbours +
    mvFieldNeighbours for both lists, UnitTools.cpp:1059).  Neighbour
    dirs clamp to BI; pairwise averages both lists; the list closes with
    the zero-BI candidate."""
    nby, nbx = dirs_g.shape
    cands = [(min(int(dirs_g[y, x]), 2),
              (int(mv0_g[y, x, 0]), int(mv0_g[y, x, 1])),
              (int(mv1_g[y, x, 0]), int(mv1_g[y, x, 1])))
             for (y, x) in _spatial_neighbours(nby, nbx, by, bx,
                                               mer_blocks_log2)]
    out = []
    for c in cands:
        if c not in out:
            out.append(c)
        if len(out) == n:
            break
    if len(out) >= 2 and len(out) < n:
        a, b = out[0], out[1]
        pw = (2, ((a[1][0] + b[1][0] + 1) >> 1,
                  (a[1][1] + b[1][1] + 1) >> 1),
              ((a[2][0] + b[2][0] + 1) >> 1,
               (a[2][1] + b[2][1] + 1) >> 1))
        if pw not in out:
            out.append(pw)
    zero = (2, (0, 0), (0, 0))
    if len(out) < n and zero not in out:
        out.append(zero)
    while len(out) < n:
        out.append(zero)
    return out


def select_merge_b(mv0_me: np.ndarray, mv1_me: np.ndarray,
                   dirs_me: np.ndarray, sad_sel: np.ndarray,
                   cand_mv0: np.ndarray, cand_mv1: np.ndarray,
                   cand_dirs: np.ndarray, cand_sads: np.ndarray,
                   lam_sqrt: float, mer_blocks_log2: int = 0):
    """Encoder B merge decision in coding order (reference analog:
    EncCu::xCheckRDCostMerge2Nx2N for B slices).  Returns (mv0, mv1,
    dirs, merge_flag, merge_idx): grids evolve with the entropy
    convention (unused-list entries take their MVP)."""
    nby, nbx = dirs_me.shape
    f_mv0 = mv0_me.astype(np.int64).copy()
    f_mv1 = mv1_me.astype(np.int64).copy()
    f_dirs = dirs_me.astype(np.int32).copy()
    merge_flag = np.zeros((nby, nbx), dtype=bool)
    merge_idx = np.zeros((nby, nbx), dtype=np.int32)
    n_fields = cand_mv0.shape[0]
    for by in range(nby):
        for bx in range(nbx):
            d = int(dirs_me[by, bx])
            pred0 = mvp_median(f_mv0, by, bx)
            pred1 = mvp_median(f_mv1, by, bx)
            if d >= 3:     # GPM/CIIP sub-state is not merge-representable
                continue
            cands = merge_candidates_b(f_dirs, f_mv0, f_mv1, by, bx,
                                       mer_blocks_log2=mer_blocks_log2)
            me = (d, (int(mv0_me[by, bx, 0]), int(mv0_me[by, bx, 1])),
                  (int(mv1_me[by, bx, 0]), int(mv1_me[by, bx, 1])))
            best = None
            for i, c in enumerate(cands):
                if c == me:
                    sad = int(sad_sel[by, bx])
                else:
                    sad = None
                    for k in range(n_fields):
                        if (int(cand_dirs[k, by, bx]) == c[0]
                                and int(cand_mv0[k, by, bx, 0]) == c[1][0]
                                and int(cand_mv0[k, by, bx, 1]) == c[1][1]
                                and int(cand_mv1[k, by, bx, 0]) == c[2][0]
                                and int(cand_mv1[k, by, bx, 1]) == c[2][1]):
                            sad = int(cand_sads[k, by, bx])
                            break
                    if sad is None:
                        continue
                cost = sad + lam_sqrt * (i + 2)
                if best is None or cost < best[0]:
                    best = (cost, i, c)
            mvd_bits = 0
            if d != 1:
                mvd_bits += _mvd_bits(np.asarray(me[1], np.int64) - pred0)
            if d != 0:
                mvd_bits += _mvd_bits(np.asarray(me[2], np.int64) - pred1)
            amvp_cost = int(sad_sel[by, bx]) + lam_sqrt * (3 + mvd_bits)
            if best is not None and best[0] <= amvp_cost:
                merge_flag[by, bx] = True
                merge_idx[by, bx] = best[1]
                cd, c0, c1 = best[2]
                f_dirs[by, bx] = cd
                f_mv0[by, bx] = c0
                f_mv1[by, bx] = c1
                d = cd
            # entropy convention: unused-list grid entries take their MVP
            if d == 0:
                f_mv1[by, bx] = pred1
            elif d == 1:
                f_mv0[by, bx] = pred0
    return f_mv0, f_mv1, f_dirs, merge_flag, merge_idx


def mvp_median_same_model(mvs: np.ndarray, model_ids: np.ndarray,
                          by: int, bx: int, model: int) -> np.ndarray:
    """Median MVP restricted to neighbors coded with the same motion model
    (simplified MM-MVP; the reference converts cross-model candidates via
    MVReprojection::motionVectorInDesiredMotionModel, UnitTools.cpp:2272 —
    conversion lands with the MM-MVP pass)."""
    nby, nbx = mvs.shape[:2]
    cand = []
    for (y, x) in ((by, bx - 1), (by - 1, bx), (by - 1, bx + 1),
                   (by - 1, bx - 1)):
        if 0 <= y < nby and 0 <= x < nbx and (y, x) < (by, bx) \
                and model_ids[y, x] == model:
            cand.append(mvs[y, x])
        if len(cand) == 3:
            break
    if not cand:
        return np.zeros(2, dtype=np.int64)
    if len(cand) == 1:
        return cand[0]
    if len(cand) == 2:
        a, b = cand
        return np.array([(int(a[0]) + int(b[0]) + 1) >> 1,
                         (int(a[1]) + int(b[1]) + 1) >> 1], np.int64)
    a, b, c = cand[:3]
    return np.array([_median3(int(a[0]), int(b[0]), int(c[0])),
                     _median3(int(a[1]), int(b[1]), int(c[1]))], np.int64)


def mvp_mm_converted(mvs: np.ndarray, model_ids: np.ndarray, by: int,
                     bx: int, model: int, s: int, conv, epipole=None
                     ) -> np.ndarray:
    """MM-MVP: median over neighbors with cross-model candidates converted
    into the current model (reference: UnitTools.cpp:2272 fillMvpCand ->
    MVReprojection::motionVectorInDesiredMotionModel).  `conv` is a
    mvp_convert.MMVPConverter shared bit-exactly by encoder and decoder."""
    nby, nbx = mvs.shape[:2]
    pos = (bx * s, by * s)
    cur_c = (bx * s + (s - 1) / 2.0, by * s + (s - 1) / 2.0)
    cand = []
    for (y, x) in ((by, bx - 1), (by - 1, bx), (by - 1, bx + 1),
                   (by - 1, bx - 1)):
        if not (0 <= y < nby and 0 <= x < nbx and (y, x) < (by, bx)):
            continue
        cand_model = int(model_ids[y, x])
        cand_c = (x * s + (s - 1) / 2.0, y * s + (s - 1) / 2.0)
        mv = conv.convert(pos, mvs[y, x], cand_model, model, cand_c, cur_c,
                          epipole, epipole)
        cand.append(mv)
        if len(cand) == 3:
            break
    if not cand:
        return np.zeros(2, dtype=np.int64)
    if len(cand) == 1:
        return cand[0]
    if len(cand) == 2:
        a, b = cand
        return np.array([(int(a[0]) + int(b[0]) + 1) >> 1,
                         (int(a[1]) + int(b[1]) + 1) >> 1], np.int64)
    a, b, c = cand[:3]
    return np.array([_median3(int(a[0]), int(b[0]), int(c[0])),
                     _median3(int(a[1]), int(b[1]), int(c[1]))], np.int64)


def _mm_mvp(mvs, models_sel, by, bx, model, s, conv, epipole):
    if conv is not None:
        return mvp_mm_converted(mvs, models_sel, by, bx, model, s, conv,
                                epipole)
    return mvp_median_same_model(mvs, models_sel, by, bx, model)


def inherited_model(model_ids: np.ndarray, by: int, bx: int,
                    default: int = 0) -> int:
    """Skip-mode model inheritance: left, else above, else CLASSIC
    (reference analog: merge candidates carry their model,
    UnitTools.cpp:872-885)."""
    if bx > 0:
        return int(model_ids[by, bx - 1])
    if by > 0:
        return int(model_ids[by - 1, bx])
    return default


def mvp_unit_grid_mm(coded: np.ndarray, models_u: np.ndarray,
                     avail: np.ndarray, uy: int, ux: int, k: int,
                     midx: int) -> np.ndarray:
    """Same-model median MVP over the causal unit grid (QT-MM leaves;
    reference analog: fillMvpCand restricted to same-model neighbors,
    the flat-grid mvp_median_same_model at unit granularity)."""
    nuy, nux = avail.shape
    cand = []
    for (y, x) in ((uy, ux - 1), (uy - 1, ux), (uy - 1, ux + k),
                   (uy - 1, ux - 1)):
        if (0 <= y < nuy and 0 <= x < nux and avail[y, x]
                and models_u[y, x] == midx):
            cand.append(coded[y, x])
        if len(cand) == 3:
            break
    if not cand:
        return np.zeros(2, dtype=np.int64)
    if len(cand) == 1:
        return cand[0].astype(np.int64)
    if len(cand) == 2:
        return ((cand[0].astype(np.int64) + cand[1] + 1) >> 1)
    c = np.stack(cand[:3]).astype(np.int64)
    return np.median(c, axis=0).astype(np.int64)


def inherited_midx_unit(models_u: np.ndarray, avail: np.ndarray, uy: int,
                        ux: int) -> int:
    """Skip-mode model inheritance on the unit grid: left, else above,
    else CLASSIC (index 0)."""
    if ux > 0 and avail[uy, ux - 1]:
        return int(models_u[uy, ux - 1])
    if uy > 0 and avail[uy - 1, ux]:
        return int(models_u[uy - 1, ux])
    return 0


def merge_candidates_qt_mm(midx_u: np.ndarray, mv_u: np.ndarray,
                           avail: np.ndarray, uy: int, ux: int, k: int,
                           n: int = MERGE_MAX
                           ) -> list[tuple[int, tuple[int, int]]]:
    """MM merge candidates (model_idx, mv) on the causal UNIT grid for a
    quadtree leaf spanning k x k units — shared bit-exactly by
    select_qt_mm, encode_p_slice_qt_mm's decisions and the decoder
    (reference: UnitTools.cpp:872-885 model inheritance through merge;
    spatial A1/B1/B0/B2 per leaf)."""
    nuy, nux = avail.shape
    cands = []
    for (y, x) in ((uy + k - 1, ux - 1), (uy - 1, ux + k - 1),
                   (uy - 1, ux + k), (uy - 1, ux - 1)):
        if 0 <= y < nuy and 0 <= x < nux and avail[y, x]:
            cands.append((int(midx_u[y, x]),
                          (int(mv_u[y, x, 0]), int(mv_u[y, x, 1]))))
    out = []
    for c in cands:
        if c not in out:
            out.append(c)
        if len(out) == n:
            break
    if len(out) >= 2 and len(out) < n and out[0][0] == out[1][0]:
        pw = (out[0][0], ((out[0][1][0] + out[1][1][0] + 1) >> 1,
                          (out[0][1][1] + out[1][1][1] + 1) >> 1))
        if pw not in out:
            out.append(pw)
    zero = (0, (0, 0))
    if len(out) < n and zero not in out:
        out.append(zero)
    while len(out) < n:
        out.append(zero)
    return out


def merge_candidates_b_mm(dirs_g: np.ndarray, midx0_g: np.ndarray,
                          mv0_g: np.ndarray, midx1_g: np.ndarray,
                          mv1_g: np.ndarray, by: int, bx: int,
                          n: int = MERGE_MAX, mer_blocks_log2: int = 0):
    """Whole-motion MM B merge candidates
    (dir, (midx0, mv0), (midx1, mv1)) from the causally-decoded grids —
    candidates inherit per-list models AND motion (reference:
    UnitTools.cpp:872-885 model inheritance through merge).  Closes with
    zero-BI-CLASSIC."""
    nby, nbx = dirs_g.shape
    cands = [(int(dirs_g[y, x]),
              (int(midx0_g[y, x]), (int(mv0_g[y, x, 0]), int(mv0_g[y, x, 1]))),
              (int(midx1_g[y, x]), (int(mv1_g[y, x, 0]), int(mv1_g[y, x, 1]))))
             for (y, x) in _spatial_neighbours(nby, nbx, by, bx,
                                               mer_blocks_log2)]
    out = []
    for c in cands:
        if c not in out:
            out.append(c)
        if len(out) == n:
            break
    zero = (2, (0, (0, 0)), (0, (0, 0)))
    if len(out) < n and zero not in out:
        out.append(zero)
    while len(out) < n:
        out.append(zero)
    return out


def encode_merge_idx(enc: BinEncoder, idx: int, n: int = MERGE_MAX) -> None:
    """Truncated-unary merge index: first bin context-coded, rest EP
    (reference: CABACWriter::merge_idx)."""
    if n <= 1:
        return
    enc.encode_bin(int(idx > 0), ctx_id("MergeIdx"))
    for i in range(1, idx):
        enc.encode_bin_ep(1)
    if 0 < idx < n - 1:
        enc.encode_bin_ep(0)


def encode_mvd_comp(enc: BinEncoder, v: int, ctx_base: str = "Mvd") -> None:
    """VVC mvd_coding per component: gt0(ctx), gt1(ctx), EG1 remainder,
    sign (reference: CABACWriter.cpp mvd_coding)."""
    a = abs(v)
    enc.encode_bin(int(a > 0), ctx_id(ctx_base, 0))
    if a > 0:
        enc.encode_bin(int(a > 1), ctx_id(ctx_base, 1))
        if a > 1:
            enc.encode_eg(a - 2, 1)
        enc.encode_bin_ep(int(v < 0))


def encode_motion_model(enc: BinEncoder, idx: int, n_active: int) -> None:
    """Truncated-unary model index over the active-model list, each bin
    context-coded (reference: CABACWriter.cpp:1854 motion_model() — first
    m_mmCodingDepth(=9) bins context-coded Ctx::MotionModel(i); all our
    lists are <= 11 so every bin gets a context)."""
    for i in range(idx):
        enc.encode_bin(1, ctx_id("MotionModel", min(i, 10)))
    if idx < n_active - 1:
        enc.encode_bin(0, ctx_id("MotionModel", min(idx, 10)))


def mer_blocks_log2(log2_parallel_merge_level: int, block_size: int
                    ) -> int:
    """The merge-estimation region's side in blocks (log2) from the SPS's
    log2_parallel_merge_level; encoder and decoder derive it here."""
    return max(0, log2_parallel_merge_level - (block_size.bit_length() - 1))


def merge_candidates_mm(midx_g: np.ndarray, mvs_sel: np.ndarray, by: int,
                        bx: int, n: int = MERGE_MAX,
                        mer_blocks_log2: int = 0
                        ) -> list[tuple[int, tuple[int, int]]]:
    """MM merge candidates (model_idx, mv) from the causally-decoded
    grids — candidates carry their motion MODEL, so merge inherits model
    and MV together (reference: UnitTools.cpp:872-885 model inheritance
    through merge candidates).  Pairwise averaging applies only between
    same-model candidates; the list closes with zero-CLASSIC (index 0).
    Neighbours inside the current block's merge-estimation region
    (2^mer_blocks_log2 blocks a side) are left out."""
    nby, nbx = midx_g.shape
    cands = [(int(midx_g[y, x]),
              (int(mvs_sel[y, x, 0]), int(mvs_sel[y, x, 1])))
             for (y, x) in _spatial_neighbours(nby, nbx, by, bx,
                                               mer_blocks_log2)]
    out = []
    for c in cands:
        if c not in out:
            out.append(c)
        if len(out) == n:
            break
    if len(out) >= 2 and len(out) < n and out[0][0] == out[1][0]:
        pw = (out[0][0], ((out[0][1][0] + out[1][1][0] + 1) >> 1,
                          (out[0][1][1] + out[1][1][1] + 1) >> 1))
        if pw not in out:
            out.append(pw)
    zero = (0, (0, 0))
    if len(out) < n and zero not in out:
        out.append(zero)
    while len(out) < n:
        out.append(zero)
    return out


def select_merge_mm(midx_me: np.ndarray, mvs_stack: np.ndarray,
                    sad_sel: np.ndarray, cand_idx: np.ndarray,
                    cand_mv: np.ndarray, cand_sads: np.ndarray,
                    active_models: list[int], lam_sqrt: float,
                    block_size: int, conv=None, epipole=None,
                    mer_blocks_log2: int = 0):
    """Encoder MM merge decision in coding order.  Returns
    (final_midx, final_stack, merge_flag, merge_idx) — final_stack has
    each block's FINAL mv written into its selected model's layer (the
    positions/finish read it through final_midx)."""
    nby, nbx = midx_me.shape
    n_active = len(active_models)
    f_midx = midx_me.astype(np.int32).copy()
    f_stack = mvs_stack.astype(np.int64).copy()
    mvs_sel = np.take_along_axis(
        f_stack, f_midx[None, :, :, None].astype(np.int64), axis=0
    )[0].astype(np.int64)
    models_sel = np.asarray([active_models[i] for i in f_midx.reshape(-1)],
                            dtype=np.int32).reshape(nby, nbx)
    merge_flag = np.zeros((nby, nbx), dtype=bool)
    merge_idx = np.zeros((nby, nbx), dtype=np.int32)
    n_fields = cand_idx.shape[0]
    sad_l = np.asarray(sad_sel).tolist()
    ci_l = np.asarray(cand_idx).tolist()
    cm_l = np.asarray(cand_mv).tolist()
    cs_l = np.asarray(cand_sads).tolist()
    for by in range(nby):
        for bx in range(nbx):
            cands = merge_candidates_mm(f_midx, mvs_sel, by, bx,
                                        mer_blocks_log2=mer_blocks_log2)
            me = (int(midx_me[by, bx]),
                  (int(mvs_sel[by, bx, 0]), int(mvs_sel[by, bx, 1])))
            best = None
            for i, c in enumerate(cands):
                if c == me:
                    sad = sad_l[by][bx]
                else:
                    sad = None
                    for k in range(n_fields):
                        mk = cm_l[k][by][bx]
                        if (ci_l[k][by][bx] == c[0] and mk[0] == c[1][0]
                                and mk[1] == c[1][1]):
                            sad = cs_l[k][by][bx]
                            break
                    if sad is None:
                        continue
                cost = sad + lam_sqrt * (i + 2)
                if best is None or cost < best[0]:
                    best = (cost, i, c)
            model = int(models_sel[by, bx])
            pred = _mm_mvp(mvs_sel, models_sel, by, bx, model, block_size,
                           conv, epipole)
            mvd = np.asarray(me[1], np.int64) - pred
            model_bins = min(me[0] + 1, n_active - 1)
            amvp_cost = (sad_l[by][bx]
                         + lam_sqrt * (2 + model_bins + _mvd_bits(mvd)))
            if best is not None and best[0] <= amvp_cost:
                merge_flag[by, bx] = True
                merge_idx[by, bx] = best[1]
                ci, cmv = best[2]
                f_midx[by, bx] = ci
                f_stack[ci, by, bx] = cmv
                mvs_sel[by, bx] = cmv
                models_sel[by, bx] = active_models[ci]
    return f_midx, f_stack, merge_flag, merge_idx


def _code_residual(enc, cbfs, levs) -> None:
    for cbf, lev, cid in zip(cbfs, levs, (0, 4, 5)):
        enc.encode_bin(int(cbf), ctx_id("QtCbf", cid))
        if cbf:
            enc.encode_coeffs(lev, chroma=(cid != 0))


def encode_p_slice_mm(model_idx: np.ndarray, active_models: list[int],
                      mvs_stack: np.ndarray, lev_y: np.ndarray,
                      lev_u: np.ndarray, lev_v: np.ndarray,
                      block_size: int = 16, conv=None,
                      epipole=None, merge_flag: np.ndarray | None = None,
                      merge_idx: np.ndarray | None = None) -> bytes:
    """Flat MM P-slice: per block skip / motion_model / mvd / residual.

    model_idx: (nby, nbx) index into active_models; mvs_stack
    (n_models, nby, nbx, 2).  With merge_flag/merge_idx (from
    select_merge_mm), skip means merge+no-residual and candidates carry
    (model, mv) — model inheritance through the merge list (reference:
    UnitTools.cpp:872-885).  Without them, skip means the inherited model
    at its MVP with no residual."""
    enc = NativeBinEncoder()
    nby, nbx = model_idx.shape
    n_active = len(active_models)
    use_merge = merge_flag is not None
    mvs_sel = np.take_along_axis(
        mvs_stack, model_idx[None, :, :, None].astype(np.int64), axis=0
    )[0].astype(np.int64)                              # (nby, nbx, 2)
    models_sel = np.asarray([active_models[i]
                             for i in model_idx.reshape(-1)],
                            dtype=np.int32).reshape(nby, nbx)
    cbf_y = (lev_y != 0).any(axis=(2, 3))
    cbf_u = (lev_u != 0).any(axis=(2, 3))
    cbf_v = (lev_v != 0).any(axis=(2, 3))
    for by in range(nby):
        for bx in range(nbx):
            midx = int(model_idx[by, bx])
            model = int(models_sel[by, bx])
            mv = mvs_sel[by, bx]
            cbfs = (bool(cbf_y[by, bx]), bool(cbf_u[by, bx]),
                    bool(cbf_v[by, bx]))
            levs = (lev_y[by, bx], lev_u[by, bx], lev_v[by, bx])
            no_resid = not any(cbfs)
            if use_merge:
                mrg = bool(merge_flag[by, bx])
                skip = mrg and no_resid
                enc.encode_bin(int(skip), ctx_id("SkipFlag"))
                if skip:
                    encode_merge_idx(enc, int(merge_idx[by, bx]))
                    continue
                enc.encode_bin(int(mrg), ctx_id("MergeFlag"))
                if mrg:
                    encode_merge_idx(enc, int(merge_idx[by, bx]))
                    _code_residual(enc, cbfs, levs)
                    continue
            else:
                inh = inherited_model(models_sel, by, bx)
                inh_mv = _mm_mvp(mvs_sel, models_sel, by, bx, inh,
                                 block_size, conv, epipole)
                skip = (no_resid and model == inh
                        and mv[0] == inh_mv[0] and mv[1] == inh_mv[1])
                enc.encode_bin(int(skip), ctx_id("SkipFlag"))
                if skip:
                    continue
            encode_motion_model(enc, midx, n_active)
            if trace_mod.TRACE is not None:
                trace_mod.TRACE.log("motion_model", by=by, bx=bx,
                                    model=model)
            pred = _mm_mvp(mvs_sel, models_sel, by, bx, model, block_size,
                           conv, epipole)
            if trace_mod.TRACE is not None:
                trace_mod.TRACE.log("mvd", by=by, bx=bx,
                                    x=int(mv[0] - pred[0]),
                                    y=int(mv[1] - pred[1]))
            encode_mvd_comp(enc, int(mv[0] - pred[0]))
            encode_mvd_comp(enc, int(mv[1] - pred[1]))
            _code_residual(enc, cbfs, levs)
    return enc.finish()


QT_SPLIT_BIAS_BINS = 6.0


def resolve_tree_qt_mm(per, rd, n_active: int, lam: float, depth: int):
    """Host bottom-up split resolve over the per-size cost lattice
    (batched analog of EncCu::xCheckModeSplit, EncCu.cpp:1118).

    per: list over sizes [top .. unit] of host tuples
    (idx, mv, sad, cidx, cmv, csad); rd: per-size (ssd, coeff_bits) from
    qt_codec.qt_rd_stats.  Cost = SSD + lambda*(coeff bits + motion
    bits), with motion bits the cheaper of the AMVP estimate and a
    merge-optimistic estimate (counted only when a measured candidate's
    SAD does not exceed the selection's — merging to a worse candidate
    would change the SSD this lattice can't see).
    Returns (splits, leaf) boolean mask lists."""
    costs = []
    for (idx, mv, sad, cidx, cmv, csad), (ssd, cbits) in zip(per, rd):
        idx = np.asarray(idx)
        mv = np.asarray(mv, dtype=np.int64)
        sad = np.asarray(sad, dtype=np.float64)
        csad = np.asarray(csad, dtype=np.float64)
        ssd = np.asarray(ssd, dtype=np.float64)
        cbits = np.asarray(cbits, dtype=np.float64)
        left = np.concatenate([mv[:, :1], mv[:, :-1]], axis=1)
        d = np.abs(mv - left).sum(-1).astype(np.float64)
        mvd_bits = 2.0 * np.log2(d + 1.0) + 2.0
        model_bins = np.minimum(idx + 1, n_active - 1)
        amvp_bits = 2.0 + model_bins + mvd_bits
        ks = np.arange(csad.shape[0], dtype=np.float64)[:, None, None]
        mrg_bits = np.where(csad <= sad[None],
                            3.0 + np.minimum(ks, 5.0), np.inf).min(axis=0)
        costs.append(ssd + lam * (cbits
                                  + np.minimum(amvp_bits, mrg_bits)))
    best = costs[depth]
    splits = [None] * depth
    for d in range(depth - 1, -1, -1):
        extra = lam if d + 1 < depth else 0.0
        b = best + extra
        # QT_SPLIT_BIAS: estimated per-leaf syntax the child cost model
        # cannot see (cbf trees, context dilution, merge candidates the
        # emission walk fails to realize) — biases the resolve toward the
        # parent so marginal splits don't land (the reference's
        # EncModeCtrl plays the same conservative role)
        agg = (b[0::2, 0::2] + b[0::2, 1::2] + b[1::2, 0::2]
               + b[1::2, 1::2]) + lam * QT_SPLIT_BIAS_BINS
        splits[d] = agg < costs[d]
        best = np.where(splits[d], agg, costs[d])
    leaf = []
    alive = np.ones(costs[0].shape, dtype=bool)
    for d in range(depth):
        sp = splits[d] & alive
        splits[d] = sp
        leaf.append(alive & ~sp)
        alive = np.repeat(np.repeat(sp, 2, 0), 2, 1)
    leaf.append(alive)
    return splits, leaf


def select_qt_mm(per, splits, leaf, active_models: list[int],
                 lam_sqrt: float, top: int, depth: int):
    """Encoder merge decision for the resolved MM quadtree, walking the
    tree in EMISSION order (z-order inside top-level raster) so candidate
    lists are exactly the ones the decoder derives from the causal unit
    grid.  per: host tuples as in resolve_tree_qt_mm.

    Returns (midx_unit, mv_unit, decisions) — decisions is a z-order list
    of (mflag, merge_idx, midx, mv, mvd) per leaf."""
    n_active = len(active_models)
    u = top >> depth
    sizes = [top >> d for d in range(depth + 1)]
    nuy, nux = leaf[-1].shape
    nty, ntx = leaf[0].shape
    midx_u = np.zeros((nuy, nux), dtype=np.int32)
    mv_u = np.zeros((nuy, nux, 2), dtype=np.int64)
    avail = np.zeros((nuy, nux), dtype=bool)
    host = []
    for (idx, mv, sad, cidx, cmv, csad) in per:
        host.append((np.asarray(idx).tolist(),
                     np.asarray(mv, dtype=np.int64),
                     np.asarray(sad).tolist(),
                     np.asarray(cidx).tolist(),
                     np.asarray(cmv).tolist(),
                     np.asarray(csad).tolist()))
    decisions = []

    def do_leaf(d, by, bx):
        k = sizes[d] // u
        uy, ux = by * k, bx * k
        idx_l, mv_a, sad_l, ci_l, cm_l, cs_l = host[d]
        me_midx = int(idx_l[by][bx])
        me_mv = (int(mv_a[by, bx, 0]), int(mv_a[by, bx, 1]))
        me_sad = sad_l[by][bx]
        cands = merge_candidates_qt_mm(midx_u, mv_u, avail, uy, ux, k)
        best = None
        for i, c in enumerate(cands):
            if c == (me_midx, me_mv):
                cs = me_sad
            else:
                cs = None
                for f in range(len(ci_l)):
                    mk = cm_l[f][by][bx]
                    if (ci_l[f][by][bx] == c[0] and mk[0] == c[1][0]
                            and mk[1] == c[1][1]):
                        cs = cs_l[f][by][bx]
                        break
                if cs is None:
                    continue
            cost = cs + lam_sqrt * (i + 2)
            if best is None or cost < best[0]:
                best = (cost, i, c)
        pred = mvp_unit_grid_mm(mv_u, midx_u, avail, uy, ux, k, me_midx)
        mvd = (me_mv[0] - int(pred[0]), me_mv[1] - int(pred[1]))
        model_bins = min(me_midx + 1, n_active - 1)
        amvp_cost = me_sad + lam_sqrt * (
            2 + model_bins + _mvd_bits(np.asarray(mvd, np.int64)))
        if best is not None and best[0] <= amvp_cost:
            _, mi, (cmidx, cmv_v) = best
            decisions.append((True, mi, cmidx, cmv_v, None))
            midx_f, mv_f = cmidx, cmv_v
        else:
            decisions.append((False, 0, me_midx, me_mv, mvd))
            midx_f, mv_f = me_midx, me_mv
        midx_u[uy:uy + k, ux:ux + k] = midx_f
        mv_u[uy:uy + k, ux:ux + k] = mv_f
        avail[uy:uy + k, ux:ux + k] = True

    def do_node(d, by, bx):
        if d < depth and bool(splits[d][by, bx]):
            for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                do_node(d + 1, 2 * by + dy, 2 * bx + dx)
            return
        do_leaf(d, by, bx)

    for by in range(nty):
        for bx in range(ntx):
            do_node(0, by, bx)
    return midx_u, mv_u, decisions


def encode_p_slice_qt_mm(splits, decisions, levels, top: int, depth: int,
                         n_active: int) -> bytes:
    """Quadtree P-slice with merge-aware per-leaf MOTION MODEL syntax
    (MM x partitioning; reference: the per-model mode loop inside the
    QTMT recursion, EncCu.cpp:775-798, CABACWriter motion_model +
    merge_flag/merge_idx/cu_skip).  Leaf syntax mirrors the flat MM
    path: skip(=merge+no-residual) / merge / motion_model+mvd, then
    cbf+coeffs — so a fully-split tree costs the flat grid plus one
    split bin per node.  `decisions` comes from select_qt_mm (z-order)."""
    enc = NativeBinEncoder()
    nty, ntx = (splits[0].shape if depth
                else levels[0][0].shape[:2])
    it = iter(decisions)

    def code_leaf(d, by, bx):
        mflag, mi, midx, mv, mvd = next(it)
        levs = tuple(levels[d][c][by, bx] for c in range(3))
        cbfs = tuple(bool(np.any(l != 0)) for l in levs)
        no_resid = not any(cbfs)
        skip = mflag and no_resid
        enc.encode_bin(int(skip), ctx_id("SkipFlag"))
        if skip:
            encode_merge_idx(enc, mi)
            return
        enc.encode_bin(int(mflag), ctx_id("MergeFlag"))
        if mflag:
            encode_merge_idx(enc, mi)
        else:
            encode_motion_model(enc, midx, n_active)
            if trace_mod.TRACE is not None:
                trace_mod.TRACE.log("motion_model", by=by, bx=bx,
                                    model=midx)
            encode_mvd_comp(enc, int(mvd[0]))
            encode_mvd_comp(enc, int(mvd[1]))
        for cbf, lev, cid in zip(cbfs, levs, (0, 4, 5)):
            enc.encode_bin(int(cbf), ctx_id("QtCbf", cid))
            if cbf:
                enc.encode_coeffs(lev, chroma=(cid != 0))

    def code_node(d, by, bx):
        if d < depth:
            sp = bool(splits[d][by, bx])
            enc.encode_bin(int(sp), ctx_id("SplitFlag", min(d, 8)))
            if sp:
                for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    code_node(d + 1, 2 * by + dy, 2 * bx + dx)
                return
        code_leaf(d, by, bx)

    for by in range(nty):
        for bx in range(ntx):
            code_node(0, by, bx)
    return enc.finish()


def select_merge_b_mm(midx0_me, midx1_me, stack0, stack1, dirs_me,
                      sad_sel, ci0, ci1, cm0, cm1, cdirs, csads,
                      active_models: list[int], lam_sqrt: float,
                      block_size: int, conv=None, ep0=None, ep1=None,
                      mer_blocks_log2: int = 0):
    """Encoder MM B merge decision in coding order.  Returns
    (f_midx0, f_midx1, f_stack0, f_stack1, f_dirs, merge_flag,
    merge_idx) — stacks carry final MVs in the selected model layers and
    the grids evolve with the entropy convention (unused lists take the
    inherited model + its MVP)."""
    nby, nbx = dirs_me.shape
    f_midx0 = midx0_me.astype(np.int32).copy()
    f_midx1 = midx1_me.astype(np.int32).copy()
    f_stack0 = stack0.astype(np.int64).copy()
    f_stack1 = stack1.astype(np.int64).copy()
    f_dirs = dirs_me.astype(np.int32).copy()
    sel0 = np.take_along_axis(
        f_stack0, f_midx0[None, :, :, None].astype(np.int64), 0
    )[0].astype(np.int64)
    sel1 = np.take_along_axis(
        f_stack1, f_midx1[None, :, :, None].astype(np.int64), 0
    )[0].astype(np.int64)
    models0 = np.asarray([active_models[i] for i in f_midx0.reshape(-1)],
                         np.int32).reshape(nby, nbx)
    models1 = np.asarray([active_models[i] for i in f_midx1.reshape(-1)],
                         np.int32).reshape(nby, nbx)
    merge_flag = np.zeros((nby, nbx), dtype=bool)
    merge_idx = np.zeros((nby, nbx), dtype=np.int32)
    n_fields = ci0.shape[0]
    n_active = len(active_models)
    sad_l = np.asarray(sad_sel).tolist()
    ci0_l = np.asarray(ci0).tolist()
    ci1_l = np.asarray(ci1).tolist()
    cm0_l = np.asarray(cm0).tolist()
    cm1_l = np.asarray(cm1).tolist()
    cd_l = np.asarray(cdirs).tolist()
    cs_l = np.asarray(csads).tolist()
    for by in range(nby):
        for bx in range(nbx):
            d = int(dirs_me[by, bx])
            cands = merge_candidates_b_mm(
                f_dirs, f_midx0, sel0, f_midx1, sel1, by, bx,
                mer_blocks_log2=mer_blocks_log2)
            me = (d, (int(midx0_me[by, bx]),
                      (int(sel0[by, bx, 0]), int(sel0[by, bx, 1]))),
                  (int(midx1_me[by, bx]),
                   (int(sel1[by, bx, 0]), int(sel1[by, bx, 1]))))
            best = None
            for i, c in enumerate(cands):
                if c == me:
                    sad = sad_l[by][bx]
                else:
                    sad = None
                    for k in range(n_fields):
                        m0k = cm0_l[k][by][bx]
                        m1k = cm1_l[k][by][bx]
                        if (cd_l[k][by][bx] == c[0]
                                and ci0_l[k][by][bx] == c[1][0]
                                and m0k[0] == c[1][1][0]
                                and m0k[1] == c[1][1][1]
                                and ci1_l[k][by][bx] == c[2][0]
                                and m1k[0] == c[2][1][0]
                                and m1k[1] == c[2][1][1]):
                            sad = cs_l[k][by][bx]
                            break
                    if sad is None:
                        continue
                cost = sad + lam_sqrt * (i + 2)
                if best is None or cost < best[0]:
                    best = (cost, i, c)
            # AMVP cost mirror of encode_b_slice_mm's syntax
            mvd_bits = 0
            if d != 1:
                p0 = _mm_mvp(sel0, models0, by, bx,
                             int(models0[by, bx]), block_size, conv, ep0)
                mvd_bits += (_mvd_bits(sel0[by, bx] - p0)
                             + min(int(midx0_me[by, bx]) + 1,
                                   n_active - 1))
            if d != 0:
                p1 = _mm_mvp(sel1, models1, by, bx,
                             int(models1[by, bx]), block_size, conv, ep1)
                mvd_bits += (_mvd_bits(sel1[by, bx] - p1)
                             + min(int(midx1_me[by, bx]) + 1,
                                   n_active - 1))
            amvp_cost = sad_l[by][bx] + lam_sqrt * (3 + mvd_bits)
            if best is not None and best[0] <= amvp_cost:
                merge_flag[by, bx] = True
                merge_idx[by, bx] = best[1]
                cd_, (c_i0, c_m0), (c_i1, c_m1) = best[2]
                f_dirs[by, bx] = cd_
                f_midx0[by, bx] = c_i0
                f_midx1[by, bx] = c_i1
                f_stack0[c_i0, by, bx] = c_m0
                f_stack1[c_i1, by, bx] = c_m1
                sel0[by, bx] = c_m0
                sel1[by, bx] = c_m1
                models0[by, bx] = active_models[c_i0]
                models1[by, bx] = active_models[c_i1]
                d = cd_
            # entropy convention: unused lists take the inherited model
            # and its MVP (mirrors encode_b_slice_mm grid evolution)
            if d == 1:
                inh0 = inherited_model(models0, by, bx)
                models0[by, bx] = inh0
                f_midx0[by, bx] = active_models.index(inh0)
                sel0[by, bx] = _mm_mvp(sel0, models0, by, bx, inh0,
                                       block_size, conv, ep0)
                f_stack0[f_midx0[by, bx], by, bx] = sel0[by, bx]
            if d == 0:
                inh1 = inherited_model(models1, by, bx)
                models1[by, bx] = inh1
                f_midx1[by, bx] = active_models.index(inh1)
                sel1[by, bx] = _mm_mvp(sel1, models1, by, bx, inh1,
                                       block_size, conv, ep1)
                f_stack1[f_midx1[by, bx], by, bx] = sel1[by, bx]
    return (f_midx0, f_midx1, f_stack0, f_stack1, f_dirs, merge_flag,
            merge_idx)


def encode_b_slice_mm(model_idx0: np.ndarray, model_idx1: np.ndarray,
                      active_models: list[int], mvs0_stack: np.ndarray,
                      mvs1_stack: np.ndarray, dirs: np.ndarray,
                      lev_y: np.ndarray, lev_u: np.ndarray,
                      lev_v: np.ndarray, block_size: int = 16,
                      conv=None, epipole0=None, epipole1=None,
                      merge_flag: np.ndarray | None = None,
                      merge_idx: np.ndarray | None = None) -> bytes:
    """MM B-slice: skip / inter_dir / per-used-list motion_model + mvd /
    residual (reference: CABACWriter motion_model():1854 per list after
    inter_pred_idc).  With merge_flag/merge_idx (select_merge_b_mm),
    skip means merge+no-residual and candidates carry whole motion incl.
    per-list models; the input grids are the FINAL (already-evolved)
    fields, so the entropy pass reads them without mutation.  Without
    them, skip means the neighbour's direction and each used list's
    inherited model at its MVP, and the unused list's grid entries take
    (inherited model, its MVP) as the decoder's do."""
    enc = NativeBinEncoder()
    nby, nbx = dirs.shape
    n_active = len(active_models)
    sel0 = np.take_along_axis(
        mvs0_stack, model_idx0[None, :, :, None].astype(np.int64), 0
    )[0].astype(np.int64)
    sel1 = np.take_along_axis(
        mvs1_stack, model_idx1[None, :, :, None].astype(np.int64), 0
    )[0].astype(np.int64)
    models0 = np.asarray([active_models[i]
                          for i in model_idx0.reshape(-1)], np.int32
                         ).reshape(nby, nbx)
    models1 = np.asarray([active_models[i]
                          for i in model_idx1.reshape(-1)], np.int32
                         ).reshape(nby, nbx)
    cbf_y = (lev_y != 0).any(axis=(2, 3))
    cbf_u = (lev_u != 0).any(axis=(2, 3))
    cbf_v = (lev_v != 0).any(axis=(2, 3))
    if merge_flag is None:
        for by in range(nby):
            for bx in range(nbx):
                d = int(dirs[by, bx])
                cbfs = (bool(cbf_y[by, bx]), bool(cbf_u[by, bx]),
                        bool(cbf_v[by, bx]))
                no_resid = not any(cbfs)
                d_pred = (int(dirs[by, bx - 1]) if bx > 0
                          else int(dirs[by - 1, bx]) if by > 0 else 0)
                inh0 = inherited_model(models0, by, bx)
                inh1 = inherited_model(models1, by, bx)
                p0 = _mm_mvp(sel0, models0, by, bx, int(models0[by, bx]),
                             block_size, conv, epipole0)
                p1 = _mm_mvp(sel1, models1, by, bx, int(models1[by, bx]),
                             block_size, conv, epipole1)
                mvd0 = sel0[by, bx] - p0
                mvd1 = sel1[by, bx] - p1
                used_zero = (((d == 1) or (mvd0 == 0).all())
                             and ((d == 0) or (mvd1 == 0).all()))
                skip = (no_resid and d == d_pred and used_zero
                        and (d == 1 or int(models0[by, bx]) == inh0)
                        and (d == 0 or int(models1[by, bx]) == inh1))
                enc.encode_bin(int(skip), ctx_id("SkipFlag"))
                if not skip:
                    enc.encode_bin(int(d == 2), ctx_id("InterDir", 0))
                    if d != 2:
                        enc.encode_bin(d, ctx_id("InterDir", 1))
                    if d != 1:
                        encode_motion_model(enc, int(model_idx0[by, bx]),
                                            n_active)
                        encode_mvd_comp(enc, int(mvd0[0]))
                        encode_mvd_comp(enc, int(mvd0[1]))
                    if d != 0:
                        encode_motion_model(enc, int(model_idx1[by, bx]),
                                            n_active)
                        encode_mvd_comp(enc, int(mvd1[0]))
                        encode_mvd_comp(enc, int(mvd1[1]))
                    _code_residual(enc, cbfs, (lev_y[by, bx], lev_u[by, bx],
                                               lev_v[by, bx]))
                # unused-list grid entries take (inherited model, its MVP) so
                # the MVP/inheritance state evolves identically on the decoder
                if d == 1:
                    models0[by, bx] = inh0
                    sel0[by, bx] = _mm_mvp(sel0, models0, by, bx, inh0,
                                           block_size, conv, epipole0)
                if d == 0:
                    models1[by, bx] = inh1
                    sel1[by, bx] = _mm_mvp(sel1, models1, by, bx, inh1,
                                           block_size, conv, epipole1)
        return enc.finish()
    for by in range(nby):
        for bx in range(nbx):
            d = int(dirs[by, bx])
            no_resid = not (cbf_y[by, bx] or cbf_u[by, bx]
                            or cbf_v[by, bx])
            mrg = bool(merge_flag[by, bx])
            skip = mrg and no_resid
            enc.encode_bin(int(skip), ctx_id("SkipFlag"))
            if skip:
                encode_merge_idx(enc, int(merge_idx[by, bx]))
                continue
            enc.encode_bin(int(mrg), ctx_id("MergeFlag"))
            if mrg:
                encode_merge_idx(enc, int(merge_idx[by, bx]))
            else:
                enc.encode_bin(int(d == 2), ctx_id("InterDir", 0))
                if d != 2:
                    enc.encode_bin(d, ctx_id("InterDir", 1))
                if d != 1:
                    encode_motion_model(enc, int(model_idx0[by, bx]),
                                        n_active)
                    p0 = _mm_mvp(sel0, models0, by, bx,
                                 int(models0[by, bx]), block_size,
                                 conv, epipole0)
                    encode_mvd_comp(enc, int(sel0[by, bx, 0] - p0[0]))
                    encode_mvd_comp(enc, int(sel0[by, bx, 1] - p0[1]))
                if d != 0:
                    encode_motion_model(enc, int(model_idx1[by, bx]),
                                        n_active)
                    p1 = _mm_mvp(sel1, models1, by, bx,
                                 int(models1[by, bx]), block_size,
                                 conv, epipole1)
                    encode_mvd_comp(enc, int(sel1[by, bx, 0] - p1[0]))
                    encode_mvd_comp(enc, int(sel1[by, bx, 1] - p1[1]))
            _code_residual(enc, (bool(cbf_y[by, bx]), bool(cbf_u[by, bx]),
                                 bool(cbf_v[by, bx])),
                           (lev_y[by, bx], lev_u[by, bx], lev_v[by, bx]))
    return enc.finish()


def _cbf_grids(lev_y, lev_u, lev_v):
    return tuple((lev != 0).any(axis=(2, 3)) for lev in (lev_y, lev_u,
                                                           lev_v))


def _amvp_pred(mvs, by: int, bx: int, col_mvs, hist, use_tmvp: bool):
    """The AMVP predictor of block (by, bx) and its mvd: with TMVP, the
    list candidate of the cheapest mvd (its index coded); else the
    median.  Returns (idx, pred, mvd); the caller codes the index."""
    mv = mvs[by, bx]
    if not use_tmvp:
        pred = mvp_median(mvs, by, bx)
        return 0, pred, mv - pred
    col = col_mvs[by, bx] if col_mvs is not None else None
    cands = amvp_list(mvs, by, bx, col, hist)
    mvds = [mv - c for c in cands]
    idx = int(np.argmin([_mvd_bits(d) for d in mvds]))
    return idx, cands[idx], mvds[idx]


def _code_amvp_mvd(enc, mv, pred, mvd, imv, by: int, bx: int) -> None:
    """The imv bins (AMVR precision) and the mvd, on the block's grid
    against the grid-rounded predictor (reference: CABACWriter amvr_mode /
    imv syntax)."""
    if imv is not None:
        m = int(imv[by, bx])
        sh = AMVR_SHIFTS[m]
        enc.encode_bin(int(m > 0), ctx_id("Amvr", 0))
        if m > 0:
            enc.encode_bin(int(m > 1), ctx_id("Amvr", 1))
        mvd = (mv - round_mv_amvr(pred, sh)) >> sh
    encode_mvd_comp(enc, int(mvd[0]))
    encode_mvd_comp(enc, int(mvd[1]))


def encode_p_slice(mvs: np.ndarray, lev_y: np.ndarray, lev_u: np.ndarray,
                   lev_v: np.ndarray, col_mvs: np.ndarray | None = None,
                   use_tmvp: bool = False,
                   imv: np.ndarray | None = None,
                   merge_flag: np.ndarray | None = None,
                   merge_idx: np.ndarray | None = None,
                   rows: tuple | None = None) -> bytes:
    """Classic P slice: mvs (nby, nbx, 2) 1/16-pel; lev_* (nby, nbx, s, s);
    raster order.  `rows` (r0, r1) codes only those block rows: one WPP
    substream, with fresh contexts and a fresh HMVP FIFO.  With merge_flag/merge_idx (from select_merge_p), skip
    means merge+no-residual and is followed by merge_idx; non-skip blocks
    signal merge_flag, then either merge_idx (+residual) or the AMVP syntax
    (reference: CABACWriter merge_flag/merge_idx/cu_skip).  Without them,
    skip means a zero mvd against candidate 0 and no residual.

    With use_tmvp the predictor comes from a 2-candidate AMVP list
    (spatial / TMVP col_mvs / HMVP / zero) with a context-coded mvp index,
    and the HMVP FIFO takes every block's MV (reference: fillMvpCand +
    HMVP LUT).  With imv ((nby, nbx) in {0, 1, 2}) each AMVP block
    signals its AMVR precision and codes the mvd on that grid."""
    enc = NativeBinEncoder()
    nby, nbx = mvs.shape[:2]
    mvs = mvs.astype(np.int64)
    use_merge = merge_flag is not None
    hist = HmvpList() if use_tmvp else None
    cbf_yg, cbf_ug, cbf_vg = _cbf_grids(lev_y, lev_u, lev_v)
    r0, r1 = rows if rows is not None else (0, nby)
    for by in range(r0, r1):
        for bx in range(nbx):
            mv = mvs[by, bx]
            cbfs = (bool(cbf_yg[by, bx]), bool(cbf_ug[by, bx]),
                    bool(cbf_vg[by, bx]))
            levs = (lev_y[by, bx], lev_u[by, bx], lev_v[by, bx])
            no_resid = not any(cbfs)
            mrg = use_merge and bool(merge_flag[by, bx])
            if use_merge:
                skip = mrg and no_resid
                enc.encode_bin(int(skip), ctx_id("SkipFlag"))
                if skip:
                    encode_merge_idx(enc, int(merge_idx[by, bx]))
                else:
                    enc.encode_bin(int(mrg), ctx_id("MergeFlag"))
                    if mrg:
                        encode_merge_idx(enc, int(merge_idx[by, bx]))
                        _code_residual(enc, cbfs, levs)
            if not mrg:
                idx, pred, mvd = _amvp_pred(mvs, by, bx, col_mvs,
                                            hist, use_tmvp)
                # skip without merge: zero mvd against candidate 0, no
                # residual
                skip = (not use_merge and no_resid and mvd[0] == 0
                        and mvd[1] == 0 and idx == 0)
                if not use_merge:
                    enc.encode_bin(int(skip), ctx_id("SkipFlag"))
                if not skip:
                    if use_tmvp:
                        enc.encode_bin(idx, ctx_id("MvpIdx"))
                    _code_amvp_mvd(enc, mv, pred, mvd, imv, by, bx)
                    _code_residual(enc, cbfs, levs)
            if hist is not None:
                hist.push(mv)
    return enc.finish()


def encode_p_slice_2ref(ref_idx: np.ndarray, mvs: np.ndarray,
                        lev_y: np.ndarray, lev_u: np.ndarray,
                        lev_v: np.ndarray,
                        col_mvs: np.ndarray | None = None,
                        use_tmvp: bool = False,
                        imv: np.ndarray | None = None,
                        merge_flag: np.ndarray | None = None,
                        merge_idx: np.ndarray | None = None) -> bytes:
    """Two-reference P slice: the merge syntax of encode_p_slice plus a
    context-coded ref_idx bin on AMVP-coded blocks (reference:
    CABACWriter::ref_idx, Ctx::RefPic); TMVP/HMVP and AMVR as in
    encode_p_slice."""
    enc = NativeBinEncoder()
    nby, nbx = mvs.shape[:2]
    mvs = mvs.astype(np.int64)
    hist = HmvpList() if use_tmvp else None
    cbf_yg, cbf_ug, cbf_vg = _cbf_grids(lev_y, lev_u, lev_v)
    for by in range(nby):
        for bx in range(nbx):
            mv = mvs[by, bx]
            cbfs = (bool(cbf_yg[by, bx]), bool(cbf_ug[by, bx]),
                    bool(cbf_vg[by, bx]))
            mrg = bool(merge_flag[by, bx])
            skip = mrg and not any(cbfs)
            enc.encode_bin(int(skip), ctx_id("SkipFlag"))
            if skip:
                encode_merge_idx(enc, int(merge_idx[by, bx]))
            else:
                enc.encode_bin(int(mrg), ctx_id("MergeFlag"))
                if mrg:
                    encode_merge_idx(enc, int(merge_idx[by, bx]))
                else:
                    enc.encode_bin(int(ref_idx[by, bx]), ctx_id("RefPic", 0))
                    idx, pred, mvd = _amvp_pred(mvs, by, bx, col_mvs,
                                                hist, use_tmvp)
                    if use_tmvp:
                        enc.encode_bin(idx, ctx_id("MvpIdx"))
                    _code_amvp_mvd(enc, mv, pred, mvd, imv, by, bx)
                _code_residual(enc, cbfs, (lev_y[by, bx], lev_u[by, bx],
                                           lev_v[by, bx]))
            if hist is not None:
                hist.push(mv)
    return enc.finish()


def encode_p_slice_affine(mvs: np.ndarray, aff: np.ndarray,
                          dmv: np.ndarray, lev_y: np.ndarray,
                          lev_u: np.ndarray, lev_v: np.ndarray) -> bytes:
    """P slice with per-block affine flags (reference: CABACWriter
    affine_flag after the skip/merge syntax, CABACWriter.cpp:1774 region).
    mvs holds the TL CPMV for affine blocks; dmv the extra (TR-TL) pair,
    coded as a second mvd."""
    enc = NativeBinEncoder()
    nby, nbx = mvs.shape[:2]
    mvs = mvs.astype(np.int64)
    cbf_yg, cbf_ug, cbf_vg = _cbf_grids(lev_y, lev_u, lev_v)
    for by in range(nby):
        for bx in range(nbx):
            mvd = mvs[by, bx] - mvp_median(mvs, by, bx)
            cbfs = (bool(cbf_yg[by, bx]), bool(cbf_ug[by, bx]),
                    bool(cbf_vg[by, bx]))
            a = bool(aff[by, bx])
            skip = (not any(cbfs) and mvd[0] == 0 and mvd[1] == 0
                    and not a)
            enc.encode_bin(int(skip), ctx_id("SkipFlag"))
            if skip:
                continue
            enc.encode_bin(int(a), ctx_id("AffineFlag", 0))
            encode_mvd_comp(enc, int(mvd[0]))
            encode_mvd_comp(enc, int(mvd[1]))
            if a:
                encode_mvd_comp(enc, int(dmv[by, bx, 0]))
                encode_mvd_comp(enc, int(dmv[by, bx, 1]))
            _code_residual(enc, cbfs, (lev_y[by, bx], lev_u[by, bx],
                                       lev_v[by, bx]))
    return enc.finish()


def encode_b_slice(mv0: np.ndarray, mv1: np.ndarray, dirs: np.ndarray,
                   lev_y: np.ndarray, lev_u: np.ndarray, lev_v: np.ndarray,
                   gpm_modes: np.ndarray | None = None,
                   use_gpm: bool = False, use_ciip: bool = False,
                   merge_flag: np.ndarray | None = None,
                   merge_idx: np.ndarray | None = None,
                   rows: tuple | None = None
                   ) -> tuple[bytes, np.ndarray, np.ndarray]:
    """Classic B slice: skip / inter_dir / per-list mvd / residual
    (reference: CABACWriter inter_pred_idc + mvd_coding per list, SMVD;
    GEO merge_gpm_partition_idx and ciip_flag, CABACWriter.cpp
    merge_data).  dirs 3 (GPM) and 4 (CIIP) are signalled as a both-list
    mode with a sub-type bin gated by the SPS tool flags; GPM adds a 4-bit
    EP mask index.  Unused-list entries in the coded MV grids are replaced
    by their MVP so the dense grid evolves identically on the decoder;
    returns (payload, coded0, coded1).  `rows` (r0, r1) codes only those
    block rows (one WPP substream): as in the JAX package, the rows above
    r0 then keep the given MVs, without their MVP replacements."""
    enc = NativeBinEncoder()
    nby, nbx = dirs.shape
    use_merge = merge_flag is not None
    coded0 = mv0.astype(np.int64).copy()
    coded1 = mv1.astype(np.int64).copy()
    cbf_y, cbf_u, cbf_v = _cbf_grids(lev_y, lev_u, lev_v)
    r0, r1 = rows if rows is not None else (0, nby)
    for by in range(r0, r1):
        for bx in range(nbx):
            d = int(dirs[by, bx])
            pred0 = mvp_median(coded0, by, bx)
            pred1 = mvp_median(coded1, by, bx)
            cbfs = (bool(cbf_y[by, bx]), bool(cbf_u[by, bx]),
                    bool(cbf_v[by, bx]))
            levs = (lev_y[by, bx], lev_u[by, bx], lev_v[by, bx])
            no_resid = not any(cbfs)
            if use_merge:
                mrg = bool(merge_flag[by, bx])
                skip = mrg and no_resid
                enc.encode_bin(int(skip), ctx_id("SkipFlag"))
                if skip:
                    encode_merge_idx(enc, int(merge_idx[by, bx]))
                    continue
                enc.encode_bin(int(mrg), ctx_id("MergeFlag"))
                if mrg:
                    encode_merge_idx(enc, int(merge_idx[by, bx]))
                    _code_residual(enc, cbfs, levs)
                    continue
            if d == 0:
                coded1[by, bx] = pred1
            elif d == 1:
                coded0[by, bx] = pred0
            mvd0x = int(coded0[by, bx, 0]) - int(pred0[0])
            mvd0y = int(coded0[by, bx, 1]) - int(pred0[1])
            mvd1x = int(coded1[by, bx, 0]) - int(pred1[0])
            mvd1y = int(coded1[by, bx, 1]) - int(pred1[1])
            # skip inherits the neighbour direction clamped to BI (GPM/CIIP
            # blocks never skip: the mask/intra state is not inherited)
            d_pred = (int(dirs[by, bx - 1]) if bx > 0
                      else int(dirs[by - 1, bx]) if by > 0 else 0)
            d_pred = min(d_pred, 2)
            used_zero = ((d == 1 or (mvd0x == 0 and mvd0y == 0))
                         and (d == 0 or (mvd1x == 0 and mvd1y == 0)))
            # with merge on, skip means merge and was coded above
            skip = (not use_merge and no_resid and d == d_pred
                    and used_zero)
            if not use_merge:
                enc.encode_bin(int(skip), ctx_id("SkipFlag"))
            if skip:
                continue
            enc.encode_bin(int(d >= 2), ctx_id("InterDir", 0))
            if d < 2:
                enc.encode_bin(d, ctx_id("InterDir", 1))
            else:
                if use_gpm and use_ciip:
                    enc.encode_bin(int(d != 2), ctx_id("GeoFlag"))
                    if d != 2:
                        enc.encode_bin(int(d == 4), ctx_id("CiipFlag"))
                elif use_gpm:
                    enc.encode_bin(int(d == 3), ctx_id("GeoFlag"))
                elif use_ciip:
                    enc.encode_bin(int(d == 4), ctx_id("CiipFlag"))
                if d == 3:
                    # GPM mask index, fixed-length EP (reference:
                    # merge_gpm_partition_idx)
                    g = int(gpm_modes[by, bx])
                    for bit in range(3, -1, -1):
                        enc.encode_bin_ep((g >> bit) & 1)
            # SMVD: mirrored bi-prediction sends one mvd (reference:
            # sym_mvd_flag, CABACWriter smvd_mode; mvd1 = -mvd0)
            smvd = (d == 2 and mvd1x == -mvd0x and mvd1y == -mvd0y)
            if d == 2:
                enc.encode_bin(int(smvd), ctx_id("SmvdFlag"))
            if d != 1:
                encode_mvd_comp(enc, mvd0x)
                encode_mvd_comp(enc, mvd0y)
            if d != 0 and not smvd:
                encode_mvd_comp(enc, mvd1x)
                encode_mvd_comp(enc, mvd1y)
            _code_residual(enc, cbfs, levs)
    return enc.finish(), coded0, coded1


def encode_p_slice_wpp(mvs, lev_y, lev_u, lev_v, col_mvs=None,
                       use_tmvp: bool = False, imv=None, merge_flag=None,
                       merge_idx=None, num_substreams: int = 4) -> bytes:
    """Inter WPP: the P slice's block rows split into independently
    decodable substreams with fresh contexts and a fresh HMVP FIFO each
    (reference: EncSlice.cpp:2024-2113 substream termination; the WPP HMVP
    reset).  The candidate and MVP grids still read across substreams
    (values, not bins), as in the intra WPP path."""
    def one(r0: int, r1: int) -> bytes:
        return encode_p_slice(mvs, lev_y, lev_u, lev_v, col_mvs=col_mvs,
                              use_tmvp=use_tmvp, imv=imv,
                              merge_flag=merge_flag, merge_idx=merge_idx,
                              rows=(r0, r1))

    return encode_substreams(one, wpp_bounds(mvs.shape[0], num_substreams))


def encode_b_slice_wpp(mv0, mv1, dirs, lev_y, lev_u, lev_v, gpm_modes=None,
                       use_gpm: bool = False, use_ciip: bool = False,
                       merge_flag=None, merge_idx=None,
                       num_substreams: int = 4) -> bytes:
    """Inter WPP for B slices (encode_b_slice per row group)."""
    def one(r0: int, r1: int) -> bytes:
        return encode_b_slice(mv0, mv1, dirs, lev_y, lev_u, lev_v,
                              gpm_modes=gpm_modes, use_gpm=use_gpm,
                              use_ciip=use_ciip, merge_flag=merge_flag,
                              merge_idx=merge_idx, rows=(r0, r1))[0]

    return encode_substreams(one, wpp_bounds(dirs.shape[0], num_substreams))


def wpp_substream_starts(nby: int, num_substreams: int) -> tuple[int, ...]:
    """The block rows at which WPP substreams 2.. start (the HMVP resets
    select_merge_p must mirror)."""
    return tuple(wpp_bounds(nby, num_substreams)[1:-1])


# ------------------------------------------------ classic quadtree / MTT

def mvp_unit_grid(coded: np.ndarray, avail: np.ndarray, uy: int, ux: int,
                  k: int) -> np.ndarray:
    """Median MVP for a leaf k units wide over the causally-coded unit grid
    (shared enc/dec; reference analog: PU::fillMvpCand spatial candidates,
    UnitTools.cpp:2172)."""
    nuy, nux = avail.shape
    cand = []
    for (y, x) in ((uy, ux - 1), (uy - 1, ux), (uy - 1, ux + k),
                   (uy - 1, ux - 1)):
        if 0 <= y < nuy and 0 <= x < nux and avail[y, x]:
            cand.append(coded[y, x])
        if len(cand) == 3:
            break
    if not cand:
        return np.zeros(2, dtype=np.int64)
    if len(cand) == 1:
        return cand[0]
    c = np.stack(cand[:3])
    if len(c) == 2:
        return (c[0] + c[1] + 1) >> 1
    return np.median(c, axis=0).astype(np.int64)


def _unit_neighbours(avail: np.ndarray, uy: int, ux: int, k: int):
    """The available spatial positions A1, B1, B0, B2 of a leaf k units
    wide at (uy, ux), in that order."""
    nuy, nux = avail.shape
    return [(y, x) for (y, x) in ((uy, ux - 1), (uy - 1, ux),
                                  (uy - 1, ux + k), (uy - 1, ux - 1))
            if 0 <= y < nuy and 0 <= x < nux and avail[y, x]]


def merge_candidates_unit(coded: np.ndarray, avail: np.ndarray, uy: int,
                          ux: int, k: int, n: int = MERGE_MAX
                          ) -> list[tuple[int, int]]:
    """Merge candidate list over the causal unit grid (QT/MTT leaves;
    reference: getInterMergeCandidates at the CU the partitioner visits).
    Spatial A1/B1/B0/B2 positions relative to a k-unit-wide leaf, then
    pairwise + zero."""
    out = []
    for y, x in _unit_neighbours(avail, uy, ux, k):
        c = (int(coded[y, x, 0]), int(coded[y, x, 1]))
        if c not in out:
            out.append(c)
        if len(out) == n:
            break
    if 2 <= len(out) < n:
        pw = ((out[0][0] + out[1][0] + 1) >> 1,
              (out[0][1] + out[1][1] + 1) >> 1)
        if pw not in out:
            out.append(pw)
    while len(out) < n:
        out.append((0, 0))
    return out


def merge_candidates_unit_b(coded0: np.ndarray, coded1: np.ndarray,
                            dirs_u: np.ndarray, avail: np.ndarray,
                            uy: int, ux: int, k: int, n: int = MERGE_MAX):
    """Whole-motion (dir, mv0, mv1) merge candidates over the causal unit
    grid (QT/MTT B leaves)."""
    out = []
    for y, x in _unit_neighbours(avail, uy, ux, k):
        c = (int(dirs_u[y, x]),
             (int(coded0[y, x, 0]), int(coded0[y, x, 1])),
             (int(coded1[y, x, 0]), int(coded1[y, x, 1])))
        if c not in out:
            out.append(c)
        if len(out) == n:
            break
    while len(out) < n:
        out.append((2, (0, 0), (0, 0)))
    return out


def mtt_child_entries(kind_code: int, by: int, bx: int):
    """Rect-grid child entries of a split node, in coding order.
    Returns [(kind, gy, gx)] into the canonical rect grids
    (common/mtt.py rect_shapes layout)."""
    if kind_code == mtt_mod.BTH:
        return [("bth", 2 * by, bx), ("bth", 2 * by + 1, bx)]
    if kind_code == mtt_mod.BTV:
        return [("btv", by, 2 * bx), ("btv", by, 2 * bx + 1)]
    if kind_code == mtt_mod.TTH:
        return [("tth_o", 4 * by, bx), ("tth_m", 2 * by, bx),
                ("tth_o", 4 * by + 3, bx)]
    if kind_code == mtt_mod.TTV:
        return [("ttv_o", by, 4 * bx), ("ttv_m", by, 2 * bx),
                ("ttv_o", by, 4 * bx + 3)]
    raise ValueError(kind_code)


def walk_tree(nty: int, ntx: int, top: int, depth: int, split_code,
              leaf) -> None:
    """Visit a picture's coding tree in coding order: raster over the top
    blocks, z-order inside.  split_code(d, by, bx, s) gives (the writer
    codes, the parser reads) the split of an internal node; leaf(key, gy,
    gx, uy, ux, ky, kx) is called for every leaf, key d for the square
    grids and (kind, d) for the rectangular ones, (uy, ux) its top-left
    unit and (ky, kx) its span in units."""
    u = top >> depth
    shapes = {(i[0], i[1]): i for i in mtt_mod.rect_shapes(top, depth)}

    def node(d, by, bx):
        s = top >> d
        code = split_code(d, by, bx, s) if d < depth else mtt_mod.LEAF
        if code == mtt_mod.QUAD:
            for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                node(d + 1, 2 * by + dy, 2 * bx + dx)
        elif code != mtt_mod.LEAF:
            for kind, gy, gx in mtt_child_entries(code, by, bx):
                _, _, sy, sx, y_off, x_off = shapes[(kind, d)]
                leaf((kind, d), gy, gx, (gy * sy + y_off) // u,
                     (gx * sx + x_off) // u, sy // u, sx // u)
        else:
            k = s // u
            leaf(d, by, bx, by * k, bx * k, k, k)

    for by in range(nty):
        for bx in range(ntx):
            node(0, by, bx)


def _code_split_syntax(enc, code: int, d: int, s: int, u: int,
                       mtt: bool) -> None:
    """Split bins of one internal node (reference: split_cu_flag,
    split_qt_flag, mtt_split_cu_binary_flag, mtt_split_cu_vertical_flag,
    CABACWriter::split_cu_mode).  The quadtree codes split_cu_flag only."""
    enc.encode_bin(int(code != mtt_mod.LEAF), ctx_id("SplitFlag", min(d, 8)))
    if code == mtt_mod.LEAF or not mtt:
        return
    enc.encode_bin(int(code == mtt_mod.QUAD), ctx_id("QtSplitFlag",
                                                     min(d, 2)))
    if code == mtt_mod.QUAD:
        return
    if mtt_mod.bt_allowed(s, u) and mtt_mod.tt_allowed(s, u):
        enc.encode_bin(int(code in (mtt_mod.BTH, mtt_mod.BTV)),
                       ctx_id("BtFlag", min(d, 2)))
    enc.encode_bin(int(code in (mtt_mod.BTV, mtt_mod.TTV)),
                   ctx_id("MttVert", min(d, 2)))


def _code_leaf_levels(enc, levs) -> None:
    _code_residual(enc, tuple(bool(np.any(l != 0)) for l in levs), levs)


def _code_leaf_p(enc, mv, levs, coded, avail, uy, ux, ky, kx,
                 use_merge: bool) -> None:
    """One P leaf of any shape: skip / [merge] / mvd / cbf / coeffs over a
    (ky, kx) unit span; updates the coded unit grid and availability.
    With use_merge, a leaf whose MV equals a candidate is coded as its
    merge_idx (the tree search decided the MV; merge is the cheaper coding
    of it)."""
    pred = mvp_unit_grid(coded, avail, uy, ux, kx)
    mv = np.asarray(mv, dtype=np.int64)
    mvd = mv - pred
    no_resid = all(not np.any(l != 0) for l in levs)
    if use_merge:
        cands = merge_candidates_unit(coded, avail, uy, ux, kx)
        t = (int(mv[0]), int(mv[1]))
        mrg = t in cands
        skip = mrg and no_resid
        enc.encode_bin(int(skip), ctx_id("SkipFlag"))
        if not skip:
            enc.encode_bin(int(mrg), ctx_id("MergeFlag"))
        if mrg:
            encode_merge_idx(enc, cands.index(t))
        else:
            encode_mvd_comp(enc, int(mvd[0]))
            encode_mvd_comp(enc, int(mvd[1]))
    else:
        skip = no_resid and mvd[0] == 0 and mvd[1] == 0
        enc.encode_bin(int(skip), ctx_id("SkipFlag"))
        if not skip:
            encode_mvd_comp(enc, int(mvd[0]))
            encode_mvd_comp(enc, int(mvd[1]))
    if not skip:
        _code_leaf_levels(enc, levs)
    coded[uy:uy + ky, ux:ux + kx] = mv
    avail[uy:uy + ky, ux:ux + kx] = True


def _b_dir_pred(dirs_u, avail, uy: int, ux: int) -> int:
    """The inter direction a non-merge skip inherits: left, else above,
    else L0."""
    if ux > 0 and avail[uy, ux - 1]:
        return int(dirs_u[uy, ux - 1])
    if uy > 0 and avail[uy - 1, ux]:
        return int(dirs_u[uy - 1, ux])
    return 0


def _code_leaf_b(enc, mv0, mv1, dv, levs, grids, uy, ux, ky, kx,
                 use_merge: bool) -> None:
    """One B leaf of any shape: skip / [merge] / inter_dir / mvd per used
    list / residual.  The unused list's unit cells take its MVP so that
    both sides evolve the same grids (coded0, coded1, dirs_u, avail)."""
    coded0, coded1, dirs_u, avail = grids
    pred0 = mvp_unit_grid(coded0, avail, uy, ux, kx)
    pred1 = mvp_unit_grid(coded1, avail, uy, ux, kx)
    mv0 = pred0 if dv == 1 else np.asarray(mv0, dtype=np.int64)
    mv1 = pred1 if dv == 0 else np.asarray(mv1, dtype=np.int64)
    mvd0, mvd1 = mv0 - pred0, mv1 - pred1
    no_resid = all(not np.any(l != 0) for l in levs)
    if use_merge:
        cands = merge_candidates_unit_b(coded0, coded1, dirs_u, avail, uy,
                                        ux, kx)
        t = (dv, (int(mv0[0]), int(mv0[1])), (int(mv1[0]), int(mv1[1])))
        mrg = t in cands
        skip = mrg and no_resid
        enc.encode_bin(int(skip), ctx_id("SkipFlag"))
        if not skip:
            enc.encode_bin(int(mrg), ctx_id("MergeFlag"))
        if mrg:
            encode_merge_idx(enc, cands.index(t))
    else:
        d_pred = _b_dir_pred(dirs_u, avail, uy, ux)
        used_zero = (((dv != 1) <= bool((mvd0 == 0).all()))
                     and ((dv != 0) <= bool((mvd1 == 0).all())))
        skip = no_resid and dv == d_pred and used_zero
        enc.encode_bin(int(skip), ctx_id("SkipFlag"))
        mrg = skip
        if skip:
            dv, mv0, mv1 = d_pred, pred0, pred1
    if not mrg:
        enc.encode_bin(int(dv == 2), ctx_id("InterDir", 0))
        if dv != 2:
            enc.encode_bin(dv, ctx_id("InterDir", 1))
        if dv != 1:
            encode_mvd_comp(enc, int(mvd0[0]))
            encode_mvd_comp(enc, int(mvd0[1]))
        if dv != 0:
            encode_mvd_comp(enc, int(mvd1[0]))
            encode_mvd_comp(enc, int(mvd1[1]))
    if not skip:
        _code_leaf_levels(enc, levs)
    coded0[uy:uy + ky, ux:ux + kx] = mv0
    coded1[uy:uy + ky, ux:ux + kx] = mv1
    dirs_u[uy:uy + ky, ux:ux + kx] = dv
    avail[uy:uy + ky, ux:ux + kx] = True


def _encode_tree(codes, fields, levels, top: int, depth: int, mtt: bool,
                 use_merge: bool) -> bytes:
    """The tree's split syntax and every leaf's.  codes: per level the
    split code of each node (mtt.LEAF/QUAD/...); fields[key] = (mv,) for P
    or (mv0, mv1, dirs) for B and levels[key] = (lev_y, lev_u, lev_v), key
    d for the square grid of level d and (kind, d) for a rect grid."""
    enc = NativeBinEncoder()
    u = top >> depth
    nty, ntx = levels[0][0].shape[:2]
    nuy, nux = levels[depth][0].shape[:2]
    bi = len(fields[0]) == 3
    grids = (np.zeros((nuy, nux, 2), dtype=np.int64),
             np.zeros((nuy, nux, 2), dtype=np.int64),
             np.zeros((nuy, nux), dtype=np.int32),
             np.zeros((nuy, nux), dtype=bool))

    def split_code(d, by, bx, s):
        code = int(codes[d][by, bx])
        _code_split_syntax(enc, code, d, s, u, mtt)
        return code

    def leaf(key, gy, gx, uy, ux, ky, kx):
        levs = tuple(levels[key][c][gy, gx] for c in range(3))
        f = fields[key]
        if bi:
            _code_leaf_b(enc, f[0][gy, gx], f[1][gy, gx], int(f[2][gy, gx]),
                         levs, grids, uy, ux, ky, kx, use_merge)
        else:
            _code_leaf_p(enc, f[0][gy, gx], levs, grids[0], grids[3], uy,
                         ux, ky, kx, use_merge)

    walk_tree(nty, ntx, top, depth, split_code, leaf)
    return enc.finish()


def _qt_codes(splits):
    return [np.where(np.asarray(sp), mtt_mod.QUAD, mtt_mod.LEAF)
            for sp in splits]


def encode_p_slice_qt(splits, mvs, levels, top: int, depth: int,
                      use_merge: bool = False) -> bytes:
    """Quadtree P-slice entropy coding (reference: CABACWriter
    coding_tree + inter CU syntax): split_cu_flag per internal node, the
    leaves in z-order within each top block, raster over the top blocks;
    the coded unit-grid MV field evolves exactly as the decoder rebuilds
    it.  Args: outputs of qtree.encode_p_frame_qt (host numpy)."""
    return _encode_tree(_qt_codes(splits), {d: (m,) for d, m in
                                            enumerate(mvs)},
                        dict(enumerate(levels)), top, depth, False,
                        use_merge)


def encode_b_slice_qt(splits, mv0s, mv1s, dirss, levels, top: int,
                      depth: int, use_merge: bool = False) -> bytes:
    """Quadtree B-slice entropy coding: the tree + per leaf inter_dir, the
    mvd of each used list and the residual."""
    return _encode_tree(_qt_codes(splits),
                        {d: f for d, f in enumerate(zip(mv0s, mv1s, dirss))},
                        dict(enumerate(levels)), top, depth, False,
                        use_merge)


def encode_p_slice_mtt(codes, sq_mv, sq_levels, rect_mv, rect_levels,
                       top: int, depth: int,
                       use_merge: bool = False) -> bytes:
    """MTT P-slice entropy coding: QT/BT/TT split syntax + the quadtree's
    leaf syntax over rectangular spans."""
    fields = {d: (m,) for d, m in enumerate(sq_mv)}
    fields.update({k: (m,) for k, m in rect_mv.items()})
    return _encode_tree(codes, fields,
                        {**dict(enumerate(sq_levels)), **rect_levels}, top,
                        depth, True, use_merge)


def encode_b_slice_mtt(codes, sq_mv0, sq_mv1, sq_dirs, sq_levels,
                       rect_mv0, rect_mv1, rect_dirs, rect_levels,
                       top: int, depth: int,
                       use_merge: bool = False) -> bytes:
    """MTT B-slice entropy coding (split syntax + the B leaf syntax over
    rectangular spans)."""
    fields = {d: f for d, f in enumerate(zip(sq_mv0, sq_mv1, sq_dirs))}
    fields.update({k: (rect_mv0[k], rect_mv1[k], rect_dirs[k])
                   for k in rect_mv0})
    return _encode_tree(codes, fields,
                        {**dict(enumerate(sq_levels)), **rect_levels}, top,
                        depth, True, use_merge)
