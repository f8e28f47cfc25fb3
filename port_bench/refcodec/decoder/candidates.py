"""The candidate lists and block walks that the inter slice syntax
shares between encoder and decoder: merge and AMVP candidates (classic,
multi-model and MM-MVP converted), the HMVP FIFO, the merge estimation
regions, the quadtree / multi-type tree walker and the WPP row bounds.

Copied from the port's `encoder/inter_coder.py` and
`encoder/intra_coder.py` (`wpp_bounds`), which hold them beside the
encoder's selection and slice writers; the reference decoder needs only
these (reference: UnitTools.cpp:1059 getInterMergeCandidates, :872-885
model inheritance through merge, fillMvpCand).
"""
from __future__ import annotations

import numpy as np

from ..common import mtt as mtt_mod


MERGE_MAX = 6     # merge candidate list size (reference: CommonDef.h
                  # MRG_MAX_NUM_CANDS = 6)


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


def _b_dir_pred(dirs_u, avail, uy: int, ux: int) -> int:
    """The inter direction a non-merge skip inherits: left, else above,
    else L0."""
    if ux > 0 and avail[uy, ux - 1]:
        return int(dirs_u[uy, ux - 1])
    if uy > 0 and avail[uy - 1, ux]:
        return int(dirs_u[uy - 1, ux])
    return 0


def wpp_bounds(nby: int, num_substreams: int) -> list[int]:
    """Block-row bounds of the WPP substreams: min(num_substreams, nby)
    row groups of near-equal height."""
    n = max(1, min(num_substreams, nby))
    return [round(i * nby / n) for i in range(n + 1)]
