"""Batched inter frames: motion compensation, search and reconstruction.

PyTorch counterpart of `vvc_mm_tpu/common/inter_frame.py` (reference:
source/Lib/CommonLib/InterPrediction.cpp — motionCompensation:1681,
xPredInterBlk:928; EncoderLib/InterSearch.cpp predInterSearch:2695;
DecoderLib/DecCu.cpp reconstruction).  Inter blocks of a frame do not
depend on each other, so every block of a frame is predicted, transformed
and reconstructed at once.  Here are the helpers the multi-model paths
share (reference padding with ERP wrap-around, the plane <-> block-batch
reshapes, the residual pass) and the classic (one MV per block) path:

  P   search_p_frame / search_p_frame_2ref (ME, the AMVR decision, the
      merge candidate fields' SADs, the co-located TMVP field among them)
      -> host selection -> finish_p_frame(_2ref); the decoder's
      reconstruct_p_frame(_2ref) shares the math; encode_p_frame is the
      one-shot program of merge off;
  B   search_b_frame(_merge) (per-list ME + the uni/bi/GPM/CIIP decision)
      -> host selection -> bpred_and_residual; the decoder's
      reconstruct_b_frame shares the math.

Encoder and decoder share the prediction, so the reconstructions agree
bit for bit; that includes the signalling-free refinements of bi blocks,
DMVR (common/dmvr.py) and BDOF (common/bdof.py), the GPM and CIIP blends
(common/gpm.py) and explicit weighted prediction (`apply_wp`, the weighted
bi combine).  A scaling list weights the P passes' (and the B
reconstruction's) quantization.  Motion-constrained tile sets clamp the
P searches' MVs into each block's tile (`mcts_clamp_mvs`, encoder side
only: the decoder needs no change).
"""
from __future__ import annotations

import torch

from . import interp, quant, transforms
from .rdcost import first_argmin

MC_MARGIN = 80     # ref padding: search range + filter taps + slack


def _edge_pad_rows(p: torch.Tensor, margin: int) -> torch.Tensor:
    top = p[:1].expand(margin, -1)
    bot = p[-1:].expand(margin, -1)
    return torch.cat([top, p, bot], 0)


def pad_ref(plane: torch.Tensor, margin: int = MC_MARGIN,
            wrap_around: bool = False) -> torch.Tensor:
    """Edge-extend a reconstructed plane for MC.  With `wrap_around`, the
    horizontal padding wraps (ERP 360 content; reference: Picture.cpp:94
    PIC_RECON_WRAP + Mv.cpp:113 wrapClipMv)."""
    w = plane.shape[1]
    if wrap_around:
        xs = torch.remainder(torch.arange(-margin, w + margin,
                                          device=plane.device), w)
        p = plane[:, xs]      # modular gather: correct even for margin > W
    else:
        p = torch.cat([plane[:, :1].expand(-1, margin), plane,
                       plane[:, -1:].expand(-1, margin)], 1)
    return _edge_pad_rows(p, margin).contiguous()


def _to_blocks(plane: torch.Tensor, s: int) -> torch.Tensor:
    h, w = plane.shape
    return (plane.reshape(h // s, s, w // s, s).permute(0, 2, 1, 3)
            .reshape(-1, s, s))


def _from_blocks(blocks: torch.Tensor, nby: int, nbx: int) -> torch.Tensor:
    s = blocks.shape[-1]
    return (blocks.reshape(nby, nbx, s, s).permute(0, 2, 1, 3)
            .reshape(nby * s, nbx * s))


def _block_coords(nby: int, nbx: int, s: int, device=None):
    idx = torch.arange(nby * nbx, dtype=torch.int32, device=device)
    return (idx // nbx) * s, (idx % nbx) * s


def mc_predict(ref_y: torch.Tensor, ref_u: torch.Tensor,
               ref_v: torch.Tensor, mvs: torch.Tensor, s: int, bit_depth: int,
               wrap_around: bool = False):
    """Motion-compensated prediction of the full frame from padded refs.

    Args:
      ref_*: unpadded reconstructed reference planes.
      mvs: (nby, nbx, 2) 1/16-pel MVs.
    Returns (pred_y, pred_u, pred_v) pixel-domain planes."""
    py, pu, pv = _mc_planes_internal(ref_y, ref_u, ref_v, mvs, s, bit_depth,
                                     wrap_around)
    nby, nbx = mvs.shape[:2]
    return tuple(_from_blocks(interp.finalize_uni(p, bit_depth), nby, nbx)
                 for p in (py, pu, pv))


def _mc_planes_internal(ref_y, ref_u, ref_v, mvs, s: int, bit_depth: int,
                        wrap_around: bool):
    """Uni-prediction of all planes kept in 14-bit internal precision
    (block-batched (B, s, s); for bi-prediction averaging, reference:
    xWeightedAverage)."""
    h, w = ref_y.shape
    nby, nbx = h // s, w // s
    sc = s // 2
    dev = ref_y.device
    mv = mvs.reshape(-1, 2)
    ry = pad_ref(ref_y, MC_MARGIN, wrap_around)
    ru = pad_ref(ref_u, MC_MARGIN // 2, wrap_around)
    rv = pad_ref(ref_v, MC_MARGIN // 2, wrap_around)
    yb, xb = _block_coords(nby, nbx, s, dev)
    py = interp.mc_luma(ry, mv, yb, xb, s, s, MC_MARGIN, bit_depth)
    ybc, xbc = _block_coords(nby, nbx, sc, dev)
    pu = interp.mc_chroma(ru, mv, ybc, xbc, sc, sc, MC_MARGIN // 2,
                          bit_depth)
    pv = interp.mc_chroma(rv, mv, ybc, xbc, sc, sc, MC_MARGIN // 2,
                          bit_depth)
    return py, pu, pv


SEI_MCTS = 134     # temporal motion-constrained tile sets SEI: (cols,
                   # rows) of the tile grid the clamps below keep motion
                   # inside (reference: SEI::TEMPORAL_MOTION_CONSTRAINED_
                   # TILE_SETS)


def _floor_div(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _tile_origins(n: int, s: int, extent: int, device):
    """Block positions (n blocks of s samples) and their tiles' origins."""
    b = torch.arange(n, dtype=torch.int32, device=device) * s
    return b, (b // extent) * extent


def mcts_clamp_mvs(mvs: torch.Tensor, block_size: int, width: int,
                   height: int, tile_cols: int, tile_rows: int
                   ) -> torch.Tensor:
    """Motion-constrained tile sets: clamp every block's MV so the full
    interpolation support (8-tap: 3 left / 4 right of the integer sample)
    stays inside the block's own tile (reference: MCTS.{cpp,h} —
    MCTSInfo::clipMvToArea).  Encoder side only: the decoder needs no
    change.  The bounds are rounded inward to the 4-pel grid (multiples of
    64 in 1/16 pel), so a later AMVR rounding cannot push a clamped MV
    back out of its tile.  mvs: (nby, nbx, 2) 1/16-pel (x, y), int32."""
    s = block_size
    nby, nbx = height // s, width // s
    tw, th = width // tile_cols, height // tile_rows

    def bounds(n, extent):
        b, t0 = _tile_origins(n, s, extent, mvs.device)
        # support [pos - 3, pos + s + 4) must stay in [t0, t0 + extent)
        lo = _floor_div((t0 - b + 3) * 16 + 63, 64) * 64
        hi = _floor_div((t0 + extent - s - 4 - b) * 16, 64) * 64
        return lo, torch.maximum(hi, lo)

    lo_x, hi_x = bounds(nbx, tw)
    lo_y, hi_y = bounds(nby, th)
    mx = torch.minimum(torch.maximum(mvs[..., 0], lo_x[None, :]),
                       hi_x[None, :])
    my = torch.minimum(torch.maximum(mvs[..., 1], lo_y[:, None]),
                       hi_y[:, None])
    return torch.stack([mx, my], -1)


def mcts_clamp(mvs: torch.Tensor, s: int, w: int, h: int,
               tiles: tuple[int, int]) -> torch.Tensor:
    """The JAX package's other MCTS clamp (no codec caller there either):
    every block's MC read window, the luma 8-tap and the chroma 4-tap at
    half resolution (a 4/5-sample margin), inside the block's own tile,
    without the 4-pel rounding.  mvs: (nby, nbx, 2) 1/16-pel (x, y);
    tiles: (cols, rows)."""
    ncx, ncy = tiles
    tw, th = w // ncx, h // ncy
    nby, nbx = mvs.shape[:2]

    def bounds(n, extent):
        b, t0 = _tile_origins(n, s, extent, mvs.device)
        lo = (t0 - b + 4) * 16
        hi = (t0 + extent - b - s - 5) * 16
        return lo, torch.maximum(hi, lo)

    lo_x, hi_x = bounds(nbx, tw)
    lo_y, hi_y = bounds(nby, th)
    mx = torch.minimum(torch.maximum(mvs[..., 0], lo_x[None, :]),
                       hi_x[None, :])
    my = torch.minimum(torch.maximum(mvs[..., 1], lo_y[:, None]),
                       hi_y[:, None])
    return torch.stack([mx, my], -1)


def _mcts(mvs: torch.Tensor, s: int, orig_y: torch.Tensor, mcts):
    """The searches' MCTS step: mvs clamped into their tiles when `mcts`
    ((cols, rows)) is given."""
    if not mcts:
        return mvs
    h, w = orig_y.shape
    return mcts_clamp_mvs(mvs, s, w, h, mcts[0], mcts[1]).to(mvs.dtype)


AMVR_SHIFTS = (2, 4, 6)    # 1/16-pel grid shifts: quarter-, full-, 4-pel
                           # (reference: IMV modes 0/1/2, TypeDef.h IMV_FPEL
                           # /IMV_4PEL; EncCu.cpp:775-782 IMV mode loop)


def round_mv_amvr(mv, shift: int):
    """Round a 1/16-pel MV (int array, tensor or scalar) to the AMVR grid —
    round half away from zero, shared enc/dec (reference:
    Mv::roundToAmvrSignalPrec via roundAffinePrecInternal2Amvr)."""
    if shift == 0:
        return mv
    off = 1 << (shift - 1)
    neg = (mv < 0)
    if torch.is_tensor(mv):
        neg = neg.to(mv.dtype)
    return ((mv + off - neg) >> shift) << shift


def amvr_decide(orig_y, ref_y_padded, mvs, block_size: int, bit_depth: int,
                lam_bits_x16: int):
    """Per-block adaptive-MV-resolution decision (reference: the EncCu IMV
    mode loop, EncCu.cpp:775-782 / xCheckRDCostInterIMV:4346): the three
    roundings of every block's MV are motion-compensated and SAD-scored at
    once, and the first minimum of SAD + lambda*mvd-bits picks the mode.

    Returns (imv (nby,nbx) int32 in {0,1,2}, mvs_rounded (nby,nbx,2))."""
    s = block_size
    h, w = orig_y.shape
    nby, nbx = h // s, w // s
    yb, xb = _block_coords(nby, nbx, s, orig_y.device)
    ob = _to_blocks(orig_y, s)
    cands, costs = [], []
    for m, sh in enumerate(AMVR_SHIFTS):
        mvr = round_mv_amvr(mvs.to(torch.int32), sh)
        pred = interp.finalize_uni(
            interp.mc_luma(ref_y_padded, mvr.reshape(-1, 2), yb, xb, s, s,
                           MC_MARGIN, bit_depth), bit_depth)
        sad = (pred - ob).abs().sum(dim=(1, 2)).to(torch.int32).reshape(
            nby, nbx)
        # rate proxy: EG-ish bit length of each mvd component at the
        # signalled precision + the imv flag bins (float32, as in JAX)
        mag = (mvr >> sh).abs()
        bits = (2 * torch.log2(1.0 + mag.to(torch.float32)).sum(-1)
                + 2.0 + (1 if m == 0 else 2))
        costs.append(sad + ((bits * lam_bits_x16).to(torch.int32) >> 4))
        cands.append(mvr)
    imv = first_argmin(torch.stack(costs), 0).to(torch.int32)
    mv_sel = torch.stack(cands).gather(
        0, imv.long()[None, :, :, None].expand(1, nby, nbx, 2))[0]
    return imv, mv_sel


def apply_wp(plane: torch.Tensor, w, o, bit_depth: int) -> torch.Tensor:
    """Explicit weighted prediction, log2Wd = 6 (reference:
    WeightPrediction.cpp — pred' = clip(((pred*w + 32) >> 6) + o))."""
    return torch.clamp(((plane * w + 32) >> 6) + o, 0, (1 << bit_depth) - 1)


def _wp_planes(pred, wp, bit_depth: int):
    """apply_wp over (Y, U, V) with a (3, 2) table of (w, o); a None
    table leaves the prediction as it is."""
    if wp is None:
        return pred
    return tuple(apply_wp(p, wp[i, 0], wp[i, 1], bit_depth)
                 for i, p in enumerate(pred))


def _combine_bi(int0, int1, dirs, nby, nbx, bit_depth, wp0=None, wp1=None,
                plane: int = 0):
    """Per-block uni/bi finalize: dirs (nby, nbx) 0=L0, 1=L1, 2=BI.

    With per-list explicit weights wp0/wp1 ((3, 2) int (w, o) per plane,
    log2Wd 6 — reference: WeightPrediction.cpp xWeightedPredictionBi),
    uni blocks apply their list's weight and bi blocks combine as
    ((p0*w0 + p1*w1 + 64) >> 7) + ((o0 + o1 + 1) >> 1)."""
    d = dirs.reshape(-1)[:, None, None]
    uni0 = interp.finalize_uni(int0, bit_depth)
    uni1 = interp.finalize_uni(int1, bit_depth)
    if wp0 is not None:
        w0, o0 = wp0[plane, 0], wp0[plane, 1]
        w1, o1 = wp1[plane, 0], wp1[plane, 1]
        bi = torch.clamp(((uni0 * w0 + uni1 * w1 + 64) >> 7)
                         + ((o0 + o1 + 1) >> 1), 0, (1 << bit_depth) - 1)
        uni0 = apply_wp(uni0, w0, o0, bit_depth)
        uni1 = apply_wp(uni1, w1, o1, bit_depth)
    else:
        bi = interp.finalize_bi(int0, int1, bit_depth)
    sel = torch.where(d == 2, bi, torch.where(d == 1, uni1, uni0))
    return _from_blocks(sel, nby, nbx)


def _luma_combine(int0, int1, dirs, nby, nbx, bit_depth, bdof: bool):
    """Luma uni/bi combine, BDOF-refined on bi blocks when `bdof` (luma
    only, reference: BDOF applies to luma bi blocks)."""
    if bdof:
        from .bdof import combine_bi_bdof
        return combine_bi_bdof(int0, int1, dirs, nby, nbx, bit_depth)
    return _combine_bi(int0, int1, dirs, nby, nbx, bit_depth)


def _pred_planes_ext(i0, i1, dirs, gpm_modes, nby, nbx, bit_depth,
                     bdof: bool, use_gpm: bool, use_ciip: bool,
                     wp0=None, wp1=None):
    """All-plane prediction combine incl. the GPM / CIIP block modes.

    dirs: 0=L0, 1=L1, 2=BI, 3=GPM (per-block mask in gpm_modes), 4=CIIP
    (bi inter + planar-from-prediction; reference: GEO weightedGeoBlk and
    the CIIP blend, InterPrediction.cpp / DecCu.cpp).  GPM/CIIP overlay the
    base uni/bi combine, so with both tools off this is the plain path.
    With explicit weights (wp0/wp1) every block takes the weighted
    combine: the caller turns BDOF, GPM and CIIP off on such slices."""
    from . import gpm as gpm_mod
    d = dirs.reshape(-1)[:, None, None]
    # CIIP's inter component is the bi average
    d_base = torch.where(dirs == 4, 2, dirs) if use_ciip else dirs
    if wp0 is not None:
        return tuple(_combine_bi(i0[p], i1[p], d_base, nby, nbx, bit_depth,
                                 wp0, wp1, p) for p in range(3))
    pred = [_luma_combine(i0[0], i1[0], d_base, nby, nbx, bit_depth, bdof),
            _combine_bi(i0[1], i1[1], d_base, nby, nbx, bit_depth),
            _combine_bi(i0[2], i1[2], d_base, nby, nbx, bit_depth)]
    s = pred[0].shape[0] // nby
    sizes = (s, s // 2, s // 2)
    if use_gpm:
        g = (gpm_modes.reshape(-1) if gpm_modes is not None else
             torch.zeros(nby * nbx, dtype=torch.int32, device=dirs.device))
        blends = [gpm_mod.gpm_blend if p == 0 else gpm_mod.gpm_blend_chroma
                  for p in range(3)]
        for p in range(3):
            b = blends[p](interp.finalize_uni(i0[p], bit_depth),
                          interp.finalize_uni(i1[p], bit_depth), g)
            pred[p] = _from_blocks(
                torch.where(d == 3, b, _to_blocks(pred[p], sizes[p])),
                nby, nbx)
    if use_ciip:
        for p in range(3):
            c = gpm_mod.ciip_from_pred(pred[p], sizes[p])
            pred[p] = _from_blocks(
                torch.where(d == 4, c, _to_blocks(pred[p], sizes[p])),
                nby, nbx)
    return tuple(pred)


def _residual_pass(orig: torch.Tensor, pred: torch.Tensor, s: int, qp: int,
                   bit_depth: int, scaling: tuple | None = None):
    """Transform/quant the residual and reconstruct — returns (levels
    (nby, nbx, s, s), recon_plane).  `scaling`: an optional 8x8
    scaling-list tuple (quant.scaling_weights)."""
    h, w = orig.shape
    nby, nbx = h // s, w // s
    log2s = s.bit_length() - 1
    ob = _to_blocks(orig, s)
    pb = _to_blocks(pred, s)
    coeff = transforms.forward_transform(ob - pb, bit_depth=bit_depth)
    levels = quant.quantize(coeff, qp, log2s, log2s, bit_depth, intra=False,
                            scaling=scaling)
    dq = quant.dequantize(levels, qp, log2s, log2s, bit_depth,
                          scaling=scaling)
    r = transforms.inverse_transform(dq, bit_depth=bit_depth)
    rec = torch.clamp(pb + r, 0, (1 << bit_depth) - 1)
    return levels.reshape(nby, nbx, s, s), _from_blocks(rec, nby, nbx)


def _residual_planes(orig, pred, s: int, qp: int, bit_depth: int,
                     scaling: tuple | None = None):
    """_residual_pass over Y, U, V -> (lev_y, lev_u, lev_v, recon dict)."""
    lev_y, rec_y = _residual_pass(orig[0], pred[0], s, qp, bit_depth,
                                  scaling)
    lev_u, rec_u = _residual_pass(orig[1], pred[1], s // 2, qp, bit_depth,
                                  scaling)
    lev_v, rec_v = _residual_pass(orig[2], pred[2], s // 2, qp, bit_depth,
                                  scaling)
    return lev_y, lev_u, lev_v, dict(y=rec_y, u=rec_u, v=rec_v)


def _recon_planes(pred, levels, s: int, qp: int, bit_depth: int,
                  scaling: tuple | None = None):
    """Decoder-side reconstruction of Y, U, V from the prediction planes
    and the coded levels (the inverse half of _residual_pass)."""
    out = {}
    for key, p, lev, size in zip("yuv", pred, levels, (s, s // 2, s // 2)):
        h, w = p.shape
        log2s = size.bit_length() - 1
        dq = quant.dequantize(lev.reshape(-1, size, size), qp, log2s, log2s,
                              bit_depth, scaling=scaling)
        r = transforms.inverse_transform(dq, bit_depth=bit_depth)
        rec = torch.clamp(_to_blocks(p, size) + r, 0, (1 << bit_depth) - 1)
        out[key] = _from_blocks(rec, h // size, w // size)
    return out


def _lambda_bits_x16(qp: int) -> int:
    return int(quant.lambda_from_qp(qp, intra=False) ** 0.5 * 16)


def _me(orig_y, ref_padded, s: int, search_range: int, lam_bits_x16: int,
        bit_depth: int):
    """Hierarchical integer ME + fractional refine -> (mvs, sad)."""
    from ..encoder import me as me_mod
    mv_int, _ = me_mod.hierarchical_search(orig_y, ref_padded, s,
                                           search_range, MC_MARGIN,
                                           lam_bits_x16)
    return me_mod.fractional_refine(orig_y, ref_padded, mv_int, s,
                                    MC_MARGIN, bit_depth)


def encode_p_frame(orig_y, orig_u, orig_v, ref_y, ref_u, ref_v, qp: int,
                   block_size: int = 16, bit_depth: int = 8,
                   search_range: int = 24, wrap_around: bool = False,
                   wp=None, scaling=None, amvr: bool = False, mcts=None):
    """Full-frame P encode: batched ME (+ the AMVR decision) -> MC (+
    explicit weights `wp`, (3, 2) (w, o) per plane) -> residual -> recon,
    the one-shot program of the merge-off path.  Returns (mvs (nby,nbx,2)
    1/16-pel, lev_y, lev_u, lev_v, recon dict); with `amvr`, (mvs, imv,
    lev_y, lev_u, lev_v, recon), mvs already rounded to each block's
    signalled precision.  `mcts` ((cols, rows) or None) clamps the MVs
    into their tiles before the AMVR decision."""
    s = block_size
    lam_bits_x16 = _lambda_bits_x16(qp)
    ry_pad = pad_ref(ref_y, MC_MARGIN, wrap_around)
    mvs, _ = _me(orig_y, ry_pad, s, search_range, lam_bits_x16, bit_depth)
    mvs = _mcts(mvs, s, orig_y, mcts)
    imv = None
    if amvr:
        imv, mvs = amvr_decide(orig_y, ry_pad, mvs, s, bit_depth,
                               lam_bits_x16)
    pred = _wp_planes(mc_predict(ref_y, ref_u, ref_v, mvs, s, bit_depth,
                                 wrap_around), wp, bit_depth)
    out = _residual_planes((orig_y, orig_u, orig_v), pred, s, qp, bit_depth,
                           scaling)
    return ((mvs, imv) if amvr else (mvs,)) + out


N_CAND_FIELDS = 5     # left, above, above-right, zero, TMVP


def _shift_mv_field(mvs: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[by, bx] = mvs[by + dy, bx + dx]; out-of-range entries 0."""
    nby, nbx = mvs.shape[:2]
    p = torch.nn.functional.pad(mvs, (0, 0, 1, 1, 1, 1))
    return p[1 + dy:1 + dy + nby, 1 + dx:1 + dx + nbx]


def _shift_i_field(f: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[by, bx] = f[by + dy, bx + dx]; out-of-range entries 0."""
    nby, nbx = f.shape
    p = torch.nn.functional.pad(f, (1, 1, 1, 1))
    return p[1 + dy:1 + dy + nby, 1 + dx:1 + dx + nbx]


def _field_sad(orig_y, ref_y_padded, mvs, s: int, bit_depth: int):
    """Per-block SAD of one MV field (batched MC + reduce)."""
    h, w = orig_y.shape
    nby, nbx = h // s, w // s
    yb, xb = _block_coords(nby, nbx, s, orig_y.device)
    pred = interp.finalize_uni(
        interp.mc_luma(ref_y_padded, mvs.reshape(-1, 2), yb, xb, s, s,
                       MC_MARGIN, bit_depth), bit_depth)
    ob = _to_blocks(orig_y, s)
    return (pred - ob).abs().sum(dim=(1, 2)).to(torch.int32).reshape(nby,
                                                                     nbx)


def search_p_frame(orig_y, ref_y, col_mvs, qp: int, block_size: int,
                   bit_depth: int, search_range: int, wrap_around: bool,
                   amvr: bool = False, mcts=None):
    """Merge-aware P search: hierarchical ME + fractional refine (+ the
    AMVR rounding), then ONE batched MC+SAD pass per candidate field (the
    left, above and above-right neighbours' MVs, zero, and the co-located
    TMVP field `col_mvs`, zeros when absent).  `mcts` ((cols, rows) or
    None) clamps the MVs into their tiles; as in the JAX package, sad_me
    stays the SAD of the unclamped MV unless AMVR recomputes it.

    Returns (mvs, imv, sad_me, cand_mvs (K,nby,nbx,2), cand_sads (K,...))."""
    s = block_size
    h, w = orig_y.shape
    lam_bits_x16 = _lambda_bits_x16(qp)
    ry_pad = pad_ref(ref_y, MC_MARGIN, wrap_around)
    mvs, sad_me = _me(orig_y, ry_pad, s, search_range, lam_bits_x16,
                      bit_depth)
    mvs = _mcts(mvs, s, orig_y, mcts)
    imv = torch.zeros((h // s, w // s), dtype=torch.int32,
                      device=orig_y.device)
    if amvr:
        imv, mvs = amvr_decide(orig_y, ry_pad, mvs, s, bit_depth,
                               lam_bits_x16)
        # post-rounding SAD so merge-vs-AMVP costs compare like for like
        sad_me = _field_sad(orig_y, ry_pad, mvs, s, bit_depth)
    cand_fields = [
        _shift_mv_field(mvs, 0, -1),       # left neighbour's MV
        _shift_mv_field(mvs, -1, 0),       # above
        _shift_mv_field(mvs, -1, 1),       # above-right
        torch.zeros_like(mvs),             # zero MV
        col_mvs.to(mvs.dtype),             # TMVP co-located
    ]
    cand_sads = torch.stack([_field_sad(orig_y, ry_pad, f, s, bit_depth)
                             for f in cand_fields])
    return mvs, imv, sad_me, torch.stack(cand_fields), cand_sads


def search_p_frame_2ref(orig_y, ref0_y, ref1_y, col_mvs, qp: int,
                        block_size: int, bit_depth: int, search_range: int,
                        wrap_around: bool, amvr: bool = False, mcts=None):
    """Two-reference merge-aware P search: per-ref ME, a per-block ref_idx
    decision, then candidate-field SADs where each candidate carries its
    (ref_idx, mv) and its SAD reads ITS reference (reference: the per-ref
    ME loop InterSearch.cpp:4937 + ref_idx RD).

    `mcts` clamps each reference's MVs as in search_p_frame.

    Returns (ref_idx, mvs, imv, sad_sel, cand_ref (K,..), cand_mvs,
    cand_sads)."""
    s = block_size
    lam_bits_x16 = _lambda_bits_x16(qp)
    pads, mvs_r, sads_r, imvs_r = [], [], [], []
    for ry in (ref0_y, ref1_y):
        ry_pad = pad_ref(ry, MC_MARGIN, wrap_around)
        pads.append(ry_pad)
        mvs, sad = _me(orig_y, ry_pad, s, search_range, lam_bits_x16,
                       bit_depth)
        mvs = _mcts(mvs, s, orig_y, mcts)
        imv = torch.zeros_like(sad)
        if amvr:
            imv, mvs = amvr_decide(orig_y, ry_pad, mvs, s, bit_depth,
                                   lam_bits_x16)
            sad = _field_sad(orig_y, ry_pad, mvs, s, bit_depth)
        mvs_r.append(mvs)
        sads_r.append(sad)
        imvs_r.append(imv)
    # ref decision: the second ref pays one more context bin
    ref_idx = (sads_r[1] + (lam_bits_x16 >> 4) < sads_r[0]).to(torch.int32)
    mv_sel = torch.where(ref_idx[..., None] == 1, mvs_r[1], mvs_r[0])
    sad_sel = torch.where(ref_idx == 1, sads_r[1], sads_r[0])
    imv_sel = torch.where(ref_idx == 1, imvs_r[1], imvs_r[0])

    def field_sad_ref(rf, mf):
        s0 = _field_sad(orig_y, pads[0], mf, s, bit_depth)
        s1 = _field_sad(orig_y, pads[1], mf, s, bit_depth)
        return torch.where(rf == 1, s1, s0)

    cand_ref, cand_mvs, cand_sads = [], [], []
    for (dy, dx) in ((0, -1), (-1, 0), (-1, 1)):
        cr = _shift_i_field(ref_idx, dy, dx)
        cm = _shift_mv_field(mv_sel, dy, dx)
        cand_ref.append(cr)
        cand_mvs.append(cm)
        cand_sads.append(field_sad_ref(cr, cm))
    z = torch.zeros_like(ref_idx)
    for f in (torch.zeros_like(mv_sel), col_mvs.to(mv_sel.dtype)):
        # the zero and the TMVP candidates ride ref 0
        cand_ref.append(z)
        cand_mvs.append(f)
        cand_sads.append(_field_sad(orig_y, pads[0], f, s, bit_depth))
    return (ref_idx, mv_sel, imv_sel, sad_sel, torch.stack(cand_ref),
            torch.stack(cand_mvs), torch.stack(cand_sads))


def finish_p_frame(orig_y, orig_u, orig_v, ref_y, ref_u, ref_v, mvs,
                   qp: int, block_size: int, bit_depth: int,
                   wrap_around: bool, wp=None, scaling=None):
    """Residual/levels/recon from a FINAL MV field (encode_p_frame minus
    the ME).  Returns (lev_y, lev_u, lev_v, recon dict)."""
    pred = _wp_planes(mc_predict(ref_y, ref_u, ref_v, mvs, block_size,
                                 bit_depth, wrap_around), wp, bit_depth)
    return _residual_planes((orig_y, orig_u, orig_v), pred, block_size, qp,
                            bit_depth, scaling)


def reconstruct_p_frame(mvs, lev_y, lev_u, lev_v, ref_y, ref_u, ref_v,
                        qp: int, block_size: int = 16, bit_depth: int = 8,
                        wrap_around: bool = False, wp=None, scaling=None):
    """Decoder-side P reconstruction (shared math with finish_p_frame ->
    bit-exact)."""
    pred = _wp_planes(mc_predict(ref_y, ref_u, ref_v, mvs, block_size,
                                 bit_depth, wrap_around), wp, bit_depth)
    return _recon_planes(pred, (lev_y, lev_u, lev_v), block_size, qp,
                         bit_depth, scaling)


def _mc_predict_2ref(ref0, ref1, ref_idx, mvs, s: int, bit_depth: int,
                     wrap_around: bool):
    """Per-block two-reference MC: both refs motion-compensated, the
    block's ref_idx selects."""
    p0 = mc_predict(ref0[0], ref0[1], ref0[2], mvs, s, bit_depth,
                    wrap_around)
    p1 = mc_predict(ref1[0], ref1[1], ref1[2], mvs, s, bit_depth,
                    wrap_around)
    out = []
    for i, sub in enumerate((1, 2, 2)):
        k = s // sub
        r = ref_idx.repeat_interleave(k, 0).repeat_interleave(k, 1)
        out.append(torch.where(r == 1, p1[i], p0[i]))
    return tuple(out)


def finish_p_frame_2ref(orig_y, orig_u, orig_v, ref0, ref1, ref_idx, mvs,
                        qp: int, block_size: int, bit_depth: int,
                        wrap_around: bool, wp=None, scaling=None):
    """Residual/levels/recon from FINAL (ref_idx, mv) fields."""
    pred = _wp_planes(_mc_predict_2ref(ref0, ref1, ref_idx, mvs, block_size,
                                       bit_depth, wrap_around), wp,
                      bit_depth)
    return _residual_planes((orig_y, orig_u, orig_v), pred, block_size, qp,
                            bit_depth, scaling)


def reconstruct_p_frame_2ref(ref_idx, mvs, lev_y, lev_u, lev_v, ref0, ref1,
                             qp: int, block_size: int = 16,
                             bit_depth: int = 8, wrap_around: bool = False,
                             wp=None, scaling=None):
    """Decoder-side two-reference P reconstruction (shared math with
    finish_p_frame_2ref -> bit-exact)."""
    pred = _wp_planes(_mc_predict_2ref(ref0, ref1, ref_idx, mvs, block_size,
                                       bit_depth, wrap_around), wp,
                      bit_depth)
    return _recon_planes(pred, (lev_y, lev_u, lev_v), block_size, qp,
                         bit_depth, scaling)


def _dmvr(ref0, ref1, mv0, mv1, dirs, s: int, wrap_around: bool):
    from .dmvr import dmvr_refine
    return dmvr_refine(pad_ref(ref0[0], MC_MARGIN, wrap_around),
                       pad_ref(ref1[0], MC_MARGIN, wrap_around), mv0, mv1,
                       dirs, s, MC_MARGIN)


def bpred_and_residual(orig_y, orig_u, orig_v, ref0, ref1, mv0, mv1, dirs,
                       qp: int, block_size: int, bit_depth: int,
                       wrap_around: bool, bdof: bool = False,
                       dmvr: bool = False, gpm_modes=None,
                       gpm: bool = False, ciip: bool = False,
                       wp0=None, wp1=None):
    """Shared B prediction + residual path (the decoder's is
    reconstruct_b_frame).  With `dmvr` the bi blocks' MV pairs are first
    refined by bilateral matching (common/dmvr.py), with `bdof` their luma
    takes the optical-flow correction; `gpm`/`ciip` blend the blocks of
    dirs 3/4 (common/gpm.py); wp0/wp1 weight each list ((3, 2) (w, o) per
    plane).  Returns (lev_y, lev_u, lev_v, recon dict)."""
    s = block_size
    h, w = orig_y.shape
    if dmvr:
        mv0, mv1 = _dmvr(ref0, ref1, mv0, mv1, dirs, s, wrap_around)
    i0 = _mc_planes_internal(*ref0, mv0, s, bit_depth, wrap_around)
    i1 = _mc_planes_internal(*ref1, mv1, s, bit_depth, wrap_around)
    pred = _pred_planes_ext(i0, i1, dirs, gpm_modes, h // s, w // s,
                            bit_depth, bdof, gpm, ciip, wp0, wp1)
    return _residual_planes((orig_y, orig_u, orig_v), pred, s, qp,
                            bit_depth)


def reconstruct_b_frame(mv0, mv1, dirs, lev_y, lev_u, lev_v, ref0, ref1,
                        qp: int, block_size: int, bit_depth: int = 8,
                        wrap_around: bool = False, bdof: bool = False,
                        dmvr: bool = False, gpm_modes=None,
                        gpm: bool = False, ciip: bool = False,
                        scaling=None, wp0=None, wp1=None):
    """Decoder-side B reconstruction (shared with the encoder's recon)."""
    s = block_size
    h, w = ref0[0].shape
    if dmvr:
        mv0, mv1 = _dmvr(ref0, ref1, mv0, mv1, dirs, s, wrap_around)
    i0 = _mc_planes_internal(*ref0, mv0, s, bit_depth, wrap_around)
    i1 = _mc_planes_internal(*ref1, mv1, s, bit_depth, wrap_around)
    pred = _pred_planes_ext(i0, i1, dirs, gpm_modes, h // s, w // s,
                            bit_depth, bdof, gpm, ciip, wp0, wp1)
    return _recon_planes(pred, (lev_y, lev_u, lev_v), s, qp, bit_depth,
                         scaling)


def search_b_frame(orig_y, ref0_y, ref1_y, qp: int, block_size: int,
                   bit_depth: int, search_range: int, wrap_around: bool,
                   gpm: bool = False, ciip: bool = False):
    """Per-list ME + per-block prediction-direction decision (reference:
    InterSearch::predInterSearch uni L0/L1 + bi; bi uses the uni-best MVs
    without iterative refinement).  With gpm/ciip the decision extends to
    dirs 3 (GPM, its mask by a batched SAD over all masks) and 4 (CIIP).
    A tie keeps the earlier direction: L0, L1, bi, GPM, CIIP.  Returns
    (mv0, mv1, dirs, gpm_modes)."""
    s = block_size
    h, w = orig_y.shape
    nby, nbx = h // s, w // s
    dev = orig_y.device
    lam = quant.lambda_from_qp(qp, intra=False)
    lam16 = int(lam ** 0.5 * 16)
    yb, xb = _block_coords(nby, nbx, s, dev)
    mvs, sads, preds = [], [], []
    for ref in (ref0_y, ref1_y):
        refp = pad_ref(ref, MC_MARGIN, wrap_around)
        mv, sad = _me(orig_y, refp, s, search_range, lam16, bit_depth)
        mvs.append(mv)
        sads.append(sad)
        preds.append(interp.mc_luma(refp, mv.reshape(-1, 2), yb, xb, s, s,
                                    MC_MARGIN, bit_depth))
    ob = _to_blocks(orig_y, s)
    bi_pix = interp.finalize_bi(preds[0], preds[1], bit_depth)
    sad_bi = (bi_pix - ob).abs().sum(dim=(1, 2)).to(torch.int32).reshape(
        nby, nbx)
    # direction decision: bi costs two mvds
    mv_bits = int(lam ** 0.5 * 8)
    costs = [sads[0], sads[1], sad_bi + mv_bits]
    gpm_modes = torch.zeros((nby, nbx), dtype=torch.int32, device=dev)
    if gpm or ciip:
        from . import gpm as gpm_mod
        big = torch.full((nby, nbx), 1 << 30, dtype=torch.int32, device=dev)
        if gpm:
            gmode, gsad = gpm_mod.gpm_search(
                ob, interp.finalize_uni(preds[0], bit_depth),
                interp.finalize_uni(preds[1], bit_depth))
            gpm_modes = gmode.reshape(nby, nbx)
            # GPM pays two mvds + the 4-bit mask index
            costs.append(gsad.reshape(nby, nbx) + mv_bits + (mv_bits >> 1))
        else:
            costs.append(big)
        if ciip:
            cblk = gpm_mod.ciip_from_pred(_from_blocks(bi_pix, nby, nbx), s)
            csad = (cblk - ob).abs().sum(dim=(1, 2)).to(torch.int32)
            costs.append(csad.reshape(nby, nbx) + mv_bits)
        else:
            costs.append(big)
    dirs = first_argmin(torch.stack(costs), 0).to(torch.int32)
    return mvs[0], mvs[1], dirs, gpm_modes


def _b_field_sad(orig_y, r0p, r1p, mv0f, mv1f, dirsf, s: int,
                 bit_depth: int):
    """Per-block SAD of one whole-motion B field (dirs 0/1/2)."""
    h, w = orig_y.shape
    nby, nbx = h // s, w // s
    yb, xb = _block_coords(nby, nbx, s, orig_y.device)
    p0 = interp.mc_luma(r0p, mv0f.reshape(-1, 2), yb, xb, s, s, MC_MARGIN,
                        bit_depth)
    p1 = interp.mc_luma(r1p, mv1f.reshape(-1, 2), yb, xb, s, s, MC_MARGIN,
                        bit_depth)
    pred = _combine_bi(p0, p1, dirsf, nby, nbx, bit_depth)
    diff = (pred - orig_y).abs()
    return diff.reshape(nby, s, nbx, s).sum(dim=(1, 3)).to(torch.int32)


def search_b_frame_merge(orig_y, ref0_y, ref1_y, qp: int, block_size: int,
                         bit_depth: int, search_range: int,
                         wrap_around: bool, gpm: bool = False,
                         ciip: bool = False):
    """Merge-aware B search: the per-list ME + direction decision of
    search_b_frame, plus per-block SADs of the whole-motion merge
    candidate fields (neighbour shifts of (mv0, mv1, dirs) and zero-bi).
    Candidate dirs from GPM/CIIP neighbours collapse to BI — a merge
    candidate carries motion, not the mask/intra sub-state (reference:
    GEO neighbours contribute their stored bi motion to merge lists).

    Returns (mv0, mv1, dirs, gpm_modes, sad_sel,
             cand_mv0/mv1 (K,nby,nbx,2), cand_dirs (K,..), cand_sads)."""
    s = block_size
    mv0, mv1, dirs, gpm_modes = search_b_frame(
        orig_y, ref0_y, ref1_y, qp, s, bit_depth, search_range,
        wrap_around, gpm, ciip)
    r0p = pad_ref(ref0_y, MC_MARGIN, wrap_around)
    r1p = pad_ref(ref1_y, MC_MARGIN, wrap_around)
    sad_sel = _b_field_sad(orig_y, r0p, r1p, mv0, mv1,
                           torch.clamp(dirs, max=2), s, bit_depth)
    cand_mv0, cand_mv1, cand_dirs = [], [], []
    for (dy, dx) in ((0, -1), (-1, 0), (-1, 1)):
        cand_mv0.append(_shift_mv_field(mv0, dy, dx))
        cand_mv1.append(_shift_mv_field(mv1, dy, dx))
        cand_dirs.append(torch.clamp(_shift_i_field(dirs, dy, dx), max=2))
    # zero-MV bi candidate
    cand_mv0.append(torch.zeros_like(mv0))
    cand_mv1.append(torch.zeros_like(mv0))
    cand_dirs.append(torch.full_like(dirs, 2))
    cand_sads = [_b_field_sad(orig_y, r0p, r1p, c0, c1, cd, s, bit_depth)
                 for c0, c1, cd in zip(cand_mv0, cand_mv1, cand_dirs)]
    return (mv0, mv1, dirs, gpm_modes, sad_sel, torch.stack(cand_mv0),
            torch.stack(cand_mv1), torch.stack(cand_dirs),
            torch.stack(cand_sads))
