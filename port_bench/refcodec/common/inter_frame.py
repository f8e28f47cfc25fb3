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


N_CAND_FIELDS = 5     # left, above, above-right, zero, TMVP


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


