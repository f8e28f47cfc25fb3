"""Multi-type-tree (QT + BT + TT) inter partitioning — the full QTMT
lattice.

PyTorch counterpart of `vvc_mm_tpu/common/mtt.py` (reference:
UnitPartitioner.h:56-64 CU_QUAD_SPLIT, CU_HORZ_SPLIT, CU_VERT_SPLIT,
CU_TRIH_SPLIT, CU_TRIV_SPLIT, driven by EncCu::xCompressCU EncCu.cpp:499 /
xCheckModeSplit EncCu.cpp:1118).  Every node of the split lattice is
evaluated for the whole frame at once (common/qtree.py) and the tree is
resolved by a batched bottom-up argmin over SIX candidates per square
node: leaf, quad split, horizontal/vertical binary split (rectangular
halves), horizontal/vertical ternary split (1/4-1/2-1/4 stripes).

Binary and ternary children are terminal leaves, and a split kind is only
offered when its stripes stay unit-aligned (BT needs s/2 >= unit, TT needs
s/4 >= unit).  Ternary middle stripes sit at an s/4 offset from the node
grid; they are evaluated on an s/4-cropped frame so that every batched
pass runs on an aligned grid.  The winning tree is resolved to a unit-grid
MV field that drives ONE motion-compensation pass, and the per-shape
residual grids (zeroed off-leaf) are inverse-transformed and summed.

The costs are float32 with the JAX package's XLA CPU numerics (see
common/qtree.py).  Its MTT encoders are not jitted programs: their costs
are computed operation by operation, each product and sum rounded on its
own (`fused=False`), and the six-way argmin takes the first of equal
costs.
"""
from __future__ import annotations

import numpy as np
import torch

from . import interp, quant, transforms
from .inter_frame import MC_MARGIN, mc_predict, pad_ref
from .qtree import (_coeff_bits_est, _field_to_unit, _mask_and_locate,
                    _mv_bits_est, _pred_b, _recon, _sum2x2, _up2,
                    node_sizes, rd_cost_f32)
from .rdcost import first_argmin

# split codes per square node (stored in the `codes` grids)
LEAF, QUAD, BTH, BTV, TTH, TTV = 0, 1, 2, 3, 4, 5
# the split code each rectangular grid belongs to
KIND_CODE = {"bth": BTH, "btv": BTV, "tth_o": TTH, "tth_m": TTH,
             "ttv_o": TTV, "ttv_m": TTV}


def _up(x: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    return x.repeat_interleave(fy, 0).repeat_interleave(fx, 1)


def bt_allowed(s: int, u: int) -> bool:
    return s // 2 >= u


def tt_allowed(s: int, u: int) -> bool:
    return s // 4 >= u


def rect_shapes(top: int, depth: int):
    """Canonical rectangular-entry list [(kind, d, sy, sx, y_off, x_off)]
    shared by encoder, decoder, and the reconstruction level layout."""
    sizes = node_sizes(top, depth)
    u = sizes[-1]
    out = []
    for d in range(depth):
        s = sizes[d]
        if bt_allowed(s, u):
            out.append(("bth", d, s // 2, s, 0, 0))
            out.append(("btv", d, s, s // 2, 0, 0))
        if tt_allowed(s, u):
            out.append(("tth_o", d, s // 4, s, 0, 0))
            out.append(("tth_m", d, s // 2, s, s // 4, 0))
            out.append(("ttv_o", d, s, s // 4, 0, 0))
            out.append(("ttv_m", d, s, s // 2, 0, s // 4))
    return out


def rect_grid(h: int, w: int, info) -> tuple[int, int]:
    """(rows, cols) of a shape's grid over an (h, w) frame."""
    _, _, sy, sx, y_off, x_off = info
    return (h - 2 * y_off) // sy, (w - 2 * x_off) // sx


# ------------------------------------------------------------------ MC


def _to_rect_blocks(plane, sy, sx):
    h, w = plane.shape
    nby, nbx = h // sy, w // sx
    return (plane.reshape(nby, sy, nbx, sx).permute(0, 2, 1, 3)
            .reshape(-1, sy, sx))


def _residual_rect(ob, pb, sy, sx, qp, bit_depth):
    """Transform/quant/reconstruct rect blocks.  Returns (levels, rec)."""
    lw, lh = sx.bit_length() - 1, sy.bit_length() - 1
    coeff = transforms.forward_transform(ob - pb, bit_depth=bit_depth)
    levels = quant.quantize(coeff, qp, lw, lh, bit_depth, intra=False)
    dq = quant.dequantize(levels, qp, lw, lh, bit_depth)
    r = transforms.inverse_transform(dq, bit_depth=bit_depth)
    return levels, torch.clamp(pb + r, 0, (1 << bit_depth) - 1)


def _crop(plane, y_off, x_off, div=1):
    """Crop y_off/x_off (luma pixels) off both ends; div=2 for chroma."""
    yo, xo = y_off // div, x_off // div
    h, w = plane.shape
    return plane[yo:h - yo, xo:w - xo]


def _internal(refs_pad, mv, ys, xs, sy, sx, bit_depth):
    """The three planes' predictions of rect blocks at luma coords
    (ys, xs), internal precision, block-batched (B, sy, sx)."""
    mv = mv.reshape(-1, 2)
    return (interp.mc_luma(refs_pad[0], mv, ys, xs, sy, sx, MC_MARGIN,
                           bit_depth),
            *(interp.mc_chroma(r, mv, ys // 2, xs // 2, sy // 2, sx // 2,
                               MC_MARGIN // 2, bit_depth)
              for r in refs_pad[1:]))


# ------------------------------------------------- rect pass evaluation


def _eval_rect_pass(orig, refs_pad, sy, sx, y_off, x_off, qp, bit_depth,
                    search_range, lam, lam16, parent_mv, dual=None):
    """One rectangular evaluation pass over the (possibly offset-cropped)
    frame.  Returns dict(mv=..., [mv1=, dirs=,] lev=(ly,lu,lv), cost=).

    `dual`: None for P; (refs1_pad, mv_bits) for B — per-list ME + uni/bi
    decision per rect block.
    """
    from ..encoder import me as me_mod
    oy = _crop(orig[0], y_off, x_off)
    ou = _crop(orig[1], y_off, x_off, 2)
    ov = _crop(orig[2], y_off, x_off, 2)
    h, w = oy.shape
    nby, nbx = h // sy, w // sx
    idx = torch.arange(nby * nbx, dtype=torch.int32, device=oy.device)
    # block coords in the UNCROPPED frame
    ys = (idx // nbx) * sy + y_off
    xs = (idx % nbx) * sx + x_off

    ref_sets = [refs_pad] if dual is None else [refs_pad, dual[0]]
    mvs, preds_y = [], []
    for rp in ref_sets:
        ry_crop = _crop(rp[0], y_off, x_off)
        mv_i, _ = me_mod.hierarchical_search_rect(
            oy, ry_crop, sy, sx, search_range, MC_MARGIN, lam16)
        mv, _ = me_mod.fractional_refine_rect(
            oy, ry_crop, mv_i, sy, sx, MC_MARGIN, bit_depth)
        mvs.append(mv)
        preds_y.append(interp.mc_luma(rp[0], mv.reshape(-1, 2), ys, xs,
                                      sy, sx, MC_MARGIN, bit_depth))
    ob = _to_rect_blocks(oy, sy, sx)
    oub = _to_rect_blocks(ou, sy // 2, sx // 2)
    ovb = _to_rect_blocks(ov, sy // 2, sx // 2)

    if dual is None:
        dirs = None
        py, pu, pv = (interp.finalize_uni(p, bit_depth) for p in
                      _internal(refs_pad, mvs[0], ys, xs, sy, sx,
                                bit_depth))
    else:
        u0 = interp.finalize_uni(preds_y[0], bit_depth)
        u1 = interp.finalize_uni(preds_y[1], bit_depth)
        bi = interp.finalize_bi(preds_y[0], preds_y[1], bit_depth)
        sad0 = (u0 - ob).abs().sum(dim=(1, 2))
        sad1 = (u1 - ob).abs().sum(dim=(1, 2))
        sadb = (bi - ob).abs().sum(dim=(1, 2)) + dual[1]
        dirs = first_argmin(torch.stack([sad0, sad1, sadb]), 0).to(
            torch.int32).reshape(nby, nbx)
        i0 = _internal(refs_pad, mvs[0], ys, xs, sy, sx, bit_depth)
        i1 = _internal(dual[0], mvs[1], ys, xs, sy, sx, bit_depth)
        # uni/bi select from internal precision (as _combine_bi and the
        # shared reconstruction)
        db = dirs.reshape(-1)[:, None, None]
        py, pu, pv = (
            torch.where(db == 0, interp.finalize_uni(a, bit_depth),
                        torch.where(db == 1,
                                    interp.finalize_uni(b, bit_depth),
                                    interp.finalize_bi(a, b, bit_depth)))
            for a, b in zip(i0, i1))

    ly, rec_y = _residual_rect(ob, py, sy, sx, qp, bit_depth)
    lu, rec_u = _residual_rect(oub, pu, sy // 2, sx // 2, qp, bit_depth)
    lv, rec_v = _residual_rect(ovb, pv, sy // 2, sx // 2, qp, bit_depth)
    ssd = (((ob - rec_y) ** 2).sum(dim=(1, 2))
           + ((oub - rec_u) ** 2).sum(dim=(1, 2))
           + ((ovb - rec_v) ** 2).sum(dim=(1, 2))
           ).reshape(nby, nbx).to(torch.float32)
    lyg = ly.reshape(nby, nbx, sy, sx)
    lug = lu.reshape(nby, nbx, sy // 2, sx // 2)
    lvg = lv.reshape(nby, nbx, sy // 2, sx // 2)
    bits = (_coeff_bits_est(lyg) + _coeff_bits_est(lug)
            + _coeff_bits_est(lvg) + 6.0)
    if parent_mv is not None:
        # map each rect block to its covering parent-node MV (offset-aware)
        ph, pw = orig[0].shape
        psy = ph // parent_mv.shape[0]
        psx = pw // parent_mv.shape[1]
        dev = oy.device
        py_idx = (torch.arange(nby, device=dev) * sy + y_off) // psy
        px_idx = (torch.arange(nbx, device=dev) * sx + x_off) // psx
        pg = parent_mv[py_idx][:, px_idx]
        bits = bits + _mv_bits_est(mvs[0], pg, fused=False)
        if dual is not None:
            bits = bits + torch.where(
                dirs != 0, _mv_bits_est(mvs[1], pg, fused=False), 0.0)
    out = dict(mv=mvs[0], lev=(lyg, lug, lvg),
               cost=rd_cost_f32(ssd, lam, bits, fused=False))
    if dual is not None:
        out["mv1"] = mvs[1]
        out["dirs"] = dirs
    return out


# ----------------------------------------------------------- resolve


def _node_agg(rc, kind, nby, nbx):
    """Aggregate a rect-grid cost onto the square node grid."""
    if kind == "bth":
        return rc[0::2] + rc[1::2]
    if kind == "btv":
        return rc[:, 0::2] + rc[:, 1::2]
    if kind == "tth_o":                     # rows 4i and 4i+3
        return rc[0::4] + rc[3::4]
    if kind == "tth_m":                     # mid grid (2*nby-1, nbx), row 2i
        return rc[0::2][:nby]
    if kind == "ttv_o":
        return rc[:, 0::4] + rc[:, 3::4]
    if kind == "ttv_m":
        return rc[:, 0::2][:, :nbx]
    raise ValueError(kind)


def resolve_mtt(per_cost, rect, top: int, depth: int, lam: float):
    """Bottom-up argmin over {leaf, quad, bth, btv, tth, ttv} per node
    (the first of equal costs wins, in that order).

    per_cost: square-leaf costs per level; rect: {(kind, d): pass dict
    with a "cost" grid}.  Returns (codes per level, alive masks per
    level)."""
    sizes = node_sizes(top, depth)
    u = sizes[-1]
    lamf = float(np.float32(lam))
    best = per_cost[depth]
    codes = [None] * depth
    for d in range(depth - 1, -1, -1):
        s = sizes[d]
        nby, nbx = per_cost[d].shape
        opts = [per_cost[d] + lamf,                       # leaf: split=0
                _sum2x2(best) + 2 * lamf]                 # quad: 2 bins
        kinds = [LEAF, QUAD]

        def agg(kind):
            return _node_agg(rect[(kind, d)]["cost"], kind, nby, nbx)
        if bt_allowed(s, u):
            opts += [agg("bth") + 4 * lamf, agg("btv") + 4 * lamf]
            kinds += [BTH, BTV]
        if tt_allowed(s, u):
            opts += [(agg("tth_o") + agg("tth_m")) + 4 * lamf,
                     (agg("ttv_o") + agg("ttv_m")) + 4 * lamf]
            kinds += [TTH, TTV]
        stack = torch.stack(opts)
        sel = first_argmin(stack, 0)
        codes[d] = torch.as_tensor(kinds, dtype=torch.int32,
                                   device=stack.device)[sel]
        best = stack.min(dim=0).values
    alive = [torch.ones(per_cost[0].shape, dtype=torch.bool,
                        device=per_cost[0].device)]
    for d in range(depth):
        alive.append(_up2(alive[d] & (codes[d] == QUAD)))
    return codes, alive


def _rect_leaf_mask(code, alive, kind, nby, nbx):
    """Expand a node-level 'this node split as KIND' mask onto the rect
    grid of that kind."""
    m = alive & code
    if kind == "bth":
        return m.repeat_interleave(2, 0)
    if kind == "btv":
        return m.repeat_interleave(2, 1)
    if kind in ("tth_o", "ttv_o"):
        z = torch.zeros_like(m)
        r = torch.stack([m, z, z, m], 1 if kind == "tth_o" else 2)
        return (r.reshape(nby * 4, nbx) if kind == "tth_o"
                else r.reshape(nby, nbx * 4))
    if kind == "tth_m":
        r = torch.zeros((2 * nby - 1, nbx), dtype=torch.bool, device=m.device)
        r[0::2] = m
        return r
    if kind == "ttv_m":
        r = torch.zeros((nby, 2 * nbx - 1), dtype=torch.bool, device=m.device)
        r[:, 0::2] = m
        return r
    raise ValueError(kind)


def _paint_unit(field, kind_info, u, nuy, nux):
    """Expand a rect-grid field (leading dims (gy, gx), trailing dims kept)
    onto the (nuy, nux) unit grid at the shape's offsets; uncovered cells
    are zero/False."""
    _, _, sy, sx, y_off, x_off = kind_info
    up = _up(field, sy // u, sx // u)
    oy, ox = y_off // u, x_off // u
    out = torch.zeros((nuy, nux) + tuple(field.shape[2:]), dtype=field.dtype,
                      device=field.device)
    out[oy:oy + up.shape[0], ox:ox + up.shape[1]] = up
    return out


def _resolve_fields_mtt(sq_fields, sq_leaf, rect_fields, rect_masks,
                        shapes, sizes, u):
    """Resolve per-shape fields (squares + rects) to the unit grid.
    Painting order is irrelevant: leaves never overlap."""
    out = _field_to_unit(sq_fields, sq_leaf, sizes, u)
    nuy, nux = out.shape[:2]
    extra = out.dim() - 2
    for info in shapes:
        key = (info[0], info[1])
        mfull = _paint_unit(rect_masks[key], info, u, nuy, nux)
        f = _paint_unit(rect_fields[key], info, u, nuy, nux)
        mfull = mfull.reshape(mfull.shape + (1,) * extra)
        out = torch.where(mfull, f, out)
    return out


def _mask_levels_mtt(sq_lev, sq_leaf, rect, rect_masks, shapes, sizes, u,
                     nuy, nux):
    """Zero levels off-leaf (squares + rects); build unit-granularity
    has-residual and leaf-id grids for deblocking."""
    masked_sq, has_resid_unit, leaf_id_unit = _mask_and_locate(
        sq_lev, sq_leaf, sizes, u)
    masked_rect = {}
    for info in shapes:
        key = (info[0], info[1])
        m = rect_masks[key]
        ml = tuple(lev * m[:, :, None, None] for lev in rect[key]["lev"])
        masked_rect[key] = ml
        hr = torch.zeros(m.shape, dtype=torch.bool, device=m.device)
        for lev in ml:
            hr = hr | (lev != 0).any(3).any(2)
        mfull = _paint_unit(m, info, u, nuy, nux)
        has_resid_unit = has_resid_unit | _paint_unit(hr, info, u, nuy, nux)
        gy, gx = m.shape
        _, _, sy, sx, y_off, x_off = info
        by = (torch.arange(gy, dtype=torch.int32, device=m.device)[:, None]
              * (sy // u) + y_off // u)
        bx = (torch.arange(gx, dtype=torch.int32, device=m.device)[None, :]
              * (sx // u) + x_off // u)
        ids = _paint_unit(by * nux + bx, info, u, nuy, nux)
        leaf_id_unit = torch.where(mfull, ids, leaf_id_unit)
    return masked_sq, masked_rect, has_resid_unit, leaf_id_unit


def _rect_recon_args(rect_levels, shapes):
    return [(rect_levels[(i[0], i[1])], (i[4], i[5])) for i in shapes]


def reconstruct_mtt(mv_unit, sq_levels, rect_levels, ref_y, ref_u, ref_v,
                    qp: int, top: int, depth: int, bit_depth: int,
                    wrap_around: bool):
    """Shared enc/dec reconstruction: unit-grid MC + residual sum over all
    shape grids (P slices).  rect_levels: dict keyed like rect_shapes."""
    pred = mc_predict(ref_y, ref_u, ref_v, mv_unit, top >> depth, bit_depth,
                      wrap_around)
    return _recon(pred, sq_levels, qp, bit_depth,
                  _rect_recon_args(rect_levels, rect_shapes(top, depth)))


def reconstruct_mtt_b(mv0_unit, mv1_unit, dirs_unit, sq_levels,
                      rect_levels, ref0, ref1, qp: int, top: int,
                      depth: int, bit_depth: int, wrap_around: bool):
    """B-slice reconstruction: per-unit uni/bi combine + residual sum."""
    pred = _pred_b(ref0, ref1, mv0_unit, mv1_unit, dirs_unit, top >> depth,
                   bit_depth, wrap_around)
    return _recon(pred, sq_levels, qp, bit_depth,
                  _rect_recon_args(rect_levels, rect_shapes(top, depth)))


# ------------------------------------------------------- frame encoders


def _encode_mtt(orig, refs_pad, refs1_pad, qp, top, depth, bit_depth,
                search_range):
    """Every square and rectangular pass, the resolve and the masks, for P
    (refs1_pad None) or B.  Returns (sq passes, rect passes, codes,
    sq_leaf, rect_masks, masked_sq, masked_rect, has_resid_unit,
    leaf_id_unit)."""
    sizes = node_sizes(top, depth)
    u = sizes[-1]
    shapes = rect_shapes(top, depth)
    lam = quant.lambda_from_qp(qp, intra=False)
    lam16 = int(lam ** 0.5 * 16)
    dual = None if refs1_pad is None else (refs1_pad, int(lam ** 0.5 * 8))
    sq, parent = [], None
    for s in sizes:
        sq.append(_eval_rect_pass(orig, refs_pad, s, s, 0, 0, qp, bit_depth,
                                  search_range, lam, lam16, parent, dual))
        parent = sq[-1]["mv"]
    rect = {}
    for info in shapes:
        kind, d, sy, sx, y_off, x_off = info
        rect[(kind, d)] = _eval_rect_pass(
            orig, refs_pad, sy, sx, y_off, x_off, qp, bit_depth,
            search_range, lam, lam16, sq[d]["mv"], dual)
    codes, alive = resolve_mtt([p["cost"] for p in sq], rect, top, depth,
                               lam)
    sq_leaf = [alive[d] & (codes[d] == LEAF) for d in range(depth)]
    sq_leaf.append(alive[depth])
    rect_masks = {}
    for kind, d, *_ in shapes:
        nby, nbx = codes[d].shape
        rect_masks[(kind, d)] = _rect_leaf_mask(
            codes[d] == KIND_CODE[kind], alive[d], kind, nby, nbx)
    nuy, nux = orig[0].shape[0] // u, orig[0].shape[1] // u
    masked = _mask_levels_mtt([p["lev"] for p in sq], sq_leaf, rect,
                              rect_masks, shapes, sizes, u, nuy, nux)
    return (sq, rect, codes, sq_leaf, rect_masks) + masked


def _unit_field(key, sq, rect, sq_leaf, rect_masks, top, depth):
    sizes = node_sizes(top, depth)
    return _resolve_fields_mtt([p[key] for p in sq], sq_leaf,
                               {k: v[key] for k, v in rect.items()},
                               rect_masks, rect_shapes(top, depth), sizes,
                               sizes[-1])


def _pads(ref, wrap_around: bool):
    return (pad_ref(ref[0], MC_MARGIN, wrap_around),
            pad_ref(ref[1], MC_MARGIN // 2, wrap_around),
            pad_ref(ref[2], MC_MARGIN // 2, wrap_around))


def encode_p_frame_mtt(orig_y, orig_u, orig_v, ref_y, ref_u, ref_v,
                       qp: int, top: int = 32, depth: int = 2,
                       bit_depth: int = 8, search_range: int = 24,
                       wrap_around: bool = False):
    """Batched MTT P encode.  Returns a dict with codes / square + rect
    mv & levels / resolved unit fields / recon / deblock inputs."""
    (sq, rect, codes, sq_leaf, rect_masks, masked_sq, masked_rect,
     has_resid_unit, leaf_id_unit) = _encode_mtt(
        (orig_y, orig_u, orig_v), _pads((ref_y, ref_u, ref_v), wrap_around),
        None, qp, top, depth, bit_depth, search_range)
    mv_unit = _unit_field("mv", sq, rect, sq_leaf, rect_masks, top, depth)
    recon = reconstruct_mtt(mv_unit, masked_sq, masked_rect, ref_y, ref_u,
                            ref_v, qp, top, depth, bit_depth, wrap_around)
    return dict(codes=codes, sq_mv=[d["mv"] for d in sq],
                sq_levels=masked_sq,
                rect_mv={k: v["mv"] for k, v in rect.items()},
                rect_levels=masked_rect, rect_masks=rect_masks,
                mv_unit=mv_unit, recon=recon,
                has_resid_unit=has_resid_unit, leaf_id_unit=leaf_id_unit)


def encode_b_frame_mtt(orig_y, orig_u, orig_v, ref0, ref1, qp: int,
                       top: int = 32, depth: int = 2, bit_depth: int = 8,
                       search_range: int = 24, wrap_around: bool = False):
    """Batched MTT B encode: per-list ME + uni/bi decision at every shape
    of the lattice."""
    (sq, rect, codes, sq_leaf, rect_masks, masked_sq, masked_rect,
     has_resid_unit, leaf_id_unit) = _encode_mtt(
        (orig_y, orig_u, orig_v), _pads(ref0, wrap_around),
        _pads(ref1, wrap_around), qp, top, depth, bit_depth, search_range)
    mv0_unit, mv1_unit, dirs_unit = (
        _unit_field(k, sq, rect, sq_leaf, rect_masks, top, depth)
        for k in ("mv", "mv1", "dirs"))
    recon = reconstruct_mtt_b(mv0_unit, mv1_unit, dirs_unit, masked_sq,
                              masked_rect, tuple(ref0), tuple(ref1), qp,
                              top, depth, bit_depth, wrap_around)
    return dict(codes=codes, sq_mv0=[d["mv"] for d in sq],
                sq_mv1=[d["mv1"] for d in sq],
                sq_dirs=[d["dirs"] for d in sq],
                sq_levels=masked_sq,
                rect_mv0={k: v["mv"] for k, v in rect.items()},
                rect_mv1={k: v["mv1"] for k, v in rect.items()},
                rect_dirs={k: v["dirs"] for k, v in rect.items()},
                rect_levels=masked_rect, rect_masks=rect_masks,
                mv0_unit=mv0_unit, mv1_unit=mv1_unit, dirs_unit=dirs_unit,
                recon=recon, has_resid_unit=has_resid_unit,
                leaf_id_unit=leaf_id_unit)
