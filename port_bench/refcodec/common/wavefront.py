"""Wavefront-batched intra frame encoding and decoding.

PyTorch counterpart of `vvc_mm_tpu/common/wavefront.py` (reference:
EncSlice.cpp:1669 encodeCtus -> EncCu.cpp:499 xCompressCU; DecSlice.cpp:74
raster decode; the anti-diagonal wavefront d = 2*by + bx makes every block
of a diagonal independent).

The JAX package runs one `lax.scan` step per diagonal.  Here the scan is a
Python loop over diagonals, each diagonal's blocks batched: gather every
block's references from the state before the step, predict (the encoder:
all 67 modes, SATD + lambda * bits decision, transform and quantize),
reconstruct, then scatter.  Luma is scattered before chroma is gathered, as
in the scan step.  The scan's padded slots (invalid entries) only ever
write into the buffer's far margin, which no valid block reads: the decoder
skips them, the encoder keeps them so that its per-step outputs have the
scan's fixed shape.

The prediction tools are carried: MIP (modes 67-74 join the candidate
tensor), MRL (the chosen angular mode again on reference ring 1), IBC (12
block-aligned causal block vectors, modes IBC_BASE + k) and CCLM (chroma
from the reconstructed luma, one flag).  So are the residual tools:
dependent quantization (kernels D1/D2 on the card), RDOQ, explicit MTS,
LFNST, transform skip with BDPCM and lossless coding.  Each step batches
its candidates: the 12 IBC blocks take one gather and one SATD call, the
five MTS pairs and the LFNST candidates of all the step's luma blocks one
quantize and one dequantize call, U and V one more.  The float32 costs
keep the JAX step's operation order (see encode_intra_frame).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import cclm, depquant, intra, lfnst, mip, quant, rom, transforms
from ..device import resolve_device

MARGIN = 64            # intra buffer margin (>= 2*S + slack)
# Intra block copy: block-aligned BV candidates (in block units), all causal
# under the wavefront order d = 2*by + bx (reference: IBC / IbcHashMap
# hash-ME over the reconstructed area; here a fixed candidate set)
IBC_BVS: tuple[tuple[int, int], ...] = (
    (0, -1), (0, -2), (0, -3), (0, -4),
    (-1, 0), (-1, -1), (-1, 1), (-1, -2),
    (-2, 0), (-2, 1), (-2, -1), (-2, 2))
IBC_BASE = 128         # block modes >= IBC_BASE are IBC (mode - base = BV idx)


@functools.lru_cache(maxsize=None)
def wavefront_coords(nby: int, nbx: int) -> tuple[np.ndarray, np.ndarray]:
    """Static wavefront schedule.

    Returns (coords, valid): coords (steps, bmax, 2) int32 block indices,
    valid (steps, bmax) bool.  Wavefront d = 2*by + bx."""
    dmax = 2 * (nby - 1) + (nbx - 1)
    rows = []
    for d in range(dmax + 1):
        blocks = [(by, d - 2 * by) for by in range(nby)
                  if 0 <= d - 2 * by < nbx]
        rows.append(blocks)
    bmax = max(len(r) for r in rows)
    coords = np.zeros((len(rows), bmax, 2), dtype=np.int32)
    valid = np.zeros((len(rows), bmax), dtype=bool)
    for i, r in enumerate(rows):
        for k, (by, bx) in enumerate(r):
            coords[i, k] = (by, bx)
            valid[i, k] = True
    return coords, valid


def grid_to_steps(grid: np.ndarray, coords: np.ndarray,
                  valid: np.ndarray) -> np.ndarray:
    """(nby, nbx, ...) grid -> (steps, bmax, ...) scan order (host)."""
    out = np.zeros(coords.shape[:2] + grid.shape[2:], grid.dtype)
    v = valid.reshape(-1)
    by = coords[..., 0].reshape(-1)[v]
    bx = coords[..., 1].reshape(-1)[v]
    flat = out.reshape((-1,) + grid.shape[2:])
    flat[v] = grid[by, bx]
    return flat.reshape(out.shape)


def mpm3_host(left: int, above: int) -> list[int]:
    """3-entry MPM list for the entropy coders (host mirror of _mpm3;
    simplified HEVC-style derivation)."""
    l = max(left, 0)
    a = max(above, 0)
    if l == a:
        if l < 2:
            return [0, 1, 50]
        return [l, 2 + ((l - 2 + 64) % 65), 2 + ((l - 2 + 1) % 65)]
    for c in (0, 1, 50, 18, 2):
        if c != l and c != a:
            return [l, a, c]
    raise AssertionError


def _gather_cref(buf: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                 s: int) -> torch.Tensor:
    """Combined intra reference vectors [left reversed, corner, top] for
    blocks at padded-buffer coords (y0, x0): (B, 4s+1)."""
    ln = 2 * s
    ar = torch.arange(ln, device=buf.device)
    left = buf[y0[:, None] + ar[None, :], (x0 - 1)[:, None]]     # (B, ln)
    ar1 = torch.arange(ln + 1, device=buf.device)
    top = buf[(y0 - 1)[:, None], x0[:, None] - 1 + ar1[None, :]]  # (B, ln+1)
    return torch.cat([torch.flip(left, [1]), top], 1)


def _cref_index(y0: np.ndarray, x0: np.ndarray, s: int, shape
                ) -> tuple[np.ndarray, np.ndarray]:
    """Row and column indices (..., 4s+1) of _gather_cref's vector for
    blocks at (y0, x0) of a buffer of `shape`, as one gather.  The start of
    each run is clamped so that the run stays inside the buffer, as a
    dynamic slice's is: that only ever moves the dead-zone reads of masked
    lanes."""
    ln = 2 * s
    ly = np.clip(y0, 0, shape[0] - ln)[..., None] + np.arange(ln)[::-1]
    lx = np.broadcast_to(np.clip(x0 - 1, 0, shape[1] - 1)[..., None],
                         ly.shape)
    tx = np.clip(x0 - 1, 0, shape[1] - (ln + 1))[..., None] \
        + np.arange(ln + 1)
    ty = np.broadcast_to(np.clip(y0 - 1, 0, shape[0] - 1)[..., None],
                         tx.shape)
    return np.concatenate([ly, ty], -1), np.concatenate([lx, tx], -1)


def _block_index(y0: torch.Tensor, x0: torch.Tensor, s: int):
    ar = torch.arange(s, device=y0.device)
    return (y0[:, None, None] + ar[None, :, None],
            x0[:, None, None] + ar[None, None, :])


def _gather_blocks(buf: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                   s: int) -> torch.Tensor:
    """The (s, s) blocks at padded-buffer coords (y0, x0), any leading
    shape: (..., s, s)."""
    return _gather_rect(buf, y0, x0, s, s)


def _gather_rect(buf: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                 h: int, w: int) -> torch.Tensor:
    """The (h, w) rectangles at (y0, x0), any leading shape, each start
    clamped into the buffer as a dynamic slice's is (only masked lanes at
    the far margin corner reach the clamp, and their values are unused)."""
    y0 = torch.clamp(y0, 0, buf.shape[0] - h)
    x0 = torch.clamp(x0, 0, buf.shape[1] - w)
    ay = torch.arange(h, device=buf.device)
    ax = torch.arange(w, device=buf.device)
    return buf[y0[..., None, None] + ay[:, None],
               x0[..., None, None] + ax[None, :]]


def _ibc_stack(buf: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
               s: int) -> torch.Tensor:
    """The blocks at the 12 IBC_BVS offsets of each (y0, x0): (B, 12, s, s)
    as one gather."""
    bv = torch.tensor(IBC_BVS, dtype=y0.dtype, device=y0.device) * s
    return _gather_blocks(buf, y0[:, None] + bv[:, 0],
                          x0[:, None] + bv[:, 1], s)


def _take(stack: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """stack[b, k[b]] of a (B, K, ...) stack."""
    idx = k.long().reshape((-1, 1) + (1,) * (stack.dim() - 2))
    return torch.gather(stack, 1, idx.expand(
        (-1, 1) + stack.shape[2:]))[:, 0]


def _cclm_luma_ctx(ry: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                   s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Downsampled luma block and downsampled luma border (top | left) for
    the CCLM model (reference: IntraPrediction.cpp xGetLumaRecPixels)."""
    dsl = cclm.downsample_luma(_gather_blocks(ry, y0, x0, s))
    top2 = _gather_rect(ry, y0 - 2, x0, 2, s)          # (B, 2, s)
    left2 = _gather_rect(ry, y0, x0 - 2, s, 2)         # (B, s, 2)
    dsl_top = (top2[:, 0, 0::2] + top2[:, 0, 1::2]
               + top2[:, 1, 0::2] + top2[:, 1, 1::2] + 2) >> 2
    dsl_left = (left2[:, 0::2, 0] + left2[:, 1::2, 0]
                + left2[:, 0::2, 1] + left2[:, 1::2, 1] + 2) >> 2
    return dsl, torch.cat([dsl_top, dsl_left], 1)


def _cclm_pred(plane_r: torch.Tensor, y0c: torch.Tensor,
               x0c: torch.Tensor, sc: int, dsl: torch.Tensor,
               border_l: torch.Tensor, bit_depth: int) -> torch.Tensor:
    ctop = _gather_rect(plane_r, y0c - 1, x0c, 1, sc)[:, 0, :]
    cleft = _gather_rect(plane_r, y0c, x0c - 1, sc, 1)[:, :, 0]
    a, b = cclm.cclm_params(border_l, torch.cat([ctop, cleft], 1))
    return cclm.cclm_predict(dsl, a, b, bit_depth)


def _predict_uv(cref: torch.Tensor, mode: torch.Tensor, s: int
                ) -> torch.Tensor:
    """U and V of B blocks predicted in one batch: cref (2B, L), U's
    reference vectors then V's, each block's mode -> (B, 2, s, s)."""
    b = mode.shape[0]
    return intra.predict_mode(cref, mode.repeat(2), s, s).reshape(
        2, b, s, s).transpose(0, 1)


def _quant_pair(coeff, levels, qp: int, log2s: int, bit_depth: int,
                intra_slice: bool, dep: bool, rdoq: bool = False):
    """Quantize `coeff` (when `levels` is None) and dequantize, with
    dependent quantization, RDOQ or neither (dep takes precedence, as in
    the JAX package).  Returns (levels, dequantized coefficients)."""
    if levels is None:
        if dep:
            levels = depquant.quantize_dep(coeff, qp, log2s, log2s,
                                           bit_depth)
        elif rdoq:
            levels = quant.quantize_rdoq(coeff, qp, log2s, log2s,
                                         bit_depth, intra=intra_slice)
        else:
            levels = quant.quantize(coeff, qp, log2s, log2s, bit_depth,
                                    intra=intra_slice)
    if dep:
        dq = depquant.dequantize_dep(levels, qp, log2s, log2s, bit_depth)
    else:
        dq = quant.dequantize(levels, qp, log2s, log2s, bit_depth)
    return levels, dq


def _tq_reconstruct(pred: torch.Tensor, resid: torch.Tensor | None,
                    levels: torch.Tensor | None, qp: int, s: int,
                    bit_depth: int, intra_slice: bool, luma: bool = True,
                    dep: bool = False, rdoq: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared transform/quant/reconstruct: the encoder passes resid (the
    levels are computed), the decoder passes levels.  Returns
    (levels, recon_block).

    Implicit MTS: small luma intra blocks (4..16) use DST-7 in both
    directions (reference: TrQuant.cpp:619 getTrTypes).  `dep` switches
    to dependent quantization, `rdoq` (without dep) to RDOQ."""
    log2s = s.bit_length() - 1
    tr = (rom.DST7 if (intra_slice and luma and 4 <= s <= 16)
          else rom.DCT2)
    coeff = (None if levels is not None else
             transforms.forward_transform(resid, tr, tr,
                                          bit_depth=bit_depth))
    levels, dq = _quant_pair(coeff, levels, qp, log2s, bit_depth,
                             intra_slice, dep, rdoq)
    r = transforms.inverse_transform(dq, tr, tr, bit_depth=bit_depth)
    return levels, torch.clamp(pred + r, 0, (1 << bit_depth) - 1)


# Explicit MTS transform pairs (horizontal, vertical), indexed by
# tu_mts_idx (reference: TrQuant.cpp:619 getTrTypes — MTS_DCT2_DCT2,
# MTS_DST7_DST7, MTS_DCT8_DST7, MTS_DST7_DCT8, MTS_DCT8_DCT8)
MTS_PAIRS = ((rom.DCT2, rom.DCT2), (rom.DST7, rom.DST7),
             (rom.DCT8, rom.DST7), (rom.DST7, rom.DCT8),
             (rom.DCT8, rom.DCT8))


@functools.lru_cache(maxsize=None)
def _lfnst_ids(device: torch.device) -> torch.Tensor:
    """The candidate indices 1 .. N_LFNST_CAND on `device` (read-only)."""
    return torch.arange(1, lfnst.N_LFNST_CAND + 1, device=device)


def _lfnst_inverse_sel(dq: torch.Tensor, mode: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """The decoder's inverse LFNST: each block's signalled index (0 off)."""
    ids = _lfnst_ids(dq.device)
    inv = lfnst.inverse(dq[None].expand(len(ids), -1, -1, -1),
                        lfnst.mode_class(mode), ids)
    out = dq
    for i in range(len(ids)):
        out = torch.where((idx == i + 1)[:, None, None], inv[i], out)
    return out


def _tq_lfnst_decode(pred, levels, mode, idx, qp: int, s: int,
                     bit_depth: int, dep: bool) -> torch.Tensor:
    """Decoder-side luma reconstruction with a per-block LFNST index."""
    tr = rom.DST7 if 4 <= s <= 16 else rom.DCT2
    _, dq = _quant_pair(None, levels, qp, s.bit_length() - 1, bit_depth,
                        True, dep)
    r = transforms.inverse_transform(_lfnst_inverse_sel(dq, mode, idx), tr,
                                     tr, bit_depth=bit_depth)
    return torch.clamp(pred + r, 0, (1 << bit_depth) - 1)


def _tq_mts_decode(pred, levels, mode, mts_idx, lfnst_idx, qp: int, s: int,
                   bit_depth: int, dep: bool, use_lfnst: bool
                   ) -> torch.Tensor:
    """Decoder-side luma reconstruction under explicit MTS (+LFNST): the
    five inverse transforms as one stacked product, each block taking its
    signalled pair."""
    _, dq = _quant_pair(None, levels, qp, s.bit_length() - 1, bit_depth,
                        True, dep)
    if use_lfnst:
        dq = _lfnst_inverse_sel(dq, mode, lfnst_idx)
    r = transforms.inverse_transform_pairs(
        dq[None].expand(len(MTS_PAIRS), -1, -1, -1), MTS_PAIRS, bit_depth)
    idx = mts_idx.long().reshape(1, -1, 1, 1).expand(1, -1, s, s)
    r = torch.gather(r, 0, idx)[0]
    return torch.clamp(pred + r, 0, (1 << bit_depth) - 1)


def _bdpcm_cumsum(d: torch.Tensor, horizontal: bool) -> torch.Tensor:
    return torch.cumsum(d, dim=-1 if horizontal else -2).to(torch.int32)


def _ts_recon(pred: torch.Tensor, q: torch.Tensor, qp: int, maxv: int
              ) -> torch.Tensor:
    return torch.clamp(pred + quant.dequantize_ts(q, qp), 0, maxv)


def decode_intra_frame(modes_steps, lev_y, lev_u, lev_v, qp: int,
                       height: int, width: int, block_size: int = 8,
                       bit_depth: int = 8, device=None,
                       dep_quant: bool = False, use_lfnst: bool = False,
                       lfnst_steps=None, use_ts: bool = False,
                       ts_steps=None, lossless: bool = False,
                       use_mts: bool = False, mts_steps=None,
                       use_cclm: bool = False, cclm_steps=None,
                       use_mip: bool = False, use_mrl: bool = False,
                       mrl_steps=None, use_ibc: bool = False):
    """Wavefront intra decode from parsed modes/levels in scan order
    ((steps, bmax) and (steps, bmax, s, s) arrays, see grid_to_steps), and
    the CCLM / MRL / LFNST / transform-skip / MTS grids of the tools that
    are on.  Returns dict(y, u, v) of int32 planes on `device` (CUDA
    unless another device is named)."""
    dev = resolve_device(device)
    s = block_size
    sc = s // 2
    h, w = height, width
    nby, nbx = h // s, w // s
    mid = 1 << (bit_depth - 1)
    maxv = (1 << bit_depth) - 1
    coords, valid = wavefront_coords(nby, nbx)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    modes_steps, lev_y, lev_u, lev_v = (t(a) for a in (modes_steps, lev_y,
                                                      lev_u, lev_v))
    zero_steps = torch.zeros_like(modes_steps)
    lf_steps, ts_steps, mt_steps, lm_steps, mr_steps = (
        zero_steps if a is None else t(a)
        for a in (lfnst_steps, ts_steps, mts_steps, cclm_steps, mrl_steps))
    ry = torch.full((h + 2 * MARGIN, w + 2 * MARGIN), mid, dtype=torch.int32,
                    device=dev)
    ru = torch.full((h // 2 + 2 * MARGIN, w // 2 + 2 * MARGIN), mid,
                    dtype=torch.int32, device=dev)
    rv = ru.clone()
    coords_t = t(coords).to(torch.int64)
    for step in range(coords.shape[0]):
        n = int(valid[step].sum())        # valid slots lead each step
        by, bx = coords_t[step, :n, 0], coords_t[step, :n, 1]
        mode = modes_steps[step, :n]
        ly = lev_y[step, :n]
        y0, x0 = MARGIN + by * s, MARGIN + bx * s
        y0c, x0c = MARGIN + by * sc, MARGIN + bx * sc
        nb_mode = torch.where(mode >= 67, 0, mode)
        cref = _gather_cref(ry, y0, x0, s)
        pred = intra.predict_mode(cref, nb_mode, s, s)
        if use_mrl:
            pred1 = intra.predict_mode(_gather_cref(ry, y0 - 1, x0 - 1, s),
                                       nb_mode, s, s)
            pred = torch.where(mr_steps[step, :n][:, None, None] > 0, pred1,
                               pred)
        if use_mip:
            pmip = mip.predict_mip_mode(
                cref, torch.clamp(mode - 67, 0, mip.N_MIP_MODES - 1), s,
                bit_depth)
            pred = torch.where(((mode >= 67) & (mode < IBC_BASE))
                               [:, None, None], pmip, pred)
        if use_ibc:
            is_ibc = mode >= IBC_BASE
            kbv = torch.clamp(mode - IBC_BASE, 0, len(IBC_BVS) - 1)
            pred = torch.where(is_ibc[:, None, None],
                               _take(_ibc_stack(ry, y0, x0, s), kbv), pred)
        if lossless:
            rec = _ts_recon(pred, ly, qp, maxv)
        else:
            if use_mts:
                rec = _tq_mts_decode(pred, ly, mode, mt_steps[step, :n],
                                     lf_steps[step, :n], qp, s, bit_depth,
                                     dep_quant, use_lfnst)
            elif use_lfnst:
                rec = _tq_lfnst_decode(pred, ly, mode, lf_steps[step, :n],
                                       qp, s, bit_depth, dep_quant)
            else:
                _, rec = _tq_reconstruct(pred, None, ly, qp, s, bit_depth,
                                         True, dep=dep_quant)
            if use_ts:
                # tsm 1: plain transform skip; 2/3: BDPCM H/V (the levels
                # hold the DPCM differences: cumsum, then dequantize)
                sel = ts_steps[step, :n][:, None, None]
                rec = torch.where(sel == 1, _ts_recon(pred, ly, qp, maxv),
                                  rec)
                for k, hor in ((2, True), (3, False)):
                    rec = torch.where(sel == k, _ts_recon(
                        pred, _bdpcm_cumsum(ly, hor), qp, maxv), rec)
        ry[_block_index(y0, x0, s)] = rec.to(torch.int32)
        predc = _predict_uv(torch.cat([_gather_cref(buf, y0c, x0c, sc)
                                       for buf in (ru, rv)]), nb_mode, sc)
        if use_cclm:
            dsl, border_l = _cclm_luma_ctx(ry, y0, x0, s)
            predlm = torch.stack([
                _cclm_pred(buf, y0c, x0c, sc, dsl, border_l, bit_depth)
                for buf in (ru, rv)], 1)
            predc = torch.where(lm_steps[step, :n][:, None, None, None] > 0,
                                predlm, predc)
        if use_ibc:
            cpatch = torch.stack([_take(_ibc_stack(buf, y0c, x0c, sc), kbv)
                                  for buf in (ru, rv)], 1)
            predc = torch.where(is_ibc[:, None, None, None], cpatch, predc)
        levc = torch.stack([lev_u[step, :n], lev_v[step, :n]], 1)
        if lossless:
            recc = _ts_recon(predc, levc, qp, maxv)
        else:
            _, recc = _tq_reconstruct(predc.reshape(2 * n, sc, sc), None,
                                      levc.reshape(2 * n, sc, sc), qp, sc,
                                      bit_depth, True, luma=False,
                                      dep=dep_quant)
            recc = recc.reshape(n, 2, sc, sc)
        ru[_block_index(y0c, x0c, sc)] = recc[:, 0].to(torch.int32)
        rv[_block_index(y0c, x0c, sc)] = recc[:, 1].to(torch.int32)
    return dict(y=ry[MARGIN:MARGIN + h, MARGIN:MARGIN + w],
                u=ru[MARGIN:MARGIN + h // 2, MARGIN:MARGIN + w // 2],
                v=rv[MARGIN:MARGIN + h // 2, MARGIN:MARGIN + w // 2])
