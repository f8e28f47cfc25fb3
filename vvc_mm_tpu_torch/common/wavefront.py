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
from .rdcost import first_argmin, satd
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


def steps_to_grid(outs_steps: np.ndarray, coords: np.ndarray,
                  valid: np.ndarray) -> np.ndarray:
    """Inverse of grid_to_steps: per-step outputs (steps, bmax, ...) ->
    (nby, nbx, ...) grid (host)."""
    nby = coords[..., 0].max() + 1
    nbx = coords[..., 1].max() + 1
    out = np.zeros((nby, nbx) + outs_steps.shape[2:], outs_steps.dtype)
    v = valid.reshape(-1)
    by = coords[..., 0].reshape(-1)[v]
    bx = coords[..., 1].reshape(-1)[v]
    out[by, bx] = outs_steps.reshape((-1,) + outs_steps.shape[2:])[v]
    return out


def _mpm3(left: torch.Tensor, above: torch.Tensor) -> torch.Tensor:
    """Vectorised 3-entry MPM list, (B,) x2 -> (B, 3): mpm3_host for a
    batch (simplified HEVC-style derivation; the encoder's decision and
    the entropy coder share it)."""
    l = torch.where(left < 0, 0, left)
    a = torch.where(above < 0, 0, above)
    eq = l == a
    ang = eq & (l >= 2)
    prev = 2 + ((l - 2 + 64) % 65)
    nxt = 2 + ((l - 2 + 1) % 65)
    third = torch.full_like(l, 2)        # first of these neither l nor a
    for c in (18, 50, 1, 0):
        third = torch.where((l != c) & (a != c), c, third)
    m0 = torch.where(ang, l, torch.where(eq, 0, l))
    m1 = torch.where(ang, prev, torch.where(eq, 1, a))
    m2 = torch.where(ang, nxt, torch.where(eq, 50, third))
    return torch.stack([m0, m1, m2], dim=1).to(torch.int32)


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


def _pad_to_buffer(plane: torch.Tensor, fill: int) -> torch.Tensor:
    h, w = plane.shape
    buf = torch.full((h + 2 * MARGIN, w + 2 * MARGIN), fill,
                     dtype=torch.int32, device=plane.device)
    buf[MARGIN:MARGIN + h, MARGIN:MARGIN + w] = plane
    return buf


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


def _rate_est(lev: torch.Tensor) -> torch.Tensor:
    """Cheap bits estimate of (..., s, s) level blocks (encoder decision
    only): 2 + 2*log2(|l|+1) a nonzero level, 0.3 a zero, summed in
    float32 in XLA's CPU order for the JAX package's blocks (each row
    left to right, then the row sums pairwise: (r0+r4)+(r2+r6) ... for 8
    rows), so that equal levels give equal sums on every device."""
    v = torch.where(lev != 0, quant.log2_rate(lev.abs(), 2.0), 0.3)
    acc = v[..., 0]
    for c in range(1, v.shape[-1]):
        acc = acc + v[..., c]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


def _rd_cost(rec: torch.Tensor, target: torch.Tensor, bits: torch.Tensor,
             lam: float) -> torch.Tensor:
    """float32 ssd + lam * bits over the last two axes, as the JAX package
    computes it on the CPU, where XLA fuses the product and the add into
    one multiply-add (exact in float64 here, then rounded once)."""
    ssd = ((rec - target) ** 2).sum((-2, -1)).to(torch.float32)
    return (ssd.to(torch.float64)
            + float(np.float32(lam)) * bits.to(torch.float64)).to(
                torch.float32)


def _pick(cost: torch.Tensor, *stacks: torch.Tensor) -> tuple:
    """First-argmin over the leading candidate axis of `cost` ((P, B)):
    (pick, and each (P, B, ...) stack's chosen (B, ...) entries)."""
    pick = first_argmin(cost, 0)
    out = []
    for st in stacks:
        idx = pick.reshape((1, -1) + (1,) * (st.dim() - 2)).expand(
            (1,) + st.shape[1:])
        out.append(torch.gather(st, 0, idx)[0])
    return (pick, *out)


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


@functools.lru_cache(maxsize=None)
def _extra_bits(bits: tuple, device: torch.device) -> torch.Tensor:
    """(P, 1) float32 signalling bits of P candidates on `device`, copied
    there once (read-only)."""
    return torch.tensor(bits, dtype=torch.float32, device=device)[:, None]


def _tq_candidates(pred, resid, coeff, pairs, n_lfnst: int, cls,
                   extra_bits: tuple, qp: int, s: int, bit_depth: int,
                   dep: bool):
    """Quantize, reconstruct and cost (P, B, s, s) candidate coefficient
    sets at once (one quantize and one dequantize call for all of them,
    each block independent of its neighbours, so the batch is exact): the
    last `n_lfnst` candidates invert LFNST indices 1 .. n_lfnst, then
    candidate p inverts the transform pair pairs[p].  Returns (levels,
    recons, costs)."""
    n_p, b = coeff.shape[:2]
    log2s = s.bit_length() - 1
    lev, dq = _quant_pair(coeff.reshape(n_p * b, s, s), None, qp, log2s,
                          bit_depth, True, dep)
    lev = lev.reshape(n_p, b, s, s)
    dq = dq.reshape(n_p, b, s, s)
    if n_lfnst:
        k = n_p - n_lfnst
        dq = torch.cat([dq[:k], lfnst.inverse(dq[k:], cls,
                                              _lfnst_ids(dq.device))])
    r = transforms.inverse_transform_pairs(dq, pairs, bit_depth)
    rec = torch.clamp(pred + r, 0, (1 << bit_depth) - 1)
    bits = _rate_est(lev) + _extra_bits(extra_bits, lev.device)
    cost = _rd_cost(rec, pred + resid, bits,
                    quant.lambda_from_qp(qp, intra=True))
    return lev, rec, cost


def _tq_lfnst_encode(pred: torch.Tensor, resid: torch.Tensor,
                     mode: torch.Tensor, qp: int, s: int, bit_depth: int,
                     dep: bool):
    """Luma TQ with a per-block LFNST index RD choice (reference:
    IntraSearch LFNST loop; TrQuant.cpp:238/262) over the implicit
    transform's coefficients.  Returns (levels, recon, lfnst_idx)."""
    tr = rom.DST7 if 4 <= s <= 16 else rom.DCT2
    coeff = transforms.forward_transform(resid, tr, tr, bit_depth=bit_depth)
    cls = lfnst.mode_class(mode)
    ids = _lfnst_ids(coeff.device)
    cands = torch.cat([coeff[None], lfnst.forward(
        coeff[None].expand(len(ids), -1, -1, -1), cls, ids)])
    lev, rec, cost = _tq_candidates(
        pred, resid, cands, ((tr, tr),) * (1 + len(ids)), len(ids), cls,
        (1.0,) + (2.0,) * len(ids), qp, s, bit_depth, dep)
    pick, lev, rec = _pick(cost, lev, rec)
    pick = torch.where((lev != 0).any(-1).any(-1), pick, 0)
    return lev, rec, pick.to(torch.int32)


def _tq_mts_encode(pred: torch.Tensor, resid: torch.Tensor,
                   mode: torch.Tensor, qp: int, s: int, bit_depth: int,
                   dep: bool, use_lfnst: bool):
    """Luma TQ with an explicit-MTS (and optional LFNST) per-block RD
    choice: the five transform pairs, plus the LFNST candidates on the
    DCT-2 coefficients (LFNST combines with mts_idx 0 only; reference:
    IntraSearch MTS loop, TrQuant getTrTypes).  The five forward and
    inverse transforms are one product each over the stacked matrices.
    Returns (levels, recon, lfnst_idx, mts_idx)."""
    coeff = transforms.forward_transform_pairs(resid, MTS_PAIRS, bit_depth)
    n_m = len(MTS_PAIRS)
    pairs, n_lf, extra = MTS_PAIRS, 0, (1.0, 2.0, 3.0, 4.0, 5.0)
    cls = None
    if use_lfnst:
        cls = lfnst.mode_class(mode)
        ids = _lfnst_ids(coeff.device)
        coeff = torch.cat([coeff, lfnst.forward(
            coeff[:1].expand(len(ids), -1, -1, -1), cls, ids)])
        n_lf = len(ids)
        pairs = pairs + ((rom.DCT2, rom.DCT2),) * n_lf
        extra = extra + (3.0,) * n_lf
    lev, rec, cost = _tq_candidates(pred, resid, coeff, pairs, n_lf, cls,
                                    extra, qp, s, bit_depth, dep)
    pick, lev, rec = _pick(cost, lev, rec)
    cbf = (lev != 0).any(-1).any(-1)
    lfnst_idx = torch.where(cbf & (pick >= n_m), pick - (n_m - 1), 0)
    mts_idx = torch.where(cbf & (pick < n_m), pick, 0)
    return lev, rec, lfnst_idx.to(torch.int32), mts_idx.to(torch.int32)


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


def _bdpcm_diff(q: torch.Tensor, horizontal: bool) -> torch.Tensor:
    """Quantized-residual DPCM: coded value = q - the left (above) q
    (reference: BDPCM, CABACReader residual_codingTS + Quant BDPCM path)."""
    prev = torch.zeros_like(q)
    if horizontal:
        prev[..., :, 1:] = q[..., :, :-1]
    else:
        prev[..., 1:, :] = q[..., :-1, :]
    return q - prev


def _bdpcm_cumsum(d: torch.Tensor, horizontal: bool) -> torch.Tensor:
    return torch.cumsum(d, dim=-1 if horizontal else -2).to(torch.int32)


def _ts_recon(pred: torch.Tensor, q: torch.Tensor, qp: int, maxv: int
              ) -> torch.Tensor:
    return torch.clamp(pred + quant.dequantize_ts(q, qp), 0, maxv)


def _ts_choice(ob, pred, pall, mode, lev_y, rec, lfnst_idx, mtsm, qp: int,
               use_bdpcm: bool, maxv: int):
    """Per-block RD over {regular, transform skip, BDPCM-H, BDPCM-V}
    (reference: transform_skip_flag + intra_bdpcm_luma_flag; a BDPCM
    block's signalled mode becomes HOR 18 / VER 50).  Returns (tsm, lev,
    rec, lfnst_idx, mtsm, mode)."""
    zero = torch.zeros_like(mode)
    lev1 = quant.quantize_ts(ob - pred, qp, intra=True)
    levs, recs = [lev_y, lev1], [rec, _ts_recon(pred, lev1, qp, maxv)]
    lfs, mts, modes = [lfnst_idx, zero], [mtsm, zero], [mode, mode]
    extra = (1.0, 2.0)
    if use_bdpcm:
        for hor, bmode in ((True, 18), (False, 50)):
            predb = pall[:, bmode]
            qb = quant.quantize_ts(ob - predb, qp, intra=True)
            levs.append(_bdpcm_diff(qb, hor))
            recs.append(_ts_recon(predb, qb, qp, maxv))
            lfs.append(zero)
            mts.append(zero)
            modes.append(torch.full_like(mode, bmode))
            extra += (3.0,)
    levs, recs = torch.stack(levs), torch.stack(recs)
    bits = _rate_est(levs) + _extra_bits(extra, levs.device)
    cost = _rd_cost(recs, ob, bits, quant.lambda_from_qp(qp, intra=True))
    return _pick(cost, levs, recs, torch.stack(lfs), torch.stack(mts),
                 torch.stack(modes))


def encode_intra_frame(orig_y: torch.Tensor, orig_u: torch.Tensor,
                       orig_v: torch.Tensor, qp: int, block_size: int = 8,
                       bit_depth: int = 8, dep_quant: bool = False,
                       use_lfnst: bool = False, use_ts: bool = False,
                       use_bdpcm: bool = False, lossless: bool = False,
                       use_mts: bool = False, use_rdoq: bool = False,
                       use_cclm: bool = False, use_mip: bool = False,
                       use_mrl: bool = False, use_ibc: bool = False,
                       stats: dict | None = None):
    """Closed-loop wavefront intra encode of one frame, on the device of
    the planes it is given.  The prediction tools: MIP, MRL, IBC, CCLM.
    The residual tools: dependent quantization, RDOQ (shadowed by
    dep_quant and unused under MTS/LFNST, as in the JAX package), explicit
    MTS, LFNST, transform skip with BDPCM, lossless.

    The float32 decision costs are the JAX step's: the mode costs
    dist + lam*bits take the products lam*bits rounded (constants c2, c3,
    c5, c7), MRL's cost is (d1 + lam) + best*0, IBC's min(d) + lam*5 with
    lam*5 rounded once from double, as XLA folds the Python scalars.

    With `stats` (a dict), the counts of blocks whose IBC or MRL choice the
    transform-skip / BDPCM pick overrode are added to its "ts_over_ibc"
    and "ts_over_mrl" (one host sync a step); "ts1_over_mrl" counts the
    MRL blocks that plain transform skip took: the JAX package codes them
    without the MRL flag but reconstructs them from ring 1, so its decoder
    (and the port's) does not reproduce them.

    Returns (outs, recon): outs the nine per-step outputs of the JAX scan
    in its order (mode, lm_flag, lfnst_idx, mrl, tsm, mtsm of shape
    (steps, bmax); lev_y, lev_u, lev_v of shape (steps, bmax, s, s) and
    (steps, bmax, s/2, s/2)); recon the dict(y, u, v) of reconstructed
    planes (exact decoder output)."""
    dev = orig_y.device
    s = block_size
    sc = s // 2
    h, w = orig_y.shape
    nby, nbx = h // s, w // s
    mid = 1 << (bit_depth - 1)
    maxv = (1 << bit_depth) - 1
    # sqrt(lambda) is a Python float in the JAX step: times a float32 bit
    # count it is rounded to float32 first; times a Python 5.0 (IBC) the
    # double product is rounded
    lam_d = math.sqrt(quant.lambda_from_qp(qp, intra=True))
    lam_satd = np.float32(lam_d)
    c2, c3, c5, c7 = (float(lam_satd * np.float32(b))
                      for b in (2.0, 3.0, 5.0, 7.0))
    c1, c_ibc = float(lam_satd), float(np.float32(lam_d * 5.0))

    coords, valid = wavefront_coords(nby, nbx)
    oy, ou, ov = (_pad_to_buffer(p, mid) for p in (orig_y, orig_u, orig_v))
    ry, ru, rv = (torch.full_like(p, mid) for p in (oy, ou, ov))
    mode_map = torch.full((nby + 1, nbx + 1), -1, dtype=torch.int32,
                          device=dev)
    n_modes = 67 + (mip.N_MIP_MODES if use_mip else 0)
    modes_grid = torch.arange(n_modes, dtype=torch.int32, device=dev)[None]

    # every step's coordinates at once; masked lanes go to the dead zone
    # in the far margin corner, and to pad cell (0, 0) of the mode map, so
    # that their duplicate writes are deterministic
    by_np, bx_np = coords[..., 0].astype(np.int64), \
        coords[..., 1].astype(np.int64)

    def t(a):
        return torch.as_tensor(a, device=dev)

    vld_all = t(valid)
    by_all, bx_all = t(by_np), t(bx_np)
    y0_np = np.where(valid, MARGIN + by_np * s, ry.shape[0] - s - 4)
    x0_np = np.where(valid, MARGIN + bx_np * s, ry.shape[1] - s - 4)
    y0c_np = np.where(valid, MARGIN + by_np * sc, ru.shape[0] - sc - 4)
    x0c_np = np.where(valid, MARGIN + bx_np * sc, ru.shape[1] - sc - 4)
    y0_all, x0_all, y0c_all, x0c_all = (
        t(a) for a in (y0_np, x0_np, y0c_np, x0c_np))
    cy_all, cx_all = (t(a) for a in _cref_index(y0_np, x0_np, s, ry.shape))
    cy1_all, cx1_all = (t(a) for a in _cref_index(y0_np - 1, x0_np - 1, s,
                                                  ry.shape))
    ccy_all, ccx_all = (
        t(a) for a in _cref_index(y0c_np, x0c_np, sc, ru.shape))
    my_all = t(np.where(valid, 1 + by_np, 0))
    mx_all = t(np.where(valid, 1 + bx_np, 0))
    bv_np = np.array(IBC_BVS, np.int64)
    ibc_ok_all = t((by_np[..., None] + bv_np[:, 0] >= 0)
                   & (bx_np[..., None] + bv_np[:, 1] >= 0)
                   & (bx_np[..., None] + bv_np[:, 1] < nbx))
    # the originals never change: one gather for all steps
    ob_all = _gather_blocks(oy, y0_all, x0_all, s)
    obc_all = torch.stack([_gather_blocks(ou, y0c_all, x0c_all, sc),
                           _gather_blocks(ov, y0c_all, x0c_all, sc)], 2)

    outs = [[] for _ in range(9)]
    zero = torch.zeros(coords.shape[1], dtype=torch.int32, device=dev)
    for step in range(coords.shape[0]):
        vld = vld_all[step]
        by, bx = by_all[step], bx_all[step]
        y0, x0 = y0_all[step], x0_all[step]
        y0c, x0c = y0c_all[step], x0c_all[step]
        # ---- luma decision
        cref = ry[cy_all[step], cx_all[step]]
        pall = intra.predict_all_modes(cref, s, s)           # (B, 67, s, s)
        if use_mip:
            # the matrix modes join the candidate tensor (indices 67..)
            pall = torch.cat([pall, mip.predict_mip_all(cref, s, bit_depth)],
                             1)
        ob = ob_all[step]
        dist = satd(pall, ob[:, None]).to(torch.float32)     # (B, modes)
        lm = mode_map[1 + by, bx]       # left neighbour (by, bx-1)
        am = mode_map[by, 1 + bx]       # above neighbour
        mpm = _mpm3(lm, am)
        bits_cost = torch.where(
            modes_grid == mpm[:, 0:1], c2,
            torch.where((modes_grid == mpm[:, 1:2])
                        | (modes_grid == mpm[:, 2:3]), c3, c7))
        if use_mip:
            # mip_flag + a fixed 3-bit mode index
            bits_cost = torch.where(modes_grid >= 67, c5, bits_cost)
        cost = dist + bits_cost
        mode = first_argmin(cost, dim=1)
        pred = _take(pall, mode)
        mode = mode.to(torch.int32)
        mrl = zero
        if use_mrl:
            # the chosen angular mode again on reference ring 1; MIP stays
            # on ring 0
            pred1 = intra.predict_mode(ry[cy1_all[step], cx1_all[step]],
                                       torch.where(mode >= 67, 0, mode), s,
                                       s)
            best = _take(cost, mode)
            d1 = satd(pred1[:, None], ob[:, None])[:, 0].to(torch.float32)
            cost1 = (d1 + c1) + best * 0.0        # +1 bit for the flag
            mrl = ((cost1 < best) & (mode < 67)).to(torch.int32)
            pred = torch.where(mrl[:, None, None] > 0, pred1, pred)
        if use_ibc:
            # the 12 block vectors over the causal region, one batch
            pstack = _ibc_stack(ry, y0, x0, s)                # (B, 12, s, s)
            d_ibc = satd(pstack, ob[:, None]).to(torch.float32)
            d_ibc = torch.where(ibc_ok_all[step], d_ibc,
                                torch.full_like(d_ibc, 1e18))
            kbv = first_argmin(d_ibc, dim=1)
            cost_ibc = d_ibc.min(1).values + c_ibc
            d_cur = satd(pred[:, None], ob[:, None])[:, 0].to(torch.float32)
            is_ibc = cost_ibc < d_cur
            pred = torch.where(is_ibc[:, None, None], _take(pstack, kbv),
                               pred)
            mode = torch.where(is_ibc, IBC_BASE + kbv.to(torch.int32), mode)
            mrl = torch.where(is_ibc, 0, mrl)
        lfnst_idx = mtsm = tsm = zero
        if lossless:
            # all transform skip at qStep 1: the residual passes exactly
            lev_y = quant.quantize_ts(ob - pred, qp, intra=True)
            rec = _ts_recon(pred, lev_y, qp, maxv)
            tsm = torch.ones_like(zero)
        else:
            if use_mts:
                lev_y, rec, lfnst_idx, mtsm = _tq_mts_encode(
                    pred, ob - pred, mode, qp, s, bit_depth, dep_quant,
                    use_lfnst)
            elif use_lfnst:
                lev_y, rec, lfnst_idx = _tq_lfnst_encode(
                    pred, ob - pred, mode, qp, s, bit_depth, dep_quant)
            else:
                lev_y, rec = _tq_reconstruct(pred, ob - pred, None, qp, s,
                                             bit_depth, True, dep=dep_quant,
                                             rdoq=use_rdoq)
            if use_ts:
                pre_mode, pre_mrl = mode, mrl
                tsm, lev_y, rec, lfnst_idx, mtsm, mode = _ts_choice(
                    ob, pred, pall, mode, lev_y, rec, lfnst_idx, mtsm, qp,
                    use_bdpcm, maxv)
                tsm = tsm.to(torch.int32)
                mrl = torch.where(tsm > 0, 0, mrl)
                if stats is not None:
                    for key, hit in (
                            ("ts_over_ibc", (pre_mode >= IBC_BASE)
                             & (mode < IBC_BASE)),
                            ("ts_over_mrl", (pre_mrl > 0) & (mrl == 0)),
                            ("ts1_over_mrl", (pre_mrl > 0) & (tsm == 1))):
                        stats[key] = stats.get(key, 0) + int((hit & vld)
                                                             .sum())
        if use_ibc:
            # from the final mode: a BDPCM pick may have replaced an IBC
            # choice, and the decoder sees only the signalled mode
            is_ibc = mode >= IBC_BASE
            kbv = torch.clamp(mode - IBC_BASE, 0, len(IBC_BVS) - 1)
        ry[_block_index(y0, x0, s)] = rec
        my, mx = my_all[step], mx_all[step]
        # MIP and IBC blocks act as planar for the neighbours' MPM lists
        # and for the derived chroma mode (reference: UnitTools
        # getIntraDirLuma MIP -> PLANAR)
        nb_mode = torch.where(mode >= 67, 0, mode)
        mode_map[my, mx] = torch.where(vld, nb_mode, mode_map[my, mx])
        # ---- chroma: the derived mode (or the luma BV) against CCLM, U and
        # V as one batch
        predc = _predict_uv(torch.cat([buf[ccy_all[step], ccx_all[step]]
                                       for buf in (ru, rv)]), nb_mode, sc)
        if use_ibc:
            # chroma rides the luma BV: block aligned, so bv * sc exactly
            cpatch = torch.stack([_take(_ibc_stack(buf, y0c, x0c, sc), kbv)
                                  for buf in (ru, rv)], 1)
            predc = torch.where(is_ibc[:, None, None, None], cpatch, predc)
        obc = obc_all[step]
        lm_flag = zero
        if use_cclm:
            # the luma context after this step's luma scatter
            dsl, border_l = _cclm_luma_ctx(ry, y0, x0, s)
            predlm = torch.stack([
                _cclm_pred(buf, y0c, x0c, sc, dsl, border_l, bit_depth)
                for buf in (ru, rv)], 1)
            if use_ibc:
                predlm = torch.where(is_ibc[:, None, None, None], predc,
                                     predlm)
            ssd_d = ((obc - predc) ** 2).sum((1, 2, 3))
            ssd_l = ((obc - predlm) ** 2).sum((1, 2, 3))
            lm_flag = (ssd_l < ssd_d).to(torch.int32)
            if use_ibc:
                lm_flag = torch.where(is_ibc, 0, lm_flag)
            predc = torch.where(lm_flag[:, None, None, None] > 0, predlm,
                                predc)
        b = predc.shape[0]
        if lossless:
            lc = quant.quantize_ts(obc - predc, qp, intra=True)
            recc = _ts_recon(predc, lc, qp, maxv)
        else:
            lc, recc = _tq_reconstruct(
                predc.reshape(2 * b, sc, sc), (obc - predc).reshape(
                    2 * b, sc, sc), None, qp, sc, bit_depth, True,
                luma=False, dep=dep_quant, rdoq=use_rdoq)
            lc, recc = lc.reshape(b, 2, sc, sc), recc.reshape(b, 2, sc, sc)
        ru[_block_index(y0c, x0c, sc)] = recc[:, 0]
        rv[_block_index(y0c, x0c, sc)] = recc[:, 1]
        for i, o in enumerate((mode, lm_flag, lfnst_idx, mrl, tsm, mtsm,
                               lev_y, lc[:, 0], lc[:, 1])):
            outs[i].append(o)
    recon = dict(y=ry[MARGIN:MARGIN + h, MARGIN:MARGIN + w],
                 u=ru[MARGIN:MARGIN + h // 2, MARGIN:MARGIN + w // 2],
                 v=rv[MARGIN:MARGIN + h // 2, MARGIN:MARGIN + w // 2])
    return tuple(torch.stack(o) for o in outs), recon


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
