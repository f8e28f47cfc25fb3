"""Two-level intra partitioning: 16x16 superblocks against 8x8 quads.

PyTorch counterpart of `vvc_mm_tpu/common/intra_part.py`, one level of
the reference's QTMT intra recursion (reference: EncCu.cpp:499
xCompressCU intra split decision; CABAC split_cu_flag).  The wavefront
runs over 16x16 SUPERBLOCKS (d = 2*i + j on the superblock grid); each
step evaluates, batched across the step's superblocks:

  * the 16x16 whole-block intra coding (all 67 modes, SATD + bits mode
    pick, transform/quant/recon), and
  * the four 8x8 sub-blocks in z-order — sequential sub-steps, so each
    sub-block predicts from the true reconstruction of its causal
    neighbours, as the fixed-8x8 wavefront does,

then picks per superblock by SSD + lambda * (level rate + mode bits +
split flag) and scatters the winning reconstruction.  The decoder runs the
same steps from the parsed split/modes/levels, so the reconstructions
agree bit for bit.

The JAX package's `lax.scan` is a Python loop over the anti-diagonals
here, each step's superblocks batched (only the valid ones: the per-step
outputs of the padded slots stay zero).  The float32 costs follow the
JAX step's XLA CPU numerics: the mode costs take the products lam * bits
rounded (as common/wavefront.py), the candidate costs
`ssd + lam * bits` are fused multiply-adds (common/qtree.rd_cost_f32), the
rates are wavefront._rate_est's.

Scope: the base toolset (DST-7/DCT-2 implicit-MTS TQ, 3-entry MPM,
derived chroma).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import intra, quant
from .qtree import rd_cost_f32
from .rdcost import first_argmin, satd
from .wavefront import (MARGIN, _block_index, _cref_index, _gather_blocks,
                        _mpm3, _pad_to_buffer, _rate_est, _take,
                        _tq_reconstruct, wavefront_coords)
from ..device import resolve_device

SB = 16          # superblock size
SUB = 8          # split sub-block size
_QUADS = ((0, 0), (0, 1), (1, 0), (1, 1))     # z-order (dy, dx)
N_OUTS = 9       # split, mode16, modes8, lev16 y/u/v, lev8 y/u/v


class _Layout:
    """Every step's block origins and reference-vector indices in the
    padded buffers, built on the host once and copied to the device once
    (steps, bmax, ...); a step reads the first n entries (the valid slots
    lead each step).  Chroma is ONE buffer: U's padded plane above V's,
    so U and V blocks are lanes of one batch (V's rows offset by the
    padded chroma height)."""

    def __init__(self, h: int, w: int, device):
        self.coords, self.valid = wavefront_coords(h // SB, w // SB)
        self.n = self.valid.sum(1)
        sy = self.coords[..., 0].astype(np.int64)
        sx = self.coords[..., 1].astype(np.int64)
        luma = (h + 2 * MARGIN, w + 2 * MARGIN)
        hc = h // 2 + 2 * MARGIN
        chroma = (2 * hc, w // 2 + 2 * MARGIN)
        q = np.asarray(_QUADS, np.int64)                 # (4, 2)
        y0, x0 = MARGIN + sy * SB, MARGIN + sx * SB      # (steps, bmax)
        # chroma lanes (steps, bmax, 2): U, then V hc rows below
        y0c = (MARGIN + sy * (SB // 2))[..., None] + np.array([0, hc])
        x0c = np.repeat((MARGIN + sx * (SB // 2))[..., None], 2, -1)
        y0q = y0[..., None] + q[:, 0] * SUB              # (steps, bmax, 4)
        x0q = x0[..., None] + q[:, 1] * SUB
        y0cq = y0c[..., None, :] + (q[:, 0] * (SUB // 2))[:, None]
        x0cq = x0c[..., None, :] + (q[:, 1] * (SUB // 2))[:, None]

        def t(a):
            return torch.as_tensor(a, device=device)
        self.origin = {k: t(v) for k, v in dict(
            y16=y0, x16=x0, yc16=y0c, xc16=x0c, y8=y0q, x8=x0q, yc8=y0cq,
            xc8=x0cq).items()}
        self.cref = {
            "16": tuple(map(t, _cref_index(y0, x0, SB, luma))),
            "8": tuple(map(t, _cref_index(y0q, x0q, SUB, luma))),
            "c16": tuple(map(t, _cref_index(y0c, x0c, SB // 2, chroma))),
            "c8": tuple(map(t, _cref_index(y0cq, x0cq, SUB // 2, chroma)))}
        self.chroma_rows = hc

    def step(self, i: int):
        """(n, origins, cref index pairs) of step i, views of the tables."""
        n = int(self.n[i])
        return (n, {k: v[i, :n] for k, v in self.origin.items()},
                {k: (a[i, :n], b[i, :n]) for k, (a, b) in self.cref.items()})


def _quad(index_pair, k: int):
    """The reference-vector index pair of quad k."""
    return index_pair[0][:, k], index_pair[1][:, k]


def _chroma_buffer(u, v, fill: int):
    """U's padded plane above V's (see _Layout)."""
    return torch.cat([_pad_to_buffer(u, fill), _pad_to_buffer(v, fill)])


def _planes(ry, rc, h: int, w: int, hc: int):
    return dict(y=ry[MARGIN:MARGIN + h, MARGIN:MARGIN + w],
                u=rc[MARGIN:MARGIN + h // 2, MARGIN:MARGIN + w // 2],
                v=rc[hc + MARGIN:hc + MARGIN + h // 2,
                     MARGIN:MARGIN + w // 2])


def _scatter(buf, y0, x0, blocks):
    buf[_block_index(y0.reshape(-1), x0.reshape(-1), blocks.shape[-1])] = \
        blocks.reshape((-1,) + tuple(blocks.shape[-2:]))


def _keep_split(buf, y0, x0, sp, whole):
    """The superblocks' final samples: what the 8x8 sub-steps wrote where
    the superblock splits (sp), the 16x16 candidate elsewhere."""
    idx = _block_index(y0.reshape(-1), x0.reshape(-1), whole.shape[-1])
    buf[idx] = torch.where(sp, buf[idx].reshape(whole.shape), whole
                           ).reshape(buf[idx].shape)


def encode_intra_frame_part(orig_y, orig_u, orig_v, qp: int,
                            bit_depth: int = 8):
    """Closed-loop two-level intra encode, on the device of the planes it
    is given.  Returns (outs, recon): outs = (split, mode16, modes8,
    lev16_y, lev16_u, lev16_v, lev8_y, lev8_u, lev8_v) as per-step
    tensors of shape (steps, bmax, ...) in the JAX scan's layout (zero in
    the padded slots); recon the reconstructed planes dict(y, u, v)."""
    dev = orig_y.device
    h, w = orig_y.shape
    nsy, nsx = h // SB, w // SB
    lam = quant.lambda_from_qp(qp, intra=True)
    lam_satd = np.float32(math.sqrt(lam))
    # the mode costs' lam * bits products, rounded once as XLA folds them
    c2, c3, c7 = (float(lam_satd * np.float32(b)) for b in (2.0, 3.0, 7.0))
    lam32 = float(np.float32(lam))
    mid = 1 << (bit_depth - 1)
    lay = _Layout(h, w, dev)
    bmax = lay.coords.shape[1]

    oy = _pad_to_buffer(orig_y, mid)
    oc = _chroma_buffer(orig_u, orig_v, mid)
    ry, rc = torch.full_like(oy, mid), torch.full_like(oc, mid)
    # mode map on the 8x8 sub-grid (for the MPM), 1-padded
    mode_map = torch.full((2 * nsy + 1, 2 * nsx + 1), -1, dtype=torch.int32,
                          device=dev)
    modes_grid = torch.arange(67, dtype=torch.int32, device=dev)[None]
    quad_y, quad_x = torch.tensor(_QUADS, device=dev).T

    def code_luma(cref, y0, x0, cy, cx, s):
        """Decide + TQ one luma block batch at size s.  Returns
        (mode, lev, rec, ssd, bits)."""
        pall = intra.predict_all_modes(ry[cref], s, s)
        ob = _gather_blocks(oy, y0, x0, s)
        dist = satd(pall, ob[:, None]).to(torch.float32)
        mpm = _mpm3(mode_map[1 + cy, cx], mode_map[cy, 1 + cx])
        is0 = modes_grid == mpm[:, 0:1]
        is12 = (modes_grid == mpm[:, 1:2]) | (modes_grid == mpm[:, 2:3])
        mode = first_argmin(dist + torch.where(is0, c2, torch.where(
            is12, c3, c7)), dim=1)
        pred = _take(pall, mode)
        mode = mode.to(torch.int32)
        lev, rec = _tq_reconstruct(pred, ob - pred, None, qp, s, bit_depth,
                                   True)
        ssd = ((rec - ob) ** 2).sum((1, 2)).to(torch.float32)
        mbits = torch.where(_take(is0, mode), 2.0,
                            torch.where(_take(is12, mode), 3.0, 7.0))
        return mode, lev, rec, ssd, _rate_est(lev) + mbits

    def code_chroma(cref, y0c, x0c, mode, s):
        """U and V of a block batch as one batch of 2n lanes: (lev, rec
        (n, 2, s, s)), ssd and rate (2, n)."""
        n = mode.shape[0]
        pred = intra.predict_mode(rc[cref].reshape(2 * n, -1),
                                  mode.repeat_interleave(2), s, s)
        ob = _gather_blocks(oc, y0c.reshape(-1), x0c.reshape(-1), s)
        lev, rec = _tq_reconstruct(pred, ob - pred, None, qp, s, bit_depth,
                                   True, luma=False)
        ssd = ((rec - ob) ** 2).sum((1, 2)).to(torch.float32)
        return (lev.reshape(n, 2, s, s), rec.reshape(n, 2, s, s),
                ssd.reshape(n, 2).T, _rate_est(lev).reshape(n, 2).T)

    outs = [[] for _ in range(N_OUTS)]
    for step in range(lay.coords.shape[0]):
        n, o, cref = lay.step(step)
        sy = (o["y16"] - MARGIN) // SB
        sx = (o["x16"] - MARGIN) // SB
        cy16, cx16 = 2 * sy, 2 * sx

        # ---- 16x16 whole-block candidate
        mode16, lev16_y, rec16_y, ssd16, rb16 = code_luma(
            cref["16"], o["y16"], o["x16"], cy16, cx16, SB)
        lev16_c, rec16_c, ssd16c, rb16c = code_chroma(
            cref["c16"], o["yc16"], o["xc16"], mode16, SB // 2)
        cost16 = rd_cost_f32((ssd16 + ssd16c[0]) + ssd16c[1], lam,
                             ((rb16 + rb16c[0]) + rb16c[1]) + 1.0)

        # ---- four 8x8 sub-blocks, z-order sub-steps.  They write into the
        # state in place: every cell they write lies in a superblock of
        # this step, whose final samples _keep_split writes below
        q = {k: [] for k in ("mode", "ly", "lc")}
        cost8 = torch.zeros_like(cost16)
        for k, (qy, qx) in enumerate(_QUADS):
            cy, cx = cy16 + qy, cx16 + qx
            m8, l8, r8, ssd8, rb8 = code_luma(
                _quad(cref["8"], k), o["y8"][:, k], o["x8"][:, k], cy, cx,
                SUB)
            l8c, r8c, s8c, rb8c = code_chroma(
                _quad(cref["c8"], k), o["yc8"][:, k], o["xc8"][:, k], m8,
                SUB // 2)
            cost8 = rd_cost_f32(((cost8 + ssd8) + s8c[0]) + s8c[1], lam,
                                (rb8 + rb8c[0]) + rb8c[1])
            _scatter(ry, o["y8"][:, k], o["x8"][:, k], r8)
            _scatter(rc, o["yc8"][:, k], o["xc8"][:, k], r8c)
            mode_map[1 + cy, 1 + cx] = m8
            for key, v in zip(q, (m8, l8, l8c)):
                q[key].append(v)
        cost8 = cost8 + lam32                        # split flag
        split = (cost8 < cost16).to(torch.int32)

        # ---- final reconstruction and mode map per superblock
        sp = split[:, None, None] == 1
        _keep_split(ry, o["y16"], o["x16"], sp, rec16_y)
        _keep_split(rc, o["yc16"], o["xc16"], sp[:, None], rec16_c)
        # split -> the four 8x8 modes; whole -> mode16 in all four cells
        cells = torch.where(split[:, None] == 1, torch.stack(q["mode"], 1),
                            mode16[:, None])
        mode_map[1 + cy16[:, None] + quad_y, 1 + cx16[:, None] + quad_x] = \
            cells
        lev8_c = torch.stack(q["lc"], 1)                 # (n, 4, 2, 4, 4)
        step_outs = (split, mode16, torch.stack(q["mode"], 1),
                     lev16_y, lev16_c[:, 0], lev16_c[:, 1],
                     torch.stack(q["ly"], 1), lev8_c[:, :, 0],
                     lev8_c[:, :, 1])
        for i, v in enumerate(step_outs):
            pad = v.new_zeros((bmax - n,) + tuple(v.shape[1:]))
            outs[i].append(torch.cat([v, pad]))
    return (tuple(torch.stack(o) for o in outs),
            _planes(ry, rc, h, w, lay.chroma_rows))


def decode_intra_frame_part(split_steps, mode16_steps, modes8_steps,
                            l16y, l16u, l16v, l8y, l8u, l8v, qp: int,
                            height: int, width: int, bit_depth: int = 8,
                            device=None):
    """Decoder steps: the encoder's reconstruction from the parsed
    decisions in scan order ((steps, bmax, ...) arrays, see
    wavefront.grid_to_steps).  Returns dict(y, u, v) of int32 planes on
    `device` (CUDA unless another device is named)."""
    dev = resolve_device(device)
    h, w = height, width
    mid = 1 << (bit_depth - 1)
    lay = _Layout(h, w, dev)
    (split_steps, mode16_steps, modes8_steps, l16y, l8y) = (
        torch.as_tensor(np.asarray(a), device=dev)
        for a in (split_steps, mode16_steps, modes8_steps, l16y, l8y))
    l16c = torch.as_tensor(np.stack([l16u, l16v], 2), device=dev)
    l8c = torch.as_tensor(np.stack([l8u, l8v], 3), device=dev)
    ry = torch.full((h + 2 * MARGIN, w + 2 * MARGIN), mid, dtype=torch.int32,
                    device=dev)
    rc = torch.full((2 * lay.chroma_rows, w // 2 + 2 * MARGIN), mid,
                    dtype=torch.int32, device=dev)

    def rec_luma(cref, mode, lev, s):
        pred = intra.predict_mode(ry[cref], mode, s, s)
        return _tq_reconstruct(pred, None, lev, qp, s, bit_depth, True)[1]

    def rec_chroma(cref, mode, lev, s):
        n = mode.shape[0]
        pred = intra.predict_mode(rc[cref].reshape(2 * n, -1),
                                  mode.repeat_interleave(2), s, s)
        return _tq_reconstruct(pred, None, lev.reshape(2 * n, s, s), qp, s,
                               bit_depth, True, luma=False)[1].reshape(
                                   n, 2, s, s)

    for step in range(lay.coords.shape[0]):
        n, o, cref = lay.step(step)
        mode16 = mode16_steps[step, :n]
        sp = split_steps[step, :n][:, None, None] == 1
        rec16_y = rec_luma(cref["16"], mode16, l16y[step, :n], SB)
        rec16_c = rec_chroma(cref["c16"], mode16, l16c[step, :n], SB // 2)
        for k in range(len(_QUADS)):
            m8 = modes8_steps[step, :n, k]
            _scatter(ry, o["y8"][:, k], o["x8"][:, k],
                     rec_luma(_quad(cref["8"], k), m8, l8y[step, :n, k],
                              SUB))
            _scatter(rc, o["yc8"][:, k], o["xc8"][:, k],
                     rec_chroma(_quad(cref["c8"], k), m8, l8c[step, :n, k],
                                SUB // 2))
        _keep_split(ry, o["y16"], o["x16"], sp, rec16_y)
        _keep_split(rc, o["yc16"], o["xc16"], sp[:, None], rec16_c)
    return _planes(ry, rc, h, w, lay.chroma_rows)
