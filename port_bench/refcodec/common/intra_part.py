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

from . import intra
from .wavefront import (MARGIN, _block_index, _cref_index, _tq_reconstruct,
                        wavefront_coords)
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
