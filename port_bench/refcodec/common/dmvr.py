"""DMVR — decoder-side motion vector refinement by bilateral matching.

PyTorch counterpart of `vvc_mm_tpu/common/dmvr.py` (reference:
source/Lib/CommonLib/InterPrediction.cpp:2241 xProcessDMVR — for each
bi-predicted block, a +-2-pel search around the signalled MV pair minimizes
SAD(P0(mv0 + d), P1(mv1 - d)); the refined pair then drives the final MC).

Normative and signalling-free: the encoder's reconstruction and the decoder
run this same integer search, so the decoded-picture hash covers it.  Every
bi block of the frame evaluates all 25 mirrored offsets at once; the scan
starts at (0, 0) and a later offset wins only with a strictly smaller SAD,
so ties keep the earliest offset.
"""
from __future__ import annotations

import torch

from . import interp

DMVR_RANGE = 2

# (dy, dx) in scan order: (0, 0) first, then row by row
_OFFSETS = [(0, 0)] + [(dy, dx)
                       for dy in range(-DMVR_RANGE, DMVR_RANGE + 1)
                       for dx in range(-DMVR_RANGE, DMVR_RANGE + 1)
                       if (dy, dx) != (0, 0)]


def dmvr_refine(ref0_pad: torch.Tensor, ref1_pad: torch.Tensor,
                mv0: torch.Tensor, mv1: torch.Tensor, dirs: torch.Tensor,
                block_size: int, margin: int):
    """Refine bi-predicted blocks' MV pairs by +-2-pel bilateral matching.

    Args:
      ref0_pad/ref1_pad: margin-padded reference luma planes.
      mv0/mv1: (nby, nbx, 2) signalled 1/16-pel MVs.
      dirs: (nby, nbx) 0=L0, 1=L1, 2=BI — only BI blocks refine.
    Returns (mv0', mv1') with the mirrored integer offset applied.
    """
    s = block_size
    r = DMVR_RANGE
    nby, nbx = dirs.shape
    nb = nby * nbx
    dev = ref0_pad.device
    idx = torch.arange(nb, dtype=torch.int32, device=dev)
    ys = (idx // nbx) * s
    xs = (idx % nbx) * s
    m0 = mv0.to(torch.int32).reshape(nb, 2)
    m1 = mv1.to(torch.int32).reshape(nb, 2)
    p = s + 2 * r

    def patches(ref, mv):
        # the cost search reads nearest-integer samples (the final MC still
        # takes the 8-tap filters); >> is floor division on int32
        bx = xs + margin + ((mv[:, 0] + 8) >> 4) - r
        by = ys + margin + ((mv[:, 1] + 8) >> 4) - r
        bx = torch.clamp(bx, 0, ref.shape[1] - p)
        by = torch.clamp(by, 0, ref.shape[0] - p)
        return interp.gather_patches_t(ref, by, bx, p, p).permute(2, 0, 1)

    p0 = patches(ref0_pad, m0)
    p1 = patches(ref1_pad, m1)
    best_cost = torch.full((nb,), 1 << 30, dtype=torch.int32, device=dev)
    best_k = torch.zeros((nb,), dtype=torch.int64, device=dev)
    for k, (dy, dx) in enumerate(_OFFSETS):
        c0 = p0[:, r + dy:r + dy + s, r + dx:r + dx + s]
        c1 = p1[:, r - dy:r - dy + s, r - dx:r - dx + s]
        sad = (c0 - c1).abs().sum(dim=(1, 2)).to(torch.int32)
        better = sad < best_cost
        best_cost = torch.where(better, sad, best_cost)
        best_k = best_k.masked_fill(better, k)
    # (dx, dy) of each offset, one copy to the device per call
    offs = torch.tensor([(dx, dy) for dy, dx in _OFFSETS], dtype=torch.int32,
                        device=dev)
    bi = (dirs.reshape(nb) == 2)[:, None]
    d16 = offs[best_k] * 16
    mv0r = torch.where(bi, m0 + d16, m0).reshape(nby, nbx, 2)
    mv1r = torch.where(bi, m1 - d16, m1).reshape(nby, nbx, 2)
    return mv0r, mv1r
