"""Adaptive Loop Filter — estimation and application.

PyTorch counterpart of `vvc_mm_tpu/common/alf.py` (reference:
source/Lib/CommonLib/AdaptiveLoopFilter.cpp — ALFProcess:402,
deriveClassification, filter7x7Blk / filter5x5Blk, applyCcAlfFilter;
EncoderLib/EncAdaptiveLoopFilter.cpp deriveCoeff).
The filters are integer (int32 features x int coeffs >> 7) and DC
preserving; per-64x64-region enable flags gate them.

The encoder's Wiener statistics are sums of products of integers.  The JAX
package accumulates them in float32, where the result depends on the order
of reduction; here they are accumulated in float64, which holds every sum
exactly (terms below 2^21, fewer than 2^32 of them), so the statistics are
the same on every device.  They agree with the JAX package's to float32
precision, and a rounded coefficient can differ by one: that changes the
slice header, not decodability (the decoder applies what is signalled).
"""
from __future__ import annotations

import numpy as np
import torch

NUM_CLASSES = 25
NUM_COEFF = 12            # symmetric diamond pairs (center excluded)
NUM_COEFF_C = 6           # chroma 5x5 diamond pairs
NUM_COEFF_CC = 7          # CC-ALF taps
COEFF_SHIFT = 7
REGION = 64

# 7x7 diamond symmetric pair offsets (upper half; mirror is implied)
DIAMOND_PAIRS = [
    (-3, 0),
    (-2, -1), (-2, 0), (-2, 1),
    (-1, -2), (-1, -1), (-1, 0), (-1, 1), (-1, 2),
    (0, -3), (0, -2), (0, -1),
]
# chroma: 5x5 diamond, one filter per plane
DIAMOND_PAIRS_C = [(-2, 0), (-1, -1), (-1, 0), (-1, 1), (0, -2), (0, -1)]
# CC-ALF luma taps relative to the co-located sample (differences to it)
CCALF_TAPS = [(-1, 0), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1), (2, 0)]


def _shift2(p: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift with edge clamp (frame-border padding)."""
    h, w = p.shape
    ys = torch.clamp(torch.arange(h, device=p.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=p.device) + dx, 0, w - 1)
    return p[ys][:, xs]


def _features(recon: torch.Tensor, pairs) -> torch.Tensor:
    return torch.stack([_shift2(recon, dy, dx) + _shift2(recon, -dy, -dx)
                        - 2 * recon for (dy, dx) in pairs]).to(torch.int32)


def _region_map(enable, h: int, w: int, device) -> torch.Tensor:
    en = torch.as_tensor(enable, device=device)
    return en.repeat_interleave(REGION, 0).repeat_interleave(
        REGION, 1)[:h, :w]


def _finish(recon, acc, bit_depth):
    out = recon + ((acc + (1 << (COEFF_SHIFT - 1))) >> COEFF_SHIFT)
    return torch.clamp(out, 0, (1 << bit_depth) - 1).to(torch.int32)


def classify(recon: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """Per-4x4-block class in 0..24 from gradient direction x activity
    (reference: deriveClassification, simplified decision tree)."""
    h, w = recon.shape
    c = recon
    gv = torch.abs(2 * c - _shift2(c, -1, 0) - _shift2(c, 1, 0))
    gh = torch.abs(2 * c - _shift2(c, 0, -1) - _shift2(c, 0, 1))
    gd0 = torch.abs(2 * c - _shift2(c, -1, -1) - _shift2(c, 1, 1))
    gd1 = torch.abs(2 * c - _shift2(c, -1, 1) - _shift2(c, 1, -1))

    def block4(x):
        return x.reshape(h // 4, 4, w // 4, 4).sum(dim=(1, 3),
                                                   dtype=torch.int32)
    sv, sh_, s0, s1 = block4(gv), block4(gh), block4(gd0), block4(gd1)
    hv_max = torch.maximum(sv, sh_)
    hv_min = torch.minimum(sv, sh_)
    d_max = torch.maximum(s0, s1)
    d_min = torch.minimum(s0, s1)
    hv_strong = hv_max > 2 * hv_min
    d_strong = d_max > 2 * d_min
    main_hv = hv_max * d_min >= d_max * hv_min
    dir_cls = torch.where(
        main_hv,
        torch.where(hv_strong, torch.where(sv > sh_, 1, 2), 0),
        torch.where(d_strong, torch.where(s0 > s1, 3, 4), 0))
    aq = torch.clamp((sv + sh_) >> (bit_depth - 2), 0, 15)
    act_cls = torch.where(aq == 0, 0, torch.where(
        aq == 1, 1, torch.where(aq <= 3, 2, torch.where(aq <= 7, 3, 4))))
    return (5 * dir_cls + act_cls).to(torch.int32)


def apply_alf(recon: torch.Tensor, cls4: torch.Tensor, coeffs, enable,
              bit_depth: int = 8) -> torch.Tensor:
    """Luma ALF: per-class 7x7 diamond filters with per-region gating."""
    h, w = recon.shape
    filtered = filter_frame(recon, cls4, coeffs, bit_depth)
    return torch.where(_region_map(enable, h, w, recon.device), filtered,
                       recon)


def apply_alf_chroma(recon: torch.Tensor, coeffs, enable,
                     bit_depth: int = 8) -> torch.Tensor:
    """Chroma ALF: one 5x5 diamond filter per plane, region gated."""
    h, w = recon.shape
    filtered = filter_chroma(recon, coeffs, bit_depth)
    return torch.where(_region_map(enable, h, w, recon.device), filtered,
                       recon)


def apply_ccalf(recon_c: torch.Tensor, luma: torch.Tensor, coeffs, enable,
                bit_depth: int = 8) -> torch.Tensor:
    """CC-ALF: a chroma correction from co-located luma differences
    (4:2:0 co-located sample at (2y, 2x)), region gated."""
    ch, cw = recon_c.shape
    out = filter_ccalf(recon_c, luma, coeffs, bit_depth)
    return torch.where(_region_map(enable, ch, cw, recon_c.device), out,
                       recon_c)


# ---------------------------------------------------------------------------
# Estimation (encoder)
# ---------------------------------------------------------------------------


def filter_frame(recon: torch.Tensor, cls4: torch.Tensor, coeffs,
                 bit_depth: int = 8) -> torch.Tensor:
    """Apply the per-class luma filters everywhere (region gating by the
    caller)."""
    dev = recon.device
    coeffs = torch.as_tensor(coeffs, device=dev).to(torch.int32)
    f = _features(recon, DIAMOND_PAIRS)
    cmap = cls4.repeat_interleave(4, 0).repeat_interleave(4, 1)
    ctab = coeffs[cmap.to(torch.int64)]
    acc = (f.permute(1, 2, 0) * ctab).sum(-1, dtype=torch.int32)
    return _finish(recon, acc, bit_depth)


def filter_chroma(recon: torch.Tensor, coeffs, bit_depth: int = 8
                  ) -> torch.Tensor:
    coeffs = torch.as_tensor(coeffs, device=recon.device).to(torch.int32)
    f = _features(recon, DIAMOND_PAIRS_C)
    acc = (f * coeffs[:, None, None]).sum(0, dtype=torch.int32)
    return _finish(recon, acc, bit_depth)


def _ccalf_features(luma: torch.Tensor, ch: int, cw: int) -> torch.Tensor:
    """(7, ch, cw) luma difference features at chroma resolution (4:2:0
    co-located sample at (2y, 2x))."""
    c0 = luma[::2, ::2][:ch, :cw]
    return torch.stack([_shift2(luma, dy, dx)[::2, ::2][:ch, :cw] - c0
                        for (dy, dx) in CCALF_TAPS]).to(torch.int32)


def filter_ccalf(recon_c: torch.Tensor, luma: torch.Tensor, coeffs,
                 bit_depth: int = 8) -> torch.Tensor:
    """The CC-ALF correction applied everywhere (region gating by the
    caller)."""
    ch, cw = recon_c.shape
    coeffs = torch.as_tensor(coeffs, device=recon_c.device).to(torch.int32)
    f = _ccalf_features(luma, ch, cw)
    acc = (f * coeffs[:, None, None]).sum(0, dtype=torch.int32)
    return _finish(recon_c, acc, bit_depth)
