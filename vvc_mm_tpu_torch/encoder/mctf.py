"""GOP-based motion-compensated temporal pre-filter (MCTF).

PyTorch counterpart of `vvc_mm_tpu/encoder/mctf.py` (reference:
source/Lib/EncoderLib/EncTemporalFilter.cpp — filter entry :288, motion
estimation :577, bilateral combine :662).  Each RA-anchor source picture is
blended with up to four past and four future *original* pictures: a
hierarchical 16x16 search (encoder/me.py) and one full-frame MC
(common/inter_frame.mc_predict) align each neighbour, then a per-pixel
bilateral weight (Gaussian in the intensity difference, scaled by the
per-block ME error and the temporal distance) blends the aligned neighbours
into the source before the encoder sees it.

The planes live on the caller's device; the combine is float32 in the form
XLA compiles the JAX package's jit of `_bilateral_combine` to (its own exp
polynomial, libm_f32.exp_xla, and its FMAs), so the filtered pictures
equal the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..common import inter_frame, libm_f32
from ..device import resolve_device
from . import me as me_mod

# Per-neighbour strength by temporal distance, mirroring the shape of the
# reference's refStrengths tables (EncTemporalFilter.cpp:95-101): nearer
# originals contribute more.
_DIST_STRENGTH = {1: 0.85, 2: 0.60, 3: 0.42, 4: 0.33}
_BLOCK = 16


def _bilateral_combine(orig: torch.Tensor, preds: torch.Tensor,
                       block_err: torch.Tensor, strengths: torch.Tensor,
                       sigma_sq: float, bit_depth: int) -> torch.Tensor:
    """Blend aligned neighbour predictions into the original plane.

    orig (H, W) int32; preds (N, H, W) int32 aligned neighbours; block_err
    (N, H, W) float32, each pixel's block's mean ME error (it lowers the
    weights where the alignment failed); strengths (N,) float32;
    sigma_sq the float32 intensity variance.  Returns (H, W) int32."""
    o = orig.to(torch.float32)
    p = preds.to(torch.float32)
    d = p - o[None]
    err_factor = torch.clamp(1.8 - block_err / 64.0, 0.3, 1.8)
    sig2 = torch.full((), float(np.float32(2.0 * np.float32(sigma_sq))),
                      dtype=torch.float32, device=o.device)
    w = (strengths[:, None, None] * err_factor) * libm_f32.exp_xla(
        -(d * d) / (sig2 * err_factor))
    # XLA's order: the weights summed in neighbour order; the weighted
    # samples too, each product fused into the running sum (an FMA)
    den = w[0]
    num = w[0] * p[0]
    for k in range(1, w.shape[0]):
        den = den + w[k]
        num = libm_f32.fma32(w[k], p[k], num)
    out = (num + o) / (den + 1.0)
    return torch.clamp(torch.round(out), 0, (1 << bit_depth) - 1
                       ).to(orig.dtype)


def _align_neighbor(orig_y: torch.Tensor, nb_planes, bit_depth: int,
                    search_range: int):
    """ME + MC of one neighbour original onto the target picture: (pred_y,
    pred_u, pred_v, the per-block mean absolute error grid)."""
    margin = inter_frame.MC_MARGIN
    refp = inter_frame.pad_ref(nb_planes[0], margin)
    mv_int, _ = me_mod.hierarchical_search(orig_y, refp, _BLOCK,
                                           search_range, margin, 0)
    mvs, sad = me_mod.fractional_refine(orig_y, refp, mv_int, _BLOCK, margin,
                                        bit_depth)
    py, pu, pv = inter_frame.mc_predict(nb_planes[0], nb_planes[1],
                                        nb_planes[2], mvs, _BLOCK, bit_depth,
                                        False)
    err = sad.to(torch.float32) / float(_BLOCK * _BLOCK)
    return py, pu, pv, err


def filter_frame(frames, poc: int, qp: int, bit_depth: int = 8,
                 strength: float = 0.95, max_refs: int = 4,
                 search_range: int = 16, device=None):
    """Filter frames[poc] with up to `max_refs` originals on each side.

    reference: EncTemporalFilter::filter (EncTemporalFilter.cpp:288).
    frames: [y, u, v] integer planes (numpy or tensors) per picture; the
    work runs on `device` (CUDA unless another is named).  Returns new
    [y, u, v] numpy int32 planes, or frames[poc] itself when the picture's
    dimensions do not divide by 64 (the hierarchical search needs them)
    or it has no neighbour."""
    h, w = frames[poc][0].shape
    if h % (4 * _BLOCK) or w % (4 * _BLOCK):
        return frames[poc]
    dev = resolve_device(device)

    def planes(f):
        return [torch.as_tensor(c, dtype=torch.int32, device=dev) for c in f]

    orig = planes(frames[poc])
    preds = {0: [], 1: [], 2: []}
    errs, strengths = [], []
    for d in range(-max_refs, max_refs + 1):
        if d == 0 or not (0 <= poc + d < len(frames)):
            continue
        py, pu, pv, err = _align_neighbor(orig[0], planes(frames[poc + d]),
                                          bit_depth, search_range)
        preds[0].append(py)
        preds[1].append(pu)
        preds[2].append(pv)
        errs.append(err)
        strengths.append(strength * _DIST_STRENGTH[abs(d)])
    if not errs:
        return frames[poc]
    sw = torch.tensor(strengths, dtype=torch.float32, device=dev)
    err_grid = torch.stack(errs)                     # (N, nby, nbx)
    # QP-adaptive sigma (reference: EncTemporalFilter sigma from QP)
    sigma = 2.0 + 0.35 * max(qp - 10, 0)
    sigma_sq = float(np.float32(sigma * sigma * (1 << (2 * (bit_depth - 8)))))
    out = []
    for ci, plane in enumerate(orig):
        sub = 1 if ci == 0 else 2
        be = err_grid.repeat_interleave(_BLOCK // sub, 1).repeat_interleave(
            _BLOCK // sub, 2)
        filt = _bilateral_combine(plane, torch.stack(preds[ci]), be, sw,
                                  sigma_sq, bit_depth)
        out.append(filt.cpu().numpy())
    return out


def prefilter_sequence(frames, qp: int, bit_depth: int = 8, period: int = 8,
                       device=None) -> list:
    """MCTF on every `period`-th picture (the RA anchors), strength 1.5 at
    every 2*period-th and 0.95 elsewhere (reference: EncTemporalFilter.cpp
    filter-strength map {8: 0.95, 16: 1.5} set up by EncApp).  The other
    pictures pass through; every search runs against *original*
    neighbours."""
    orig = list(frames)
    out = list(frames)
    for poc in range(0, len(orig), period):
        s = 1.5 if (2 * period > 0 and poc % (2 * period) == 0) else 0.95
        out[poc] = filter_frame(orig, poc, qp, bit_depth, strength=s,
                                device=device)
    return out
