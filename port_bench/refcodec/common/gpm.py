"""Geometric partitioning mode (GPM) and combined inter/intra (CIIP).

PyTorch counterpart of `vvc_mm_tpu/common/gpm.py` (reference:
source/Lib/CommonLib/InterPrediction.cpp — motionCompensationGeo /
weightedGeoBlk; the CIIP blend in DecCu.cpp / EncCu.cpp
xCheckRDCostMerge2Nx2N; GEO tables g_geoParams in Rom.cpp).

  * The masks are a fixed (NUM_GPM_MODES, s, s) weight table (16 split
    angles through the block centre, a 0..8 ramp); a block's blend is one
    gather and a multiply-add over the whole frame.
  * CIIP's planar signal is built from the inter-predicted frame itself
    (not from reconstructed neighbours), so the frame stays one batched
    step on encoder and decoder alike and the recon stays bit-exact.

All of it is integer arithmetic (the table is made once on the host in
float64, as the JAX package makes it), so the port equals the JAX package
bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

NUM_GPM_MODES = 16          # reference uses 64 angle/offset pairs
_RAMP = 2.0                 # blend ramp half-width in samples


@functools.lru_cache(maxsize=None)
def gpm_weights(s: int) -> np.ndarray:
    """(NUM_GPM_MODES, s, s) int32 weights in 0..8 for the P0 side.

    Mode k splits the block along the line through the centre with normal
    at angle 2*pi*k/NUM_GPM_MODES; the complementary split is k + N/2
    (reference analog: g_geoParams angle+distance table, Rom.cpp)."""
    yy, xx = np.meshgrid(np.arange(s, dtype=np.float64),
                         np.arange(s, dtype=np.float64), indexing="ij")
    cy = cx = (s - 1) / 2.0
    out = np.zeros((NUM_GPM_MODES, s, s), dtype=np.int32)
    for k in range(NUM_GPM_MODES):
        th = 2.0 * np.pi * k / NUM_GPM_MODES
        d = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
        w = np.clip(np.round(4.0 + d * (4.0 / _RAMP)), 0, 8)
        out[k] = w.astype(np.int32)
    return out


def _weights(s: int, device, sub: int = 1) -> torch.Tensor:
    w = gpm_weights(s)[:, ::sub, ::sub]
    return torch.from_numpy(np.ascontiguousarray(w)).to(device)


def gpm_blend(p0: torch.Tensor, p1: torch.Tensor, modes: torch.Tensor
              ) -> torch.Tensor:
    """Blend two pixel-domain uni predictions (B, s, s) with per-block GPM
    masks selected by `modes` (B,) int32: (w*p0 + (8-w)*p1 + 4) >> 3."""
    wt = _weights(p0.shape[-1], p0.device)[modes.long()]
    return (wt * p0 + (8 - wt) * p1 + 4) >> 3


def gpm_blend_chroma(p0: torch.Tensor, p1: torch.Tensor,
                     modes: torch.Tensor) -> torch.Tensor:
    """Chroma blend: the luma mask subsampled 2x (reference: GEO chroma
    weights are the collocated luma weights)."""
    wt = _weights(2 * p0.shape[-1], p0.device, 2)[modes.long()]
    return (wt * p0 + (8 - wt) * p1 + 4) >> 3


def _planar(top: torch.Tensor, left: torch.Tensor, s: int) -> torch.Tensor:
    """Batched planar prediction from (B, s+1) top / left neighbour rows
    (index s = above-right / below-left sample; reference:
    IntraPrediction.cpp:295 xPredIntraPlanar)."""
    log2s = s.bit_length() - 1
    xs = torch.arange(s, dtype=torch.int32, device=top.device)
    tr = top[:, s][:, None, None]
    bl = left[:, s][:, None, None]
    t = top[:, None, :s]                               # (B, 1, s)
    lf = left[:, :s, None]                             # (B, s, 1)
    hor = (s - 1 - xs)[None, None, :] * lf + (xs + 1)[None, None, :] * tr
    ver = (s - 1 - xs)[None, :, None] * t + (xs + 1)[None, :, None] * bl
    return (hor + ver + s) >> (log2s + 1)


def ciip_from_pred(pred_plane: torch.Tensor, s: int) -> torch.Tensor:
    """CIIP candidate for every block of the frame: planar intra whose
    neighbours come from the inter-predicted plane, averaged with the
    inter prediction itself — (inter + planar + 1) >> 1 (reference: CIIP
    weight 2/2 mid case).  Returns (B, s, s) blocks in raster order."""
    h, w = pred_plane.shape
    nby, nbx = h // s, w // s
    dev = pred_plane.device
    # edge padding: one row/column before, s after
    ys = torch.clamp(torch.arange(-1, h + s, device=dev), 0, h - 1)
    xs = torch.clamp(torch.arange(-1, w + s, device=dev), 0, w - 1)
    pad = pred_plane[ys][:, xs]
    idx = torch.arange(nby * nbx, device=dev)
    y0 = (idx // nbx) * s
    x0 = (idx % nbx) * s
    k = torch.arange(s + 1, device=dev)
    top = pad[y0[:, None], x0[:, None] + 1 + k[None, :]]
    left = pad[y0[:, None] + 1 + k[None, :], x0[:, None]]
    planar = _planar(top, left, s)
    blocks = (pred_plane.reshape(nby, s, nbx, s).permute(0, 2, 1, 3)
              .reshape(-1, s, s))
    return (blocks + planar + 1) >> 1
