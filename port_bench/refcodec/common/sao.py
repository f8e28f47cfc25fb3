"""Sample Adaptive Offset — estimation and application.

PyTorch counterpart of `estimate_sao` and `apply_sao` in
`vvc_mm_tpu/common/sao.py` (reference:
source/Lib/CommonLib/SampleAdaptiveOffset.cpp — SAOProcess:613,
offsetCTU:544; EncoderLib/EncSampleAdaptiveOffset.cpp).  Per-64x64-region
params: type 0 off, 1 band offset (4 consecutive bands of 32), 2..5 edge
offset (0/90/135/45 degrees) with the 4 HEVC edge categories.
"""
from __future__ import annotations

import torch

REGION = 64            # SAO region = CTU size
MAX_OFFSET = 7         # |offset| cap at 8 bit (reference: SAO offset range)

_EO_DIRS = {2: ((0, -1), (0, 1)),      # horizontal
            3: ((-1, 0), (1, 0)),      # vertical
            4: ((-1, -1), (1, 1)),     # 135 diagonal
            5: ((-1, 1), (1, -1))}     # 45 diagonal


def eo_category(plane: torch.Tensor, sao_type: int) -> torch.Tensor:
    """Edge-offset category map 0..4: 1 valley, 2 concave edge, 0 none,
    3 convex edge, 4 peak; frame-border samples whose neighbour would wrap
    get 0."""
    (dy0, dx0), (dy1, dx1) = _EO_DIRS[sao_type]
    n0 = torch.roll(plane, (-dy0, -dx0), (0, 1))
    n1 = torch.roll(plane, (-dy1, -dx1), (0, 1))
    s = torch.sign(plane - n0) + torch.sign(plane - n1)
    cat = torch.zeros_like(s, dtype=torch.int32)
    for val, c in ((-2, 1), (-1, 2), (1, 3), (2, 4)):
        cat = torch.where(s == val, c, cat)
    h, w = plane.shape
    yy = torch.arange(h, device=plane.device)[:, None]
    xx = torch.arange(w, device=plane.device)[None, :]
    valid = torch.ones_like(cat, dtype=torch.bool)
    for (dy, dx) in ((dy0, dx0), (dy1, dx1)):
        if dy:
            valid = valid & (yy + dy >= 0) & (yy + dy < h)
        if dx:
            valid = valid & (xx + dx >= 0) & (xx + dx < w)
    return torch.where(valid, cat, 0)


def band_index(plane: torch.Tensor, bit_depth: int) -> torch.Tensor:
    return (plane >> (bit_depth - 5)).to(torch.int32)   # 32 bands


def apply_sao(recon: torch.Tensor, types, offsets, band_pos,
              bit_depth: int = 8) -> torch.Tensor:
    """Apply per-region SAO params: types/band_pos (gy, gx), offsets
    (gy, gx, 4)."""
    dev = recon.device
    types = torch.as_tensor(types, device=dev)
    offsets = torch.as_tensor(offsets, device=dev).to(torch.int32)
    band_pos = torch.as_tensor(band_pos, device=dev)
    h, w = recon.shape

    def upsample(a):
        return a.repeat_interleave(REGION, 0).repeat_interleave(
            REGION, 1)[:h, :w]

    t_map = upsample(types)
    bp_map = upsample(band_pos)
    off_maps = [upsample(offsets[..., c]) for c in range(4)]

    out = recon
    # band offset
    rel = torch.remainder(band_index(recon, bit_depth) - bp_map, 32)
    bo = torch.zeros_like(recon)
    for c in (3, 2, 1, 0):
        bo = torch.where(rel == c, off_maps[c], bo)
    out = out + torch.where(t_map == 1, bo, 0)
    # edge offsets
    for t in (2, 3, 4, 5):
        cat = eo_category(recon, t)
        eo = torch.zeros_like(recon)
        for c in (4, 3, 2, 1):
            eo = torch.where(cat == c, off_maps[c - 1], eo)
        out = out + torch.where(t_map == t, eo, 0)
    return torch.clamp(out, 0, (1 << bit_depth) - 1).to(torch.int32)


