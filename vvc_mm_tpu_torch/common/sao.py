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


def _region_sums(x: torch.Tensor, gy: int, gx: int) -> torch.Tensor:
    """(H, W) -> (gy, gx) region sums (REGION-aligned, padded frames)."""
    h, w = x.shape
    return x.reshape(gy, h // gy, gx, w // gx).sum(dim=(1, 3)) \
        .to(torch.int32)


def _pad_edge(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    h, w = x.shape
    ys = torch.clamp(torch.arange(ph, device=x.device), max=h - 1)
    xs = torch.clamp(torch.arange(pw, device=x.device), max=w - 1)
    return x[ys][:, xs]


def estimate_sao(orig: torch.Tensor, recon: torch.Tensor, lam: float,
                 bit_depth: int = 8):
    """Choose per-region SAO params.

    Returns (types (gy,gx) int32, offsets (gy,gx,4) int32, band_pos
    (gy,gx) int32).  The offsets are one correctly rounded float32
    division of integers each (round half to even), the costs float32
    sums of integer-valued gains in the JAX package's order, and the type
    and band choices take the FIRST minimum, so the parameters equal the
    JAX package's exactly."""
    from .inter_frame import first_argmin
    h, w = orig.shape
    dev = orig.device
    gy = -(-h // REGION)
    gx = -(-w // REGION)
    ph, pw = gy * REGION, gx * REGION
    if (ph, pw) != (h, w):
        # pad to region multiples with equal orig/recon (no contribution)
        orig = _pad_edge(orig, ph, pw)
        recon = _pad_edge(recon, ph, pw)
    diff = (orig - recon).to(torch.int32)
    lam32 = torch.tensor(lam, dtype=torch.float32, device=dev)
    zeros_g = torch.zeros((gy, gx), dtype=torch.int32, device=dev)

    def offset_and_gain(mask):
        m = mask.to(torch.int32)
        cnt = _region_sums(m, gy, gx)
        sd = _region_sums(diff * m, gy, gx)
        o = torch.round(sd.to(torch.float32)
                        / torch.clamp(cnt, min=1).to(torch.float32)
                        ).to(torch.int32)
        o = torch.clamp(o, -MAX_OFFSET, MAX_OFFSET)
        # SSD delta of adding offset o: sum((d-o)^2 - d^2) = n*o^2-2*o*sd
        g = (cnt * o * o - 2 * o * sd).to(torch.float32)
        # never accept an offset that increases distortion
        o = torch.where(g > 0, 0, o)
        return o, torch.clamp(g, max=0.0)

    # type 0: off
    costs = [torch.zeros((gy, gx), dtype=torch.float32, device=dev)]
    all_offsets = [torch.zeros((gy, gx, 4), dtype=torch.int32, device=dev)]
    all_bandpos = [zeros_g]

    # band offset: 32 bands -> per-band offsets, pick best 4-consecutive run
    bidx = band_index(recon, bit_depth)
    band = [offset_and_gain(bidx == b) for b in range(32)]
    band_off = torch.stack([o for o, _ in band], dim=-1)     # (gy, gx, 32)
    runs = torch.stack(
        [((band[st][1] + band[st + 1][1]) + band[st + 2][1])
         + band[st + 3][1] for st in range(29)], dim=-1)     # (gy, gx, 29)
    best_start = first_argmin(runs, 2)
    bo_gain = runs.min(dim=-1).values
    bo_offsets = torch.gather(
        band_off, 2, best_start[..., None]
        + torch.arange(4, device=dev)[None, None, :])
    costs.append(bo_gain + lam32 * (4 * 4 + 5 + 3))
    all_offsets.append(bo_offsets)
    all_bandpos.append(best_start.to(torch.int32))

    for t in (2, 3, 4, 5):
        cat = eo_category(recon, t)
        offs = []
        gain = torch.zeros((gy, gx), dtype=torch.float32, device=dev)
        for c in range(1, 5):
            o, g = offset_and_gain(cat == c)
            offs.append(o)
            gain = gain + g
        # EO sign constraints (valley/concave >= 0, convex/peak <= 0)
        offs = torch.stack([torch.clamp(offs[0], min=0),
                            torch.clamp(offs[1], min=0),
                            torch.clamp(offs[2], max=0),
                            torch.clamp(offs[3], max=0)], dim=-1)
        costs.append(gain + lam32 * (4 * 4 + 3))
        all_offsets.append(offs)
        all_bandpos.append(zeros_g)

    types = first_argmin(torch.stack(costs), 0)
    offsets = torch.gather(torch.stack(all_offsets), 0,
                           types[None, ..., None].expand(1, gy, gx, 4))[0]
    band_pos = torch.gather(torch.stack(all_bandpos), 0, types[None])[0]
    return types.to(torch.int32), offsets, band_pos
