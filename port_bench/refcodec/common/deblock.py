"""In-loop deblocking filter — all edges of a frame filtered in parallel.

PyTorch counterpart of `vvc_mm_tpu/common/deblock.py`, the TPU-native
analog of the reference DeblockingFilter (reference:
source/Lib/CommonLib/DeblockingFilter.cpp — deblockingFilterPic:150 drives
per-CTU xDeblockCU over vertical then horizontal edges; per-4-line
decisions with beta/tc thresholds; strong/weak luma filters; chroma
filtered only at bs==2 edges).

Re-design: with the uniform block grid, edges are >= 8 px apart, and a
deblocking edge only touches +-3 samples while decisions read +-4 — edges
never overlap, so EVERY vertical edge of the frame filters in one
vectorized step (then horizontal).  Decisions follow the HEVC/VVC scheme:
d = dp0+dq0+dp3+dq3 per 4-line segment against beta(QP), strong-filter
test per segment, tc-clipped weak filter otherwise.

Boundary strengths (reference: DeblockingFilter xGetBoundaryStrengthSingle):
2 if either side intra; 1 if either side has coded residual or the MV
difference is >= half-pel; else 0.  Both encoder and decoder call
`deblock_frame` on the reconstruction with identical inputs -> recon
stays bit-exact.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

# HEVC/VVC beta and tc tables (H.265 Table 8-12; VVC inherits the scheme)
BETA_TABLE = np.array(
    [0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
                26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54,
                56, 58, 60, 62, 64], dtype=np.int32)
TC_TABLE = np.array(
    [0] * 18 + [1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
                5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24],
    dtype=np.int32)


def _tables(qp: int, bs_offset: int, bit_depth: int):
    beta = int(BETA_TABLE[np.clip(qp, 0, 51)]) << (bit_depth - 8)
    tc = int(TC_TABLE[np.clip(qp + bs_offset, 0, 53)]) << (bit_depth - 8)
    return beta, tc


def _filter_luma_edges(plane: torch.Tensor, edge_pos: np.ndarray,
                       bs: torch.Tensor, qp: int, bit_depth: int
                       ) -> torch.Tensor:
    """Filter all vertical luma edges at columns `edge_pos`.

    plane: (H, W); bs: (n_edges, H) per-line boundary strength (already
    broadcast from per-block-pair values).  Horizontal edges reuse this via
    transpose."""
    if len(edge_pos) == 0:
        return plane
    h = plane.shape[0]
    idx = torch.as_tensor(edge_pos[:, None] + np.arange(-4, 4)[None, :],
                          device=plane.device)        # (E, 8) p3..p0 q0..q3
    seg = plane[:, idx]                               # (H, E, 8)
    seg = seg.permute(1, 0, 2)                        # (E, H, 8)
    p3, p2, p1, p0 = seg[..., 0], seg[..., 1], seg[..., 2], seg[..., 3]
    q0, q1, q2, q3 = seg[..., 4], seg[..., 5], seg[..., 6], seg[..., 7]

    beta1, tc1 = _tables(qp, 0, bit_depth)
    beta2, tc2 = _tables(qp, 2, bit_depth)
    tc = torch.where(bs >= 2, tc2, tc1).to(torch.int32)
    beta = torch.where(bs >= 2, beta2, beta1).to(torch.int32)

    dp = torch.abs(p2 - 2 * p1 + p0)                    # (E, H)
    dq = torch.abs(q2 - 2 * q1 + q0)
    # per-4-line segment decision from lines 0 and 3
    nseg = h // 4
    dp_s = dp.reshape(-1, nseg, 4)
    dq_s = dq.reshape(-1, nseg, 4)
    d_seg = dp_s[:, :, 0] + dq_s[:, :, 0] + dp_s[:, :, 3] + dq_s[:, :, 3]
    beta_s = beta.reshape(-1, nseg, 4)[:, :, 0]
    tc_s = tc.reshape(-1, nseg, 4)[:, :, 0]
    filter_on = (d_seg < beta_s) & (tc_s > 0)
    sw0 = 2 * (dp_s[:, :, 0] + dq_s[:, :, 0]) < (beta_s >> 2)
    sw3 = 2 * (dp_s[:, :, 3] + dq_s[:, :, 3]) < (beta_s >> 2)
    sp0 = (torch.abs(p3 - p0) + torch.abs(q0 - q3)).reshape(-1, nseg, 4)
    sd0 = (torch.abs(p0 - q0)).reshape(-1, nseg, 4)
    strong = (filter_on & sw0 & sw3
              & (sp0[:, :, 0] < (beta_s >> 3)) & (sp0[:, :, 3] < (beta_s >> 3))
              & (sd0[:, :, 0] < ((tc_s * 5 + 1) >> 1))
              & (sd0[:, :, 3] < ((tc_s * 5 + 1) >> 1)))

    # broadcast segment decisions to lines
    rep = lambda a: a.repeat_interleave(4, dim=1)
    f_on = rep(filter_on)
    f_strong = rep(strong)
    tc_l = tc
    # weak filter
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    d_ok = torch.abs(delta) < (tc_l * 10)
    delta = torch.clamp(delta, -tc_l, tc_l)
    p0w = p0 + torch.where(d_ok, delta, 0)
    q0w = q0 - torch.where(d_ok, delta, 0)
    # side taps of the weak filter (HEVC dEp/dEq decisions, per segment)
    dp_side = rep((dp_s[:, :, 0] + dp_s[:, :, 3])
                  < ((beta_s + (beta_s >> 1)) >> 3))
    dq_side = rep((dq_s[:, :, 0] + dq_s[:, :, 3])
                  < ((beta_s + (beta_s >> 1)) >> 3))
    tc2_l = tc_l >> 1
    dp1 = torch.clamp((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1, -tc2_l, tc2_l)
    dq1 = torch.clamp((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1, -tc2_l, tc2_l)
    p1w = p1 + torch.where(d_ok & dp_side, dp1, 0)
    q1w = q1 + torch.where(d_ok & dq_side, dq1, 0)
    # strong filter
    p0s = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
    p1s = (p2 + p1 + p0 + q0 + 2) >> 2
    p2s = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
    q0s = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
    q1s = (q2 + q1 + q0 + p0 + 2) >> 2
    q2s = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3
    tc2x = 2 * tc_l
    clip_s = lambda new, old: old + torch.clamp(new - old, -tc2x, tc2x)

    maxv = (1 << bit_depth) - 1
    cl = lambda x: torch.clamp(x, 0, maxv)

    out = seg
    sel = lambda s_val, w_val, old: cl(torch.where(
        f_on & f_strong, s_val, torch.where(f_on, w_val, old)))
    new_p2 = sel(clip_s(p2s, p2), p2, p2)
    new_p1 = sel(clip_s(p1s, p1), p1w, p1)
    new_p0 = sel(clip_s(p0s, p0), p0w, p0)
    new_q0 = sel(clip_s(q0s, q0), q0w, q0)
    new_q1 = sel(clip_s(q1s, q1), q1w, q1)
    new_q2 = sel(clip_s(q2s, q2), q2, q2)
    out = torch.stack([p3, new_p2, new_p1, new_p0, new_q0, new_q1, new_q2,
                       q3], -1).to(plane.dtype)
    out = out.permute(1, 0, 2)                         # (H, E, 8)
    plane = plane.clone()
    plane[:, idx] = out
    return plane


def _filter_chroma_edges(plane: torch.Tensor, edge_pos: np.ndarray,
                         bs: torch.Tensor, qp: int, bit_depth: int
                         ) -> torch.Tensor:
    if len(edge_pos) == 0:
        return plane
    idx = torch.as_tensor(edge_pos[:, None] + np.arange(-2, 2)[None, :],
                          device=plane.device)        # p1 p0 q0 q1
    seg = plane[:, idx].permute(1, 0, 2)               # (E, H, 4)
    p1, p0, q0, q1 = seg[..., 0], seg[..., 1], seg[..., 2], seg[..., 3]
    _, tc = _tables(qp, 2, bit_depth)
    on = bs >= 2                                       # chroma: intra only
    delta = torch.clamp((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
    maxv = (1 << bit_depth) - 1
    new_p0 = torch.clamp(p0 + torch.where(on, delta, 0), 0, maxv)
    new_q0 = torch.clamp(q0 - torch.where(on, delta, 0), 0, maxv)
    seg = torch.stack([p1, new_p0, new_q0, q1], -1).to(plane.dtype)
    plane = plane.clone()
    plane[:, idx] = seg.permute(1, 0, 2)
    return plane


def _bs_to_lines(bs_blocks: torch.Tensor, block_span: int, n_lines: int
                 ) -> torch.Tensor:
    """(n_edges, n_blocks) per-block-pair bs -> (n_edges, n_lines)."""
    return bs_blocks.repeat_interleave(block_span, dim=1)[:, :n_lines]


def deblock_frame(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  bs_ver: torch.Tensor, bs_hor: torch.Tensor,
                  block_size: int, qp: int, bit_depth: int = 8):
    """Deblock one frame in-loop (vertical edges then horizontal —
    reference: deblockingFilterPic edge-direction order).

    bs_ver: (nby, nbx-1) boundary strength of vertical edges (between
    horizontally adjacent blocks); bs_hor: (nby-1, nbx)."""
    s = block_size
    h, w = y.shape
    nby, nbx = h // s, w // s
    # --- luma vertical ---
    ev = np.arange(1, nbx) * s
    bs_ver = torch.as_tensor(bs_ver, device=y.device)
    bs_hor = torch.as_tensor(bs_hor, device=y.device)
    bs_v = _bs_to_lines(bs_ver.T, s, h)                # (E, H)
    y = _filter_luma_edges(y, ev, bs_v, qp, bit_depth)
    # --- luma horizontal (transpose trick) ---
    eh = np.arange(1, nby) * s
    bs_h = _bs_to_lines(bs_hor, s, w)                  # (E, W)
    y = _filter_luma_edges(y.T, eh, bs_h, qp, bit_depth).T.contiguous()
    # --- chroma (4:2:0, edges at s//2 spacing, bs==2 only) ---
    sc = s // 2
    hc, wc = u.shape
    evc = np.arange(1, nbx) * sc
    ehc = np.arange(1, nby) * sc
    bs_vc = _bs_to_lines(bs_ver.T, sc, hc)
    bs_hc = _bs_to_lines(bs_hor, sc, wc)
    qpc = qp                                            # chroma QP = luma (round-1)
    u = _filter_chroma_edges(u, evc, bs_vc, qpc, bit_depth)
    u = _filter_chroma_edges(u.T, ehc, bs_hc, qpc, bit_depth).T.contiguous()
    v = _filter_chroma_edges(v, evc, bs_vc, qpc, bit_depth)
    v = _filter_chroma_edges(v.T, ehc, bs_hc, qpc, bit_depth).T.contiguous()
    return y, u, v


def boundary_strengths_intra(nby: int, nbx: int, device=None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """All-intra frame: every edge has bs=2 (on `device`, CUDA unless
    another device is named)."""
    device = resolve_device(device)
    return (torch.full((nby, nbx - 1), 2, dtype=torch.int32, device=device),
            torch.full((nby - 1, nbx), 2, dtype=torch.int32, device=device))


def boundary_strengths_inter(mvs: torch.Tensor, has_resid: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """P-frame bs from per-block MVs (1/16-pel) and cbf (reference:
    xGetBoundaryStrengthSingle — mv diff >= half-pel (8 units) or coded
    residual on either side -> bs 1, else 0)."""
    dv = (mvs[:, 1:] - mvs[:, :-1]).abs().amax(dim=-1)
    rv = has_resid[:, 1:] | has_resid[:, :-1]
    bs_ver = ((dv >= 8) | rv).to(torch.int32)
    dh = (mvs[1:] - mvs[:-1]).abs().amax(dim=-1)
    rh = has_resid[1:] | has_resid[:-1]
    bs_hor = ((dh >= 8) | rh).to(torch.int32)
    return bs_ver, bs_hor
