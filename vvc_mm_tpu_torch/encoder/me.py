"""Batched motion estimation — full-search integer + fractional refinement.

PyTorch counterpart of `integer_search`, `hierarchical_search` and
`fractional_refine` in `vvc_mm_tpu/encoder/me.py`, and of their
rectangular forms `*_rect` for the MTT's binary and ternary leaves; the
square versions are the rectangular ones at sy = sx (reference:
source/Lib/EncoderLib/InterSearch.cpp — xMotionEstimation:4937 TZ search +
fractional refinement).  Instead of a serial, divergent pattern search,
every displacement of the window is a full-frame shift-and-SAD reduced per
block, all blocks at once, then an argmin; the fractional refinement
evaluates the half- and quarter-pel neighbours of every block through the
real 8-tap MC filter.  All integer math: the results equal the JAX
package's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..common import interp
from ..common.inter_frame import first_argmin


def _block_sums_rect(x: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """Sum (H, W) -> (H/sy, W/sx) over sy x sx tiles."""
    h, w = x.shape
    return x.reshape(h // sy, sy, w // sx, sx).sum(dim=(1, 3))


def integer_search(orig: torch.Tensor, ref_padded: torch.Tensor,
                   block_size: int, search_range: int, margin: int = 0,
                   lambda_bits_x16: int = 0):
    """integer_search_rect over square blocks."""
    return integer_search_rect(orig, ref_padded, block_size, block_size,
                               search_range, margin, lambda_bits_x16)


def integer_search_rect(orig: torch.Tensor, ref_padded: torch.Tensor,
                        sy: int, sx: int, search_range: int,
                        margin: int = 0, lambda_bits_x16: int = 0):
    """Exhaustive integer-pel search for every (sy x sx) block of a frame
    (rectangular blocks are the MTT's binary and ternary leaves,
    reference: UnitPartitioner.h:56-64).

    Args:
      orig: (H, W) int32 original luma.
      ref_padded: (H + 2*margin, W + 2*margin) int32 reference with
        edge-extended margin >= search_range.
      lambda_bits_x16: MV-cost weight (x16 fixed point) applied to |mv| as
        a cheap rate proxy.
    Returns:
      (mv_int, sad): (nby, nbx, 2) int32 integer MVs (x, y) and their SADs.
    """
    h, w = orig.shape
    r = search_range
    m = margin if margin else r
    hp, wp = ref_padded.shape
    disp = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    disp_np = np.array(disp, dtype=np.int32)
    sads = []
    for dy, dx in disp:
        # the JAX package slices with dynamic_slice, which clamps the
        # start into range; so does this
        y0 = min(max(m + dy, 0), hp - h)
        x0 = min(max(m + dx, 0), wp - w)
        shifted = ref_padded[y0:y0 + h, x0:x0 + w]
        sads.append(_block_sums_rect((orig - shifted).abs(), sy, sx))
    sads = torch.stack(sads).to(torch.int32)              # (D, nby, nbx)
    if lambda_bits_x16:
        cost_np = np.abs(disp_np[:, 0]) + np.abs(disp_np[:, 1])
        mv_cost = torch.as_tensor((cost_np * lambda_bits_x16) >> 4,
                                  dtype=torch.int32, device=orig.device)
        total = sads + mv_cost[:, None, None]
    else:
        total = sads
    best = first_argmin(total, 0)                         # (nby, nbx)
    dtab = torch.as_tensor(disp_np, device=orig.device)
    mv_int = torch.stack([dtab[best, 1], dtab[best, 0]], dim=-1)
    sad = torch.gather(sads, 0, best[None])[0]
    return mv_int, sad


def _downsample4(x: torch.Tensor) -> torch.Tensor:
    """4x4 mean, truncated (samples are non-negative, so the JAX package's
    float mean + cast equals the integer quotient)."""
    h, w = x.shape
    return x.reshape(h // 4, 4, w // 4, 4).sum(dim=(1, 3)) // 16


def hierarchical_search(orig: torch.Tensor, ref_padded: torch.Tensor,
                        block_size: int, search_range: int, margin: int,
                        lambda_bits_x16: int = 0):
    """hierarchical_search_rect over square blocks."""
    return hierarchical_search_rect(orig, ref_padded, block_size,
                                    block_size, search_range, margin,
                                    lambda_bits_x16)


def hierarchical_search_rect(orig: torch.Tensor, ref_padded: torch.Tensor,
                             sy: int, sx: int, search_range: int,
                             margin: int, lambda_bits_x16: int = 0):
    """Coarse-to-fine integer search of (sy x sx) blocks: exhaustive at 1/4
    resolution, then a +-3 full-resolution refinement around the upscaled
    winner.

    Returns (mv_int (nby,nbx,2) in pels, sad at full resolution)."""
    h, w = orig.shape
    nby, nbx = h // sy, w // sx
    dev = orig.device
    # --- coarse: quarter resolution, quarter range, quarter block ---
    orig4 = _downsample4(orig)
    m4 = margin // 4
    o4 = margin - m4 * 4
    ref4 = _downsample4(ref_padded[o4:o4 + h + 8 * m4, o4:o4 + w + 8 * m4])
    r4 = max(search_range // 4, 2)
    mv4, _ = integer_search_rect(orig4, ref4, max(sy // 4, 1),
                                 max(sx // 4, 1), r4, m4, lambda_bits_x16)
    base = mv4 * 4                                     # (nby, nbx, 2) pels

    # --- fine: +-3 px window around the coarse winner, per-block gathers ---
    nb = nby * nbx
    idx = torch.arange(nb, dtype=torch.int32, device=dev)
    ys = (idx // nbx) * sy
    xs = (idx % nbx) * sx
    ob = orig.reshape(nby, sy, nbx, sx).permute(1, 3, 0, 2).reshape(sy, sx,
                                                                     nb)
    basef = base.reshape(nb, 2)
    win = 3
    gy = torch.clamp(ys + margin + basef[:, 1] - win, 0,
                     ref_padded.shape[0] - (sy + 2 * win))
    gx = torch.clamp(xs + margin + basef[:, 0] - win, 0,
                     ref_padded.shape[1] - (sx + 2 * win))
    patch = interp.gather_patches_t(ref_padded, gy, gx, sy + 2 * win,
                                    sx + 2 * win)     # (sy+6, sx+6, nb)
    best_sad = torch.full((nb,), 1 << 30, dtype=torch.int32, device=dev)
    best_d = torch.zeros((nb, 2), dtype=torch.int32, device=dev)
    for dy in range(2 * win + 1):
        for dx in range(2 * win + 1):
            cand = patch[dy:dy + sy, dx:dx + sx]
            sad = (cand - ob).abs().sum(dim=(0, 1)).to(torch.int32)
            better = sad < best_sad
            best_sad = torch.where(better, sad, best_sad)
            d = torch.tensor([dx - win, dy - win], dtype=torch.int32,
                             device=dev)
            best_d = torch.where(better[:, None], d[None, :], best_d)
    mv = (basef + best_d).reshape(nby, nbx, 2).to(torch.int32)
    return mv, best_sad.reshape(nby, nbx)


_NEIGH = np.array([(-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0),
                   (-1, 1), (0, 1), (1, 1)], dtype=np.int32)


def fractional_refine(orig: torch.Tensor, ref_padded: torch.Tensor,
                      mv_int: torch.Tensor, block_size: int, margin: int,
                      bit_depth: int = 8):
    """fractional_refine_rect over square blocks."""
    return fractional_refine_rect(orig, ref_padded, mv_int, block_size,
                                  block_size, margin, bit_depth)


def fractional_refine_rect(orig: torch.Tensor, ref_padded: torch.Tensor,
                           mv_int: torch.Tensor, sy: int, sx: int,
                           margin: int, bit_depth: int = 8):
    """Refine integer MVs of (sy x sx) blocks on the 1/16-pel grid: half-
    then quarter-pel diamonds, each evaluating the 8 neighbours through the
    real 8-tap MC filter (reference: InterSearch xPatternSearchFracDIF).
    The per-block reference patch is gathered once with a +-2 px slack;
    every candidate is evaluated on that patch, the +-1 integer crossings
    selecting one of the shifted windows.

    Args:
      mv_int: (nby, nbx, 2) integer-pel MVs (x, y).
    Returns:
      ((nby, nbx, 2) int32 MVs in 1/16-pel units, their SADs).
    """
    h, w = orig.shape
    nby, nbx = h // sy, w // sx
    nb = nby * nbx
    dev = orig.device
    taps = 8
    pad = 2                                   # int-crossing slack (px)
    psz_y = sy + taps - 1 + 2 * pad           # gathered patch sides
    psz_x = sx + taps - 1 + 2 * pad
    idx = torch.arange(nb, dtype=torch.int32, device=dev)
    ys = (idx // nbx) * sy
    xs = (idx % nbx) * sx
    ob = orig.reshape(nby, sy, nbx, sx).permute(1, 3, 0, 2).reshape(sy, sx,
                                                                     nb)

    mv0 = mv_int.reshape(nb, 2).to(torch.int32)
    gy = torch.clamp(ys + margin + mv0[:, 1] - (taps // 2 - 1) - pad, 0,
                     ref_padded.shape[0] - psz_y)
    gx = torch.clamp(xs + margin + mv0[:, 0] - (taps // 2 - 1) - pad, 0,
                     ref_padded.shape[1] - psz_x)
    patch = interp.gather_patches_t(ref_padded, gy, gx, psz_y, psz_x)
    patch = patch.to(torch.int32)             # (psz_y, psz_x, nb)

    table = torch.as_tensor(interp.LUMA_FILTER, dtype=torch.int32,
                            device=dev)
    shift1 = bit_depth - 8
    offs1 = (1 << (shift1 - 1)) if shift1 > 0 else 0
    fin_shift = interp.IF_INTERNAL_PREC - bit_depth
    fin_offs = 1 << (fin_shift - 1)
    maxv = (1 << bit_depth) - 1

    def eval_mv(mv_c):
        """mv_c (nb, 2) 1/16-pel; int part within mv0 +- pad."""
        fx = (mv_c[:, 0] & 15).to(torch.int64)
        fy = (mv_c[:, 1] & 15).to(torch.int64)
        ox = (mv_c[:, 0] >> 4) - mv0[:, 0] + pad      # in [0, 2*pad]
        oy = (mv_c[:, 1] >> 4) - mv0[:, 1] + pad
        cx = table[fx]                                # (nb, 8)
        cy = table[fy]
        # h-pass at every x-alignment: (psz_y, sx + 2*pad, nb)
        hw = sx + 2 * pad
        hsum = sum(patch[:, t:t + hw, :] * cx[:, t][None, None, :]
                   for t in range(taps))
        hval = (hsum + offs1) >> shift1 if shift1 > 0 else hsum
        # select the x-window at per-block alignment ox
        hsel = torch.zeros((psz_y, sx, nb), dtype=torch.int32, device=dev)
        for k in range(2 * pad + 1):
            hsel = torch.where((ox == k)[None, None, :],
                               hval[:, k:k + sx, :], hsel)
        # v-pass at every y-alignment, then select
        vh = 2 * pad + 1
        vsum = sum(hsel[t:t + vh + sy - 1, :, :] * cy[:, t][None, None, :]
                   for t in range(taps))
        val = torch.zeros((sy, sx, nb), dtype=torch.int32, device=dev)
        for k in range(vh):
            val = torch.where((oy == k)[None, None, :], vsum[k:k + sy], val)
        val = val >> 6
        pix = torch.clamp((val + fin_offs) >> fin_shift, 0, maxv)
        return (pix - ob).abs().sum(dim=(0, 1)).to(torch.int32)

    mv = mv0 * 16
    base_cost = eval_mv(mv)
    for step_pel in (8, 4):
        for k in range(8):
            d = torch.as_tensor(_NEIGH[k] * step_pel, dtype=torch.int32,
                                device=dev)
            cost = eval_mv(mv + d[None, :])
            better = cost < base_cost
            mv = torch.where(better[:, None], mv + d[None, :], mv)
            base_cost = torch.minimum(cost, base_cost)
    return mv.reshape(nby, nbx, 2), base_cost.reshape(nby, nbx)
