"""Batched intra prediction: planar / DC / 65 angular modes (+PDPC).

PyTorch counterpart of `vvc_mm_tpu/common/intra.py` (reference:
source/Lib/CommonLib/IntraPrediction.cpp).  The projection of every angular
mode for a block size is precomputed on the host into static (65, H, W)
gather-index + weight tables over a combined 1-D reference vector
    c = [left[H+W-1] .. left[0], corner, top[0] .. top[H+W-1]]
(corner at index H+W), so predicting all 67 modes for a batch of blocks is
two gathers and one weighted add.  Unavailable reference samples are not
substituted (the recon buffer starts at 1<<(bd-1)), exactly as in the JAX
package, so prediction is bit-exact with it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# VVC intra angle table (spec Table 8-8): absAngMode 0..16 -> angle (1/32 pel)
_ANG_TABLE = np.array([0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20, 23, 26,
                       29, 32], dtype=np.int64)


def _mode_angle(mode: int) -> tuple[int, bool]:
    """(intraPredAngle, is_vertical_group) for mode in 2..66."""
    assert 2 <= mode <= 66
    if mode >= 34:                     # vertical group: predict from top
        delta = mode - 50              # VER_IDX = 50
        sign = 1 if delta >= 0 else -1
        return sign * int(_ANG_TABLE[abs(delta)]), True
    delta = 18 - mode                  # HOR_IDX = 18; transposed group
    sign = 1 if delta >= 0 else -1
    return sign * int(_ANG_TABLE[abs(delta)]), False


@functools.lru_cache(maxsize=None)
def angular_tables(h: int, w: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static gather tables for all 65 angular modes of an (h, w) block.

    Returns (idx0, idx1, frac), each int32 (65, h, w), indexing the combined
    reference vector c.  pred = ((32-frac)*c[idx0] + frac*c[idx1] + 16) >> 5.

    Negative-angle main-reference extension (the runtime invAngle projection
    of the reference, IntraPrediction.cpp xPredIntraAng) is baked into the
    tables: integer main-ref coordinate p <= -2 maps to the side reference at
    j = (((p+1) * invAngle + 128) >> 8) - 1 with invAngle = round(8192/angle).
    """
    side_len = h + w                    # samples on each side of the corner
    corner = side_len                   # c-index of the corner sample

    idx0 = np.zeros((65, h, w), dtype=np.int32)
    idx1 = np.zeros((65, h, w), dtype=np.int32)
    frac = np.zeros((65, h, w), dtype=np.int32)

    for mode in range(2, 67):
        angle, vertical = _mode_angle(mode)
        # main/side ref c-index maps for this group
        if vertical:
            def main_c(k: int) -> int:     # top[k], k in [0, side_len)
                return corner + 1 + min(k, side_len - 1)

            def side_c(j: int) -> int:     # left[j]
                return corner - 1 - min(j, side_len - 1)
        else:
            def main_c(k: int) -> int:     # left[k]
                return corner - 1 - min(k, side_len - 1)

            def side_c(j: int) -> int:     # top[j]
                return corner + 1 + min(j, side_len - 1)

        inv_angle = round(8192 / angle) if angle < 0 else 0

        def map_main(p: int) -> int:
            """Integer main-ref coordinate -> c index (projecting p<=-2 onto
            the side reference for negative angles)."""
            if p >= 0:
                return main_c(p)
            if p == -1:
                return corner
            j = (((p + 1) * inv_angle + 128) >> 8) - 1
            return side_c(max(j, 0))

        bh, bw = (h, w) if vertical else (w, h)
        for yy in range(bh):
            off = ((yy + 1) * angle) >> 5
            fr = ((yy + 1) * angle) & 31
            for xx in range(bw):
                p = xx + off
                y_, x_ = (yy, xx) if vertical else (xx, yy)
                idx0[mode - 2, y_, x_] = map_main(p)
                idx1[mode - 2, y_, x_] = map_main(p + 1)
                frac[mode - 2, y_, x_] = fr
    return idx0, idx1, frac


@functools.lru_cache(maxsize=None)
def _tables_flat(h: int, w: int):
    i0, i1, fr = angular_tables(h, w)
    return i0.reshape(-1), i1.reshape(-1), fr.reshape(65, h, w)


@functools.lru_cache(maxsize=None)
def _tables_on(h: int, w: int, device: torch.device):
    """The angular tables on `device`, copied there once (a copy per call
    makes the host wait for the device).  Read-only."""
    i0, i1, fr = _tables_flat(h, w)
    return (torch.as_tensor(i0, dtype=torch.int64, device=device),
            torch.as_tensor(i1, dtype=torch.int64, device=device),
            torch.as_tensor(fr, dtype=torch.int32, device=device))


def _planar(top: torch.Tensor, left: torch.Tensor, h: int, w: int
            ) -> torch.Tensor:
    """VVC planar (reference: IntraPrediction.cpp:295 xPredIntraPlanar).
    top/left: (B, side_len) int32."""
    log2w = w.bit_length() - 1
    log2h = h.bit_length() - 1
    dev = top.device
    xs = torch.arange(w, dtype=torch.int32, device=dev)
    ys = torch.arange(h, dtype=torch.int32, device=dev)
    top_row = top[:, :w]                       # (B, w)
    left_col = left[:, :h]                     # (B, h)
    top_right = top[:, w][:, None, None]       # (B,1,1)
    bottom_left = left[:, h][:, None, None]
    hor = ((w - 1 - xs)[None, None, :] * left_col[:, :, None]
           + (xs + 1)[None, None, :] * top_right)
    ver = ((h - 1 - ys)[None, :, None] * top_row[:, None, :]
           + (ys + 1)[None, :, None] * bottom_left)
    return ((hor << log2h) + (ver << log2w) + (h * w)) >> (log2w + log2h + 1)


def _dc(top: torch.Tensor, left: torch.Tensor, h: int, w: int
        ) -> torch.Tensor:
    """VVC DC (reference: IntraPrediction.cpp:353 xPredIntraDc).
    Returns (B, 1, 1)."""
    i32 = torch.int32
    if w == h:
        s = top[:, :w].sum(1, dtype=i32) + left[:, :h].sum(1, dtype=i32)
        dc = (s + w) >> (w.bit_length())          # / (2w)
    elif w > h:
        dc = (top[:, :w].sum(1, dtype=i32) + (w >> 1)) >> (w.bit_length() - 1)
    else:
        dc = (left[:, :h].sum(1, dtype=i32) + (h >> 1)) >> (h.bit_length() - 1)
    return dc[:, None, None]


def _pdpc(pred: torch.Tensor, top: torch.Tensor, left: torch.Tensor,
          h: int, w: int) -> torch.Tensor:
    """Position-dependent prediction combination for planar/DC."""
    scale = ((w.bit_length() - 1) + (h.bit_length() - 1) - 2) >> 2
    dev = pred.device
    xs = torch.arange(w, dtype=torch.int32, device=dev)
    ys = torch.arange(h, dtype=torch.int32, device=dev)
    wl = (32 >> torch.clamp((2 * xs) >> scale, max=31))[None, None, :]
    wt = (32 >> torch.clamp((2 * ys) >> scale, max=31))[None, :, None]
    lv = left[:, :h][:, :, None]
    tv = top[:, :w][:, None, :]
    return (wl * lv + wt * tv + (64 - wl - wt) * pred + 32) >> 6


def predict_all_modes(cref: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 2*(h+w)+1) combined reference vectors -> (B, 67, h, w) int32
    predictions (mode index = VVC mode number)."""
    corner = h + w
    left = torch.flip(cref[:, :corner], [1])   # (B, h+w) j ascending
    top = cref[:, corner + 1:]                 # (B, h+w)
    b = cref.shape[0]
    planar = _pdpc(_planar(top, left, h, w), top, left, h, w)
    dc = _pdpc(_dc(top, left, h, w).expand(b, h, w), top, left, h, w)
    i0, i1, fr = _tables_on(h, w, cref.device)
    g0 = cref[:, i0].reshape(-1, 65, h, w)
    g1 = cref[:, i1].reshape(-1, 65, h, w)
    ang = ((32 - fr)[None] * g0 + fr[None] * g1 + 16) >> 5
    return torch.cat([planar[:, None], dc[:, None], ang], dim=1)


def predict_mode(cref: torch.Tensor, modes: torch.Tensor, h: int, w: int
                 ) -> torch.Tensor:
    """Predict one (per-block) mode: (B, L), (B,) -> (B, h, w)."""
    allp = predict_all_modes(cref, h, w)
    idx = modes.to(torch.int64)[:, None, None, None].expand(-1, 1, h, w)
    return torch.gather(allp, 1, idx)[:, 0]
