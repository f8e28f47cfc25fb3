"""ROM tables: transform core matrices, coefficient scan orders, quant scales.

TPU-native analog of the reference's Rom.cpp / RomTr.cpp (reference:
source/Lib/CommonLib/Rom.cpp:1-1017, RomTr.cpp).  Unlike the reference, which
stores hand-written constant tables, every matrix here is *generated* from the
defining cosine/sine formulas at import time and cached as numpy int32 arrays.

Numerics:
* DST-VII / DCT-VIII matrices produced by the closed-form rounding formula
  reproduce the VVC spec tables exactly (the spec defines them that way).
* DCT-II matrices are the formula-rounded integer DCT; the H.266 spec tables
  contain a handful of legacy hand-tuned entries (e.g. 83/36 vs 84/35 in the
  4-point matrix) inherited from H.264.  Our codec is self-consistent
  (encoder and decoder share these matrices); swapping in the spec tables is a
  1-function change when standard-conformant bitstreams are targeted.

All matrices use the VVC fixed-point convention: rows are orthonormal basis
vectors scaled by 64*sqrt(N) (6-bit matrix precision, TRANSFORM_MATRIX_SHIFT=6
in the reference, TrQuant_EMT.cpp).
"""
from __future__ import annotations

import functools
import math

import numpy as np

# supported 1-D transform sizes
TR_SIZES = (2, 4, 8, 16, 32, 64)

# transform types (reference: TrQuant.cpp:619 getTrTypes / MTS)
DCT2 = 0
DST7 = 1
DCT8 = 2


@functools.lru_cache(maxsize=None)
def dct2_matrix(n: int) -> np.ndarray:
    """N-point integer DCT-II, rows scaled to norm 64*sqrt(N).

    T[i][j] = round(64 * sqrt(2) * cos(pi*i*(2j+1)/(2N))), T[0][j] = 64.
    (reference analog: RomTr.cpp g_trCoreDCT2P4..P64)
    """
    t = np.zeros((n, n), dtype=np.int32)
    t[0, :] = 64
    for i in range(1, n):
        for j in range(n):
            t[i, j] = int(round(64.0 * math.sqrt(2.0)
                                * math.cos(math.pi * i * (2 * j + 1) / (2 * n))))
    return t


@functools.lru_cache(maxsize=None)
def dst7_matrix(n: int) -> np.ndarray:
    """N-point integer DST-VII (reference analog: RomTr.cpp g_trCoreDST7P4..).

    T[i][j] = round(64*sqrt(N) * sqrt(4/(2N+1)) * sin(pi*(2i+1)*(j+1)/(2N+1)))
    — this formula reproduces the VVC spec tables exactly.
    """
    s = 64.0 * math.sqrt(n) * math.sqrt(4.0 / (2 * n + 1))
    t = np.zeros((n, n), dtype=np.int32)
    for i in range(n):
        for j in range(n):
            t[i, j] = int(round(s * math.sin(math.pi * (2 * i + 1) * (j + 1)
                                             / (2 * n + 1))))
    return t


@functools.lru_cache(maxsize=None)
def dct8_matrix(n: int) -> np.ndarray:
    """N-point integer DCT-VIII (reference analog: RomTr.cpp g_trCoreDCT8P4..).

    T[i][j] = round(64*sqrt(N) * sqrt(4/(2N+1)) * cos(pi*(2i+1)*(2j+1)/(4N+2)))
    """
    s = 64.0 * math.sqrt(n) * math.sqrt(4.0 / (2 * n + 1))
    t = np.zeros((n, n), dtype=np.int32)
    for i in range(n):
        for j in range(n):
            t[i, j] = int(round(s * math.cos(math.pi * (2 * i + 1) * (2 * j + 1)
                                             / (4 * n + 2))))
    return t


def tr_matrix(tr_type: int, n: int) -> np.ndarray:
    if tr_type == DCT2:
        return dct2_matrix(n)
    if tr_type == DST7:
        return dst7_matrix(n)
    if tr_type == DCT8:
        return dct8_matrix(n)
    raise ValueError(f"unknown transform type {tr_type}")


# ---------------------------------------------------------------------------
# Quantization scales (published VVC/HEVC constants;
# reference: Quant.cpp g_quantScales / g_invQuantScales)
# ---------------------------------------------------------------------------
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564],
                        dtype=np.int32)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)

QUANT_SHIFT = 14          # log2 of the quantScales fixed-point base
IQUANT_SHIFT = 6          # log2 of invQuantScales base at qp%6==4 (64)


# ---------------------------------------------------------------------------
# Coefficient scan orders (reference: Rom.cpp initROM scan order tables).
# VVC scans 4x4 coefficient groups (CGs) and coefficients inside a CG in
# up-right diagonal order, starting from the DC (top-left), and codes them in
# *reverse* scan order.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def diag_scan(w: int, h: int) -> np.ndarray:
    """Up-right diagonal scan positions for a w x h grid.

    Returns (w*h, 2) int32 array of (x, y) positions in scan order
    (DC first).  Matches VVC's diagonal scan: diagonals d = x+y ascending,
    within a diagonal y descending (bottom-left to top-right).
    """
    pos = []
    for d in range(w + h - 1):
        for y in range(min(d, h - 1), -1, -1):
            x = d - y
            if x < w:
                pos.append((x, y))
    return np.array(pos, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def scan_order(log2w: int, log2h: int) -> np.ndarray:
    """Flat scan index map for a transform block: scan[i] = y*W + x of the
    i-th scanned coefficient, scanning CGs diagonally and coefficients inside
    each 4x4 CG diagonally (VVC residual_coding scan)."""
    w, h = 1 << log2w, 1 << log2h
    cgw, cgh = min(w, 4), min(h, 4)
    ncgx, ncgy = w // cgw, h // cgh
    cg_scan = diag_scan(ncgx, ncgy)
    in_scan = diag_scan(cgw, cgh)
    out = np.zeros(w * h, dtype=np.int32)
    i = 0
    for cgx, cgy in cg_scan:
        for sx, sy in in_scan:
            x = cgx * cgw + sx
            y = cgy * cgh + sy
            out[i] = y * w + x
            i += 1
    return out


# ---------------------------------------------------------------------------
# Golomb-Rice / exp-Golomb helpers used by residual binarization
# ---------------------------------------------------------------------------
