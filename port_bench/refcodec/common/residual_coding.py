"""Transform-coefficient entropy coding (VVC-style CG/scan/level ladder).

Copy of `vvc_mm_tpu/common/residual_coding.py`.

TPU-native analog of the reference residual coding (reference:
source/Lib/DecoderLib/CABACReader.cpp residual_coding / CommonLib/
ContextModelling.cpp CoeffCodingContext).  Host-side and strictly sequential
per substream (arithmetic coding is; SURVEY.md §7 "CABAC on host / chunked").

Scheme per transform block (self-consistent simplification of VVC):
  1. last significant scan position: x/y coordinates, each binarized as a
     context-coded truncated-unary group prefix + bypass suffix (VVC
     last_sig_coeff_x/y scheme exactly).
  2. reverse scan over 4x4 coefficient groups (diag order): sig-CG flag
     (implied for CG0 and last CG), then per coefficient: sig flag (context
     from #significant neighbors already coded in the CG), gt1, gt2, then
     bypass Rice/EG remainder with a per-CG adaptive Rice parameter, then
     bypass signs.
CBF itself is coded by the caller (block-level syntax).
"""
from __future__ import annotations

import numpy as np

from . import rom
from .cabac import BinDecoder
from .contexts import ctx_id


def _last_group(v: int) -> tuple[int, int, int]:
    """VVC last-position binarization: value -> (groupIdx, suffix_len,
    suffix)."""
    if v < 4:
        return v, 0, 0
    msb = v.bit_length() - 1
    sl = msb - 1
    g = 2 * msb + ((v >> sl) & 1)
    return g, sl, v & ((1 << sl) - 1)


def _group_min(g: int) -> int:
    if g < 4:
        return g
    sl = (g >> 1) - 1
    return (2 + (g & 1)) << sl


def _decode_last_coord(dec: BinDecoder, log2size: int, chroma: bool,
                       axis: str) -> int:
    set_name = "LastX" if axis == "x" else "LastY"
    gmax, _, _ = _last_group((1 << log2size) - 1)
    base = 20 if chroma else (log2size - 2) * 5
    g = 0
    while g < gmax and dec.decode_bin(
            ctx_id(set_name, min(base + min(g, 4), 24))):
        g += 1
    if g < 4:
        return g
    sl = (g >> 1) - 1
    return _group_min(g) + (dec.decode_bins_ep(sl) if sl else 0)


def _sig_ctx(cg: np.ndarray, pos: int, cgw: int, chroma: bool) -> int:
    """Sig-flag context from already-coded (higher scan index) neighbors
    right/below inside the CG (simplified VVC template)."""
    x, y = pos % cgw, pos // cgw
    n = 0
    if x + 1 < cgw and cg[y, x + 1] != 0:
        n += 1
    if y + 1 < cg.shape[0] and cg[y + 1, x] != 0:
        n += 1
    if x + 1 < cgw and y + 1 < cg.shape[0] and cg[y + 1, x + 1] != 0:
        n += 1
    return ctx_id("SigFlag", (12 if chroma else 0) + min(n, 2))


def decode_coeffs(dec: BinDecoder, h: int, w: int, chroma: bool
                  ) -> np.ndarray:
    """Exact inverse of encode_coeffs -> (h, w) int32 levels."""
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    scan = rom.scan_order(log2w, log2h)
    flat = np.zeros(h * w, dtype=np.int32)
    lx = _decode_last_coord(dec, log2w, chroma, "x")
    ly = _decode_last_coord(dec, log2h, chroma, "y")
    lpos = ly * w + lx
    last = int(np.nonzero(scan == lpos)[0][0])

    cgw, cgh = min(w, 4), min(h, 4)
    cg_size = cgw * cgh
    ncg = (last // cg_size) + 1
    for cgi in range(ncg - 1, -1, -1):
        base = cgi * cg_size
        implied = (cgi == ncg - 1) or (cgi == 0)
        if not implied:
            has = dec.decode_bin(ctx_id("SigCoeffGroup", 2 * int(chroma)))
            if not has:
                continue
        cg2d = np.zeros((cgh, cgw), dtype=np.int64)
        rice = 0
        start = min(last - base, cg_size - 1) if cgi == ncg - 1 else cg_size - 1
        for k in range(start, -1, -1):
            p = int(scan[base + k])
            px, py = p % w, p // w
            cx, cy = px % cgw, py % cgh
            is_last_coeff = (base + k) == last
            if is_last_coeff:
                sig = 1
            else:
                sig = dec.decode_bin(
                    _sig_ctx(cg2d, cy * cgw + cx, cgw, chroma))
            if sig:
                a = 1
                if dec.decode_bin(ctx_id("GtxFlag", 11 * int(chroma))):
                    a = 2
                    if dec.decode_bin(
                            ctx_id("GtxFlag", 11 * int(chroma) + 1)):
                        rem = dec.decode_eg(rice)
                        a = 3 + rem
                        if rem > (3 << rice):
                            rice = min(rice + 1, 4)
                cg2d[cy, cx] = a
                flat[p] = a
        for k in range(start, -1, -1):
            p = int(scan[base + k])
            if flat[p] != 0:
                if dec.decode_bin_ep():
                    flat[p] = -flat[p]
    return flat.reshape(h, w)
