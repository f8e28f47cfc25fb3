"""Intra slice entropy encoding: block modes + residual levels -> CABAC.

PyTorch-port copy of `vvc_mm_tpu/encoder/intra_coder.py` (reference:
source/Lib/EncoderLib/CABACWriter.cpp — coding_tree_unit:148,
intra_luma_pred_mode, cbf + residual_coding).  Host code over the native
CABAC encoder; it consumes the dense grids of the wavefront encode and is
the mirror of decoder/intra_parser.py.  The intra tools (CCLM, MIP, LFNST,
MRL, TS/BDPCM, IBC, MTS) and the WPP / intra-split writers raise
NotImplementedError (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import numpy as np

from ..common.contexts import ctx_id
from ..common.wavefront import mpm3_host
from ..utils.native import NativeBinEncoder


def encode_intra_mode(enc, mode: int, left: int, above: int) -> None:
    mpm = mpm3_host(left, above)
    if mode in mpm:
        enc.encode_bin(1, ctx_id("IntraLumaMpmFlag"))
        idx = mpm.index(mode)
        enc.encode_bin_ep(int(idx > 0))
        if idx > 0:
            enc.encode_bin_ep(idx - 1)
    else:
        enc.encode_bin(0, ctx_id("IntraLumaMpmFlag"))
        rem = sorted(m for m in range(67) if m not in mpm)
        enc.encode_bins_ep(rem.index(mode), 6)


def _nb(m: int) -> int:
    """Neighbour mode for MPM purposes: MIP/IBC act as planar (reference:
    UnitTools getIntraDirLuma MIP->PLANAR mapping)."""
    return 0 if m >= 67 else m


def encode_intra_slice(modes: np.ndarray, lev_y: np.ndarray,
                       lev_u: np.ndarray, lev_v: np.ndarray,
                       cclm=None, mip: bool = False, lfnst=None, mrl=None,
                       ts=None, bdpcm: bool = False, ibc: bool = False,
                       mts=None) -> bytes:
    """modes (nby, nbx); lev_* (nby, nbx, s, s).  Raster block order.  The
    tool arguments are the JAX package's; each must be off."""
    on = [k for k, v in (("cclm", cclm), ("mip", mip), ("lfnst", lfnst),
                         ("mrl", mrl), ("ts", ts), ("bdpcm", bdpcm),
                         ("ibc", ibc), ("mts", mts))
          if v is not None and v is not False]
    if on:
        raise NotImplementedError(
            f"intra tools {on}: ROADMAP queue 1 item 9 (intra tools)")
    enc = NativeBinEncoder()
    _encode_intra_rows(enc, modes, lev_y, lev_u, lev_v, 0, modes.shape[0])
    return enc.finish()


def _encode_intra_rows(enc, modes, lev_y, lev_u, lev_v, r0: int, r1: int
                       ) -> None:
    """Code block rows [r0, r1) into `enc`."""
    nbx = modes.shape[1]
    cbf_ctx = (ctx_id("QtCbf", 0), ctx_id("QtCbf", 4), ctx_id("QtCbf", 5))
    for by in range(r0, r1):
        for bx in range(nbx):
            left = _nb(int(modes[by, bx - 1])) if bx > 0 else -1
            above = _nb(int(modes[by - 1, bx])) if by > 0 else -1
            encode_intra_mode(enc, int(modes[by, bx]), left, above)
            for cid, lev in enumerate((lev_y, lev_u, lev_v)):
                blk = lev[by, bx]
                cbf = bool(np.any(blk != 0))
                enc.encode_bin(int(cbf), cbf_ctx[cid])
                if cbf:
                    enc.encode_coeffs(blk, chroma=(cid != 0))
