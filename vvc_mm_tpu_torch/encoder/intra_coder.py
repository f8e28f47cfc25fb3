"""Intra slice entropy encoding: block modes + residual levels -> CABAC.

PyTorch-port copy of `vvc_mm_tpu/encoder/intra_coder.py` (reference:
source/Lib/EncoderLib/CABACWriter.cpp — coding_tree_unit:148,
intra_luma_pred_mode, cbf + residual_coding).  Host code over the native
CABAC encoder; it consumes the dense grids of the wavefront encode and is
the mirror of decoder/intra_parser.py.  It codes the prediction tools'
syntax (IBC flag and block-vector index, MIP flag and mode,
MultiRefLineIdx, the chroma LM flag) and the residual tools' (transform
skip and BDPCM flags, lfnst_idx, tu_mts_idx), and the two-level
intra-split slice (`encode_intra_slice_part`) and the WPP slice
(`encode_intra_slice_wpp`: substreams with fresh contexts and entry
points, the framing the inter WPP writers share).
"""
from __future__ import annotations

import concurrent.futures as cf

import numpy as np

from ..common.contexts import ctx_id
from ..common.wavefront import IBC_BASE, mpm3_host
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
    tool arguments are the JAX package's: `cclm` / `mrl` / `lfnst` / `mts`
    the (nby, nbx) flag and index grids of the tools that are on, `ts` the
    transform-skip mode grid (0 regular, 1 TS, 2/3 BDPCM H/V; reference:
    transform_skip_flag + intra_bdpcm_luma_flag), `mip`, `bdpcm` and `ibc`
    the SPS flags.  Modes 67-74 are MIP modes, IBC_BASE + k the IBC block
    vector k."""
    enc = NativeBinEncoder()
    _encode_intra_rows(enc, modes, lev_y, lev_u, lev_v, 0, modes.shape[0],
                       lfnst, ts, bdpcm, mts, cclm, mip, mrl, ibc)
    return enc.finish()


def _encode_intra_rows(enc, modes, lev_y, lev_u, lev_v, r0: int, r1: int,
                       lfnst=None, ts=None, bdpcm: bool = False, mts=None,
                       cclm=None, mip: bool = False, mrl=None,
                       ibc: bool = False) -> None:
    """Code block rows [r0, r1) into `enc`."""
    nbx = modes.shape[1]
    cbf_ctx = (ctx_id("QtCbf", 0), ctx_id("QtCbf", 4), ctx_id("QtCbf", 5))
    for by in range(r0, r1):
        for bx in range(nbx):
            left = _nb(int(modes[by, bx - 1])) if bx > 0 else -1
            above = _nb(int(modes[by - 1, bx])) if by > 0 else -1
            mode = int(modes[by, bx])
            is_ibc = mode >= IBC_BASE
            if ibc:
                # pred_mode_ibc_flag + 4-bit BV index (reference:
                # CABACReader pred_mode + IBC merge/BV syntax)
                enc.encode_bin(int(is_ibc), ctx_id("IbcFlag", 0))
                if is_ibc:
                    enc.encode_bins_ep(mode - IBC_BASE, 4)
            if not is_ibc:
                if mip:
                    enc.encode_bin(int(mode >= 67), ctx_id("MipFlag"))
                if mode >= 67:
                    enc.encode_bins_ep(mode - 67, 3)
                else:
                    encode_intra_mode(enc, mode, left, above)
                    if mrl is not None:
                        enc.encode_bin(int(mrl[by, bx] != 0),
                                       ctx_id("MultiRefLineIdx"))
                if cclm is not None:
                    enc.encode_bin(int(cclm[by, bx] != 0),
                                   ctx_id("IntraChromaPredMode"))
            tsm = int(ts[by, bx]) if ts is not None else 0
            if ts is not None:
                enc.encode_bin(int(tsm > 0), ctx_id("TransformSkipFlag", 0))
                if tsm > 0 and bdpcm:
                    enc.encode_bin(int(tsm >= 2), ctx_id("BDPCMFlag", 0))
                    if tsm >= 2:
                        enc.encode_bin(int(tsm == 3), ctx_id("BDPCMFlag", 1))
            for cid, lev in enumerate((lev_y, lev_u, lev_v)):
                blk = lev[by, bx]
                cbf = bool(np.any(blk != 0))
                enc.encode_bin(int(cbf), cbf_ctx[cid])
                if cbf:
                    enc.encode_coeffs(blk, chroma=(cid != 0))
                if cid or not cbf or tsm:
                    continue
                lf = int(lfnst[by, bx]) if lfnst is not None else 0
                if lfnst is not None:
                    # lfnst_idx: truncated unary, 2 contexts (reference:
                    # CABACWriter residual_lfnst_mode)
                    enc.encode_bin(int(lf > 0), ctx_id("LFNSTIdx", 0))
                    if lf > 0:
                        enc.encode_bin(int(lf > 1), ctx_id("LFNSTIdx", 1))
                if mts is not None and lf == 0:
                    # tu_mts_idx: truncated unary over 4 contexts, on the
                    # DCT2 / no-LFNST, non-TS path (reference: CABACWriter
                    # mts_idx)
                    m = int(mts[by, bx])
                    for k in range(4):
                        enc.encode_bin(int(m > k), ctx_id("MtsIdx", k))
                        if m <= k:
                            break


def wpp_bounds(nby: int, num_substreams: int) -> list[int]:
    """Block-row bounds of the WPP substreams: min(num_substreams, nby)
    row groups of near-equal height."""
    n = max(1, min(num_substreams, nby))
    return [round(i * nby / n) for i in range(n + 1)]


def wpp_frame(subs: list[bytes]) -> bytes:
    """Substream framing (reference: entry_point_offset syntax): u16
    count, u32 lengths, then the streams."""
    out = bytearray(len(subs).to_bytes(2, "big"))
    for t in subs:
        out += len(t).to_bytes(4, "big")
    for t in subs:
        out += t
    return bytes(out)


def encode_substreams(one, bounds: list[int]) -> bytes:
    """`one(r0, r1)` -> the substream of block rows [r0, r1), for every
    row group at once on host threads (the C coder runs outside the GIL),
    framed in row order whichever thread finishes first."""
    n = len(bounds) - 1
    with cf.ThreadPoolExecutor(max_workers=min(n, 8)) as ex:
        subs = list(ex.map(lambda i: one(bounds[i], bounds[i + 1]),
                           range(n)))
    return wpp_frame(subs)


def encode_intra_slice_wpp(modes: np.ndarray, lev_y: np.ndarray,
                           lev_u: np.ndarray, lev_v: np.ndarray,
                           cclm=None, mip: bool = False, lfnst=None,
                           mrl=None, ts=None, bdpcm: bool = False,
                           ibc: bool = False, mts=None,
                           num_substreams: int = 4) -> bytes:
    """Wavefront/tile-style entropy substreams with entry points.  The
    reference's WPP restarts CABAC per CTU row with context inheritance
    (reference: EncSlice.cpp:2024-2113 per-substream termination); as in
    the JAX package, the block rows here split into `num_substreams`
    groups, each an independently decodable stream with FRESH contexts
    (the tile-style restart), coded concurrently.  The MPM neighbours
    still read the whole mode grid.  The arguments are
    encode_intra_slice's."""
    def one(r0: int, r1: int) -> bytes:
        enc = NativeBinEncoder()
        _encode_intra_rows(enc, modes, lev_y, lev_u, lev_v, r0, r1, lfnst,
                           ts, bdpcm, mts, cclm, mip, mrl, ibc)
        return enc.finish()

    return encode_substreams(one, wpp_bounds(modes.shape[0],
                                             num_substreams))


def encode_intra_slice_part(split: np.ndarray, mode16: np.ndarray,
                            modes8: np.ndarray, l16y: np.ndarray,
                            l16u: np.ndarray, l16v: np.ndarray,
                            l8y: np.ndarray, l8u: np.ndarray,
                            l8v: np.ndarray) -> bytes:
    """Two-level intra slice: per 16x16 superblock a split_cu_flag, then
    one mode + residual set (whole) or four in z-order (split) (reference:
    CABACWriter split_cu_flag + intra_luma_pred_mode; common/intra_part.py
    is the reconstruction mirror).  The (nsy, nsx, ...) grids are
    encode_intra_frame_part's outputs."""
    from ..common.intra_part import _QUADS
    enc = NativeBinEncoder()
    nsy, nsx = split.shape
    # final mode per 8x8 cell (the MPM source, as the encoder's mode map)
    cell = np.full((2 * nsy, 2 * nsx), -1, dtype=np.int32)

    def code_one(mode, cy, cx, levs):
        left = int(cell[cy, cx - 1]) if cx > 0 else -1
        above = int(cell[cy - 1, cx]) if cy > 0 else -1
        encode_intra_mode(enc, int(mode), left, above)
        for lev, cid in zip(levs, (0, 4, 5)):
            cbf = bool(np.any(lev != 0))
            enc.encode_bin(int(cbf), ctx_id("QtCbf", cid))
            if cbf:
                enc.encode_coeffs(lev, chroma=(cid != 0))

    for sy in range(nsy):
        for sx in range(nsx):
            sp = int(split[sy, sx])
            enc.encode_bin(sp, ctx_id("SplitFlag", 0))
            if sp:
                for k, (qy, qx) in enumerate(_QUADS):
                    cy, cx = 2 * sy + qy, 2 * sx + qx
                    code_one(modes8[sy, sx, k], cy, cx,
                             (l8y[sy, sx, k], l8u[sy, sx, k],
                              l8v[sy, sx, k]))
                    cell[cy, cx] = int(modes8[sy, sx, k])
            else:
                code_one(mode16[sy, sx], 2 * sy, 2 * sx,
                         (l16y[sy, sx], l16u[sy, sx], l16v[sy, sx]))
                cell[2 * sy:2 * sy + 2, 2 * sx:2 * sx + 2] = \
                    int(mode16[sy, sx])
    return enc.finish()
