"""Intra slice entropy decoding: CABAC -> block modes, tool indices and levels.

PyTorch-port copy of `vvc_mm_tpu/decoder/intra_parser.py` (reference:
source/Lib/DecoderLib/CABACReader.cpp — coding_tree_unit:138,
intra_luma_pred_mode, residual_coding).  Host numpy code over the native
CABAC decoder.  It parses the prediction tools' syntax (IBC flag and
block-vector index, MIP flag and mode, MultiRefLineIdx, the chroma LM
flag) and the residual tools' (transform skip and BDPCM flags, lfnst_idx,
tu_mts_idx), the two-level intra-split slice (`decode_intra_slice_part`)
and the WPP slice (`decode_intra_slice_wpp`, whose framing the inter WPP
parsers share).
"""
from __future__ import annotations

import numpy as np

from ..common.cabac import BinDecoder
from ..common.contexts import ctx_id
from ..common.wavefront import IBC_BASE, mpm3_host
from .candidates import wpp_bounds
from ..utils.trace import label, make_decoder


def decode_intra_mode(dec: BinDecoder, left: int, above: int) -> int:
    mpm = mpm3_host(left, above)
    if dec.decode_bin(ctx_id("IntraLumaMpmFlag")):
        if dec.decode_bin_ep():
            return mpm[1 + dec.decode_bin_ep()]
        return mpm[0]
    rem = sorted(m for m in range(67) if m not in mpm)
    return rem[dec.decode_bins_ep(6)]


def decode_intra_slice(data: bytes, nby: int, nbx: int, s: int,
                       lfnst: bool = False, ts: bool = False,
                       bdpcm: bool = False, mts: bool = False,
                       cclm: bool = False, mip: bool = False,
                       mrl: bool = False, ibc: bool = False, stats=None):
    """Returns the dense grids (modes, cclm_flags, lfnst_idx, mrl_idx,
    ts_mode, mts_idx, lev_y, lev_u, lev_v).  The flags: the SPS tools
    whose syntax the slice carries.  With `stats` (utils.trace.BitStats)
    the Python spec coder runs with per-syntax accounting (the
    DecoderAnalyserApp analog)."""
    dec = make_decoder(data, stats)
    grids = _alloc_grids(nby, nbx, s)
    _decode_intra_rows(dec, grids, s, 0, nby, lfnst, ts, bdpcm, mts, cclm,
                       mip, mrl, ibc)
    return grids


def parse_wpp_frame(data: bytes) -> list[bytes]:
    """The substreams of a WPP payload (inverse of the encoder's framing:
    u16 count, u32 lengths, streams)."""
    n = int.from_bytes(data[:2], "big")
    lens = [int.from_bytes(data[2 + 4 * i:6 + 4 * i], "big")
            for i in range(n)]
    off = 2 + 4 * n
    subs = []
    for ln in lens:
        subs.append(data[off:off + ln])
        off += ln
    return subs


def decode_intra_slice_wpp(data: bytes, nby: int, nbx: int, s: int,
                           stats=None, **tools):
    """The WPP variant of decode_intra_slice (same tool flags and result):
    one independently decodable substream with fresh contexts per row
    group, parsed in row order into shared grids."""
    subs = parse_wpp_frame(data)
    bounds = wpp_bounds(nby, len(subs))
    grids = _alloc_grids(nby, nbx, s)
    for i, sub in enumerate(subs):
        _decode_intra_rows(make_decoder(sub, stats), grids, s, bounds[i],
                           bounds[i + 1], **tools)
    return grids


def _alloc_grids(nby: int, nbx: int, s: int):
    sc = s // 2
    return (np.zeros((nby, nbx), dtype=np.int32),
            np.zeros((nby, nbx), dtype=np.int32),
            np.zeros((nby, nbx), dtype=np.int32),
            np.zeros((nby, nbx), dtype=np.int32),
            np.zeros((nby, nbx), dtype=np.int32),
            np.zeros((nby, nbx), dtype=np.int32),
            np.zeros((nby, nbx, s, s), dtype=np.int32),
            np.zeros((nby, nbx, sc, sc), dtype=np.int32),
            np.zeros((nby, nbx, sc, sc), dtype=np.int32))


def _decode_intra_rows(dec, grids, s: int, r0: int, r1: int,
                       lfnst: bool = False, ts: bool = False,
                       bdpcm: bool = False, mts: bool = False,
                       cclm: bool = False, mip: bool = False,
                       mrl: bool = False, ibc: bool = False) -> None:
    modes, lm, lf, mr, tsg, mtsg, lev_y, lev_u, lev_v = grids
    nby, nbx = modes.shape
    sc = s // 2
    for by in range(r0, r1):
        for bx in range(nbx):
            # MIP and IBC neighbours (modes >= 67) act as planar for the
            # MPM list
            left = int(modes[by, bx - 1]) if bx > 0 else -1
            above = int(modes[by - 1, bx]) if by > 0 else -1
            left = 0 if left >= 67 else left
            above = 0 if above >= 67 else above
            label(dec, "intra_mode")
            is_ibc = ibc and bool(label(dec, "ibc_flag") or dec.decode_bin(
                ctx_id("IbcFlag", 0)))
            if is_ibc:
                modes[by, bx] = IBC_BASE + dec.decode_bins_ep(4)
            elif mip and (label(dec, "mip_flag")
                          or dec.decode_bin(ctx_id("MipFlag"))):
                modes[by, bx] = 67 + dec.decode_bins_ep(3)
            else:
                modes[by, bx] = decode_intra_mode(dec, left, above)
                if mrl:
                    label(dec, "mrl_idx")
                    mr[by, bx] = dec.decode_bin(ctx_id("MultiRefLineIdx"))
            if cclm and not is_ibc:
                label(dec, "cclm_flag")
                lm[by, bx] = dec.decode_bin(ctx_id("IntraChromaPredMode"))
            if ts and (label(dec, "transform_skip_flag")
                       or dec.decode_bin(ctx_id("TransformSkipFlag", 0))):
                tsg[by, bx] = 1
                if bdpcm and dec.decode_bin(ctx_id("BDPCMFlag", 0)):
                    tsg[by, bx] = 2 + dec.decode_bin(ctx_id("BDPCMFlag", 1))
            for comp, lev, size in (("y", lev_y, s), ("u", lev_u, sc),
                                    ("v", lev_v, sc)):
                cbf_ctx = ctx_id("QtCbf", {"y": 0, "u": 4, "v": 5}[comp])
                label(dec, "cbf")
                cbf = bool(dec.decode_bin(cbf_ctx))
                if cbf:
                    label(dec, "residual_" + comp)
                    lev[by, bx] = dec.decode_coeffs(size, size,
                                                    chroma=(comp != "y"))
                if comp != "y" or not cbf or tsg[by, bx]:
                    continue
                if lfnst and (label(dec, "lfnst_idx")
                              or dec.decode_bin(ctx_id("LFNSTIdx", 0))):
                    lf[by, bx] = 1 + dec.decode_bin(ctx_id("LFNSTIdx", 1))
                if mts and lf[by, bx] == 0:
                    label(dec, "mts_idx")
                    m = 0
                    for k in range(4):
                        if not dec.decode_bin(ctx_id("MtsIdx", k)):
                            break
                        m += 1
                    mtsg[by, bx] = m


def decode_intra_slice_part(data: bytes, nsy: int, nsx: int, stats=None):
    """Exact inverse of encoder.intra_coder.encode_intra_slice_part.
    Returns the grids (split, mode16, modes8, l16y, l16u, l16v, l8y, l8u,
    l8v)."""
    from ..common.intra_part import _QUADS, SB, SUB
    dec = make_decoder(data, stats)
    sc16, sc8 = SB // 2, SUB // 2
    split = np.zeros((nsy, nsx), dtype=np.int32)
    mode16 = np.zeros((nsy, nsx), dtype=np.int32)
    modes8 = np.zeros((nsy, nsx, 4), dtype=np.int32)
    l16 = tuple(np.zeros((nsy, nsx, s, s), dtype=np.int32)
                for s in (SB, sc16, sc16))
    l8 = tuple(np.zeros((nsy, nsx, 4, s, s), dtype=np.int32)
               for s in (SUB, sc8, sc8))
    cell = np.full((2 * nsy, 2 * nsx), -1, dtype=np.int32)

    def parse_one(cy, cx, levs):
        left = int(cell[cy, cx - 1]) if cx > 0 else -1
        above = int(cell[cy - 1, cx]) if cy > 0 else -1
        label(dec, "intra_mode")
        mode = decode_intra_mode(dec, left, above)
        for lev, cid in zip(levs, (0, 4, 5)):
            label(dec, "cbf")
            if dec.decode_bin(ctx_id("QtCbf", cid)):
                label(dec, "residual")
                lev[...] = dec.decode_coeffs(*lev.shape, chroma=(cid != 0))
        return mode

    for sy in range(nsy):
        for sx in range(nsx):
            label(dec, "split_flag")
            sp = dec.decode_bin(ctx_id("SplitFlag", 0))
            split[sy, sx] = sp
            if sp:
                for k, (qy, qx) in enumerate(_QUADS):
                    cy, cx = 2 * sy + qy, 2 * sx + qx
                    m = parse_one(cy, cx, tuple(g[sy, sx, k] for g in l8))
                    modes8[sy, sx, k] = m
                    cell[cy, cx] = m
            else:
                m = parse_one(2 * sy, 2 * sx, tuple(g[sy, sx] for g in l16))
                mode16[sy, sx] = m
                cell[2 * sy:2 * sy + 2, 2 * sx:2 * sx + 2] = m
    return (split, mode16, modes8) + l16 + l8
