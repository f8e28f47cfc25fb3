"""Tracing + per-syntax bit statistics (host code, as the JAX package's
utils/trace.py).

The analog of the reference's observability layer (reference:
source/Lib/CommonLib/dtrace.h:96-153 — CDTrace named channels with rule
predicates, DTRACE(...) macros e.g. the motion_model trace at
CABACWriter.cpp:2110; and the CodingStatistics /
RExt__DECODER_DEBUG_BIT_STATISTICS analyser builds, TypeDef.h:148-160,
which power DecoderAnalyserApp's per-syntax-element bit accounting).

Two tools:
  * Trace — channel-keyed event log with enable rules (channel:condition),
    written to a file or collected in memory.  Runtime-configurable, not
    compile-time like the reference's ENABLE_TRACING.
  * BitStats — per-syntax-element bin/bit accounting for the *Python*
    entropy coder (the executable spec); the decoder/encoder label the
    current syntax element and the coder reports fractional bit positions.
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field

from ..common.cabac import BinDecoder


def label(dec, name: str) -> None:
    """Name the syntax element a parser decodes next on a StatsBinDecoder
    (a no-op on the native decoder); returns None, so that a parser can
    write `label(dec, ...) or dec.decode_bin(...)`."""
    lab = getattr(dec, "label", None)
    if lab is not None:
        lab(name)


def make_decoder(data: bytes, stats=None):
    """The parsers' bin decoder: the Python spec coder, with `stats` (a
    BitStats) with per-syntax accounting.  The frozen reference has no
    native coder."""
    if stats is not None:
        return StatsBinDecoder(data, stats)
    return SpecBinDecoder(data)


class SpecBinDecoder(BinDecoder):
    """The Python BinDecoder (common/cabac.py) with the native decoder's
    residual call: common/residual_coding.py over its bins."""

    def decode_coeffs(self, h: int, w: int, chroma: bool):
        from ..common.residual_coding import decode_coeffs
        return decode_coeffs(self, h, w, chroma)


class StatsBinDecoder:
    """Wraps the Python BinDecoder with per-syntax bit accounting.

    Bits are measured exactly as -log2(p) of each decoded decision —
    the information content the range coder actually spends.  The
    parsers' residual call, decode_coeffs, runs the Python spec coder
    (common/residual_coding.py) through this decoder's bins."""

    def __init__(self, data: bytes, stats: BitStats) -> None:
        from ..common.cabac import BinDecoder
        from ..common.contexts import PROB_ONE
        self._d = BinDecoder(data)
        self._stats = stats
        self._one = PROB_ONE

    def label(self, name: str):
        self._stats.label(name)
        return self

    def decode_bin(self, ctx: int) -> int:
        p1 = min(max(self._d.ctx.prob(ctx), 1), self._one - 1)
        b = self._d.decode_bin(ctx)
        p = p1 if b else (self._one - p1)
        self._stats.add(-math.log2(p / self._one))
        return b

    def decode_bin_ep(self) -> int:
        b = self._d.decode_bin_ep()
        self._stats.add(1.0)
        return b

    def decode_bins_ep(self, nbits: int) -> int:
        v = self._d.decode_bins_ep(nbits)
        self._stats.add(float(nbits), nbits)
        return v

    def decode_eg(self, k: int) -> int:
        # account by before/after position of EP bits: replicate logic
        v = 0
        kk = k
        while self.decode_bin_ep():
            v += 1 << kk
            kk += 1
        if kk:
            v += self.decode_bins_ep(kk)
        return v

    def decode_coeffs(self, h: int, w: int, chroma: bool):
        from ..common.residual_coding import decode_coeffs
        return decode_coeffs(self, h, w, chroma)
