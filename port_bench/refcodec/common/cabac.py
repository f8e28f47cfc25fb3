"""Binary arithmetic coder (context-adaptive) — the entropy-coding core.

Copy of `vvc_mm_tpu/common/cabac.py` (reference:
source/Lib/EncoderLib/BinEncoder.cpp:94-98 BinEncoderBase [9-bit range core],
source/Lib/DecoderLib/BinDecoder.cpp:313 decodeBin).

Design note: VVC's normative CABAC core uses a 9-bit range with a table-free
dual-rate probability estimator and renormalization by leading-zero count.
This codec is self-consistent rather than VVC-bit-exact, so the arithmetic
core is a 32-bit range coder (carry propagation via cache/cache_size) driven
by the *same* dual-rate 15-bit probability estimator (contexts.ContextState).
Rationale:
  every `range * p` product fits in 47 bits -> plain Python ints are exact;
  the Python coder here is the executable specification; the port's
  native/cabac.c is the bit-identical path its slice writers and parsers
  use.  The frozen reference decodes with this coder and keeps only its
  decoder.
"""
from __future__ import annotations

import numpy as np

from .contexts import ContextState, PROB_BITS, PROB_ONE

TOP = 1 << 24
BOT_BITS = 24


class BinDecoder:
    """Exact inverse of BinEncoder."""

    def __init__(self, data: bytes, ctx_state: ContextState | None = None) -> None:
        self.ctx = ctx_state if ctx_state is not None else ContextState()
        self.data = data
        self.pos = 0
        self.range = 0xFFFFFFFF
        self.code = 0
        self.pos += 1             # first byte is the encoder's dummy cache
        for _ in range(4):
            self.code = (self.code << 8) | self._byte()

    def _byte(self) -> int:
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def _decode(self, p1: int) -> int:
        bound = (self.range >> PROB_BITS) * (PROB_ONE - p1)
        if self.code < bound:
            binval = 0
            self.range = bound
        else:
            binval = 1
            self.code -= bound
            self.range -= bound
        while self.range < TOP:
            self.range <<= 8
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFFFF
        return binval

    def decode_bin(self, ctx: int) -> int:
        p1 = self.ctx.prob(ctx)
        p1 = min(max(p1, 1), PROB_ONE - 1)
        binval = self._decode(p1)
        self.ctx.update(ctx, binval)
        return binval

    def decode_bin_ep(self) -> int:
        return self._decode(PROB_ONE >> 1)

    def decode_bins_ep(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.decode_bin_ep()
        return v

    def decode_unary(self, ctx0: int, ctx_rest: int, max_val: int) -> int:
        v = 0
        while v < max_val:
            if not self.decode_bin(ctx0 if v == 0 else ctx_rest):
                break
            v += 1
        return v

    def decode_eg(self, k: int) -> int:
        value = 0
        while self.decode_bin_ep():
            value += 1 << k
            k += 1
        if k:
            value += self.decode_bins_ep(k)
        return value


# ---------------------------------------------------------------------------
# Rate estimation + context evolution over a bin string, with the
# FRAC_BITS table of contexts.py (numpy reference used in tests).
# ---------------------------------------------------------------------------
