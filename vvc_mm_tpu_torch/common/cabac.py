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
  the Python coder here is the executable specification; native/cabac.c,
  bound in utils/native.py, is the bit-identical path the slice writers and
  parsers use.

The encoder and decoder below are exact inverses.
"""
from __future__ import annotations

import numpy as np

from .contexts import ContextState, PROB_BITS, PROB_ONE, RATE0, RATE1

TOP = 1 << 24
BOT_BITS = 24


class BinEncoder:
    """Range encoder over adaptive binary contexts."""

    def __init__(self, ctx_state: ContextState | None = None) -> None:
        self.ctx = ctx_state if ctx_state is not None else ContextState()
        self.low = 0              # 33+8 bit accumulator (python int)
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.cache_size = 1       # first shift emits the (ignored) 0 cache
        self.out = bytearray()
        self.num_bins = 0

    # -- core --------------------------------------------------------------
    def _shift_low(self) -> None:
        if self.low < 0xFF000000 or self.low > 0xFFFFFFFF:
            carry = self.low >> 32
            c = self.cache
            while self.cache_size:
                self.out.append((c + carry) & 0xFF)
                c = 0xFF
                self.cache_size -= 1
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def _encode(self, bin_is_one: bool, p1: int) -> None:
        # p1 = 15-bit probability of bin==1; '0' owns the low part of range
        bound = (self.range >> PROB_BITS) * (PROB_ONE - p1)
        if bin_is_one:
            self.low += bound
            self.range -= bound
        else:
            self.range = bound
        while self.range < TOP:
            self.range <<= 8
            self._shift_low()
        self.num_bins += 1

    # -- public API ----------------------------------------------------------
    def encode_bin(self, binval: int, ctx: int) -> None:
        p1 = self.ctx.prob(ctx)
        # clamp away from 0/1 so bound != 0 (coder invariant)
        p1 = min(max(p1, 1), PROB_ONE - 1)
        self._encode(bool(binval), p1)
        self.ctx.update(ctx, binval)

    def encode_bin_ep(self, binval: int) -> None:
        """Bypass (equiprobable) bin (reference: encodeBinEP)."""
        self._encode(bool(binval), PROB_ONE >> 1)

    def encode_bins_ep(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.encode_bin_ep((value >> i) & 1)

    def encode_unary(self, value: int, ctx0: int, ctx_rest: int,
                     max_val: int) -> None:
        """Truncated-unary with a dedicated first-bin context."""
        for i in range(min(value, max_val)):
            self.encode_bin(1, ctx0 if i == 0 else ctx_rest)
        if value < max_val:
            self.encode_bin(0, ctx0 if value == 0 else ctx_rest)

    def encode_eg(self, value: int, k: int) -> None:
        """k-th order exp-Golomb, bypass coded (coeff remainder, mvd)."""
        while value >= (1 << k):
            self.encode_bin_ep(1)
            value -= 1 << k
            k += 1
        self.encode_bin_ep(0)
        self.encode_bins_ep(value, k) if k else None

    def finish(self) -> bytes:
        """Flush: 5 shift_lows emit everything incl. cache."""
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


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
def estimate_bits_and_update(p0: np.ndarray, p1: np.ndarray,
                             bins: np.ndarray, ctxs: np.ndarray
                             ) -> tuple[np.ndarray, np.ndarray, int]:
    """Sequentially update contexts for a bin string, returning total
    fractional bits (x512).  numpy reference used in tests."""
    from .contexts import frac_bits
    total = 0
    for b, c in zip(bins.tolist(), ctxs.tolist()):
        p = (int(p0[c]) + int(p1[c])) >> 1
        total += int(frac_bits(np.array(p), np.array(b)))
        if b:
            p0[c] += (PROB_ONE - p0[c]) >> RATE0
            p1[c] += (PROB_ONE - p1[c]) >> RATE1
        else:
            p0[c] -= p0[c] >> RATE0
            p1[c] -= p1[c] >> RATE1
    return p0, p1, total
