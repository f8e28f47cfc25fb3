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


class Trace:
    """CDTrace analog: named channels, optional POC filters.

    rules: e.g. ["motion_model", "mvd:poc==3"] enables the channel
    globally or only when the context value matches."""

    def __init__(self, rules: list[str] | None = None,
                 path: str | None = None) -> None:
        self._rules: dict[str, str | None] = {}
        for r in rules or []:
            if ":" in r:
                ch, cond = r.split(":", 1)
                self._rules[ch] = cond
            else:
                self._rules[r] = None
        self._file = open(path, "w") if path else None
        self.events: list[tuple[str, dict]] = []
        self.ctx: dict[str, int] = {}

    def set_ctx(self, **kwargs) -> None:
        """Set condition variables (e.g. poc=7) for rule evaluation."""
        self.ctx.update(kwargs)

    def enabled(self, channel: str) -> bool:
        if channel not in self._rules:
            return False
        cond = self._rules[channel]
        if cond is None:
            return True
        try:
            return bool(eval(cond, {}, dict(self.ctx)))  # noqa: S307
        except Exception:                                # noqa: BLE001
            return False

    def log(self, channel: str, **fields) -> None:
        if not self.enabled(channel):
            return
        self.events.append((channel, dict(fields)))
        if self._file:
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            self._file.write(f"{channel}: {kv}\n")

    def close(self) -> None:
        if self._file:
            self._file.close()


def label(dec, name: str) -> None:
    """Name the syntax element a parser decodes next on a StatsBinDecoder
    (a no-op on the native decoder); returns None, so that a parser can
    write `label(dec, ...) or dec.decode_bin(...)`."""
    lab = getattr(dec, "label", None)
    if lab is not None:
        lab(name)


def make_decoder(data: bytes, stats=None):
    """The parsers' bin decoder: the native one, or with `stats` (a
    BitStats) the Python spec coder with per-syntax accounting."""
    if stats is not None:
        return StatsBinDecoder(data, stats)
    from .native import NativeBinDecoder
    return NativeBinDecoder(data)


# Global trace instance (None = tracing off, zero overhead at call sites
# via the `if TRACE:` idiom).
TRACE: Trace | None = None


def enable_trace(rules: list[str], path: str | None = None) -> Trace:
    global TRACE
    TRACE = Trace(rules, path)
    return TRACE


def disable_trace() -> None:
    global TRACE
    if TRACE:
        TRACE.close()
    TRACE = None


@dataclass
class BitStats:
    """Per-syntax bin/bit accounting (CodingStatistics analog)."""
    bits: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    bins: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    _label: str = "other"

    def label(self, name: str) -> "BitStats":
        self._label = name
        return self

    def add(self, nbits: float, nbins: int = 1) -> None:
        self.bits[self._label] += nbits
        self.bins[self._label] += nbins

    def report(self) -> str:
        total = sum(self.bits.values()) or 1.0
        lines = [f"{'syntax':<20}{'bits':>12}{'bins':>10}{'share':>8}"]
        for k in sorted(self.bits, key=lambda k: -self.bits[k]):
            lines.append(f"{k:<20}{self.bits[k]:>12.1f}"
                         f"{self.bins[k]:>10d}"
                         f"{100 * self.bits[k] / total:>7.1f}%")
        lines.append(f"{'TOTAL':<20}{total:>12.1f}")
        return "\n".join(lines)


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
