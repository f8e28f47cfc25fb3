"""CABAC context models: two-rate adaptive binary probability states.

TPU-native analog of the reference Contexts/ContextModelling (reference:
source/Lib/CommonLib/Contexts.h:87-138 BinProbModel_Std — two probability
estimates with different adaptation windows; Contexts.cpp context set init
tables, incl. the extension's Ctx::MotionModel 11-context set at
Contexts.h:226 / Contexts.cpp:420-427).

Design differences from the reference (deliberate, TPU-first):
* The arithmetic coder is a 32-bit multiplication-based range coder (see
  cabac.py) rather than the table-driven 9-bit VVC core — same compression,
  trivially correct, and the probability state is a plain (p0, p1) int pair
  that also lives as int32 *tensors* on the TPU for batched rate estimation
  during RD search (RdCost analog).
* Context initialization uses a per-slice-type 6-bit init probability rather
  than VVC's slope/offset QP model (a later refinement hook).

Probability convention: p = probability of bin==1, 15-bit (0..32768).
Adaptation (reference BinProbModel_Std::update):
    bin==1:  p0 += (32768 - p0) >> R0 ;  p1 += (32768 - p1) >> R1
    bin==0:  p0 -= p0 >> R0           ;  p1 -= p1 >> R1
    p_used = (p0 + p1) >> 1
with R0=4 (fast) and R1=8 (slow).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

PROB_BITS = 15
PROB_ONE = 1 << PROB_BITS          # 32768
RATE0 = 4
RATE1 = 8


# ---------------------------------------------------------------------------
# Context set layout.  Each named set owns a contiguous range of context ids.
# Counts follow the reference's sets where they exist (Contexts.cpp), pruned
# to the tools implemented so far; the MotionModel set keeps the reference's
# 11 contexts (Contexts.h:226).
# ---------------------------------------------------------------------------
_CTX_SETS: list[tuple[str, int]] = [
    ("SplitFlag", 9),          # qt split (ctx by neighbor depth)
    ("QtSplitFlag", 3),        # quad-vs-mtt (reference: split_qt_flag)
    ("BtFlag", 3),             # binary-vs-ternary (mtt_split_cu_binary)
    ("MttVert", 3),            # mtt_split_cu_vertical_flag
    ("SplitQtFlag", 6),
    ("SplitHvFlag", 5),
    ("Split12Flag", 4),
    ("PredMode", 2),
    ("SkipFlag", 3),
    ("MergeFlag", 1),
    ("MergeIdx", 1),
    ("IntraLumaMpmFlag", 2),
    ("IntraLumaPlanarFlag", 2),
    ("IntraChromaPredMode", 1),
    ("MultiRefLineIdx", 2),
    ("ISPMode", 2),
    ("MipFlag", 4),
    ("QtRootCbf", 1),
    ("QtCbf", 9),              # [luma 4][cb 2][cr 3]-ish
    ("SigCoeffGroup", 4),      # [luma 2][chroma 2]
    ("SigFlag", 18),           # template-based (luma 12, chroma 6, pruned)
    ("ParFlag", 11),
    ("GtxFlag", 22),           # gt1 + gt3
    ("LastX", 25),
    ("LastY", 25),
    ("TsSigFlag", 3),
    ("MtsIdx", 4),
    ("InterDir", 6),
    ("RefPic", 2),
    ("Mvd", 2),
    ("MvpIdx", 1),
    ("SmvdFlag", 1),
    ("Amvr", 2),
    ("AffineFlag", 3),
    ("MmvdFlag", 1),
    ("SaoMergeFlag", 1),
    ("SaoTypeIdx", 1),
    ("AlfCtbFlag", 9),
    ("LFNSTIdx", 3),
    ("MTSIdx", 4),
    ("TransformSkipFlag", 2),
    ("BDPCMFlag", 2),          # intra_bdpcm_luma_flag + dir
    # --- multi-model motion extension (reference Contexts.h:226) ---
    ("MotionModel", 11),
    ("EpipoleDelta", 2),
    ("ImvFlag", 5),
    ("BcwIdx", 1),
    ("GeoFlag", 1),            # GPM vs plain BI (reference: merge GEO cu)
    ("CiipFlag", 1),           # reference: ciip_flag
    ("IbcFlag", 3),            # intra block copy (reference: Ctx::IBCFlag)
]

CTX_OFFSET: dict[str, int] = {}
NUM_CTX = 0
for _name, _n in _CTX_SETS:
    CTX_OFFSET[_name] = NUM_CTX
    NUM_CTX += _n


def ctx_id(set_name: str, idx: int = 0) -> int:
    off = CTX_OFFSET[set_name]
    return off + idx


# default initial probability of one, per context (can be specialized per
# slice type later; 0.5 everywhere is a safe self-consistent default, with a
# few hand-tuned priors for strongly-biased flags).
_INIT_P1 = np.full(NUM_CTX, PROB_ONE // 2, dtype=np.int32)


def _set_init(name: str, p: float, idx: int | None = None) -> None:
    off = CTX_OFFSET[name]
    n = dict(_CTX_SETS)[name]
    if idx is None:
        _INIT_P1[off:off + n] = int(p * PROB_ONE)
    else:
        _INIT_P1[off + idx] = int(p * PROB_ONE)


_set_init("SigFlag", 0.40)
_set_init("SigCoeffGroup", 0.55)
_set_init("QtCbf", 0.55)
_set_init("SkipFlag", 0.35)
_set_init("MergeFlag", 0.45)
_set_init("IntraLumaMpmFlag", 0.65)
_set_init("TransformSkipFlag", 0.25)
_set_init("MotionModel", 0.30)   # non-CLASSIC models are the minority


@dataclass
class ContextState:
    """Mutable probability state for all contexts of one entropy substream.

    Kept as numpy arrays so the (host-side, C-accelerated) bin coder and the
    (device-side) rate estimator share one representation."""
    p0: np.ndarray = field(default_factory=lambda: _INIT_P1.copy())
    p1: np.ndarray = field(default_factory=lambda: _INIT_P1.copy())

    def clone(self) -> "ContextState":
        """WPP context inheritance (reference: EncSlice.cpp:1928 context
        save after first CTU of a row, :2083 restore)."""
        return ContextState(self.p0.copy(), self.p1.copy())

    def prob(self, ctx: int) -> int:
        return (int(self.p0[ctx]) + int(self.p1[ctx])) >> 1

    def update(self, ctx: int, binval: int) -> None:
        if binval:
            self.p0[ctx] += (PROB_ONE - self.p0[ctx]) >> RATE0
            self.p1[ctx] += (PROB_ONE - self.p1[ctx]) >> RATE1
        else:
            self.p0[ctx] -= self.p0[ctx] >> RATE0
            self.p1[ctx] -= self.p1[ctx] >> RATE1

# ---------------------------------------------------------------------------
# Rate estimation: fractional bits of coding bin b with probability p.
# Table of -log2(p/32768) in 1/512-bit units over 6-bit quantized p
# (reference analog: fracBitsAccess in Contexts.h / RdCost).
# ---------------------------------------------------------------------------
FRAC_BITS_SCALE = 512


def _build_frac_bits_table() -> np.ndarray:
    idx = (np.arange(1 << 6) + 0.5) / (1 << 6)      # p in (0,1)
    bits1 = -np.log2(idx)
    bits0 = -np.log2(1.0 - idx)
    return np.stack([bits0, bits1], 1) * FRAC_BITS_SCALE


FRAC_BITS_TABLE = _build_frac_bits_table().astype(np.int32)  # (64, 2)


