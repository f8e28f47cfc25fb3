"""Epipole list for geodesic (camera-pose) motion.

Copied from `vvc_mm_tpu/common/mm/epipole.py` (host numpy; reference:
source/Lib/CommonLib/EpipoleList.{cpp,h} — (curPOC,refPOC)->epipole map with
exact -> per-POC -> global fallback (EpipoleList.cpp:20-42), fixed-point
2^-24 storage (CommonDef.h:441), nearest-two-POC predictor derivePredictor:44,
decode-order availability gating makeAvailable).  Encoder and decoder share
it, so the predictor and the reconstructed epipoles are identical on both
sides.
"""
from __future__ import annotations

import numpy as np

from ..typedefs import EPIPOLE_PRECISION_BITS

FIXED_ONE = 1 << EPIPOLE_PRECISION_BITS


def to_fixed(e) -> tuple[int, int, int]:
    return tuple(int(round(float(c) * FIXED_ONE)) for c in e)


def from_fixed(e) -> np.ndarray:
    return np.asarray([c / FIXED_ONE for c in e], dtype=np.float64)


class EpipoleList:
    """Host-side map; epipoles are per-frame scalars (3,) float."""

    def __init__(self, global_epipole=(0.0, 0.0, 1.0)) -> None:
        self.global_epipole = np.asarray(global_epipole, dtype=np.float64)
        self._map: dict[tuple[int, int], np.ndarray] = {}
        self._available: set[tuple[int, int]] = set()

    def set_epipole(self, cur_poc: int, ref_poc: int, epipole,
                    available: bool = True) -> None:
        self._map[(cur_poc, ref_poc)] = np.asarray(epipole, dtype=np.float64)
        if available:
            self._available.add((cur_poc, ref_poc))

    def make_available(self, cur_poc: int, ref_poc: int) -> None:
        """Decode-order gating (reference: EpipoleList makeAvailable) —
        an epipole becomes usable once its PH has been decoded."""
        self._available.add((cur_poc, ref_poc))

    def find_epipole(self, cur_poc: int, ref_poc: int) -> np.ndarray:
        """exact -> any-ref-of-cur-POC -> global (reference:
        EpipoleList.cpp:20-42)."""
        key = (cur_poc, ref_poc)
        if key in self._map and key in self._available:
            return self._map[key]
        for (c, r), e in self._map.items():
            if c == cur_poc and (c, r) in self._available:
                return e
        return self.global_epipole

    def derive_predictor(self, cur_poc: int, ref_poc: int) -> np.ndarray:
        """Average of the epipoles of the nearest two available POCs
        (reference: EpipoleList.cpp:44 derivePredictor); falls back to the
        global epipole."""
        cands = sorted(
            ((abs(c - cur_poc), c, r) for (c, r) in self._available
             if c != cur_poc),
        )[:2]
        if not cands:
            return self.global_epipole
        es = [self._map[(c, r)] for _, c, r in cands]
        return np.mean(es, axis=0)
