"""Lambda-domain rate control.

A copy of the JAX package's `vvc_mm_tpu/encoder/rate_ctrl.py` (host
Python in float64; no array code), an analog of the reference RateCtrl
(reference: source/Lib/EncoderLib/RateCtrl.{cpp,h} — EncRCSeq/EncRCGOP/EncRCPic
hierarchy implementing the R-lambda model of JCTVC-K0103: R = alpha *
lambda^beta per picture, with alpha/beta updated from actual bits, and
lambda -> QP via QP = 4.2005 ln(lambda) + 13.7122).

Simplified to picture-level control (the reference adds CTU-level QP
adaptation): a leaky bit budget allocates per-picture targets with
hierarchical weights; the model solves lambda for the target and updates
its parameters from the realized (bits, lambda) pairs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class RateControl:
    target_bps: float            # bits per second
    frame_rate: float
    width: int
    height: int
    alpha: float = 3.2003        # reference initial ALPHA (RateCtrl.cpp)
    beta: float = -1.367         # reference initial BETA
    min_qp: int = 12
    max_qp: int = 49

    def __post_init__(self) -> None:
        self.bits_per_frame = self.target_bps / self.frame_rate
        self.pixels = self.width * self.height
        self.budget = 0.0        # leaky accumulator of unspent bits
        self.last_lambda = None

    def _weight(self, slice_type: str, temporal_id: int) -> float:
        """Hierarchical picture-level bit weights (reference: GOP-level
        allocation in EncRCGOP — I pictures get a large share, higher
        temporal layers less)."""
        if slice_type == "I":
            return 4.0
        return {0: 2.0, 1: 1.4, 2: 1.0, 3: 0.7}.get(temporal_id, 0.6)

    def pick_qp(self, slice_type: str, temporal_id: int = 0) -> int:
        """Target bits -> lambda via R = alpha * lambda^beta -> QP."""
        target = self.bits_per_frame * self._weight(slice_type, temporal_id)
        # feed back accumulated surplus/deficit (quarter per picture)
        target = max(target + self.budget * 0.25, self.bits_per_frame * 0.1)
        self._current_target = target
        bpp = target / self.pixels
        lam = self.alpha * (bpp ** self.beta)
        lam = min(max(lam, 0.1), 10000.0)
        if self.last_lambda is not None:
            # clip lambda swings (reference: lambda clip in EncRCPic)
            lam = min(max(lam, self.last_lambda / 3.0),
                      self.last_lambda * 3.0)
        self._current_lambda = lam
        qp = int(round(4.2005 * math.log(lam) + 13.7122))
        return min(max(qp, self.min_qp), self.max_qp)

    def update(self, actual_bits: int) -> None:
        """Model adaptation from realized bits (reference:
        EncRCPic::updateAfterPicture alpha/beta LMS update)."""
        self.budget += self.bits_per_frame - actual_bits
        bpp = max(actual_bits / self.pixels, 1e-6)
        lam_est = self.alpha * (bpp ** self.beta)
        lam = self._current_lambda
        if lam_est > 1e-9:
            err = math.log(lam) - math.log(lam_est)
            self.alpha *= math.exp(0.10 * err)
            self.beta += 0.05 * err * math.log(bpp)
            self.alpha = min(max(self.alpha, 0.05), 500.0)
            self.beta = min(max(self.beta, -3.0), -0.1)
        self.last_lambda = lam
