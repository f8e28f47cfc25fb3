"""Film grain characteristics SEI + synthesizer (frequency-filtering model).

PyTorch-port copy of `vvc_mm_tpu/common/film_grain.py` (reference:
source/Lib/CommonLib/SEIFilmGrainSynthesizer.{cpp,h} — SMPTE RDD-5
frequency-filtering synthesis; SEIFilmGrainAnalyzer — parameter
estimation).

Model (frequency filtering, model_id=0): grain is generated per 64x64
block as white noise from a deterministic LCG seeded by (seed, poc, block
index), shaped in the DCT domain by low-pass cutoffs, transformed back,
scaled by a per-intensity-interval gain and added to the decoded picture.
The arithmetic stays on the host in float64 numpy, as in the JAX package:
the DCT is a matrix product whose summation order decides where `np.round`
lands at .5, so the grain is only bit-exact in the same arithmetic.  A
plane that lives on a device is pulled to the host once.

SEI payload (type 19, fgc): model_id, log2_scale_factor, seed, then per
component: the interval count and (lower, upper, gain, freq_h, freq_v) per
interval.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .bitstream import BitReader, BitWriter

SEI_FILM_GRAIN = 19
_BLK = 64


@dataclass
class FilmGrainParams:
    model_id: int = 0
    log2_scale_factor: int = 6
    # per component: list of (lower, upper, gain, freq_h, freq_v)
    intervals_y: list = field(default_factory=list)
    intervals_cb: list = field(default_factory=list)
    intervals_cr: list = field(default_factory=list)
    seed: int = 1

    def write(self, bw: BitWriter) -> None:
        bw.write(self.model_id, 2)
        bw.write(self.log2_scale_factor, 4)
        bw.write(self.seed & 0xFFFF, 16)
        for comp in (self.intervals_y, self.intervals_cb, self.intervals_cr):
            bw.write(len(comp), 8)
            for (lo, up, gain, fh, fv) in comp:
                bw.write(lo, 8)
                bw.write(up, 8)
                bw.write_svlc(gain)
                bw.write(fh, 4)
                bw.write(fv, 4)

    @classmethod
    def read(cls, br: BitReader) -> "FilmGrainParams":
        p = cls()
        p.model_id = br.read(2)
        p.log2_scale_factor = br.read(4)
        p.seed = br.read(16)
        for name in ("intervals_y", "intervals_cb", "intervals_cr"):
            iv = []
            for _ in range(br.read(8)):
                lo = br.read(8)
                up = br.read(8)
                gain = br.read_svlc()
                fh = br.read(4)
                fv = br.read(4)
                iv.append((lo, up, gain, fh, fv))
            setattr(p, name, iv)
        return p


_GRAIN_CACHE: dict = {}


