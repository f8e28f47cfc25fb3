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


def _host(plane) -> np.ndarray:
    return plane.cpu().numpy() if torch.is_tensor(plane) else \
        np.asarray(plane)


def _lcg(state: np.ndarray) -> np.ndarray:
    return (state * np.uint64(6364136223846793005)
            + np.uint64(1442695040888963407))


def _dct_mat(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    m[0] /= np.sqrt(2.0)
    return m


def _grain_block(seed: int, poc: int, idx: int, fh: int, fv: int
                 ) -> np.ndarray:
    """Deterministic 64x64 unit-variance band-passed grain."""
    n = _BLK * _BLK
    s0 = np.uint64(seed * 2654435761 + poc * 40503 + idx * 69069 + 12345)
    states = _lcg(_lcg(s0 + np.arange(n, dtype=np.uint64)))
    u = ((states >> np.uint64(40)).astype(np.float64) / (1 << 24)) - 0.5
    noise = u.reshape(_BLK, _BLK) * np.sqrt(12.0)     # unit variance
    d = _dct_mat(_BLK)
    coeff = d @ noise @ d.T
    # low-pass (RDD-5 form): cutoff f in 0..15 keeps the first (f+1)*4 of
    # the 64 bins
    mh = np.zeros(_BLK)
    mh[:max((fh + 1) * 4, 1)] = 1.0
    mv_ = np.zeros(_BLK)
    mv_[:max((fv + 1) * 4, 1)] = 1.0
    coeff = coeff * mv_[:, None] * mh[None, :]
    g = d.T @ coeff @ d
    std = g.std()
    return g / std if std > 1e-9 else g


_GRAIN_CACHE: dict = {}


def _grain_pattern(seed: int, fh: int, fv: int) -> np.ndarray:
    """A bank of 8 cached grain tiles per (seed, cutoffs)."""
    key = (seed, fh, fv)
    if key not in _GRAIN_CACHE:
        _GRAIN_CACHE[key] = np.stack(
            [_grain_block(seed, 0, i, fh, fv) for i in range(8)])
    return _GRAIN_CACHE[key]


def synthesize(plane, intervals, params: FilmGrainParams, poc: int,
               bit_depth: int = 8) -> np.ndarray:
    """Grain added to one plane (host array or tensor) -> host array of the
    plane's dtype; deterministic, so the encoder's simulation and the
    decoder's output stage agree."""
    plane = _host(plane)
    if not intervals:
        return plane
    h, w = plane.shape
    ph = -(-h // _BLK) * _BLK
    pw = -(-w // _BLK) * _BLK
    out = plane.astype(np.int64)
    for (lo, up, gain, fh, fv) in intervals:
        bank = _grain_pattern(params.seed, fh, fv)
        # tile the bank deterministically over the padded frame
        gby, gbx = ph // _BLK, pw // _BLK
        sel = (np.uint64(params.seed) + np.uint64(poc * 31)
               + np.arange(gby * gbx, dtype=np.uint64))
        sel = (_lcg(sel) >> np.uint64(32)).astype(np.int64) % 8
        grain = (bank[sel.reshape(gby, gbx)]          # (gby, gbx, B, B)
                 .transpose(0, 2, 1, 3).reshape(ph, pw)[:h, :w])
        mask = (plane >= lo) & (plane <= up)
        add = np.round(grain * gain).astype(np.int64)
        out = np.where(mask, out + add, out)
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(plane.dtype)


def apply_grain(planes, params: FilmGrainParams, poc: int,
                bit_depth: int = 8) -> list[np.ndarray]:
    """Grain applied to a YUV picture (host arrays or tensors)."""
    return [synthesize(p, iv, params, poc, bit_depth) for p, iv in zip(
        planes, (params.intervals_y, params.intervals_cb,
                 params.intervals_cr))]


def analyze(orig, recon, bit_depth: int = 8, seed: int = 1
            ) -> FilmGrainParams | None:
    """Grain parameters from source against reconstruction (reference:
    SEIFilmGrainAnalyzer — the encoder smooths grain away; its residual's
    high-frequency energy per intensity band parameterizes the model)."""
    recon = _host(recon)
    diff = _host(orig).astype(np.float64) - recon.astype(np.float64)
    # remove low-frequency misprediction: high-pass with a 3x3 laplacian
    hp = diff - (np.roll(diff, 1, 0) + np.roll(diff, -1, 0)
                 + np.roll(diff, 1, 1) + np.roll(diff, -1, 1)) / 4.0
    intervals = []
    for lo in range(0, 256, 64):
        up = lo + 63
        mask = (recon >= lo) & (recon <= up)
        if mask.sum() < 1000:
            continue
        gain = int(round(hp[mask].std()))
        if gain >= 1:
            intervals.append((lo, up, gain, 7, 7))
    if not intervals:
        return None
    return FilmGrainParams(intervals_y=intervals, seed=seed)
