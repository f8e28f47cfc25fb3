"""Reference-picture memory-bandwidth model (JVET-J0090 CacheModel analog;
host counters, the same as the JAX package's utils/cache_model.py).

Reference: source/Lib/CommonLib/CacheModel.{cpp,h} — simulates the memory
traffic of motion compensation (every reference sample fetched per
interpolated block, with a cache model) to compare tool configurations by
decoder bandwidth.  Hooks in the reference: JVET_J0090_SET_REF_PICTURE /
accessors inside InterPrediction (InterPrediction.cpp:695).

Here the batched MC paths report their fetch footprints analytically:
an SxS uni-prediction block with an 8-tap filter reads (S+7)^2 samples;
each 4x4 MM subblock reads 11x11 (InterPrediction.cpp:683 per-subblock
independent displacement); chroma 4:2:0 reads 2x (S/2+3)^2.  A simple
direct-mapped line cache (64-byte lines over the padded reference) models
reuse between overlapping fetches, like the reference's cache simulation.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class FrameTraffic:
    poc: int
    samples: int = 0        # raw reference samples touched
    bytes_fetched: int = 0  # after the line-granularity model
    hits: int = 0           # line-cache hits (direct-mapped model)
    misses: int = 0         # line-cache misses (lines actually fetched)


@dataclass
class CacheModel:
    """Analytic bandwidth accounting, enabled per decode/encode run."""
    bytes_per_sample: int = 1
    line_bytes: int = 64
    frames: list[FrameTraffic] = field(default_factory=list)
    _cur: FrameTraffic | None = None

    def start_frame(self, poc: int) -> None:
        self._cur = FrameTraffic(poc)
        self.frames.append(self._cur)

    def report_block_mc(self, n_blocks: int, block_size: int,
                        taps: int = 8, chroma: bool = True) -> None:
        """Uni-prediction of n_blocks SxS blocks."""
        if self._cur is None:
            return
        luma = n_blocks * (block_size + taps - 1) ** 2
        c = 2 * n_blocks * (block_size // 2 + 3) ** 2 if chroma else 0
        self._add(luma + c)

    def report_subblock_mc(self, n_subblocks: int, sub: int = 4,
                           taps: int = 8, chroma: bool = True) -> None:
        """MM per-subblock MC (4x4 luma / 2x2 chroma independent fetches)."""
        if self._cur is None:
            return
        luma = n_subblocks * (sub + taps - 1) ** 2
        c = 2 * (n_subblocks // 4) * (2 + 3) ** 2 if chroma else 0
        self._add(luma + c)

    def _add(self, samples: int) -> None:
        self._cur.samples += samples
        self._cur.bytes_fetched = self._cur.samples * self.bytes_per_sample

    N_SETS = 512            # direct-mapped cache: 512 x 64-byte lines

    def simulate_mc(self, mvs: np.ndarray, block_size: int, width: int,
                    taps: int = 8) -> None:
        """True line-granularity simulation of translational MC reads
        (reference: CacheModel::cacheAccess — direct-mapped line cache
        over the reference plane).  Blocks are visited in coding (raster)
        order; each block's luma read window [(x-3, y-3) .. (x+S+4,
        y+S+4)) is decomposed into 64-byte-aligned lines, and each line
        either hits (same tag resident in its set) or misses (fetch).

        mvs: (nby, nbx, 2) 1/16-pel MVs; width: reference width in
        samples (pitch for line addressing)."""
        if self._cur is None:
            return
        s = block_size
        nby, nbx = mvs.shape[:2]
        lb = self.line_bytes // self.bytes_per_sample   # samples per line
        cache = np.full(self.N_SETS, -1, dtype=np.int64)
        hits = misses = 0
        win = s + taps - 1
        for by in range(nby):
            for bx in range(nbx):
                x0 = bx * s + (int(mvs[by, bx, 0]) >> 4) - (taps // 2 - 1)
                y0 = by * s + (int(mvs[by, bx, 1]) >> 4) - (taps // 2 - 1)
                l0, l1 = x0 // lb, (x0 + win - 1) // lb
                for row in range(y0, y0 + win):
                    base = row * (width // lb + 2)
                    for ln in range(l0, l1 + 1):
                        addr = base + ln
                        st = addr % self.N_SETS
                        if cache[st] == addr:
                            hits += 1
                        else:
                            cache[st] = addr
                            misses += 1
        self._cur.hits += hits
        self._cur.misses += misses
        self._cur.samples += (hits + misses) * lb
        self._cur.bytes_fetched += misses * self.line_bytes

    def report(self, frame_rate: float = 30.0) -> str:
        if not self.frames:
            return "CacheModel: no inter traffic recorded"
        tot = sum(f.bytes_fetched for f in self.frames)
        per = tot / len(self.frames)
        bw = per * frame_rate / 1e6
        lines = [f"CacheModel: {len(self.frames)} pictures, "
                 f"{per / 1e6:.2f} MB/picture, {bw:.1f} MB/s @ "
                 f"{frame_rate:g} fps"]
        for f in self.frames:
            acc = f.hits + f.misses
            hit = f" cache hit {100.0 * f.hits / acc:.1f}%" if acc else ""
            lines.append(f"  POC {f.poc:4d}: {f.samples} ref samples, "
                         f"{f.bytes_fetched / 1e6:.2f} MB{hit}")
        return "\n".join(lines)
