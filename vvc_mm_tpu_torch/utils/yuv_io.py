"""Planar YUV file I/O with bit-depth conversion and padding.

PyTorch-port copy of `vvc_mm_tpu/utils/yuv_io.py` (reference:
source/Lib/Utilities/VideoIOYuv.cpp — open/read/write/skipFrames with
bit-depth shifts).  Frames are numpy int32 planes on the host; device
placement happens in the codec layers.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..common.typedefs import ChromaFormat, CHROMA_SCALE_X, CHROMA_SCALE_Y


@dataclass
class VideoFormat:
    width: int
    height: int
    bit_depth: int = 8
    chroma_format: ChromaFormat = ChromaFormat.C420

    @property
    def chroma_size(self) -> tuple[int, int]:
        return (self.height >> CHROMA_SCALE_Y[self.chroma_format],
                self.width >> CHROMA_SCALE_X[self.chroma_format])

    @property
    def frame_bytes(self) -> int:
        nbytes = 2 if self.bit_depth > 8 else 1
        ch, cw = self.chroma_size
        nchroma = 0 if self.chroma_format == ChromaFormat.C400 else 2
        return nbytes * (self.width * self.height + nchroma * ch * cw)


class YuvReader:
    """reference: VideoIOYuv::open/read/skipFrames."""

    def __init__(self, path: str, fmt: VideoFormat) -> None:
        self.fmt = fmt
        self._f = open(path, "rb")
        self._size = os.fstat(self._f.fileno()).st_size

    @property
    def num_frames(self) -> int:
        return self._size // self.fmt.frame_bytes

    def skip_frames(self, n: int) -> None:
        self._f.seek(n * self.fmt.frame_bytes, os.SEEK_CUR)

    def read_frame(self) -> list[np.ndarray] | None:
        fmt = self.fmt
        dtype = np.dtype("<u2") if fmt.bit_depth > 8 else np.uint8
        raw = self._f.read(fmt.frame_bytes)
        if len(raw) < fmt.frame_bytes:
            return None
        buf = np.frombuffer(raw, dtype=dtype)
        y = buf[:fmt.width * fmt.height].reshape(fmt.height, fmt.width)
        planes = [y.astype(np.int32)]
        if fmt.chroma_format != ChromaFormat.C400:
            ch, cw = fmt.chroma_size
            off = fmt.width * fmt.height
            for _ in range(2):
                planes.append(buf[off:off + ch * cw]
                              .reshape(ch, cw).astype(np.int32))
                off += ch * cw
        return planes

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class YuvWriter:
    """reference: VideoIOYuv::write (with output bit-depth conversion)."""

    def __init__(self, path: str, fmt: VideoFormat) -> None:
        self.fmt = fmt
        self._f = open(path, "wb")

    def write_frame(self, planes: list[np.ndarray]) -> None:
        fmt = self.fmt
        dtype = np.dtype("<u2") if fmt.bit_depth > 8 else np.uint8
        maxv = (1 << fmt.bit_depth) - 1
        for p in planes:
            self._f.write(np.clip(p, 0, maxv).astype(dtype).tobytes())

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def synthetic_sequence(fmt: VideoFormat, num_frames: int, seed: int = 7,
                       motion: tuple[float, float] = (3.0, 1.0)
                       ) -> list[list[np.ndarray]]:
    """Deterministic synthetic test content: band-limited noise translated by
    `motion` pixels/frame (so inter tools have something to find), plus a
    moving bright disc.  The tests' content: no clip is shipped with the
    repository."""
    rng = np.random.default_rng(seed)
    h, w = fmt.height, fmt.width
    maxv = (1 << fmt.bit_depth) - 1
    # band-limited noise via box-blurred random field (tileable)
    base = rng.integers(0, maxv + 1, size=(h, w)).astype(np.float32)
    for ax in (0, 1):
        for r in (1, 2, 4):
            base = (base + np.roll(base, r, axis=ax)
                    + np.roll(base, -r, axis=ax)) / 3.0
    base = ((base - base.min()) / max(float(np.ptp(base)), 1e-6)
            * (0.7 * maxv) + 0.1 * maxv)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(num_frames):
        dy, dx = motion[1] * t, motion[0] * t
        y = np.roll(np.roll(base, int(round(dy)), axis=0),
                    int(round(dx)), axis=1).copy()
        cy, cx = (h / 2 + 0.2 * h * np.sin(t * 0.3),
                  w / 2 + 0.3 * w * np.cos(t * 0.2))
        mask = ((yy - cy) ** 2 + (xx - cx) ** 2) < (min(h, w) / 8) ** 2
        y[mask] = 0.9 * maxv
        yp = np.clip(y, 0, maxv).astype(np.int32)
        ch, cw = fmt.chroma_size
        sy = fmt.height // ch if ch else 1
        sx = fmt.width // cw if cw else 1
        u = np.clip(maxv * 0.5 + (yp[::sy, ::sx] - maxv * 0.5) * 0.3, 0,
                    maxv).astype(np.int32)
        v = np.clip(maxv * 0.5 - (yp[::sy, ::sx] - maxv * 0.5) * 0.2, 0,
                    maxv).astype(np.int32)
        frames.append([yp, u, v] if fmt.chroma_format != ChromaFormat.C400
                      else [yp])
    return frames
