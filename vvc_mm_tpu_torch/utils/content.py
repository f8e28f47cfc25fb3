"""Deterministic test content for the port's smoke run and benchmarks.

A numpy copy of `bench.realistic_sequence` (the JAX package's benchmark
clip): two noise octaves under a global pan + slow zoom, a rotating bright
disc and a static high-contrast grid region, 8-bit 4:2:0.  The committed
streams under tests/data/torch_port/ were encoded from this content, so
the port can score its decoded pictures against the source without the
JAX package.  `fade_sequence` turns a clip into the fade that the weighted
prediction streams code.
"""
from __future__ import annotations

import numpy as np

from ..common.picture import psnr  # noqa: F401  (re-exported)


def realistic_sequence(width: int, height: int, num_frames: int,
                       seed: int = 11):
    """Deterministic realistic test content: two noise octaves under a
    global pan + slow zoom, a rotating bright disc, and a static
    high-contrast grid region (text/UI analog).  8-bit 4:2:0."""
    rng = np.random.default_rng(seed)
    h, w = height, width
    # two octaves of band-limited noise, oversized so pan/zoom stays
    # in-bounds
    oh, ow = h + h // 4, w + w // 4
    base = rng.integers(0, 256, size=(oh, ow)).astype(np.float32)
    for r in (1, 2, 4, 8):
        base = (base + np.roll(base, r, 0) + np.roll(base, -r, 0)
                + np.roll(base, r, 1) + np.roll(base, -r, 1)) / 5.0
    fine = rng.integers(0, 256, size=(oh, ow)).astype(np.float32)
    for r in (1, 2):
        fine = (fine + np.roll(fine, r, 0) + np.roll(fine, -r, 1)) / 3.0
    tex = 0.7 * base + 0.3 * fine
    tex = (tex - tex.min()) / max(float(np.ptp(tex)), 1e-6) * 200 + 20
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for t in range(num_frames):
        zoom = 1.0 + 0.004 * t
        px = 3.1 * t
        py = 1.2 * t
        sx = np.clip(xx / zoom + px, 0, ow - 2)
        sy = np.clip(yy / zoom + py, 0, oh - 2)
        x0, y0 = sx.astype(np.int32), sy.astype(np.int32)
        fx, fy = sx - x0, sy - y0
        y = ((1 - fy) * ((1 - fx) * tex[y0, x0] + fx * tex[y0, x0 + 1])
             + fy * ((1 - fx) * tex[y0 + 1, x0]
                     + fx * tex[y0 + 1, x0 + 1]))
        # rotating bright disc
        ang = 0.25 * t
        cx = w * 0.5 + 0.22 * w * np.cos(ang)
        cy = h * 0.5 + 0.3 * h * np.sin(ang)
        r2 = (xx - cx) ** 2 + (yy - cy) ** 2
        y = np.where(r2 < (0.04 * h) ** 2, 235.0, y)
        # static high-contrast grid region (text/UI analog)
        gy, gx = h // 8, w // 8
        y[gy:2 * gy, gx:3 * gx] = np.where(
            ((yy[gy:2 * gy, gx:3 * gx] // 4)
             + (xx[gy:2 * gy, gx:3 * gx] // 4)) % 2 == 0, 30.0, 220.0)
        yp = np.clip(y, 0, 255).astype(np.int32)
        u = np.full((h // 2, w // 2), 120, np.int32) + (
            yp[::2, ::2] // 16)
        v = np.full((h // 2, w // 2), 124, np.int32) - (
            yp[1::2, ::2] // 16)
        frames.append([yp, np.clip(u, 0, 255), np.clip(v, 0, 255)])
    return frames


def fade_sequence(frames, step: float):
    """A fade to black over `frames` ([y, u, v] int planes): frame i keeps
    the gain g = 1 - step*i, luma y*g and chroma 128 + (c - 128)*g,
    clipped to 0..255 and truncated to int32 (the fade of the JAX
    package's tests/test_weighted_pred.py)."""
    out = []
    for i, (y, u, v) in enumerate(frames):
        g = 1.0 - step * i
        out.append([np.clip(np.asarray(y, np.float64) * g, 0, 255)
                    .astype(np.int32)]
                   + [np.clip(128 + (np.asarray(c, np.float64) - 128) * g,
                              0, 255).astype(np.int32) for c in (u, v)])
    return out
