"""The benchmark's input pictures, made from the seed.

`realistic_sequence` is a frozen copy of
`vvc_mm_tpu_torch/utils/content.py:realistic_sequence` (itself a numpy
copy of the JAX package's benchmark clip): two noise octaves under a
global pan and slow zoom, a rotating bright disc and a static
high-contrast grid, 8-bit 4:2:0.  The program may change; this does not.
`yaw` turns an ERP clip about the vertical axis (a cyclic shift of its
columns), so that units of one run code different pictures of the same
statistics.
"""
from __future__ import annotations

import numpy as np


def realistic_sequence(width: int, height: int, num_frames: int,
                       seed: int) -> list[list[np.ndarray]]:
    rng = np.random.default_rng(seed)
    h, w = height, width
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
        ang = 0.25 * t
        cx = w * 0.5 + 0.22 * w * np.cos(ang)
        cy = h * 0.5 + 0.3 * h * np.sin(ang)
        r2 = (xx - cx) ** 2 + (yy - cy) ** 2
        y = np.where(r2 < (0.04 * h) ** 2, 235.0, y)
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


def yaw(frames: list, turn: float) -> list:
    """The clip turned by `turn` of a full circle: luma columns shift by
    a multiple of 16 samples, chroma by half as many."""
    shift = int(round(turn * frames[0][0].shape[1] / 16)) * 16
    return [[np.ascontiguousarray(np.roll(p, shift // (1 if i == 0 else 2),
                                          axis=1))
             for i, p in enumerate(f)] for f in frames]


def seed_words(seed: int) -> list[int]:
    """Any whole number as the non-negative words numpy seeds from."""
    return [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, int(seed < 0)]
