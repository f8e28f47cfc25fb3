"""Scalar quantization and dequantization — PyTorch counterpart of
`vvc_mm_tpu/common/quant.py` (reference: source/Lib/CommonLib/Quant.cpp:356
dequant, Quant.cpp quant with the dead-zone offsets, QuantRDOQ.cpp).

  level  = sign * ((|coeff| * (181/256)^odd * qScale[QP%6] + offset) >> qBits)
  qBits  = 14 + QP//6 + tShift; offset = (171 intra | 85 inter) << (qBits-9)
  coeff' = clip16(level * iScale[QP%6] << QP//6 * (2*181/256)^odd >> dqShift)
  dqShift = bitDepth + ceil((log2W+log2H)/2) - 9   (= 6 - tShift)

The arithmetic stays in int32, products included, so that it wraps exactly
where the JAX package's int32 arithmetic does (LFNST-ed coefficients can
take |coeff| * qScale above 2^31).

The encoder's rate models take float32 2*log2(level + 1) + c of integer
levels.  The JAX package computes it on the CPU from XLA's float32 `log`, a
polynomial of its own that rounds many values apart from a correctly
rounded log2 (torch's), times float32(2 / ln 2), fused with the
add.  `log2_rate` reads a table of XLA's values instead, built once on the
host by `_xla_log_f32`, a copy of XLA's polynomial in numpy float32
operations; the table is the same on every device, so the card's kernels,
the plain versions on the card and the CPU all take the same rates.
"""
from __future__ import annotations

import functools
import struct

import numpy as np
import torch

from . import rom
from .rdcost import first_argmin
from .transforms import _clip16, _rshift_round, transform_shift

DEFAULT_WEIGHT = 16      # flat scaling factor (reference: Quant.cpp m=16)
LOG2_LEVELS = 1 << 17    # the rate tables cover levels [0, 2^17)


def _f32_hex(h: str) -> np.float32:
    """A float32 constant from the hexadecimal double LLVM prints for it."""
    return np.float32(struct.unpack(">d", bytes.fromhex(h))[0])


def _xla_log_f32(x: np.ndarray) -> np.ndarray:
    """Natural log of positive normal float32 values as XLA's CPU backend
    computes it (a Cephes-style polynomial in float32, each operation
    rounded on its own).  tests/test_torch_quant_tools.py holds the rate
    tables built from it to XLA's: equal below level 11,047, three levels
    above apart in the last bit."""
    f32 = np.float32
    v = x.astype(f32).view(np.int32)
    ef = ((v >> 23) - 127).astype(f32) + f32(1.0)
    m = ((v & np.int32(-2139095041)) | np.int32(1056964608)).view(f32)
    small = m < _f32_hex("3FE6A09E60000000")             # sqrt(1/2)
    e = ef - np.where(small, f32(1), f32(0))
    x = (m - f32(1)) + np.where(small, m, f32(0))
    x2 = x * x
    x3 = x2 * x
    p1 = x * _f32_hex("3FB2043760000000") + _f32_hex("BFBD7A3700000000")
    p2 = x * _f32_hex("BFBFCBA9E0000000") + _f32_hex("3FC23D37E0000000")
    p3 = x * _f32_hex("3FC999D580000000") + _f32_hex("BFCFFFFF80000000")
    p1 = p1 * x + _f32_hex("3FBDE4A340000000")
    p2 = p2 * x + _f32_hex("BFC555CA00000000")
    p3 = p3 * x + _f32_hex("3FD5555540000000")
    y = ((p1 * x3 + p2) * x3 + p3) * x3
    y = y + _f32_hex("BF2BD01060000000") * e
    r = (x - f32(0.5) * x2) + y
    return (r + _f32_hex("3FE6300000000000") * e).astype(f32)


@functools.lru_cache(maxsize=None)
def log2_rate_np(const: float) -> np.ndarray:
    """float32 2*log2(l + 1) + const for l in [0, LOG2_LEVELS), as the JAX
    package computes it on the CPU: XLA folds 2*log2(x) into log(x) times
    float32(2 / ln 2) and contracts that product and the add into one
    fused multiply-add.  The product of two float32 values and the add are
    exact in float64 here, so one rounding to float32 gives the FMA."""
    x = np.arange(1, LOG2_LEVELS + 1, dtype=np.float32)
    k = np.float64(np.float32(2.0) * np.float32(1.0 / np.log(2.0)))
    return (_xla_log_f32(x).astype(np.float64) * k + const).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _rate_table(const: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(log2_rate_np(const)).to(device)


def log2_rate(level: torch.Tensor, const: float) -> torch.Tensor:
    """float32 2*log2(level + 1) + const of non-negative integer levels
    below LOG2_LEVELS (a level outside the table raises: none of the
    callers' levels can leave it)."""
    return _rate_table(const, level.device)[level.long()]


@functools.lru_cache(maxsize=None)
def scaling_weights(base8x8: tuple, h: int, w: int) -> np.ndarray:
    """Per-coefficient quant weights for an (h, w) block from the signalled
    8x8 base matrix, nearest-upsampled / decimated (reference: ScalingList
    derivation in Quant.cpp xSetScalingListDec — larger blocks replicate,
    smaller blocks subsample the 8x8 list)."""
    base = np.asarray(base8x8, dtype=np.int32).reshape(8, 8)
    ys = (np.arange(h) * 8 // h).clip(0, 7)
    xs = (np.arange(w) * 8 // w).clip(0, 7)
    return np.clip(base[np.ix_(ys, xs)], 1, 255)


@functools.lru_cache(maxsize=None)
def _weights(base8x8: tuple, h: int, w: int, device: torch.device
             ) -> torch.Tensor:
    """scaling_weights on `device`, copied there once (read-only)."""
    return torch.from_numpy(scaling_weights(base8x8, h, w)).to(device)


def dequantize(level: torch.Tensor, qp: int, log2w: int, log2h: int,
               bit_depth: int = 8, scaling: tuple | None = None
               ) -> torch.Tensor:
    """Inverse quantization (normative).  With a scaling list the signalled
    weight (flat default 16) is folded into the level with rounding before
    the standard scale, the encoder's quantize mirroring it."""
    t_shift, odd = transform_shift(log2w, log2h, bit_depth)
    dq_shift = 6 - t_shift
    i_scale = int(rom.INV_QUANT_SCALES[qp % 6]) << (qp // 6)
    level = level.to(torch.int32)
    if scaling is not None:
        wgt = _weights(tuple(scaling), 1 << log2h, 1 << log2w, level.device)
        level = _rshift_round(level * wgt, 4)
    c = level * i_scale
    if odd:
        # *2*181/256 == sqrt(2) to undo the forward-side 181/256
        c = _clip16(_rshift_round(c * 181, 8 + dq_shift - 1))
    else:
        c = _clip16(_rshift_round(c, dq_shift))
    return c.to(torch.int32)


def _magnitude(coeff: torch.Tensor, odd: bool
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sign, |coeff| * (181/256)^odd) in int32."""
    c = coeff.to(torch.int32)
    mag = c.abs()
    if odd:
        mag = (mag * 181 + 128) >> 8
    return torch.sign(c), mag


def quantize(coeff: torch.Tensor, qp: int, log2w: int, log2h: int,
             bit_depth: int = 8, intra: bool = True,
             scaling: tuple | None = None) -> torch.Tensor:
    """Scalar quantization with the VVC dead-zone offsets (171/512 intra,
    85/512 inter).  (B, H, W) int32 -> int32 levels."""
    t_shift, odd = transform_shift(log2w, log2h, bit_depth)
    q_bits = rom.QUANT_SHIFT + qp // 6 + t_shift
    q_scale = int(rom.QUANT_SCALES[qp % 6])
    sign, mag = _magnitude(coeff, odd)
    if scaling is not None:
        w = _weights(tuple(scaling), 1 << log2h, 1 << log2w, mag.device)
        mag = torch.div(mag * 16 + (w >> 1), w, rounding_mode="floor")
    offset = (171 if intra else 85) << (q_bits - 9)
    level = torch.clamp((mag * q_scale + offset) >> q_bits, 0,
                        (1 << 15) - 1)
    return (sign * level).to(torch.int32)


def quantize_rdoq(coeff: torch.Tensor, qp: int, log2w: int, log2h: int,
                  bit_depth: int = 8, intra: bool = True) -> torch.Tensor:
    """Rate-distortion-optimised scalar quantization (RDOQ-lite;
    reference: QuantRDOQ.cpp's per-coefficient level decision without its
    context-chained rate state): each coefficient takes the cheapest of
    {dead-zone level, level - 1, 0} on the exact dequantizer's distortion
    plus lambda times 2*log2(l+1)+3 bits (0.1 for a zero), in float32 and
    in the JAX package's operation order; ties keep the earlier
    candidate.  Encoder-only."""
    t_shift, odd = transform_shift(log2w, log2h, bit_depth)
    sign, mag = _magnitude(coeff, odd)
    q_bits = rom.QUANT_SHIFT + qp // 6 + t_shift
    q_scale = int(rom.QUANT_SCALES[qp % 6])
    offset = (171 if intra else 85) << (q_bits - 9)
    l_dz = (mag * q_scale + offset) >> q_bits            # dead-zone level
    lam = float(np.float32(lambda_from_qp(qp, intra=intra)))
    scale2 = 2.0 ** (-2 * t_shift)         # a power of two: exact in f32
    levs = torch.stack([l_dz, torch.clamp(l_dz - 1, min=0),
                        torch.zeros_like(l_dz)])
    rec = dequantize(sign * levs, qp, log2w, log2h, bit_depth).abs()
    d = (mag - rec).to(torch.float32)
    rate = torch.where(levs > 0, log2_rate(levs, 3.0), 0.1)
    cost = d * d * scale2 + lam * rate
    pick = first_argmin(cost, 0)
    level = torch.gather(levs, 0, pick[None])[0]
    level = torch.clamp(level, 0, (1 << 15) - 1)
    return (sign * level).to(torch.int32)


def ts_qp(qp: int) -> int:
    """Transform-skip QP clamp (reference: Quant.cpp QpParam with
    sps_min_qp_prime_ts — qStep >= 1, so TS is lossless at QP 4)."""
    return max(qp, 4)


def dequantize_ts(level: torch.Tensor, qp: int) -> torch.Tensor:
    """Pixel-domain dequantization of transform-skip blocks: resid = level
    * qStep(QP), the exact inverse of quantize_ts at QP 4."""
    qp = ts_qp(qp)
    i_scale = int(rom.INV_QUANT_SCALES[qp % 6]) << (qp // 6)
    return _clip16(_rshift_round(level.to(torch.int32) * i_scale, 6)).to(
        torch.int32)


def lambda_from_qp(qp: int, intra: bool = True) -> float:
    """RD lambda (reference: EncSlice.cpp:107 setUpLambda — 0.57*2^((qp-12)/3)
    with slice-type dependent weighting).  A Python float on purpose: the
    search thresholds derived from it are host numbers."""
    alpha = 0.57 if intra else 0.68
    return alpha * (2.0 ** ((qp - 12) / 3.0))
