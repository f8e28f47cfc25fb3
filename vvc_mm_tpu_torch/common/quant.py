"""Scalar quantization and dequantization — PyTorch counterpart of
`vvc_mm_tpu/common/quant.py` (reference: source/Lib/CommonLib/Quant.cpp:356
dequant, Quant.cpp quant with the dead-zone offsets).

  level  = sign * ((|coeff| * (181/256)^odd * qScale[QP%6] + offset) >> qBits)
  qBits  = 14 + QP//6 + tShift; offset = (171 intra | 85 inter) << (qBits-9)
  coeff' = clip16(level * iScale[QP%6] << QP//6 * (2*181/256)^odd >> dqShift)
  dqShift = bitDepth + ceil((log2W+log2H)/2) - 9   (= 6 - tShift)

The arithmetic stays in int32, products included, so that it wraps exactly
where the JAX package's int32 arithmetic does.
"""
from __future__ import annotations

import torch

from . import rom
from .transforms import _clip16, _rshift_round, transform_shift


def dequantize(level: torch.Tensor, qp: int, log2w: int, log2h: int,
               bit_depth: int = 8, scaling: tuple | None = None
               ) -> torch.Tensor:
    """Inverse quantization (normative), flat scaling only."""
    if scaling is not None:
        raise NotImplementedError("scaling lists: ROADMAP queue 1 item 9")
    t_shift, odd = transform_shift(log2w, log2h, bit_depth)
    dq_shift = 6 - t_shift
    i_scale = int(rom.INV_QUANT_SCALES[qp % 6]) << (qp // 6)
    c = level.to(torch.int32) * i_scale
    if odd:
        # *2*181/256 == sqrt(2) to undo the forward-side 181/256
        c = _clip16(_rshift_round(c * 181, 8 + dq_shift - 1))
    else:
        c = _clip16(_rshift_round(c, dq_shift))
    return c.to(torch.int32)


def quantize(coeff: torch.Tensor, qp: int, log2w: int, log2h: int,
             bit_depth: int = 8, intra: bool = True,
             scaling: tuple | None = None) -> torch.Tensor:
    """Scalar quantization with the VVC dead-zone offsets (171/512 intra,
    85/512 inter), flat scaling only.  (B, H, W) int32 -> int32 levels."""
    if scaling is not None:
        raise NotImplementedError("scaling lists: ROADMAP queue 1 item 9")
    t_shift, odd = transform_shift(log2w, log2h, bit_depth)
    q_bits = rom.QUANT_SHIFT + qp // 6 + t_shift
    q_scale = int(rom.QUANT_SCALES[qp % 6])
    c = coeff.to(torch.int32)
    sign = torch.sign(c)
    mag = c.abs()
    if odd:
        mag = (mag * 181 + 128) >> 8
    offset = (171 if intra else 85) << (q_bits - 9)
    level = torch.clamp((mag * q_scale + offset) >> q_bits, 0,
                        (1 << 15) - 1)
    return (sign * level).to(torch.int32)


def lambda_from_qp(qp: int, intra: bool = True) -> float:
    """RD lambda (reference: EncSlice.cpp:107 setUpLambda — 0.57*2^((qp-12)/3)
    with slice-type dependent weighting).  A Python float on purpose: the
    search thresholds derived from it are host numbers."""
    alpha = 0.57 if intra else 0.68
    return alpha * (2.0 ** ((qp - 12) / 3.0))
