"""CCLM — cross-component linear-model chroma prediction, batched —
PyTorch port.

Counterpart of `vvc_mm_tpu/common/cclm.py` (reference:
source/Lib/CommonLib/IntraPrediction.cpp:267 predIntraChromaLM /
xGetLumaRecPixels + xGetLMParameters): chroma is predicted from the
reconstructed, 2x2-averaged luma of the same block through
c = (l * a >> K) + b, with (a, b) from the block's reconstructed border.

The JAX package computes in int32: `a * l_min` and `l * a` overflow there
(a reaches 255 << 16 when the border's luma range is 1) and wrap.  The
port forms the products in int64 and wraps them to int32 the same way, on
every device.  Its argsort is stable, and ties among border samples are
common, so the port's is stable too.
"""
from __future__ import annotations

import torch

K = 16  # fixed-point shift of the model slope


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 two's-complement wrap (XLA's int32 overflow)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def downsample_luma(blocks: torch.Tensor) -> torch.Tensor:
    """(B, s, s) reconstructed luma -> (B, s/2, s/2) by 2x2 averaging."""
    b, s, _ = blocks.shape
    sc = s // 2
    r = blocks.reshape(b, sc, 2, sc, 2)
    return (r.sum(dim=(2, 4)) + 2) >> 2


def cclm_params(border_l: torch.Tensor, border_c: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b) per block from (B, N) int32 luma / chroma border pairs (top
    row then left column): the two smallest and two largest luma samples,
    averaged with their chroma partners, then the slope's floor division."""
    order = torch.argsort(border_l, dim=1, stable=True)
    lo, hi = order[:, :2], order[:, -2:]

    def avg(v, i):
        return (torch.gather(v, 1, i).sum(1) + 1) >> 1
    l_min, l_max = avg(border_l, lo), avg(border_l, hi)
    c_min, c_max = avg(border_c, lo), avg(border_c, hi)
    diff = (l_max - l_min).to(torch.int64)
    num = (c_max - c_min).to(torch.int64) << K
    a = torch.where(diff > 0, torch.div(num, diff.clamp(min=1),
                                        rounding_mode="floor"),
                    torch.zeros_like(num))
    a = _wrap32(a)
    prod = _wrap32(a.to(torch.int64) * l_min.to(torch.int64))
    b = _wrap32(c_min.to(torch.int64) - (prod >> K).to(torch.int64))
    return a, b


def cclm_predict(dsl: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 bit_depth: int = 8) -> torch.Tensor:
    """The per-block linear model: (B, sc, sc) -> (B, sc, sc) int32."""
    prod = _wrap32(dsl.to(torch.int64) * a.to(torch.int64)[:, None, None])
    p = (prod >> K).to(torch.int64) + b.to(torch.int64)[:, None, None]
    return torch.clamp(_wrap32(p), 0, (1 << bit_depth) - 1)
