"""Dependent quantization (DepQuant): the trellis quantizer and its
normative dequantizer.

PyTorch counterpart of `vvc_mm_tpu/common/depquant.py` (reference:
source/Lib/CommonLib/DepQuant.cpp:821+ `class State`).  Two scalar
quantizers Q0/Q1, half a step apart, are coupled through a 4-state machine
driven by level parity:

    state 0,1 -> Q0 (recon t = 2*level),   state 2,3 -> Q1 (t = 2*level-1)
    next_state = TRANS[state][level & 1]

and the encoder picks the level sequence minimising sum(dist + lambda*rate)
along the reverse diagonal scan (the coding order, high frequency -> DC)
over every position of the block.

The JAX package runs both as `lax.scan`s over the coding positions.  Here
each has a plain PyTorch twin (the scan written out as a loop over the
positions, vectorised over the batch of blocks) and a hand-written CUDA
kernel (D1 `quantize_dep`, D2 `dequantize_dep`, csrc/depquant.cu, launched
by ops/depquant_kernel.py).  The public functions take the twin for a
tensor on the CPU and launch the kernel for a CUDA tensor; they never fall
back.

The trellis costs are float32 as the JAX package computes them on the CPU,
where XLA contracts err*err and the add it feeds into one fused
multiply-add, while lam_h*rate (a product of a select) is rounded on its
own: fma(err, err, cost) + lam_h*rate.  Here the fused multiply-add is
taken in float64 (the product of two float32 values is exact there) and
rounded once to float32.  The tie rules are the JAX package's (the first of equal flat candidates src*3 + k, the first
cheapest final state; dead states carry the constant 3e38, whose ties
decide those argmins).  The rate reads quant.log2_rate_np's table, the same
on every device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import rom
from .quant import log2_rate_np
from .rdcost import first_argmin
from .transforms import _clip16, _rshift_round, transform_shift

# state transition by level parity (reference: DepQuant.cpp state setup)
TRANS = np.array([[0, 2], [2, 0], [1, 3], [3, 1]], dtype=np.int32)
# quantizer offset per state: Q0 for {0,1}, Q1 for {2,3}
STATE_OFF = np.array([0, 0, 1, 1], dtype=np.int32)

_INF = float(np.float32(3e38))
MAX_LEVEL = (1 << 15) - 1


def _coding_order(log2w: int, log2h: int) -> np.ndarray:
    """Flat positions in coding order (reverse diagonal scan)."""
    return rom.scan_order(log2w, log2h)[::-1].copy()


@functools.lru_cache(maxsize=None)
def _order(log2w: int, log2h: int, device: torch.device) -> torch.Tensor:
    """_coding_order as an int32 tensor on `device` (read-only)."""
    return torch.from_numpy(_coding_order(log2w, log2h)).to(device)


@functools.lru_cache(maxsize=None)
def rate_bits_np() -> np.ndarray:
    """float32 rate in bits of each level 0 .. MAX_LEVEL: 0.7 for a zero,
    2 + 2*log2(l+1) otherwise (a cheap CABAC-ladder model; encoder-only)."""
    r = log2_rate_np(2.0)[:MAX_LEVEL + 1].copy()
    r[0] = np.float32(0.7)
    return r


@functools.lru_cache(maxsize=None)
def _rate_table(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rate_bits_np()).to(device)


@functools.lru_cache(maxsize=None)
def _trellis_consts(device: torch.device):
    """Per-candidate constants of one trellis step over the flat (4 source
    states x 3 candidates) axis: the state offset, the source state, the
    candidate's step over l0 and whether it is the zero candidate; then
    the flat transition table and the 4 destination states as a column."""
    src = torch.arange(4, device=device).repeat_interleave(3)      # (12,)
    k = torch.arange(3, device=device).repeat(4)
    soff = torch.as_tensor(STATE_OFF, device=device)[src]
    trans = torch.as_tensor(TRANS.reshape(-1), device=device)
    return (soff.to(torch.int32), src, (k == 2).to(torch.int32), k == 0,
            trans, torch.arange(4, device=device)[:, None])


def dq_params(qp: int, log2w: int, log2h: int, bit_depth: int,
              lam: float | None = None) -> dict:
    """The scalars of quantize_dep: the float32 scale from |coeff| to
    half-step units, lambda in those units (both float32 values held in
    Python floats) and the odd-size flag."""
    t_shift, odd = transform_shift(log2w, log2h, bit_depth)
    q_bits = rom.QUANT_SHIFT + qp // 6 + t_shift
    q_scale = int(rom.QUANT_SCALES[qp % 6])
    if lam is None:
        # the pixel-domain lambda (0.57*2^((qp-12)/3), EncSlice.cpp:107)
        # in half-step units: dist_pixel = err_half^2 * hs^2 / (4^ts*2^odd)
        # with hs = 2^(q_bits-1)/q_scale
        lam_pix = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        scale = (2.0 ** (26 + 2 * (qp // 6))
                 / (float(q_scale) ** 2 * (2.0 if odd else 1.0)))
        lam = lam_pix / scale
    return dict(xscale=float(np.float32(q_scale / float(1 << (q_bits - 1)))),
                lam_h=float(np.float32(lam)), odd=bool(odd))


def quantize_dep_plain(coeff: torch.Tensor, qp: int, log2w: int, log2h: int,
                       bit_depth: int = 8, lam: float | None = None
                       ) -> torch.Tensor:
    """D1's plain version: the trellis over (B, H, W) int32 coefficients
    -> signed int32 levels."""
    b, h, w = coeff.shape
    n = h * w
    dev = coeff.device
    p = dq_params(qp, log2w, log2h, bit_depth, lam)
    order = _order(log2w, log2h, dev).long()
    flat = coeff.reshape(b, n).to(torch.int32)
    sign = torch.sign(flat)
    mag = flat.abs()
    if p["odd"]:
        mag = (mag * 181 + 128) >> 8
    xs = (mag.to(torch.float32) * p["xscale"])[:, order].t()   # (n, B)
    rate = _rate_table(dev)
    soff, src, plus1, zero, trans, dest_ids = _trellis_consts(dev)
    soff_f = soff.to(torch.float32)
    cost = torch.full((b, 4), _INF, dtype=torch.float32, device=dev)
    cost[:, 0] = 0.0                                   # start in state 0
    lvls, srcs = [], []
    for i in range(n):
        x = xs[i][:, None]                                        # (B, 1)
        l0 = torch.clamp(torch.floor((x + soff_f) * 0.5), 0,
                         MAX_LEVEL - 1).to(torch.int32)           # (B, 12)
        cands = torch.where(zero, 0, l0 + plus1)
        t = (2 * cands - soff * (cands > 0)).to(torch.float32)
        err = x - t
        e2 = err.to(torch.float64)
        d = (cost[:, src].to(torch.float64) + e2 * e2).to(torch.float32)
        c = d + p["lam_h"] * rate[cands.long()]
        dest = trans[src * 2 + (cands & 1)]
        cm = torch.where(dest[:, None, :] == dest_ids, c[:, None, :], _INF)
        k = first_argmin(cm, 2)                               # (B, 4)
        cost = torch.gather(cm, 2, k[..., None])[..., 0]
        lvls.append(torch.gather(cands, 1, k))
        srcs.append(src[k])
    cur = first_argmin(cost, 1)                                # (B,)
    lev = torch.empty((n, b), dtype=torch.int32, device=dev)
    for i in range(n - 1, -1, -1):
        lev[i] = torch.gather(lvls[i], 1, cur[:, None])[:, 0]
        cur = torch.gather(srcs[i], 1, cur[:, None])[:, 0]
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    out[:, order] = lev.t()
    return (out * sign).reshape(b, h, w)


def _dq_scales(qp: int, log2w: int, log2h: int, bit_depth: int
               ) -> tuple[int, int, bool]:
    t_shift, odd = transform_shift(log2w, log2h, bit_depth)
    dq_shift = 6 - t_shift + 1                     # +1: half-step lattice
    i_scale = int(rom.INV_QUANT_SCALES[qp % 6]) << (qp // 6)
    return i_scale, dq_shift, bool(odd)


def dequantize_dep_plain(level: torch.Tensor, qp: int, log2w: int,
                         log2h: int, bit_depth: int = 8) -> torch.Tensor:
    """D2's plain version: the decoder's state machine along the coding
    order, then the scale (integer only)."""
    b, h, w = level.shape
    n = h * w
    dev = level.device
    i_scale, dq_shift, odd = _dq_scales(qp, log2w, log2h, bit_depth)
    order = _order(log2w, log2h, dev).long()
    ls = level.reshape(b, n).to(torch.int32)[:, order].t()        # (n, B)
    a = ls.abs()
    parity = a & 1
    soff = torch.as_tensor(STATE_OFF, device=dev)
    trans = torch.as_tensor(TRANS.reshape(-1), device=dev)
    state = torch.zeros(b, dtype=torch.int64, device=dev)
    offs = []
    for i in range(n):
        offs.append(soff[state])
        state = trans[state * 2 + parity[i]]
    t = (2 * a - torch.stack(offs) * (a > 0)) * torch.sign(ls)
    tflat = torch.empty((b, n), dtype=torch.int32, device=dev)
    tflat[:, order] = t.t().to(torch.int32)
    c = tflat.reshape(b, h, w) * i_scale
    if odd:
        c = _clip16(_rshift_round(c * 181, 8 + dq_shift - 1))
    else:
        c = _clip16(_rshift_round(c, dq_shift))
    return c.to(torch.int32)


def quantize_dep(coeff: torch.Tensor, qp: int, log2w: int, log2h: int,
                 bit_depth: int = 8, lam: float | None = None
                 ) -> torch.Tensor:
    """Trellis-quantize a (B, H, W) int32 coefficient batch: signed int32
    levels whose dependent reconstruction minimises distortion +
    lambda*rate along the scan.  CPU tensors take the plain version, CUDA
    tensors kernel D1."""
    if coeff.device.type == "cpu":
        return quantize_dep_plain(coeff, qp, log2w, log2h, bit_depth, lam)
    from ..ops import depquant_kernel
    if depquant_kernel.CAPTURED is not None:
        depquant_kernel.CAPTURED[("quantize_dep", tuple(coeff.shape))] = \
            (coeff, qp, log2w, log2h, bit_depth, lam)
    p = dq_params(qp, log2w, log2h, bit_depth, lam)
    return depquant_kernel.quantize_dep(
        coeff, _order(log2w, log2h, coeff.device), _rate_table(coeff.device),
        p["xscale"], p["lam_h"], p["odd"])


def dequantize_dep(level: torch.Tensor, qp: int, log2w: int, log2h: int,
                   bit_depth: int = 8) -> torch.Tensor:
    """Normative dependent dequantization (reference: Quant.cpp dequant DQ
    path), shared by the encoder's reconstruction and the decoder.  CPU
    tensors take the plain version, CUDA tensors kernel D2."""
    if level.device.type == "cpu":
        return dequantize_dep_plain(level, qp, log2w, log2h, bit_depth)
    from ..ops import depquant_kernel
    if depquant_kernel.CAPTURED is not None:
        depquant_kernel.CAPTURED[("dequantize_dep", tuple(level.shape))] = \
            (level, qp, log2w, log2h, bit_depth)
    i_scale, dq_shift, odd = _dq_scales(qp, log2w, log2h, bit_depth)
    return depquant_kernel.dequantize_dep(
        level, _order(log2w, log2h, level.device), i_scale, dq_shift, odd)
