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
each has a plain PyTorch twin, written in its kernel's decomposition and
vectorised over the batch of blocks, and a hand-written CUDA kernel (D1
`quantize_dep`, D2 `dequantize_dep`, csrc/depquant.cu, launched by
ops/depquant_kernel.py).  The public functions take the twin for a tensor
on the CPU and launch the kernel for a CUDA tensor; they never fall back.

The trellis costs are float32 as the JAX package computes them on the CPU,
where XLA contracts err*err and the add it feeds into one fused
multiply-add, while lam_h*rate (a product of a select) is rounded on its
own: fma(err, err, cost) + lam_h*rate.  Here the fused multiply-add is
taken in float64 (the product of two float32 values is exact there) and
rounded once to float32.  The tie rules are the JAX package's (the first
of equal flat candidates src*3 + k, the first cheapest final state; dead
states carry the constant 3e38, whose ties decide those argmins).  The
rate reads quant.log2_rate_np's table, the same on every device.
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


# Of the 12 flat candidates (source state*3 + k: level 0, l0, l0 + 1) only
# three reach each destination state d, by TRANS: d's sources are the two
# states of one quantizer, 2*(d & 1) and 2*(d & 1) + 1 (so all three lie on
# the lattice of offset d & 1), and each offers the zero level and the even
# one of {l0, l0 + 1} for one destination, the odd one for the other.
# Candidate j of d, in flat order: its source state (DEST_SRC) and its
# term (DEST_TERM: 0 the zero level, 1 the even level, 2 the odd one).
# (When l0 = 0 the even level is the zero level, at the same cost: the tie
# keeps the zero term, which comes first.)  A dead destination, all three
# candidates at 3e38, keeps the first of them, where the JAX package's
# 12-way masked argmin takes flat candidate 0; no backtrack reads either,
# since it starts at the cheapest final state, which is live, and a live
# state's cheapest candidate comes from a live source.
DEST_SRC = np.array([[0, 0, 1], [2, 2, 3], [0, 1, 1], [2, 3, 3]], np.int64)
DEST_TERM = np.array([[0, 1, 2], [0, 1, 2], [2, 0, 1], [2, 0, 1]], np.int64)


@functools.lru_cache(maxsize=None)
def _dest_tables(device: torch.device):
    """On `device`: DEST_SRC, DEST_TERM and the lattice (state offset) of
    each destination as a column."""
    return (torch.as_tensor(DEST_SRC, device=device),
            torch.as_tensor(DEST_TERM, device=device),
            (torch.arange(4, device=device) & 1)[:, None])


def lattice_levels(x: torch.Tensor, soff: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The even and the odd one of the two levels {l0, l0 + 1} around x
    (float32, half-step units) in the quantizer of offset `soff`, with
    l0 = clamp(floor((x + soff) / 2), 0, MAX_LEVEL - 1)."""
    l0 = torch.clamp(torch.floor((x + float(soff)) * 0.5), 0,
                     MAX_LEVEL - 1).to(torch.int32)
    return (l0 + 1) & ~1, l0 | 1


def _terms(x: torch.Tensor, lam_h: float, rate: torch.Tensor):
    """What a trellis step needs that the cost front does not touch, for
    each lattice (state offset 0, 1) and term (zero, even, odd level): the
    level, its squared error in float64 (exact: the square of a float32)
    and its float32 lam_h * rate.  x (...) -> three (..., 2, 3) tensors."""
    lv, e2, lr = [], [], []
    for soff in (0, 1):
        even, odd = lattice_levels(x, soff)
        lvl = torch.stack([torch.zeros_like(even), even, odd], -1)
        t = (2 * lvl - soff * (lvl > 0)).to(torch.float32)
        err = (x[..., None] - t).to(torch.float64)
        lv.append(lvl)
        e2.append(err * err)
        lr.append(lam_h * rate[lvl.long()])
    return torch.stack(lv, -2), torch.stack(e2, -2), torch.stack(lr, -2)


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
    """D1's plain version, in D1's decomposition: first every position's
    terms (_terms), then the chain over the coding positions, in which each
    destination state keeps the first cheapest of its three candidates,
    then the backtrack of the states from the first cheapest final
    one, then each position's level from its state and code.  (B, H, W)
    int32 coefficients -> signed int32 levels."""
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
    lv, e2, lr = _terms(xs, p["lam_h"], _rate_table(dev))  # (n, B, 2, 3)
    src, term, lat = _dest_tables(dev)
    e2, lr = e2[:, :, lat, term], lr[:, :, lat, term]     # (n, B, 4, 3)
    cost = torch.full((b, 4), _INF, dtype=torch.float32, device=dev)
    cost[:, 0] = 0.0                                   # start in state 0
    codes = torch.empty((n, b, 4), dtype=torch.int64, device=dev)
    for i in range(n):
        c = ((cost.to(torch.float64)[:, src] + e2[i]).to(torch.float32)
             + lr[i])                                          # (B, 4, 3)
        k = first_argmin(c, 2)                                    # (B, 4)
        cost = torch.gather(c, 2, k[..., None])[..., 0]
        codes[i] = k
    cur = first_argmin(cost, 1)                                # (B,)
    state = torch.empty((n, b), dtype=torch.int64, device=dev)
    for i in range(n - 1, -1, -1):
        state[i] = cur
        cur = src[cur, codes[i].gather(1, cur[:, None])[:, 0]]
    code = codes.gather(2, state[..., None])[..., 0]            # (n, B)
    lev = lv.gather(2, (state & 1)[..., None, None].expand(n, b, 1, 3))
    lev = lev[:, :, 0].gather(2, term[state, code][..., None])[..., 0]
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    out[:, order] = lev.t()
    return (out * sign).reshape(b, h, w)


def _dq_scales(qp: int, log2w: int, log2h: int, bit_depth: int
               ) -> tuple[int, int, bool]:
    t_shift, odd = transform_shift(log2w, log2h, bit_depth)
    dq_shift = 6 - t_shift + 1                     # +1: half-step lattice
    i_scale = int(rom.INV_QUANT_SCALES[qp % 6]) << (qp // 6)
    return i_scale, dq_shift, bool(odd)


def dq_states(parity: torch.Tensor) -> torch.Tensor:
    """The state before each coding position of the machine that starts
    in state 0 and steps next = TRANS[state][parity], for (B, n) parities
    (0 or 1) in coding order.  The machine is affine over GF(2): with
    state = 2*b1 + b0, next = (b0 ^ parity, b1).  So b1 before position p
    is the XOR of the parities at p-1, p-3, ..., and b0 the XOR of those
    at p-2, p-4, ...: one XOR prefix over each class of positions of one
    index parity, taken here in log2(n) doubling steps (D2 takes it a
    warp's 32 positions at a time, by ballot and popcount)."""
    n = parity.shape[1]
    cx = parity.to(torch.int64)     # parity[j] ^ parity[j-2] ^ parity[j-4]...
    k = 2
    while k < n:
        cx = cx ^ torch.nn.functional.pad(cx, (k, 0))[:, :n]
        k *= 2
    b1 = torch.nn.functional.pad(cx, (1, 0))[:, :n]
    b0 = torch.nn.functional.pad(cx, (2, 0))[:, :n]
    return 2 * b1 + b0


def dequantize_dep_plain(level: torch.Tensor, qp: int, log2w: int,
                         log2h: int, bit_depth: int = 8) -> torch.Tensor:
    """D2's plain version, in D2's decomposition: the states by
    dq_states' XOR prefix of the level parities, then each position's
    reconstruction and the scale (integer only)."""
    b, h, w = level.shape
    n = h * w
    dev = level.device
    i_scale, dq_shift, odd = _dq_scales(qp, log2w, log2h, bit_depth)
    order = _order(log2w, log2h, dev).long()
    ls = level.reshape(b, n).to(torch.int32)[:, order]           # (B, n)
    a = ls.abs()
    soff = dq_states(a & 1) >> 1          # STATE_OFF[state] is its b1
    t = (2 * a - soff * (a > 0)) * torch.sign(ls)
    tflat = torch.empty((b, n), dtype=torch.int32, device=dev)
    tflat[:, order] = t.to(torch.int32)
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
