"""D1 and D2: dependent quantization's trellis and its dequantizer,
hand-written CUDA for Hopper (csrc/depquant.cu).

  D1 quantize_dep    replaces the `lax.scan` of
                     vvc_mm_tpu/common/depquant.py:70 quantize_dep (no
                     Pallas kernel): the Viterbi search over 4 states x 3
                     candidate levels along the coding order, then the
                     backtrack.
  D2 dequantize_dep  replaces the `lax.scan` of depquant.py:165
                     dequantize_dep: the parity state machine, then the
                     scale.

D1 runs 4 lanes a block (one a destination state, the cost front passed
by shuffles) over terms staged in shared memory; each position depends on
the one before, so a block's floor is that chain of n dependent steps,
not its bytes or operations.  D2 takes a warp's 32 coding positions at a
time, the states by a ballot and a popcount.  Their plain versions are
common/depquant.py's quantize_dep_plain and dequantize_dep_plain, written
in the kernels' decompositions; common/depquant.py's quantize_dep and
dequantize_dep call this module for CUDA tensors.  `LAUNCHES` counts
launches (a group of utils/profiling.py's counter registry).
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from . import cuda_lib

LAUNCHES = profiling.counters("depquant_kernel",
                              ("quantize_dep", "dequantize_dep"))
# When a dict, common/depquant.py's wrappers keep the arguments of their
# last launch in it, keyed by (kernel, block batch shape): a timing run
# replays a kernel on the inputs the encoder really gave it.
CAPTURED: dict | None = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C argument types of each launcher; the last argument is the stream
_ARGS = {
    "quantize_dep": [_P, _I, _I, _P, _P, _F, _F, _I, _P, _P, _P],
    "dequantize_dep": [_P, _I, _I, _P, _I, _I, _I, _P, _P],
}
_BOUND: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch `name` on `device`'s current stream, raise if the launch was
    refused, count it."""
    fn = _BOUND.get(name)
    if fn is None:
        fn = getattr(cuda_lib.load("depquant"), name)
        fn.argtypes = _ARGS[name]
        fn.restype = ctypes.c_int
        _BOUND[name] = fn
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    profiling.launch(LAUNCHES, name)


def _check(name: str, t: torch.Tensor, order: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() != 3 or order.dtype != torch.int32:
        raise TypeError(f"{name}: (B, H, W) int32 blocks and an int32 "
                        f"order required, got {t.dtype} {tuple(t.shape)}")
    if order.device != t.device or order.numel() != t.shape[1] * t.shape[2]:
        raise ValueError(f"{name}: the coding order does not fit the blocks")


def quantize_dep(coeff: torch.Tensor, order: torch.Tensor,
                 rate: torch.Tensor, xscale: float, lam_h: float,
                 odd: bool) -> torch.Tensor:
    """D1 on (B, H, W) int32 coefficients -> signed int32 levels.  `order`:
    the raster position of each coding position; `rate`: float32 bits of
    each level 0 .. 32767; xscale and lam_h float32 values."""
    _check("quantize_dep", coeff, order)
    if rate.dtype != torch.float32 or rate.device != coeff.device:
        raise TypeError("quantize_dep: float32 rate table on the device "
                        "required")
    b, h, w = coeff.shape
    n = h * w
    out = torch.empty_like(coeff, dtype=torch.int32)
    if b == 0:
        return out
    # the decision words and path bytes of blocks of more than 256
    # coefficients, which do not fit shared memory
    scratch = (torch.empty(5 * b * n, dtype=torch.uint8,
                           device=coeff.device) if n > 256 else None)
    c = coeff.contiguous()
    _launch("quantize_dep", coeff.device, c.data_ptr(), b, n,
            order.data_ptr(), rate.data_ptr(), xscale, lam_h, int(odd),
            None if scratch is None else scratch.data_ptr(),
            out.data_ptr())
    return out


def dequantize_dep(level: torch.Tensor, order: torch.Tensor, i_scale: int,
                   dq_shift: int, odd: bool) -> torch.Tensor:
    """D2 on (B, H, W) int32 levels -> int32 dequantized coefficients."""
    _check("dequantize_dep", level, order)
    b, h, w = level.shape
    out = torch.empty_like(level, dtype=torch.int32)
    if b == 0:
        return out
    lv = level.contiguous()
    _launch("dequantize_dep", level.device, lv.data_ptr(), b, h * w,
            order.data_ptr(), i_scale, dq_shift, int(odd), out.data_ptr())
    return out
