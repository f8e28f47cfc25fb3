"""L1: glibc's float32 sinf, cosf, tanf and atan2f, hand-written CUDA for
Hopper (csrc/libm_f32.cu).

  L1 libm_f32   replaces the libm calls that XLA's CPU code makes for the
                JAX package's sphere positions (`jnp.sin`, `cos`, `tan`,
                `arctan2`, and `arcsin` / `arccos` / `arctan` through
                their atan2 expansions); the JAX package has no Pallas
                kernel for them.

On a CUDA tensor each wrapper launches the kernel (one launch a call) and
raises if the launch fails; on a CPU tensor it runs the plain version,
common/libm_f32.py.  The expansions and the correctly rounded sqrt are
float32 and float64 torch operations around the wrappers, the same on
both devices.  `LAUNCHES` counts launches (a group of utils/profiling.py's
counter registry).
"""
from __future__ import annotations

import ctypes

import torch

from ..common import libm_f32 as plain
from ..utils import profiling
from . import cuda_lib

LAUNCHES = profiling.counters("libm_kernel", ("libm_f32",))
_FUNCS = {"sinf": 1, "cosf": 1, "tanf": 1, "atan2f": 2}
_BOUND: dict = {}


def reset_launches() -> None:
    LAUNCHES["libm_f32"] = 0


def _launch(name: str, out: torch.Tensor, *args: torch.Tensor) -> None:
    fn = _BOUND.get(name)
    if fn is None:
        fn = getattr(cuda_lib.load("libm_f32"), "libm_" + name)
        fn.argtypes = ([ctypes.c_void_p] * (_FUNCS[name] + 1)
                       + [ctypes.c_int64, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[name] = fn
    with torch.cuda.device(out.device):
        err = fn(*(a.data_ptr() for a in args), out.data_ptr(), out.numel(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"libm_{name}: CUDA launch failed with error {err}")
    profiling.launch(LAUNCHES, "libm_f32")


def _unary(name: str, x) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.device.type != "cuda":
        return getattr(plain, name)(x)
    xc = x.contiguous()
    out = torch.empty_like(xc)
    if out.numel():
        _launch(name, out, xc)
    return out


def sin(x) -> torch.Tensor:
    return _unary("sinf", x)


def cos(x) -> torch.Tensor:
    return _unary("cosf", x)


def tan(x) -> torch.Tensor:
    return _unary("tanf", x)


def atan2(y, x) -> torch.Tensor:
    y = torch.as_tensor(y, dtype=torch.float32)
    x = torch.as_tensor(x, dtype=torch.float32, device=y.device)
    y, x = torch.broadcast_tensors(y, x)
    if y.device.type != "cuda":
        return plain.atan2f(y, x)
    yc, xc = y.contiguous(), x.contiguous()
    out = torch.empty_like(yc)
    if out.numel():
        _launch("atan2f", out, yc, xc)
    return out


sqrt = plain.sqrtf
fma32 = plain.fma32
rsqrt_xla = plain.rsqrt_xla


def atan(x) -> torch.Tensor:
    """jnp.arctan as XLA expands it: atan2(x, 1)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return atan2(x, torch.ones_like(x))


def asin(x) -> torch.Tensor:
    """jnp.arcsin: 2 atan2(x, 1 + sqrt((1 - x)(1 + x))), doubled by an
    add."""
    x = torch.as_tensor(x, dtype=torch.float32)
    a = atan2(x, sqrt((1.0 - x) * (x + 1.0)) + 1.0)
    return a + a


def acos(x) -> torch.Tensor:
    """jnp.arccos: atan2(sqrt((1 - x)(1 + x)), x)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return atan2(sqrt((1.0 - x) * (x + 1.0)), x)
