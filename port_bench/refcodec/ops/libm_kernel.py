"""L1's entry points, as the port's `ops/libm_kernel.py` names them, on
their plain versions: glibc 2.36's float32 sinf, cosf, tanf and atan2f
(common/libm_f32.py), and the expansions XLA gives `jnp.arctan`,
`arcsin` and `arccos` around them.  The frozen reference runs on the CPU
and launches no kernel.
"""
from __future__ import annotations

import torch

from ..common import libm_f32 as plain


def _unary(name: str, x) -> torch.Tensor:
    return getattr(plain, name)(torch.as_tensor(x, dtype=torch.float32))


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
    return plain.atan2f(y, x)


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
