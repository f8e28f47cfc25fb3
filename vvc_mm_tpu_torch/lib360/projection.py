"""Image-plane <-> unit-sphere projections — elementwise float32 torch.

PyTorch counterpart of `vvc_mm_tpu/lib360/projection.py` (reference:
source/Lib/CommonLib/Coordinate.{h,cpp} and Projection.cpp).  Only the
projections the multi-model decoder slice needs are here: ERP (the source
projection) and Perspective (the MPA motion plane).

Every function takes float32 tensors of any shape (Python scalars
broadcast) and keeps the JAX package's operation order, because the
positions they feed are rounded to 1/16 pel and are normative.  The math
functions are ops/libm_kernel.py's, which round as the JAX package's CPU
code does.  Where the JAX codec runs a function inside a jit, XLA rewrites
its float32 arithmetic (a division by a constant becomes a product with
the rounded reciprocal, z / r becomes z * rsqrt(r^2), products feed adds
as FMAs): the `*_fused` forms copy that compiled form.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import libm_kernel as lm

PI = math.pi


def recip32(v) -> float:
    """XLA's folded reciprocal of a float32 constant."""
    return float(np.float32(1.0) / np.float32(v))


def div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c as one rounded float32 division on every device: PyTorch's
    CUDA kernel divides by a Python scalar through its reciprocal, so the
    divisor goes in as a tensor."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def _folded(fn, x: torch.Tensor) -> torch.Tensor:
    """fn, a double function of the host, on each distinct value of the
    float32 host tensor x, rounded to float32 once."""
    vals, inv = torch.unique(x, return_inverse=True)
    out = torch.tensor([fn(v) for v in vals.tolist()], dtype=torch.float64)
    return out.to(torch.float32)[inv]


# ---------------------------------------------------------------------------
# Coordinate conversions (reference: Coordinate.cpp)
# ---------------------------------------------------------------------------
def cartesian_to_polar(x, y):
    return lm.sqrt(x * x + y * y), lm.atan2(y, x)


def polar_to_cartesian(r, phi):
    return r * lm.cos(phi), r * lm.sin(phi)


def cartesian_to_spherical(x, y, z):
    r = lm.sqrt(x * x + y * y + z * z)
    theta = lm.acos(torch.clamp(z / r, -1.0, 1.0))
    phi = lm.atan2(y, x)
    return r, theta, phi


def spherical_to_cartesian(r, theta, phi):
    st = lm.sin(theta)
    return r * st * lm.cos(phi), r * st * lm.sin(phi), r * lm.cos(theta)


# ---------------------------------------------------------------------------
# Equirectangular projection (reference: Projection.cpp ERP methods)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ERP:
    width: int
    height: int
    pixel_offset: float = 0.0

    @property
    def focal(self) -> float:
        """reference: Projection.h:128 — 1/tan(pi/H)."""
        return 1.0 / math.tan(PI / self.height)

    def to_sphere(self, x, y):
        phi = -div(x + self.pixel_offset, self.width) * 2.0 * PI
        theta = div(y + self.pixel_offset, self.height) * PI
        return spherical_to_cartesian(1.0, theta, phi)

    def from_sphere(self, cx, cy, cz):
        _, theta, phi = cartesian_to_spherical(cx, cy, cz)
        phi = torch.where(phi > 0, phi - 2.0 * PI, phi)
        x = -div(phi, 2.0 * PI) * self.width - self.pixel_offset
        y = div(theta, PI) * self.height - self.pixel_offset
        return x, y

    def to_sphere_folded(self, x, y):
        """to_sphere of constant coordinates, as XLA's constant folder
        computes it inside a jit: sin and cos in double, rounded once.
        Host tensors only: the host's double sin and cos (glibc's, as the
        folder's) run on each distinct angle, so a caller computes this
        once per grid (MVReprojection.grid_sphere) and keeps the result
        on its device."""
        if x.device.type != "cpu" or y.device.type != "cpu":
            raise ValueError("to_sphere_folded takes host tensors")
        phi = -div(x + self.pixel_offset, self.width) * 2.0 * PI
        theta = div(y + self.pixel_offset, self.height) * PI
        st = _folded(math.sin, theta)
        return (st * _folded(math.cos, phi), st * _folded(math.sin, phi),
                _folded(math.cos, theta))

    def from_sphere_fused(self, cx, cy, cz, ss, phi_xy=None):
        """from_sphere inside a jit; ss is x^2 + y^2 + z^2 in the caller's
        compiled form, phi_xy the (x, y) that phi's fusion computes where
        they differ from the others.  z / r is z * rsqrt(ss), phi / (2 pi)
        a product with the float32 reciprocal, and (theta / pi) * height
        one product with the folded constant."""
        zr = lm.rsqrt_xla(ss) * cz
        theta = lm.acos(torch.clamp(zr, -1.0, 1.0))
        px, py = (cx, cy) if phi_xy is None else phi_xy
        phi = lm.atan2(py, px)
        phi = torch.where(phi > 0, phi - 2.0 * PI, phi)
        x = (phi * -recip32(2.0 * PI)) * float(self.width) - self.pixel_offset
        y_scale = float(np.float32(recip32(PI)) * np.float32(self.height))
        y = theta * y_scale - self.pixel_offset
        return x, y


# ---------------------------------------------------------------------------
# Perspective projection with virtual image plane (reference:
# Projection.cpp PerspectiveProjection; used as the MPA motion plane)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Perspective:
    focal: float
    cx: float = 0.0
    cy: float = 0.0

    def to_sphere(self, x, y, vip):
        """vip: bool tensor — point lies on the virtual (behind-camera)
        image plane."""
        r, phi = cartesian_to_polar(x - self.cx, y - self.cy)
        theta = lm.atan(div(r, self.focal))
        vipf = vip.to(theta.dtype)
        theta = theta - vipf * (2.0 * theta - PI)
        phi = phi - vipf * PI
        xsr, ysr, zsr = spherical_to_cartesian(1.0, theta, phi)
        # axis permutation (reference: RadialProjection/Perspective toSphere)
        return -zsr, xsr, -ysr

    def to_sphere_fused(self, x, y, vip):
        """to_sphere inside a jit (cx = cy = 0): r = sqrt(fma(x, x, y*y))
        and r / focal a product with the float32 reciprocal.  Returns the
        sphere point's factors (cos theta, sin theta, cos phi, sin phi):
        the callers' fused sums multiply them in their own order."""
        r = lm.sqrt(lm.fma32(x, x, y * y))
        phi = lm.atan2(y, x)
        theta = lm.atan(r * recip32(self.focal))
        vipf = vip.to(theta.dtype)
        theta = theta - vipf * (2.0 * theta - PI)
        phi = phi - vipf * PI
        return lm.cos(theta), lm.sin(theta), lm.cos(phi), lm.sin(phi)

    def from_sphere(self, cx3, cy3, cz3):
        """Returns (x, y, vip)."""
        # inverse axis permutation: spherical of (y, -z, -x)
        _, theta, phi = cartesian_to_spherical(cy3, -cz3, -cx3)
        r = self.focal * lm.tan(theta)
        x, y = polar_to_cartesian(r, phi)
        return x + self.cx, y + self.cy, r < 0


def make_projection(projection_id: int, width: int, height: int):
    """Factory over ProjectionID (reference: EncLib.cpp:335-355).  The
    port's decoder slice carries ERP only."""
    from ..common.typedefs import ProjectionID
    pid = ProjectionID(projection_id)
    if pid == ProjectionID.EQUIRECTANGULAR:
        return ERP(width, height)
    raise NotImplementedError(
        f"projection {pid.name}: fisheye/calibrated projections are "
        "ROADMAP queue 1 item 11 (lib360)")
