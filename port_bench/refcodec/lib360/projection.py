"""Image-plane <-> unit-sphere projections — elementwise float32 torch.

PyTorch counterpart of `vvc_mm_tpu/lib360/projection.py` (reference:
source/Lib/CommonLib/Coordinate.{h,cpp} and Projection.cpp): ERP and
Equisolid (fisheye), the source projections that multi-model coding takes;
Perspective, the MPA motion plane; Calibrated, a radial projection through
a sampled polynomial (LookupTable).

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


# ---------------------------------------------------------------------------
# Equisolid (fisheye) projection (reference: Projection.cpp Equisolid)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Equisolid:
    focal: float
    cx: float = 0.0
    cy: float = 0.0

    def to_sphere(self, x, y):
        r, phi = cartesian_to_polar(x - self.cx, y - self.cy)
        theta = 2.0 * lm.asin(torch.clamp(div(r, 2.0 * self.focal), -1.0,
                                          1.0))
        xsr, ysr, zsr = spherical_to_cartesian(1.0, theta, phi)
        return -zsr, xsr, -ysr

    def from_sphere(self, cx3, cy3, cz3):
        _, theta, phi = cartesian_to_spherical(cy3, -cz3, -cx3)
        r = (2.0 * self.focal) * lm.sin(theta / 2.0)
        x, y = polar_to_cartesian(r, phi)
        return x + self.cx, y + self.cy

    def to_sphere_folded(self, x, y):
        """to_sphere of the constant subblock grid inside the JAX codec's
        jit: XLA folds it op by op in float32 with glibc's functions, so it
        equals to_sphere (on any device)."""
        return self.to_sphere(x, y)

    def from_sphere_fused(self, cx3, cy3, cz3, ss, phi_yz=None):
        """from_sphere inside a jit; ss is the squared norm of (cy3, -cz3,
        -cx3) in the caller's compiled form (sphere_ss_fused).  (-cx3) / r
        is (-cx3) * rsqrt(ss), and the image point fma(cos(phi), r, c) per
        axis; phi_yz: the (cy3, cz3) that phi's own fusion computes, where
        it differs."""
        zr = lm.rsqrt_xla(ss) * -cx3
        theta = lm.acos(torch.clamp(zr, -1.0, 1.0))
        py, pz = (cy3, cz3) if phi_yz is None else phi_yz
        phi = lm.atan2(-pz, py)
        r = lm.sin(theta * 0.5) * float(np.float32(2.0 * self.focal))
        return (lm.fma32(lm.cos(phi), r, float(np.float32(self.cx))),
                lm.fma32(lm.sin(phi), r, float(np.float32(self.cy))))

    @staticmethod
    def sphere_ss_fused(cx3, cy3, cz3, q_first: bool):
        """The squared norm of from_sphere's (p, q, r) = (cy3, -cz3, -cx3)
        as XLA contracts it: fma(r, r, fma(p, p, q*q)), or with q_first
        fma(r, r, fma(q, q, p*p)) (the compiled code's operand order)."""
        p, q, r = cy3, -cz3, -cx3
        inner = lm.fma32(q, q, p * p) if q_first else lm.fma32(p, p, q * q)
        return lm.fma32(r, r, inner)

    def sphere_angles_fused(self, x, y, fused_r2: bool):
        """(theta, phi) of to_sphere(x, y) inside the JAX codec's merged
        positions: r^2 = fma(dx, dx, dy*dy) (fused_r2) or two rounded
        squares summed (a block centre's, hoisted out of the vectorized
        loop), r / (2 focal) a product with the float32 reciprocal, then
        the arcsin expansion."""
        dx, dy = x - self.cx, y - self.cy
        r2 = lm.fma32(dx, dx, dy * dy) if fused_r2 else dx * dx + dy * dy
        q = torch.clamp(lm.sqrt(r2) * recip32(2.0 * self.focal), -1.0, 1.0)
        a = lm.atan2(q, lm.sqrt((1.0 - q) * (q + 1.0)) + 1.0)
        return (a + a) * 2.0, lm.atan2(dy, dx)

    def center_spherical_fused(self, cx, cy):
        """(theta_c, phi_c) of block centres, cartesian_to_spherical of
        to_sphere(cx, cy), as the JAX codec's merged positions compute
        them: sphere_angles_fused, then the sphere point's squared norm
        fma(Y, Y, fma(ct, ct, X*X)) with (X, Y) = (cos phi, sin phi) *
        sin theta."""
        theta, phi = self.sphere_angles_fused(cx, cy, False)
        st, ct = lm.sin(theta), lm.cos(theta)
        x, y = lm.cos(phi) * st, lm.sin(phi) * st
        ss = lm.fma32(y, y, lm.fma32(ct, ct, x * x))
        theta_c = lm.acos(torch.clamp(lm.rsqrt_xla(ss) * -y, -1.0, 1.0))
        return theta_c, lm.atan2(x, -ct)


class LookupTable:
    """Sampled 1-D monotone function with forward and inverse lookup
    (reference: LookupTable.h:12-32 — used by CalibratedProjection for the
    theta <-> radius polynomial).  The samples are float64 on the host, as
    the JAX package takes them; a lookup interpolates in float32, as its
    jnp.interp does without x64 (jax/_src/numpy/lax_numpy.py `_interp`,
    which runs under a jit: fp[i-1] + (delta / dx) * df is one FMA)."""

    def __init__(self, fn, domain, n: int = 4096):
        lo, hi = domain
        self.xs = np.linspace(lo, hi, int(n))
        self.ys = np.array([float(fn(x)) for x in self.xs])
        if not np.all(np.diff(self.ys) >= 0):
            raise ValueError("LookupTable requires a monotone function")

    @staticmethod
    def interp(x, xp: np.ndarray, fp: np.ndarray) -> torch.Tensor:
        """jnp.interp(x, xp, fp) in float32, with fp[0] left of xp and
        fp[-1] right of it."""
        x = torch.as_tensor(x, dtype=torch.float32)
        xp = torch.as_tensor(np.asarray(xp, np.float32), device=x.device)
        fp = torch.as_tensor(np.asarray(fp, np.float32), device=x.device)
        i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                        1, xp.numel() - 1)
        df = fp[i] - fp[i - 1]
        dx = xp[i] - xp[i - 1]
        delta = x - xp[i - 1]
        eps = float(np.spacing(np.finfo(np.float32).eps))
        dx0 = dx.abs() <= eps
        f = torch.where(dx0, fp[i - 1], lm.fma32(
            delta / torch.where(dx0, torch.ones_like(dx), dx), df,
            fp[i - 1]))
        f = torch.where(x < xp[0], fp[0], f)
        return torch.where(x > xp[-1], fp[-1], f)

    def lookup(self, x):
        return self.interp(x, self.xs, self.ys)

    def inverse_lookup(self, y):
        return self.interp(y, self.ys, self.xs)


class Calibrated:
    """Calibrated polynomial radial projection (reference:
    Projection.h:78-97 CalibratedProjection — radius(theta) is a fitted
    polynomial sampled into a LookupTable; theta(radius) is the inverse
    lookup; LUT domain [0, pi/2 + pi/18] as in Projection.cpp:88).  It has
    no focal length, so no MPA motion plane: multi-model coding refuses
    it (make_projection)."""

    def __init__(self, coefficients, cx: float = 0.0, cy: float = 0.0,
                 n: int = 4096):
        self.coeffs = tuple(float(c) for c in coefficients)
        self.cx, self.cy = cx, cy
        self._lut = LookupTable(self._poly,
                                (0.0, np.pi / 2 + np.pi / 18), n)

    def _poly(self, t: float) -> float:
        return sum(c * t ** i for i, c in enumerate(self.coeffs))

    def radius(self, theta):
        return self._lut.lookup(theta)

    def theta(self, radius):
        return self._lut.inverse_lookup(radius)

    def to_sphere(self, x, y):
        r, phi = cartesian_to_polar(x - self.cx, y - self.cy)
        theta = self.theta(r)
        xsr, ysr, zsr = spherical_to_cartesian(1.0, theta, phi)
        return -zsr, xsr, -ysr

    def from_sphere(self, cx3, cy3, cz3):
        _, theta, phi = cartesian_to_spherical(cy3, -cz3, -cx3)
        r = self.radius(theta)
        x, y = polar_to_cartesian(r, phi)
        return x + self.cx, y + self.cy


DEFAULT_FOCAL = (1088.0 / 5.2) * 1.8   # reference: a 1088-pixel sensor


def make_projection(projection_id: int, width: int, height: int,
                    focal: float | None = None, coefficients=None,
                    motion: bool = False):
    """Factory over ProjectionID (reference: EncLib.cpp:335-355).
    PERSPECTIVE raises, as in the JAX package (MM operates on ERP or
    fisheye content).  motion=True asks for a projection that multi-model
    coding can take: CALIBRATED then raises too, because it has no focal
    length for the MPA motion plane (the JAX package's `Calibrated` has no
    `focal`, so its encoder fails at the first P picture)."""
    from ..common.typedefs import ProjectionID
    pid = ProjectionID(projection_id)
    if pid == ProjectionID.EQUIRECTANGULAR:
        return ERP(width, height)
    if pid == ProjectionID.PERSPECTIVE:
        raise NotImplementedError("perspective source projection: "
                                  "MM operates on ERP/fisheye content")
    if pid == ProjectionID.EQUISOLID:
        return Equisolid(focal or DEFAULT_FOCAL, (width - 1) / 2.0,
                         (height - 1) / 2.0)
    if pid == ProjectionID.CALIBRATED:
        if motion:
            raise NotImplementedError(
                "calibrated source projection with multi-model motion: "
                "the projection has no focal length for the MPA motion "
                "plane (the JAX package's Calibrated has no `focal`, so its "
                "encoder cannot code it either)")
        # default: equidistant-ish polynomial r = f*theta when no
        # calibration is supplied
        f = focal or DEFAULT_FOCAL
        coeffs = coefficients if coefficients is not None else (0.0, f)
        return Calibrated(coeffs, (width - 1) / 2.0, (height - 1) / 2.0)
    raise NotImplementedError(f"projection {pid}")
