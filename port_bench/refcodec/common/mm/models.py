"""The multi-model motion models of the decoder slice — elementwise torch.

PyTorch counterpart of `vvc_mm_tpu/common/mm/models.py` (reference:
source/Lib/CommonLib/MotionModels/): CLASSIC (translational), the three MPA
planes, 3-D translational (3DT), tangential (TAN), ROT and the geodesic
family (GED with a signalled epipole, GEDA on the fixed axes).

Each model is two elementwise functions:

  model_motion(grid_x, grid_y, mv_x, mv_y, cx, cy) -> (moved_x, moved_y)
      maps each subblock center of the current block to where it lands in
      the reference frame.  Arguments broadcast, so one call models every
      subblock of a frame.
  mv_for_shift(px, py, sx, sy, cx, cy) -> (mv_x, mv_y)
      the closed-form inverse (reference: MotionModel.h
      motionVectorForEquivalentPixelShiftAt), used by
      reprojection.mv_in_desired_model; the codec's MM-MVP converts
      through the host's mvp_convert.py instead.

MV units are pixels (float32); the 1/16-pel rounding lives in
reprojection.py.  A model may give NaN (a point behind the camera, TAN's
0/0 at rho = 0, an arcsin argument that rounds past 1); the callers turn
NaN into "no motion".  The operation order is the JAX package's, so the
float32 results differ from it only where the math libraries round
differently.
"""
from __future__ import annotations

import numpy as np
import torch

from ...lib360.projection import (Equisolid, Perspective,
                                  cartesian_to_spherical, div,
                                  spherical_to_cartesian, PI)
from ..typedefs import MotionModelID as M
from ...ops import libm_kernel as lm


# ---------------------------------------------------------------------------
# Translational (CLASSIC)
# ---------------------------------------------------------------------------
def translational_motion(grid_x, grid_y, mv_x, mv_y, cx=None, cy=None):
    return grid_x + mv_x, grid_y + mv_y


def translational_mv_for_shift(px, py, sx, sy, cx=None, cy=None):
    return sx - px, sy - py


# ---------------------------------------------------------------------------
# Motion-plane adaptive (MPA) — reference: MotionPlaneAdaptiveMotionModel.cpp
# ---------------------------------------------------------------------------
def _mpa_axes_to_plane(plane: int, x, y, z):
    """Sphere -> motion-plane axes (reference: toPerspective switch,
    MotionPlaneAdaptiveMotionModel.cpp:117-143)."""
    if plane == M.MPA_FRONT_BACK:
        return x, y, z
    if plane == M.MPA_LEFT_RIGHT:
        return y, -x, z
    if plane == M.MPA_TOP_BOTTOM:
        return -z, y, x
    raise ValueError(plane)


def _mpa_axes_from_plane(plane: int, x, y, z):
    """Inverse axis swap (reference: toProjection switch)."""
    if plane == M.MPA_FRONT_BACK:
        return x, y, z
    if plane == M.MPA_LEFT_RIGHT:
        return -y, x, z
    if plane == M.MPA_TOP_BOTTOM:
        return z, y, -x
    raise ValueError(plane)


def mpa_to_perspective(proj, plane: int, grid_x, grid_y):
    """Project to the motion plane; returns (px, py, vip).  Cacheable per
    frame geometry (reference: fillCache)."""
    persp = Perspective(proj.focal)
    sx, sy, sz = proj.to_sphere(grid_x, grid_y)
    px_, py_, pz_ = _mpa_axes_to_plane(plane, sx, sy, sz)
    return persp.from_sphere(px_, py_, pz_)


def mpa_from_perspective(proj, plane: int, px, py, vip):
    persp = Perspective(proj.focal)
    sx, sy, sz = persp.to_sphere(px, py, vip)
    x, y, z = _mpa_axes_from_plane(plane, sx, sy, sz)
    return proj.from_sphere(x, y, z)


def mpa_from_perspective_fused(proj, plane: int, px, py, vip):
    """mpa_from_perspective as XLA compiles it in the JAX codec's merged
    positions.  With (X, Y, Z) = (-ct, st*cp, -(st*sp)) the sphere point
    (ct = cos theta, st = sin theta, cp = cos phi, sp = sin phi), the
    plane's axes swap it, and r^2 is two FMAs whose order the compiled
    code fixes: fma(st*sp, st*sp, fma(ct, ct, (st*cp)^2)) on the front/back
    and left/right planes, fma(ct, ct, fma(sp*st, sp*st, (cp*st)^2)) on
    the top/bottom plane."""
    ct, st, cp, sp = Perspective(proj.focal).to_sphere_fused(px, py, vip)
    a, b = st * cp, st * sp
    if isinstance(proj, Equisolid):
        x, y, z = _mpa_axes_from_plane(plane, -ct, a, -b)
        return proj.from_sphere_fused(x, y, z, proj.sphere_ss_fused(
            x, y, z, q_first=plane == M.MPA_TOP_BOTTOM))
    if plane == M.MPA_TOP_BOTTOM:
        ss = lm.fma32(ct, ct, lm.fma32(b, b, a * a))
    else:
        ss = lm.fma32(b, b, lm.fma32(ct, ct, a * a))
    x, y, z = _mpa_axes_from_plane(plane, -ct, a, -b)
    return proj.from_sphere_fused(x, y, z, ss)


def mpa_center_motion_fused(proj, plane: int, cx, cy, mv_x, mv_y):
    """MPA's motion of ERP block centres in the form XLA compiles for the
    JAX codec's search jits (reproject_block_centers inside them): the
    centre's sphere point op by op, its perspective-plane angles through
    r^2 with the row's ct*ct rounded on its own (hoisted) and the other
    two squares fused, fma(r, r, fma(p, p, ct*ct)) on the front/back and
    left/right planes and fma(p, p, q*q) + ct*ct on the top/bottom plane
    ((p, q, r) the spherical arguments), the plane radius tan(theta) *
    focal and the MV step fused into its coordinates, fma(R, cos(phi),
    mv * sign); then the merged positions' form back."""
    fma = lm.fma32
    phi = -div(cx + proj.pixel_offset, proj.width) * 2.0 * PI
    theta = div(cy + proj.pixel_offset, proj.height) * PI
    cp, sp = lm.cos(phi), lm.sin(phi)
    st, ct = lm.sin(theta), lm.cos(theta)
    ct2 = ct * ct
    a, b = st * cp, st * sp
    if plane == M.MPA_TOP_BOTTOM:
        p, q, r = b, -a, ct
        ss = fma(p, p, q * q) + ct2
    else:
        p, q, r = (b, -ct, -a) if plane == M.MPA_FRONT_BACK else (-a, -ct, -b)
        ss = fma(r, r, fma(p, p, ct2))
    theta_p = lm.acos(torch.clamp(lm.rsqrt_xla(ss) * r, -1.0, 1.0))
    phi_p = lm.atan2(q, p)
    radius = lm.tan(theta_p) * float(np.float32(proj.focal))
    vip = radius < 0
    sign = torch.where(vip, -1.0, 1.0).to(radius.dtype)
    px = fma(radius, lm.cos(phi_p), mv_x * sign)
    py = fma(radius, lm.sin(phi_p), mv_y * sign)
    return mpa_from_perspective_fused(proj, plane, px, py, vip)


def mpa_motion(proj, plane: int, grid_x, grid_y, mv_x, mv_y, cx=None, cy=None,
               pers_cache=None, form: str | None = None):
    """pers_cache: optional precomputed (px, py, vip) for the grid (the
    JAX package computes it op by op, outside its jit).  form: "merged"
    or "search", the motion in the form of the JAX codec's jit-compiled
    positions (the same for both); None, op by op."""
    if pers_cache is None:
        px, py, vip = mpa_to_perspective(proj, plane, grid_x, grid_y)
    else:
        px, py, vip = pers_cache
    sign = torch.where(vip, -1.0, 1.0).to(px.dtype)
    back = mpa_from_perspective if form is None else \
        mpa_from_perspective_fused
    return back(proj, plane, px + mv_x * sign, py + mv_y * sign, vip)


def mpa_mv_for_shift(proj, plane: int, px_, py_, sx_, sy_, cx=None,
                     cy=None):
    """Equivalent motion-plane MV for a pixel shift.  NaN where the original
    and the shifted position fall on different image planes (the caller
    zeroes it)."""
    ox, oy, ovip = mpa_to_perspective(proj, plane, px_, py_)
    mx, my, mvip = mpa_to_perspective(proj, plane, sx_, sy_)
    sign = torch.where(mvip, -1.0, 1.0).to(mx.dtype)
    bad = ovip != mvip
    nan = torch.tensor(float("nan"), dtype=mx.dtype, device=mx.device)
    return (torch.where(bad, nan, (mx - ox) * sign),
            torch.where(bad, nan, (my - oy) * sign))


# ---------------------------------------------------------------------------
# 3-D translational (3DT) — reference: ThreeDTranslationalMotionModel.cpp
# ---------------------------------------------------------------------------
def t3d_motion(proj, grid_x, grid_y, mv_x, mv_y, cx, cy,
               form: str | None = None, grid_sphere=None):
    """The block center's displacement on the sphere, (center + mv) minus
    center in 3-D, added to every grid point and projected back; op by
    op, or (form "merged") in the form XLA compiles for the JAX codec's
    merged positions: the grid's sphere points folded in double
    (grid_sphere, ERP.to_sphere_folded of the grid), the centers'
    factors float32 values (their products at run time), each coordinate
    of the displacement one FMA, fma(cp*st at the moved center, -(center's
    product)), and r^2 = fma(z, z, fma(x, x, y*y)).  The merge search
    ("search") computes it op by op."""
    if form == "merged" and isinstance(proj, Equisolid):
        return _t3d_motion_equisolid(proj, grid_sphere, grid_x, grid_y,
                                     mv_x, mv_y, cx, cy)
    if form == "merged":
        gx, gy, gz = grid_sphere
        th_c = div(cy + proj.pixel_offset, proj.height) * PI
        ph_c = -div(cx + proj.pixel_offset, proj.width) * 2.0 * PI
        st_c, ct_c = lm.sin(th_c), lm.cos(th_c)
        cp_c, sp_c = lm.cos(ph_c), lm.sin(ph_c)
        th_m = div(cy + mv_y + proj.pixel_offset, proj.height) * PI
        ph_m = -div(cx + mv_x + proj.pixel_offset, proj.width) * 2.0 * PI
        st, ct = lm.sin(th_m), lm.cos(th_m)
        x = gx + lm.fma32(lm.cos(ph_m), st, -(st_c * cp_c))
        y = gy + lm.fma32(lm.sin(ph_m), st, -(sp_c * st_c))
        z = (ct - ct_c) + gz
        out_x, out_y = proj.from_sphere_fused(
            x, y, z, lm.fma32(z, z, lm.fma32(x, x, y * y)))
    else:
        c3x, c3y, c3z = proj.to_sphere(cx, cy)
        m3x, m3y, m3z = proj.to_sphere(cx + mv_x, cy + mv_y)
        gx, gy, gz = proj.to_sphere(grid_x, grid_y)
        out_x, out_y = proj.from_sphere(gx + (m3x - c3x), gy + (m3y - c3y),
                                        gz + (m3z - c3z))
    zero = (mv_x == 0) & (mv_y == 0)
    return (torch.where(zero, grid_x, out_x), torch.where(zero, grid_y, out_y))


def _t3d_motion_equisolid(proj, grid_sphere, grid_x, grid_y, mv_x, mv_y,
                          cx, cy):
    """t3d_motion on an Equisolid in the form XLA compiles for the JAX
    codec's merged positions: the grid's sphere points folded
    (grid_sphere), the centres' angles with two rounded squares, the moved
    centres' with r^2 one FMA; the displacement's y and z one FMA each
    (the moved centre's product fused in y, the centre's in z), and
    r^2 = fma(x, x, fma(y, y, z*z))."""
    gx, gy, gz = grid_sphere
    th_c, ph_c = proj.sphere_angles_fused(cx, cy, False)
    th_m, ph_m = proj.sphere_angles_fused(cx + mv_x, cy + mv_y, True)
    st_c, st_m = lm.sin(th_c), lm.sin(th_m)
    x = gx + (lm.cos(th_c) - lm.cos(th_m))
    y = gy + lm.fma32(lm.cos(ph_m), st_m, -(lm.cos(ph_c) * st_c))
    z = gz + lm.fma32(lm.sin(ph_c), st_c, -(lm.sin(ph_m) * st_m))
    out_x, out_y = proj.from_sphere_fused(
        x, y, z, proj.sphere_ss_fused(x, y, z, q_first=False))
    zero = (mv_x == 0) & (mv_y == 0)
    return (torch.where(zero, grid_x, out_x), torch.where(zero, grid_y, out_y))


def t3d_mv_for_shift(proj, px, py, sx, sy, cx, cy):
    c3 = proj.to_sphere(cx, cy)
    p3 = proj.to_sphere(px, py)
    s3 = proj.to_sphere(sx, sy)
    moved = tuple(s - p + c for s, p, c in zip(s3, p3, c3))
    mx, my = proj.from_sphere(*moved)
    return mx - cx, my - cy


# ---------------------------------------------------------------------------
# Tangential (TAN) — reference: TangentialMotionModel.cpp
# ---------------------------------------------------------------------------
def _tan_to_plane(proj, x, y, eps_c, alpha_c):
    """Gnomonic projection onto the tangent plane at the block center
    (elevation eps = pi/2 - theta, azimuth alpha = phi)."""
    gx, gy, gz = proj.to_sphere(x, y)
    _, theta, phi = cartesian_to_spherical(gx, gy, gz)
    eps = PI / 2 - theta
    d_alpha = phi - alpha_c
    cos_psi = (lm.sin(eps_c) * lm.sin(eps)
               + lm.cos(eps_c) * lm.cos(eps) * lm.cos(d_alpha))
    plane_y = (lm.sin(eps) * lm.cos(eps_c)
               - lm.sin(eps_c) * lm.cos(eps) * lm.cos(d_alpha)) \
        / cos_psi
    plane_x = (lm.sin(d_alpha) * lm.cos(eps)) / cos_psi
    return plane_x, plane_y


def _center_angles(proj, cx, cy):
    c3 = proj.to_sphere(cx, cy)
    _, theta_c, phi_c = cartesian_to_spherical(*c3)
    return PI / 2 - theta_c, phi_c


def tan_motion(proj, angle_res: float, grid_x, grid_y, mv_x, mv_y, cx, cy,
               form: str | None = None, grid_sphere=None):
    """Move on the block center's tangent plane by -mv * angle_res, then
    the inverse gnomonic projection (reference:
    TangentialMotionModel.cpp:35-44).  A grid point at the tangent point
    with a zero plane move gives rho = 0 and 0/0 = NaN, and an arcsin
    argument that rounds past 1 gives NaN: both are "no motion" for the
    caller, as in the JAX package.  form "merged": the form of the JAX
    codec's merged positions (_tan_motion_fused, with grid_sphere as
    t3d_motion's); "search" and None: op by op."""
    if form == "merged":
        return _tan_motion_fused(proj, angle_res, grid_sphere, grid_x,
                                 grid_y, mv_x, mv_y, cx, cy)
    eps_c, alpha_c = _center_angles(proj, cx, cy)
    plane_x, plane_y = _tan_to_plane(proj, grid_x, grid_y, eps_c, alpha_c)
    pxm = plane_x - mv_x * angle_res
    pym = plane_y - mv_y * angle_res
    rho = lm.sqrt(pxm * pxm + pym * pym)
    eta = lm.atan(rho)
    gamma = (rho * lm.cos(eps_c) * lm.cos(eta)
             - pym * lm.sin(eps_c) * lm.sin(eta))
    alpha_m = alpha_c + lm.atan((pxm * lm.sin(eta)) / gamma)
    eps_m = lm.asin(lm.cos(eta) * lm.sin(eps_c)
                         + (pym * lm.sin(eta) * lm.cos(eps_c)) / rho)
    c = spherical_to_cartesian(1.0, PI / 2 - eps_m, alpha_m)
    out_x, out_y = proj.from_sphere(*c)
    zero = (mv_x == 0) & (mv_y == 0)
    return (torch.where(zero, grid_x, out_x), torch.where(zero, grid_y, out_y))


def _tan_motion_fused(proj, angle_res: float, grid_sphere, grid_x, grid_y,
                      mv_x, mv_y, cx, cy):
    """tan_motion in the form XLA compiles for the JAX codec's merged
    positions: the grid's sphere points folded, its angles and their
    sines op by op (true divisions; on an Equisolid XLA's fold of z/r,
    z * (1/sqrt(r^2)) with the reciprocal rounded), the block centers'
    angles as ROT's;
    then each a*b +- c*d one FMA, the sums of squares FMAs (on an
    Equisolid the projection's own centre angles and squared norm)."""
    fma = lm.fma32
    equisolid = isinstance(proj, Equisolid)
    if equisolid:
        gx, gy, gz = grid_sphere
        rr = 1.0 / lm.sqrt(gx * gx + gy * gy + gz * gz)
        theta = lm.acos(torch.clamp(gz * rr, -1.0, 1.0))
        phi = lm.atan2(gy, gx)
    else:
        _, theta, phi = cartesian_to_spherical(*grid_sphere)
    eps = PI / 2 - theta
    sin_e, cos_e = lm.sin(eps), lm.cos(eps)
    theta_c, alpha_c = (proj.center_spherical_fused(cx, cy) if equisolid
                        else _center_spherical_fused(proj, cx, cy, False))
    eps_c = PI / 2 - theta_c
    sin_c, cos_c = lm.sin(eps_c), lm.cos(eps_c)
    d_alpha = phi - alpha_c
    cos_da, sin_da = lm.cos(d_alpha), lm.sin(d_alpha)
    cos_psi = fma(sin_c, sin_e, (cos_c * cos_e) * cos_da)
    plane_y = fma(cos_c, sin_e, -((sin_c * cos_e) * cos_da)) / cos_psi
    plane_x = (sin_da * cos_e) / cos_psi
    pxm = plane_x - mv_x * angle_res
    pym = plane_y - mv_y * angle_res
    rho = lm.sqrt(fma(pxm, pxm, pym * pym))
    eta = lm.atan(rho)
    sin_eta, cos_eta = lm.sin(eta), lm.cos(eta)
    gamma = fma(rho * cos_c, cos_eta, -((pym * sin_c) * sin_eta))
    alpha_m = alpha_c + lm.atan((pxm * sin_eta) / gamma)
    eps_m = lm.asin(fma(sin_c, cos_eta, (cos_c * (pym * sin_eta)) / rho))
    theta_m = PI / 2 - eps_m
    st, ct = lm.sin(theta_m), lm.cos(theta_m)
    x, y = lm.cos(alpha_m) * st, lm.sin(alpha_m) * st
    ss = (proj.sphere_ss_fused(x, y, ct, q_first=True) if equisolid
          else fma(ct, ct, fma(x, x, y * y)))
    out_x, out_y = proj.from_sphere_fused(x, y, ct, ss)
    zero = (mv_x == 0) & (mv_y == 0)
    return (torch.where(zero, grid_x, out_x), torch.where(zero, grid_y, out_y))


def tan_mv_for_shift(proj, angle_res: float, px, py, sx, sy, cx, cy):
    eps_c, alpha_c = _center_angles(proj, cx, cy)
    ox, oy = _tan_to_plane(proj, px, py, eps_c, alpha_c)
    mx, my = _tan_to_plane(proj, sx, sy, eps_c, alpha_c)
    return div(ox - mx, angle_res), div(oy - my, angle_res)


# ---------------------------------------------------------------------------
# Rotational (ROT) — reference: RotationalMotionModel.cpp
# ---------------------------------------------------------------------------
def _rot_z(a, x, y, z):
    ca, sa = lm.cos(a), lm.sin(a)
    return x * ca - y * sa, x * sa + y * ca, z


def _rot_y(a, x, y, z):
    ca, sa = lm.cos(a), lm.sin(a)
    return x * ca + z * sa, y, -x * sa + z * ca


def _center_spherical_fused(proj, cx, cy, search: bool):
    """(theta_c, phi_c) of block centers as the JAX codec's jits compute
    them, from float32 sphere points.  Merged positions:
    r^2 = (ct*ct) + fma(st*cp, st*cp, (st*sp)^2), the first square hoisted
    out of the vectorized loop and so rounded on its own; the merge
    search: r^2 = fma(ct, ct, fma(st*cp, st*cp, (st*sp)^2))."""
    x, y, ct = proj.to_sphere(cx, cy)
    if search:
        ss = lm.fma32(ct, ct, lm.fma32(x, x, y * y))
    else:
        ss = ct * ct + lm.fma32(x, x, y * y)
    theta_c = lm.acos(torch.clamp(ct * lm.rsqrt_xla(ss), -1.0, 1.0))
    return theta_c, lm.atan2(y, x)


def _rot_motion_fused(proj, angle_res: float, grid_sphere, grid_x, grid_y,
                      mv_x, mv_y, cx, cy, search: bool):
    """rot_motion in the forms XLA compiles for the JAX codec: each rotated
    coordinate a*b +- c*d is one FMA, fma(a, b, +-(c*d)), with the operands
    in the compiled code's order.  In the merged positions (one fusion a
    coordinate) the grid's sphere points are constants folded in double
    (grid_sphere);
    in the merge search (search=True) they are float32 values, the chain
    is split over several fusions, and three FMAs take the other product:
    x2, z5, and the y4 that feeds phi."""
    fma = lm.fma32
    equisolid = isinstance(proj, Equisolid)
    if equisolid:
        theta_c, phi_c = proj.center_spherical_fused(cx, cy)
    else:
        theta_c, phi_c = _center_spherical_fused(proj, cx, cy, search)
    px, py, pz = proj.to_sphere(grid_x, grid_y) if search else grid_sphere
    cf, sf = lm.cos(phi_c), lm.sin(phi_c)
    beta = PI / 2 - theta_c
    cb, sb = lm.cos(beta), lm.sin(beta)
    x1 = fma(cf, px, sf * py)                           # U p
    y1 = fma(cf, py, -(sf * px))
    x2 = fma(pz, sb, cb * x1) if search else fma(x1, cb, pz * sb)
    z2 = fma(pz, cb, -(x1 * sb))
    a = mv_y * angle_res                                # R q
    ca, sa = lm.cos(a), lm.sin(a)
    x3 = fma(x2, ca, z2 * sa)
    z3 = fma(z2, ca, -(x2 * sa))
    b = -mv_x * angle_res
    cm, sm = lm.cos(b), lm.sin(b)
    x4 = fma(cm, x3, -(y1 * sm))
    y4 = fma(y1, cm, sm * x3)
    y4_phi = fma(x3, sm, y1 * cm) if search else y4
    x5 = fma(cb, x4, -(sb * z3))                        # U^T r
    z5 = fma(x4, sb, z3 * cb) if search else fma(cb, z3, sb * x4)
    x6 = fma(cf, x5, -(sf * y4))
    y6 = fma(cf, y4, sf * x5)
    if equisolid:
        out_x, out_y = proj.from_sphere_fused(
            x6, y6, z5, proj.sphere_ss_fused(x6, y6, z5, q_first=True))
        zero = (mv_x == 0) & (mv_y == 0)
        return (torch.where(zero, grid_x, out_x),
                torch.where(zero, grid_y, out_y))
    ss = fma(z5, z5, fma(x6, x6, y6 * y6))
    if search:
        x6 = fma(cf, x5, -(sf * y4_phi))
        y6 = fma(cf, y4_phi, sf * x5)
    out_x, out_y = proj.from_sphere_fused(x6, y6, z5, ss)
    zero = (mv_x == 0) & (mv_y == 0)
    return (torch.where(zero, grid_x, out_x), torch.where(zero, grid_y, out_y))


def rot_motion(proj, angle_res: float, grid_x, grid_y, mv_x, mv_y, cx, cy,
               form: str | None = None, grid_sphere=None):
    """Sphere rotation Rz(-mvx*res)*Ry(mvy*res) conjugated by the block-
    center alignment rotation U = Ry(pi/2 - theta_c) * Rz(-phi_c)
    (reference: RotationalMotionModel.cpp:44-57), applied elementwise; op
    by op, or in the form the JAX codec's jit compiles (form "merged",
    with grid_sphere as t3d_motion's, or "search", as
    reprojection.reproject_frame's `form`)."""
    if form is not None:
        return _rot_motion_fused(proj, angle_res, grid_sphere, grid_x,
                                 grid_y, mv_x, mv_y, cx, cy,
                                 form == "search")
    c3 = proj.to_sphere(cx, cy)
    _, theta_c, phi_c = cartesian_to_spherical(*c3)
    beta = PI / 2 - theta_c
    p = proj.to_sphere(grid_x, grid_y)
    q = _rot_y(beta, *_rot_z(-phi_c, *p))               # U p
    r = _rot_z(-mv_x * angle_res, *_rot_y(mv_y * angle_res, *q))  # R q
    o = _rot_z(phi_c, *_rot_y(-beta, *r))               # U^T r
    out_x, out_y = proj.from_sphere(*o)
    zero = (mv_x == 0) & (mv_y == 0)
    return (torch.where(zero, grid_x, out_x), torch.where(zero, grid_y, out_y))


def rot_mv_for_shift(proj, angle_res: float, px, py, sx, sy, cx, cy):
    """Estimated equivalent rotation MV (the reference notes that the exact
    inverse needs nonlinear optimization; this is its estimate)."""
    c3 = proj.to_sphere(cx, cy)
    _, theta_c, phi_c = cartesian_to_spherical(*c3)
    beta = PI / 2 - theta_c
    p_al = _rot_y(beta, *_rot_z(-phi_c, *proj.to_sphere(px, py)))
    s_al = _rot_y(beta, *_rot_z(-phi_c, *proj.to_sphere(sx, sy)))
    _, th_p, ph_p = cartesian_to_spherical(*p_al)
    _, th_s, ph_s = cartesian_to_spherical(*s_al)
    return (div(_wrap_angle(ph_p - ph_s), angle_res),
            div(th_s - th_p, angle_res))


# ---------------------------------------------------------------------------
# Geodesic (GED / GEDA) — reference: GeodesicMotionModel.cpp
# ---------------------------------------------------------------------------
VISHWANATH_ORIGINAL = 0
VISHWANATH_MODULATED = 1


def ged_rotation_matrix(epipole: np.ndarray) -> np.ndarray:
    """3x3 matrix rotating the epipole onto the north pole (0,0,1)
    (reference: setEpipole — Rodrigues aligning z to epipole, transposed).
    Host-side numpy float64, rounded to float32 once: epipoles are
    per-frame scalars."""
    p = np.asarray(epipole, dtype=np.float64)
    p = p / np.sqrt((p * p).sum())
    cross = np.array([-p[1], p[0], 0.0])
    s = np.sqrt((cross * cross).sum())
    if s == 0:
        r = np.eye(3)
        if p[2] < 0:
            r[2, 2] = -1
        return r.astype(np.float32)
    c = np.clip(p[2], -1.0, 1.0)
    k = np.array([[0, -cross[2], cross[1]],
                  [cross[2], 0, -cross[0]],
                  [-cross[1], cross[0], 0]])
    r = np.eye(3) + k + k @ k * ((1 - c) / (s * s))
    return r.T.astype(np.float32)


def _mat_apply(m, x, y, z):
    return (m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
            m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
            m[2, 0] * x + m[2, 1] * y + m[2, 2] * z)


def _row_fused(a: float, b: float, x, y):
    """a*x + b*y as XLA compiles it: one FMA with the first product fused,
    but a negative first coefficient turns the add into a subtraction of
    that product, and the other product is fused."""
    if a >= 0:
        return lm.fma32(x, a, y * b)
    return lm.fma32(y, b, x * a)


def _pair_fused(a: float, b: float, x, y):
    """a*x + b*y as XLA compiles it on an Equisolid: one FMA with the
    first product fused, but a negative a alone (b >= 0) moves y's
    product first."""
    if b < 0 or a >= 0:
        return lm.fma32(x, a, y * b)
    return lm.fma32(y, b, x * a)


def _ged_motion_equisolid(proj, angle_res: float, m, grid_sphere, grid_x,
                          grid_y, mv_x, mv_y, cx, cy):
    """_ged_motion_fused on an Equisolid: the grid's points, rotation,
    angles and their sines op by op (as to_sphere); the block centres'
    angles as sphere_angles_fused, their rotation rows
    fma(Z, m2, _pair_fused(-m0, m1, cos theta, Y)) on the sphere point
    (-cos theta, Y, Z) and r^2 = fma(z, z, fma(x, x, y*y)); the rotation
    back fma(cz, m2i, _pair_fused(m0i, m1i, cx, cy)) a coordinate, r^2
    as from_sphere_fused's; phi's fusion adds a*mvy to phi on its own,
    the other fuses it (an FMA)."""
    gx, gy, gz = grid_sphere
    r, theta, phi = cartesian_to_spherical(
        *(m[i][0] * gx + m[i][1] * gy + m[i][2] * gz for i in range(3)))
    sin_t, cos_t = lm.sin(theta), lm.cos(theta)
    th_c, ph_c = proj.sphere_angles_fused(cx, cy, False)
    st_c, ct_c = lm.sin(th_c), lm.cos(th_c)
    y_c, z_c = lm.cos(ph_c) * st_c, st_c * -lm.sin(ph_c)
    crx, cry, crz = (lm.fma32(z_c, m[i][2],
                              _pair_fused(-m[i][0], m[i][1], ct_c, y_c))
                     for i in range(3))
    ss_c = lm.fma32(crz, crz, lm.fma32(crx, crx, cry * cry))
    theta_c = lm.acos(torch.clamp(crz * lm.rsqrt_xla(ss_c), -1.0, 1.0))
    a = mv_x * angle_res
    k = lm.sin(theta_c + a) / lm.sin(a)
    theta_m = theta + lm.atan(sin_t / (k + (-cos_t)))
    rst, cz = r * lm.sin(theta_m), r * lm.cos(theta_m)

    def back(phi_m):
        cx3, cy3 = rst * lm.cos(phi_m), rst * lm.sin(phi_m)
        return [lm.fma32(cz, m[2][i], _pair_fused(m[0][i], m[1][i], cx3,
                                                  cy3)) for i in range(3)]
    ox, oy, oz = back(lm.fma32(mv_y, angle_res, phi))
    phi_yz = back(phi + mv_y * angle_res)[1:]
    out_x, out_y = proj.from_sphere_fused(
        ox, oy, oz, proj.sphere_ss_fused(ox, oy, oz, q_first=False), phi_yz)
    zero = (mv_x == 0) & (mv_y == 0)
    return (torch.where(zero, grid_x, out_x), torch.where(zero, grid_y, out_y))


def _ged_motion_fused(proj, angle_res: float, rot_mat, grid_sphere, grid_x,
                      grid_y, mv_x, mv_y, cx, cy):
    """ged_motion's modulated flavour in the form XLA compiles for the JAX
    codec's merged positions: the grid's sphere points folded in double,
    its rotation, angles and their sines op by op; the block centers'
    rotation a folded column term plus one FMA (_row_fused), r^2 FMAs;
    the rotation back one FMA a term; phi's fusion adds a*mvy to phi on
    its own, the other fuses it (an FMA).  rot_mat is a host array: its
    entries enter as float32 scalars."""
    m = [[float(v) for v in row] for row in np.asarray(rot_mat, np.float32)]
    if isinstance(proj, Equisolid):
        return _ged_motion_equisolid(proj, angle_res, m, grid_sphere, grid_x,
                                     grid_y, mv_x, mv_y, cx, cy)
    gx, gy, gz = grid_sphere
    r, theta, phi = cartesian_to_spherical(
        *(m[i][0] * gx + m[i][1] * gy + m[i][2] * gz for i in range(3)))
    sin_t, cos_t = lm.sin(theta), lm.cos(theta)
    th_c = div(cy + proj.pixel_offset, proj.height) * PI
    ph_c = -div(cx + proj.pixel_offset, proj.width) * 2.0 * PI
    st_c, ct_c = lm.sin(th_c), lm.cos(th_c)
    x, y = st_c * lm.cos(ph_c), st_c * lm.sin(ph_c)
    crx, cry, crz = (ct_c * m[i][2] + _row_fused(m[i][0], m[i][1], x, y)
                     for i in range(3))
    ss_c = lm.fma32(crz, crz, lm.fma32(crx, crx, cry * cry))
    theta_c = lm.acos(torch.clamp(crz * lm.rsqrt_xla(ss_c), -1.0, 1.0))
    a = mv_x * angle_res
    k = lm.sin(theta_c + a) / lm.sin(a)
    theta_m = theta + lm.atan(sin_t / (k + (-cos_t)))
    rst, cz = r * lm.sin(theta_m), r * lm.cos(theta_m)

    def back(phi_m):
        cx3, cy3 = rst * lm.cos(phi_m), rst * lm.sin(phi_m)
        return [lm.fma32(cz, m[2][i], _row_fused(m[0][i], m[1][i], cx3, cy3))
                for i in range(3)]
    ox, oy, oz = back(lm.fma32(mv_y, angle_res, phi))
    phi_xy = back(phi + mv_y * angle_res)[:2]
    out_x, out_y = proj.from_sphere_fused(
        ox, oy, oz, lm.fma32(oz, oz, lm.fma32(ox, ox, oy * oy)), phi_xy)
    zero = (mv_x == 0) & (mv_y == 0)
    return (torch.where(zero, grid_x, out_x), torch.where(zero, grid_y, out_y))


def ged_motion(proj, angle_res: float, rot_mat, flavor: int,
               grid_x, grid_y, mv_x, mv_y, cx, cy, form: str | None = None,
               grid_sphere=None):
    """rot_mat: (3,3) float32 epipole-alignment matrix from
    ged_rotation_matrix.  The modulated flavour keeps the JAX package's
    order, k = sin(theta_c + a*mvx) / sin(a*mvx) and then
    atan(sin(theta) / (k - cos(theta))): a zero mvx with a non-zero mvy
    gives an infinite k or a NaN there as here, and the caller's NaN -> no
    motion rule is the reference's.  form "merged": the modulated flavour
    in the form of the JAX codec's merged positions (a host rot_mat,
    grid_sphere as t3d_motion's); "search" and None: op by op."""
    if form == "merged" and flavor != VISHWANATH_ORIGINAL:
        return _ged_motion_fused(proj, angle_res, rot_mat, grid_sphere,
                                 grid_x, grid_y, mv_x, mv_y, cx, cy)
    m = torch.as_tensor(rot_mat, dtype=torch.float32, device=grid_x.device)
    g3 = proj.to_sphere(grid_x, grid_y)
    rx, ry, rz = _mat_apply(m, *g3)
    r, theta, phi = cartesian_to_spherical(rx, ry, rz)
    if flavor == VISHWANATH_ORIGINAL:
        theta_moved = theta + angle_res * mv_x
    else:
        c3 = proj.to_sphere(cx, cy)
        crx, cry, crz = _mat_apply(m, *c3)
        _, theta_c, _ = cartesian_to_spherical(crx, cry, crz)
        k = (lm.sin(theta_c + angle_res * mv_x)
             / lm.sin(angle_res * mv_x))
        d_theta = lm.atan(lm.sin(theta) / (k - lm.cos(theta)))
        theta_moved = theta + d_theta
    phi_moved = phi + angle_res * mv_y
    c = spherical_to_cartesian(r, theta_moved, phi_moved)
    ox, oy, oz = _mat_apply(m.T, *c)
    out_x, out_y = proj.from_sphere(ox, oy, oz)
    zero = (mv_x == 0) & (mv_y == 0)
    return (torch.where(zero, grid_x, out_x), torch.where(zero, grid_y, out_y))


def _wrap_angle(a):
    """Wrap an angle difference into [-pi, pi) (floor modulo, as
    jnp.mod)."""
    return torch.remainder(a + PI, 2 * PI) - PI


def ged_mv_for_shift(proj, angle_res: float, rot_mat, flavor: int,
                     px, py, sx, sy, cx, cy):
    m = torch.as_tensor(rot_mat, dtype=torch.float32, device=px.device)
    _, th_p, ph_p = cartesian_to_spherical(
        *_mat_apply(m, *proj.to_sphere(px, py)))
    _, th_s, ph_s = cartesian_to_spherical(
        *_mat_apply(m, *proj.to_sphere(sx, sy)))
    mv_y = div(_wrap_angle(ph_s - ph_p), angle_res)
    if flavor == VISHWANATH_ORIGINAL:
        return div(th_s - th_p, angle_res), mv_y
    _, th_c, _ = cartesian_to_spherical(
        *_mat_apply(m, *proj.to_sphere(cx, cy)))
    d_theta = th_s - th_p
    k = lm.sin(d_theta + th_p) / lm.sin(d_theta)
    d_theta_c = lm.atan(lm.sin(th_c) / (k - lm.cos(th_c)))
    return div(d_theta_c, angle_res), mv_y


GEDA_EPIPOLES = {
    M.GEODESIC_AXIS_X: np.array([1.0, 0.0, 0.0]),
    M.GEODESIC_AXIS_Y: np.array([0.0, 1.0, 0.0]),
    M.GEODESIC_AXIS_Z: np.array([0.0, 0.0, 1.0]),
}
