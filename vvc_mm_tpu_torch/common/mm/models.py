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

from ...lib360.projection import (Perspective, cartesian_to_spherical,
                                  spherical_to_cartesian, PI)
from ..typedefs import MotionModelID as M


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


def mpa_motion(proj, plane: int, grid_x, grid_y, mv_x, mv_y, cx=None, cy=None,
               pers_cache=None):
    """pers_cache: optional precomputed (px, py, vip) for the grid."""
    if pers_cache is None:
        px, py, vip = mpa_to_perspective(proj, plane, grid_x, grid_y)
    else:
        px, py, vip = pers_cache
    sign = torch.where(vip, -1.0, 1.0).to(px.dtype)
    return mpa_from_perspective(proj, plane, px + mv_x * sign,
                                py + mv_y * sign, vip)


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
def t3d_motion(proj, grid_x, grid_y, mv_x, mv_y, cx, cy):
    """The block center's displacement on the sphere, (center + mv) minus
    center in 3-D, added to every grid point and projected back."""
    c3x, c3y, c3z = proj.to_sphere(cx, cy)
    m3x, m3y, m3z = proj.to_sphere(cx + mv_x, cy + mv_y)
    gx, gy, gz = proj.to_sphere(grid_x, grid_y)
    out_x, out_y = proj.from_sphere(gx + (m3x - c3x), gy + (m3y - c3y),
                                    gz + (m3z - c3z))
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
    cos_psi = (torch.sin(eps_c) * torch.sin(eps)
               + torch.cos(eps_c) * torch.cos(eps) * torch.cos(d_alpha))
    plane_y = (torch.sin(eps) * torch.cos(eps_c)
               - torch.sin(eps_c) * torch.cos(eps) * torch.cos(d_alpha)) \
        / cos_psi
    plane_x = (torch.sin(d_alpha) * torch.cos(eps)) / cos_psi
    return plane_x, plane_y


def _center_angles(proj, cx, cy):
    c3 = proj.to_sphere(cx, cy)
    _, theta_c, phi_c = cartesian_to_spherical(*c3)
    return PI / 2 - theta_c, phi_c


def tan_motion(proj, angle_res: float, grid_x, grid_y, mv_x, mv_y, cx, cy):
    """Move on the block center's tangent plane by -mv * angle_res, then
    the inverse gnomonic projection (reference:
    TangentialMotionModel.cpp:35-44).  A grid point at the tangent point
    with a zero plane move gives rho = 0 and 0/0 = NaN, and an arcsin
    argument that rounds past 1 gives NaN: both are "no motion" for the
    caller, as in the JAX package."""
    eps_c, alpha_c = _center_angles(proj, cx, cy)
    plane_x, plane_y = _tan_to_plane(proj, grid_x, grid_y, eps_c, alpha_c)
    pxm = plane_x - mv_x * angle_res
    pym = plane_y - mv_y * angle_res
    rho = torch.sqrt(pxm * pxm + pym * pym)
    eta = torch.arctan(rho)
    gamma = (rho * torch.cos(eps_c) * torch.cos(eta)
             - pym * torch.sin(eps_c) * torch.sin(eta))
    alpha_m = alpha_c + torch.arctan((pxm * torch.sin(eta)) / gamma)
    eps_m = torch.arcsin(torch.cos(eta) * torch.sin(eps_c)
                         + (pym * torch.sin(eta) * torch.cos(eps_c)) / rho)
    c = spherical_to_cartesian(1.0, PI / 2 - eps_m, alpha_m)
    out_x, out_y = proj.from_sphere(*c)
    zero = (mv_x == 0) & (mv_y == 0)
    return (torch.where(zero, grid_x, out_x), torch.where(zero, grid_y, out_y))


def tan_mv_for_shift(proj, angle_res: float, px, py, sx, sy, cx, cy):
    eps_c, alpha_c = _center_angles(proj, cx, cy)
    ox, oy = _tan_to_plane(proj, px, py, eps_c, alpha_c)
    mx, my = _tan_to_plane(proj, sx, sy, eps_c, alpha_c)
    return (ox - mx) / angle_res, (oy - my) / angle_res


# ---------------------------------------------------------------------------
# Rotational (ROT) — reference: RotationalMotionModel.cpp
# ---------------------------------------------------------------------------
def _rot_z(a, x, y, z):
    ca, sa = torch.cos(a), torch.sin(a)
    return x * ca - y * sa, x * sa + y * ca, z


def _rot_y(a, x, y, z):
    ca, sa = torch.cos(a), torch.sin(a)
    return x * ca + z * sa, y, -x * sa + z * ca


def rot_motion(proj, angle_res: float, grid_x, grid_y, mv_x, mv_y, cx, cy):
    """Sphere rotation Rz(-mvx*res)*Ry(mvy*res) conjugated by the block-
    center alignment rotation U = Ry(pi/2 - theta_c) * Rz(-phi_c)
    (reference: RotationalMotionModel.cpp:44-57), applied elementwise."""
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
    return _wrap_angle(ph_p - ph_s) / angle_res, (th_s - th_p) / angle_res


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


def ged_motion(proj, angle_res: float, rot_mat, flavor: int,
               grid_x, grid_y, mv_x, mv_y, cx, cy):
    """rot_mat: (3,3) float32 epipole-alignment matrix from
    ged_rotation_matrix.  The modulated flavour keeps the JAX package's
    order, k = sin(theta_c + a*mvx) / sin(a*mvx) and then
    atan(sin(theta) / (k - cos(theta))): a zero mvx with a non-zero mvy
    gives an infinite k or a NaN there as here, and the caller's NaN -> no
    motion rule is the reference's."""
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
        k = (torch.sin(theta_c + angle_res * mv_x)
             / torch.sin(angle_res * mv_x))
        d_theta = torch.arctan(torch.sin(theta) / (k - torch.cos(theta)))
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
    mv_y = _wrap_angle(ph_s - ph_p) / angle_res
    if flavor == VISHWANATH_ORIGINAL:
        return (th_s - th_p) / angle_res, mv_y
    _, th_c, _ = cartesian_to_spherical(
        *_mat_apply(m, *proj.to_sphere(cx, cy)))
    d_theta = th_s - th_p
    k = torch.sin(d_theta + th_p) / torch.sin(d_theta)
    d_theta_c = torch.arctan(torch.sin(th_c) / (k - torch.cos(th_c)))
    return d_theta_c / angle_res, mv_y


GEDA_EPIPOLES = {
    M.GEODESIC_AXIS_X: np.array([1.0, 0.0, 0.0]),
    M.GEODESIC_AXIS_Y: np.array([0.0, 1.0, 0.0]),
    M.GEODESIC_AXIS_Z: np.array([0.0, 0.0, 1.0]),
}
