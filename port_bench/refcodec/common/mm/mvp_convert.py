"""MM-MVP candidate conversion — host-side scalar engine.

Copied from `vvc_mm_tpu/common/mm/mvp_convert.py` (host float64; reference:
MVReprojection::motionVectorInDesiredMotionModel,
source/Lib/CommonLib/MVReprojection.cpp:168 — forward-map the candidate MV
at the current position under the candidate's model, then closed-form
inverse under the desired model; zero-MV passthrough and NaN -> zero
guards; gated by sps_mmmvp_enabled_flag, VLCReader.cpp:1983).

It runs inside the sequential entropy loop (MVP feeds MV reconstruction),
in Python floats and numpy float64 exactly as the JAX package runs it, so
a converted MV is the same integer in both packages and in the port's
encoder and decoder.
"""
from __future__ import annotations

import math

import numpy as np

from ..typedefs import MotionModelID as M
from .models import GEDA_EPIPOLES, ged_rotation_matrix

PI = math.pi


def _wrap(a: float) -> float:
    """Wrap an angle difference into [-pi, pi)."""
    return (a + PI) % (2 * PI) - PI


# ---- scalar sphere math (mirrors lib360.projection, numpy floats) --------
def _cart_to_sph(x, y, z):
    r = math.sqrt(x * x + y * y + z * z)
    theta = math.acos(max(-1.0, min(1.0, z / r)))
    phi = math.atan2(y, x)
    return r, theta, phi


def _sph_to_cart(r, theta, phi):
    st = math.sin(theta)
    return r * st * math.cos(phi), r * st * math.sin(phi), r * math.cos(theta)


class _ERP:
    def __init__(self, width: int, height: int):
        self.w, self.h = width, height
        self.focal = 1.0 / math.tan(PI / height)

    def to_sphere(self, x, y):
        phi = -(x / self.w) * 2 * PI
        theta = (y / self.h) * PI
        return _sph_to_cart(1.0, theta, phi)

    def from_sphere(self, cx, cy, cz):
        _, theta, phi = _cart_to_sph(cx, cy, cz)
        if phi > 0:
            phi -= 2 * PI
        return (-(phi / (2 * PI)) * self.w, (theta / PI) * self.h)


def _persp_from_sphere(focal, cx3, cy3, cz3):
    _, theta, phi = _cart_to_sph(cy3, -cz3, -cx3)
    r = focal * math.tan(theta)
    return r * math.cos(phi), r * math.sin(phi), r < 0


def _persp_to_sphere(focal, x, y, vip):
    r = math.sqrt(x * x + y * y)
    phi = math.atan2(y, x)
    theta = math.atan(r / focal)
    if vip:
        theta = PI - theta
        phi = phi - PI
    xsr, ysr, zsr = _sph_to_cart(1.0, theta, phi)
    return -zsr, xsr, -ysr


_MPA_TO = {M.MPA_FRONT_BACK: lambda x, y, z: (x, y, z),
           M.MPA_LEFT_RIGHT: lambda x, y, z: (y, -x, z),
           M.MPA_TOP_BOTTOM: lambda x, y, z: (-z, y, x)}
_MPA_FROM = {M.MPA_FRONT_BACK: lambda x, y, z: (x, y, z),
             M.MPA_LEFT_RIGHT: lambda x, y, z: (-y, x, z),
             M.MPA_TOP_BOTTOM: lambda x, y, z: (z, y, -x)}


class MMVPConverter:
    """Scalar model-to-model MV conversion (per SPS geometry)."""

    def __init__(self, width: int, height: int, ged_flavor: int = 1):
        self.proj = _ERP(width, height)
        self.angle_res = PI / height
        self.flavor = ged_flavor
        self._rots: dict[tuple, np.ndarray] = {}

    # -- per-model forward map (point + mv -> moved point) ----------------
    def _ged_rot(self, epipole) -> np.ndarray:
        key = tuple(np.round(np.asarray(epipole, dtype=np.float64), 9))
        if key not in self._rots:
            self._rots[key] = ged_rotation_matrix(epipole).astype(np.float64)
        return self._rots[key]

    def model_point(self, model, px, py, mvx, mvy, cx, cy, epipole):
        p = self.proj
        if model == M.CLASSIC:
            return px + mvx, py + mvy
        if model in _MPA_TO:
            sx, sy, sz = p.to_sphere(px, py)
            mx, my, mz = _MPA_TO[M(model)](sx, sy, sz)
            ppx, ppy, vip = _persp_from_sphere(p.focal, mx, my, mz)
            sgn = -1.0 if vip else 1.0
            bx, by, bz = _persp_to_sphere(p.focal, ppx + mvx * sgn,
                                          ppy + mvy * sgn, vip)
            ox, oy, oz = _MPA_FROM[M(model)](bx, by, bz)
            return p.from_sphere(ox, oy, oz)
        if model == M.THREE_D_TRANSLATIONAL:
            c3 = p.to_sphere(cx, cy)
            m3 = p.to_sphere(cx + mvx, cy + mvy)
            g3 = p.to_sphere(px, py)
            return p.from_sphere(g3[0] + m3[0] - c3[0],
                                 g3[1] + m3[1] - c3[1],
                                 g3[2] + m3[2] - c3[2])
        if model == M.TANGENTIAL:
            _, th_c, ph_c = _cart_to_sph(*p.to_sphere(cx, cy))
            eps_c, al_c = PI / 2 - th_c, ph_c
            _, th, ph = _cart_to_sph(*p.to_sphere(px, py))
            eps = PI / 2 - th
            da = ph - al_c
            cp = (math.sin(eps_c) * math.sin(eps)
                  + math.cos(eps_c) * math.cos(eps) * math.cos(da))
            ypl = (math.sin(eps) * math.cos(eps_c)
                   - math.sin(eps_c) * math.cos(eps) * math.cos(da)) / cp
            xpl = (math.sin(da) * math.cos(eps)) / cp
            xm = xpl - mvx * self.angle_res
            ym = ypl - mvy * self.angle_res
            rho = math.sqrt(xm * xm + ym * ym)
            if rho == 0:
                return px, py
            eta = math.atan(rho)
            gam = (rho * math.cos(eps_c) * math.cos(eta)
                   - ym * math.sin(eps_c) * math.sin(eta))
            al_m = al_c + math.atan((xm * math.sin(eta)) / gam)
            eps_m = math.asin(math.cos(eta) * math.sin(eps_c)
                              + (ym * math.sin(eta) * math.cos(eps_c)) / rho)
            return p.from_sphere(*_sph_to_cart(1.0, PI / 2 - eps_m, al_m))
        if model == M.ROTATIONAL:
            _, th_c, ph_c = _cart_to_sph(*p.to_sphere(cx, cy))
            beta = PI / 2 - th_c
            v = np.asarray(p.to_sphere(px, py))
            q = _roty(beta) @ (_rotz(-ph_c) @ v)
            r = _rotz(-mvx * self.angle_res) @ (
                _roty(mvy * self.angle_res) @ q)
            o = _rotz(ph_c) @ (_roty(-beta) @ r)
            return p.from_sphere(*o)
        # geodesic family
        if model != M.GEODESIC_CAMPOSE:
            epipole = GEDA_EPIPOLES[M(model)]
        rot = self._ged_rot(epipole)
        g = rot @ np.asarray(p.to_sphere(px, py))
        r, theta, phi = _cart_to_sph(*g)
        if self.flavor == 0:
            theta_m = theta + self.angle_res * mvx
        else:
            if mvx == 0:
                theta_m = theta
            else:
                c = rot @ np.asarray(p.to_sphere(cx, cy))
                _, th_c, _ = _cart_to_sph(*c)
                k = (math.sin(th_c + self.angle_res * mvx)
                     / math.sin(self.angle_res * mvx))
                theta_m = theta + math.atan(
                    math.sin(theta) / (k - math.cos(theta)))
        phi_m = phi + self.angle_res * mvy
        o = rot.T @ np.asarray(_sph_to_cart(r, theta_m, phi_m))
        return p.from_sphere(*o)

    # -- per-model inverse (point + shifted point -> mv) -------------------
    def mv_for_shift(self, model, px, py, sx, sy, cx, cy, epipole):
        p = self.proj
        if model == M.CLASSIC:
            return sx - px, sy - py
        if model in _MPA_TO:
            def to_pers(x, y):
                s3 = p.to_sphere(x, y)
                m3 = _MPA_TO[M(model)](*s3)
                return _persp_from_sphere(p.focal, *m3)
            ox, oy, ov = to_pers(px, py)
            mx, my, mv_ = to_pers(sx, sy)
            if ov != mv_:
                return math.nan, math.nan
            sgn = -1.0 if mv_ else 1.0
            return (mx - ox) * sgn, (my - oy) * sgn
        if model == M.THREE_D_TRANSLATIONAL:
            c3 = np.asarray(p.to_sphere(cx, cy))
            p3 = np.asarray(p.to_sphere(px, py))
            s3 = np.asarray(p.to_sphere(sx, sy))
            mx, my = p.from_sphere(*(s3 - p3 + c3))
            return mx - cx, my - cy
        if model == M.TANGENTIAL:
            _, th_c, ph_c = _cart_to_sph(*p.to_sphere(cx, cy))
            eps_c, al_c = PI / 2 - th_c, ph_c

            def to_plane(x, y):
                _, th, ph = _cart_to_sph(*p.to_sphere(x, y))
                eps = PI / 2 - th
                da = ph - al_c
                cp = (math.sin(eps_c) * math.sin(eps)
                      + math.cos(eps_c) * math.cos(eps) * math.cos(da))
                return ((math.sin(da) * math.cos(eps)) / cp,
                        (math.sin(eps) * math.cos(eps_c)
                         - math.sin(eps_c) * math.cos(eps)
                         * math.cos(da)) / cp)
            ox, oy = to_plane(px, py)
            mx, my = to_plane(sx, sy)
            return (ox - mx) / self.angle_res, (oy - my) / self.angle_res
        if model == M.ROTATIONAL:
            _, th_c, ph_c = _cart_to_sph(*p.to_sphere(cx, cy))
            beta = PI / 2 - th_c
            u = lambda v: _roty(beta) @ (_rotz(-ph_c) @ np.asarray(v))
            _, th_p, ph_p = _cart_to_sph(*u(p.to_sphere(px, py)))
            _, th_s, ph_s = _cart_to_sph(*u(p.to_sphere(sx, sy)))
            return (_wrap(ph_p - ph_s) / self.angle_res,
                    (th_s - th_p) / self.angle_res)
        if model != M.GEODESIC_CAMPOSE:
            epipole = GEDA_EPIPOLES[M(model)]
        rot = self._ged_rot(epipole)
        _, th_p, ph_p = _cart_to_sph(*(rot @ np.asarray(p.to_sphere(px, py))))
        _, th_s, ph_s = _cart_to_sph(*(rot @ np.asarray(p.to_sphere(sx, sy))))
        mvy = _wrap(ph_s - ph_p) / self.angle_res
        if self.flavor == 0:
            return (th_s - th_p) / self.angle_res, mvy
        d = th_s - th_p
        if d == 0:
            return 0.0, mvy
        _, th_c, _ = _cart_to_sph(*(rot @ np.asarray(p.to_sphere(cx, cy))))
        k = math.sin(d + th_p) / math.sin(d)
        return (math.atan(math.sin(th_c) / (k - math.cos(th_c)))
                / self.angle_res, mvy)

    def convert(self, pos_xy, mv_16th, model_from: int, model_to: int,
                cand_center, cur_center, epipole_from=None,
                epipole_to=None) -> np.ndarray:
        """Convert a 1/16-pel MV between models at `pos` (reference:
        motionVectorInDesiredMotionModel flow incl. guards)."""
        mvx, mvy = float(mv_16th[0]) / 16.0, float(mv_16th[1]) / 16.0
        if mvx == 0 and mvy == 0:
            return np.zeros(2, dtype=np.int64)
        if model_from == model_to:
            return np.asarray(mv_16th, dtype=np.int64)
        try:
            sx, sy = self.model_point(model_from, float(pos_xy[0]),
                                      float(pos_xy[1]), mvx, mvy,
                                      float(cand_center[0]),
                                      float(cand_center[1]), epipole_from)
            ox, oy = self.mv_for_shift(model_to, float(pos_xy[0]),
                                       float(pos_xy[1]), sx, sy,
                                       float(cur_center[0]),
                                       float(cur_center[1]), epipole_to)
        except (ValueError, ZeroDivisionError):
            return np.zeros(2, dtype=np.int64)
        if math.isnan(ox) or math.isnan(oy) or math.isinf(ox) \
                or math.isinf(oy):
            return np.zeros(2, dtype=np.int64)
        # clamp to the codec MV range (reference: MV_MAX clipping in
        # Mv.h) — near-pole conversions can blow up numerically and an
        # unclamped value overflows the int64 MV grid arithmetic
        lim = float(1 << 17)
        ox = min(max(ox * 16.0, -lim), lim)
        oy = min(max(oy * 16.0, -lim), lim)
        return np.asarray([int(round(ox)), int(round(oy))],
                          dtype=np.int64)


def _rotz(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _roty(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.asarray([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
