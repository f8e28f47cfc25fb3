"""360 geometry conversion: ERP, cubemaps, EAC and the other 360Lib
formats, fisheye and viewport resampling.

PyTorch counterpart of `vvc_mm_tpu/lib360/geometry.py` (reference:
source/Lib/Lib360/TGeometry.{cpp,h} — geoConvert resamples any geometry to
any other through the unit sphere with NN/bilinear/Lanczos kernels;
factory TGeometry::create:378; subclasses TEquiRect, TCubeMap,
TEquiAngularCubeMap, TViewPort et al).

Every geometry is a pair of host maps, numpy float64 as in the JAX
package, so the maps are equal to its:
    dirs(width, height) -> unit-sphere direction per output pixel
    coords(dirs, width, height) -> continuous source pixel coords
A conversion computes the (dst -> src) coordinate field once per
(src_geo, dst_geo, size) on the host, then resamples on the device:
`_resample` gathers every tap of the kernel at once (one gather of
(taps, H', W') samples), then sums the weighted taps in float32 as XLA's
compiled form of the JAX package's jit does.

Sphere convention matches lib360.projection (theta from +z,
phi = atan2(y, x); ERP x -> -phi).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..common.libm_f32 import fma32
from ..device import resolve_device

PI = math.pi


# ---------------------------------------------------------------------------
# direction fields
# ---------------------------------------------------------------------------
def erp_dirs(width: int, height: int) -> np.ndarray:
    """(H, W, 3) unit directions of ERP pixel centers."""
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    phi = -(xx + 0.5) / width * 2 * PI
    theta = (yy + 0.5) / height * PI
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)], -1)


def erp_coords(dirs: np.ndarray, width: int, height: int) -> np.ndarray:
    """(..., 3) dirs -> (..., 2) continuous ERP (x, y)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    r = np.sqrt(x * x + y * y + z * z)
    theta = np.arccos(np.clip(z / r, -1, 1))
    phi = np.arctan2(y, x)
    phi = np.where(phi > 0, phi - 2 * PI, phi)
    return np.stack([-phi / (2 * PI) * width - 0.5,
                     theta / PI * height - 0.5], -1)


# Cubemap: 3x2 frame packing, face order per 360Lib CMP default
# (right, front, left on top row; bottom, back, top on bottom row —
# reference: TCubeMap face layout); face size = W/3 = H/2.
_CMP_FACES = {
    # face -> (axis permutation) mapping face-local (u, v) in [-1,1] to dir
    0: lambda u, v: ( np.ones_like(u), -u, -v),       # +x (front)
    1: lambda u, v: (-u, -np.ones_like(u), -v),       # -y (right)
    2: lambda u, v: (-np.ones_like(u),  u, -v),       # -x (back)
    3: lambda u, v: ( u,  np.ones_like(u), -v),       # +y (left)
    4: lambda u, v: ( v, -u,  np.ones_like(u)),       # +z (top)
    5: lambda u, v: (-v, -u, -np.ones_like(u)),       # -z (bottom)
}


def _cmp_face_uv(dirs: np.ndarray):
    """dirs -> (face, u, v) with u,v in [-1,1]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    face = np.where((ax >= ay) & (ax >= az), np.where(x > 0, 0, 2),
             np.where(ay >= az, np.where(y > 0, 3, 1),
                      np.where(z > 0, 4, 5)))
    eps = 1e-12
    u = np.zeros_like(x)
    v = np.zeros_like(x)
    m = face == 0
    u[m] = -y[m] / (ax[m] + eps); v[m] = -z[m] / (ax[m] + eps)
    m = face == 2
    u[m] = y[m] / (ax[m] + eps); v[m] = -z[m] / (ax[m] + eps)
    m = face == 3
    u[m] = x[m] / (ay[m] + eps); v[m] = -z[m] / (ay[m] + eps)
    m = face == 1
    u[m] = -x[m] / (ay[m] + eps); v[m] = -z[m] / (ay[m] + eps)
    m = face == 4
    u[m] = -y[m] / (az[m] + eps); v[m] = x[m] / (az[m] + eps)
    m = face == 5
    u[m] = -y[m] / (az[m] + eps); v[m] = -x[m] / (az[m] + eps)
    return face, u, v


def _cube_uv_warp(u, warp):
    """Cube-face coordinate warps (the generalized-cubemap family,
    reference: TEquiAngularCubeMap / TAdjustedCubeMap / TGeneralizedCubeMap):
      'eac': u' = 4/pi*atan(u); 'acp': JVET-F0025 polynomial
      u' = sgn(u)*(1.36|u| - 0.36u^2); True/'eac' and False/None supported
      for back compatibility."""
    if warp in (True, "eac"):
        return (4.0 / PI) * np.arctan(u)
    if warp == "acp":
        return np.sign(u) * (1.36 * np.abs(u) - 0.36 * u * u)
    return u


def _cube_uv_unwarp(u, warp):
    if warp in (True, "eac"):
        return np.tan(u * PI / 4.0)
    if warp == "acp":
        # invert 0.36 v^2 - 1.36 v + |u| = 0 on [0, 1]
        a = np.abs(u)
        v = (1.36 - np.sqrt(np.maximum(1.36 ** 2 - 4 * 0.36 * a, 0.0))) \
            / (2 * 0.36)
        return np.sign(u) * v
    return u


def cmp_dirs(width: int, height: int, eac=False) -> np.ndarray:
    f = width // 3
    assert width == 3 * f and height == 2 * f, "CMP expects 3x2 packing"
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    fx, fy = xx // f, yy // f
    face = fy * 3 + fx
    u = ((xx % f) + 0.5) / f * 2 - 1
    v = ((yy % f) + 0.5) / f * 2 - 1
    u = _cube_uv_unwarp(u, eac)
    v = _cube_uv_unwarp(v, eac)
    dirs = np.zeros((height, width, 3))
    for fid in range(6):
        m = face == fid
        dx, dy, dz = _CMP_FACES[fid](u[m], v[m])
        n = np.sqrt(dx * dx + dy * dy + dz * dz)
        dirs[m] = np.stack([dx / n, dy / n, dz / n], -1)
    return dirs


def cmp_coords(dirs: np.ndarray, width: int, height: int,
               eac=False) -> np.ndarray:
    f = width // 3
    face, u, v = _cmp_face_uv(dirs)
    u = _cube_uv_warp(u, eac)
    v = _cube_uv_warp(v, eac)
    px = (np.clip(u, -1, 1) + 1) / 2 * f - 0.5 + (face % 3) * f
    py = (np.clip(v, -1, 1) + 1) / 2 * f - 0.5 + (face // 3) * f
    return np.stack([px, py], -1)


def viewport_dirs(width: int, height: int, fov_deg: float,
                  yaw_deg: float, pitch_deg: float) -> np.ndarray:
    """Rectilinear viewport (reference: TViewPort / viewport PSNR)."""
    fov = math.radians(fov_deg)
    focal = (width / 2) / math.tan(fov / 2)
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    u = (xx + 0.5 - width / 2) / focal
    v = (yy + 0.5 - height / 2) / focal
    d = np.stack([np.ones_like(u), -u, -v], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    yaw, pitch = math.radians(yaw_deg), math.radians(pitch_deg)
    ry = np.array([[math.cos(pitch), 0, math.sin(pitch)], [0, 1, 0],
                   [-math.sin(pitch), 0, math.cos(pitch)]])
    rz = np.array([[math.cos(yaw), -math.sin(yaw), 0],
                   [math.sin(yaw), math.cos(yaw), 0], [0, 0, 1]])
    return d @ (rz @ ry).T


def eap_dirs(width: int, height: int) -> np.ndarray:
    """Equal-area (Lambert cylindrical) projection (reference: TEqualArea):
    x is longitude like ERP, y samples sin(latitude) uniformly."""
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    phi = -2.0 * PI * ((xx + 0.5) / width - 0.5)
    slat = 1.0 - 2.0 * (yy + 0.5) / height          # sin(lat) in (-1, 1)
    clat = np.sqrt(np.maximum(1.0 - slat * slat, 0.0))
    return np.stack([clat * np.cos(phi), clat * np.sin(phi), slat], -1)


def eap_coords(dirs: np.ndarray, width: int, height: int) -> np.ndarray:
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    n = np.sqrt(x * x + y * y + z * z) + 1e-12
    phi = np.arctan2(y, x)
    slat = z / n
    px = (0.5 - phi / (2.0 * PI)) * width - 0.5
    py = (1.0 - slat) / 2.0 * height - 0.5
    return np.stack([px, py], -1)


def cpp_dirs(width: int, height: int) -> np.ndarray:
    """Craster parabolic projection (reference: TCrastersParabolic — the
    CPP-PSNR domain, lib360/metrics.py shares the map)."""
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    ny = (2.0 * (yy + 0.5) / height - 1.0)          # in (-1, 1)
    # canonical CPP: y = 2 sin(lat/3), x = lon (2 cos(2lat/3) - 1); the
    # normalized frame maps y in [-1,1] <-> lat in [-pi/2, pi/2]
    lat = 3.0 * np.arcsin(np.clip(ny / 2.0, -1, 1))
    stretch = 2.0 * np.cos(2.0 * lat / 3.0) - 1.0
    nx = 2.0 * (xx + 0.5) / width - 1.0
    lon = np.where(stretch > 1e-6, nx * PI / np.maximum(stretch, 1e-6), 0.0)
    lon = np.clip(lon, -PI, PI)
    clat = np.cos(lat)
    return np.stack([clat * np.cos(-lon), clat * np.sin(-lon),
                     np.sin(lat)], -1)


def cpp_coords(dirs: np.ndarray, width: int, height: int) -> np.ndarray:
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    n = np.sqrt(x * x + y * y + z * z) + 1e-12
    lat = np.arcsin(np.clip(z / n, -1, 1))
    lon = -np.arctan2(y, x)
    nx = lon / PI * (2.0 * np.cos(2.0 * lat / 3.0) - 1.0)
    ny = 2.0 * np.sin(lat / 3.0)
    px = (nx + 1.0) / 2.0 * width - 0.5
    py = (ny + 1.0) / 2.0 * height - 0.5
    return np.stack([px, py], -1)


def fisheye_dirs(width: int, height: int, fov_deg: float = 180.0
                 ) -> np.ndarray:
    """Equisolid fisheye (reference: TFisheye; lib360/projection.py
    EquisolidProjection is the MM-extension twin): r = 2 f sin(theta/2)."""
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    u = (2.0 * (xx + 0.5) / width - 1.0)
    v = (2.0 * (yy + 0.5) / height - 1.0)
    r = np.sqrt(u * u + v * v)
    theta_max = np.deg2rad(fov_deg) / 2.0
    rmax = 2.0 * np.sin(theta_max / 2.0)
    theta = 2.0 * np.arcsin(np.clip(r * rmax / 2.0, -1, 1))
    psi = np.arctan2(v, u)
    st = np.sin(theta)
    # optical axis +x; image plane (y, z)
    return np.stack([np.cos(theta), -st * np.cos(psi), -st * np.sin(psi)],
                    -1)


def fisheye_coords(dirs: np.ndarray, width: int, height: int,
                   fov_deg: float = 180.0) -> np.ndarray:
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    n = np.sqrt(x * x + y * y + z * z) + 1e-12
    theta = np.arccos(np.clip(x / n, -1, 1))
    psi = np.arctan2(-z, -y)
    theta_max = np.deg2rad(fov_deg) / 2.0
    rmax = 2.0 * np.sin(theta_max / 2.0)
    r = 2.0 * np.sin(np.minimum(theta, theta_max) / 2.0) / rmax
    u = r * np.cos(psi)
    v = r * np.sin(psi)
    px = (u + 1.0) / 2.0 * width - 0.5
    py = (v + 1.0) / 2.0 * height - 0.5
    return np.stack([px, py], -1)


# ---------------------------------------------------------------------------
# latitude/longitude helpers (sphere convention of this module: z up,
# dir = [cos(lat)cos(phi), cos(lat)sin(phi), sin(lat)], ERP x -> -phi)
# ---------------------------------------------------------------------------
def _latlon_to_dirs(lat, lon):
    cl = np.cos(lat)
    return np.stack([cl * np.cos(-lon), cl * np.sin(-lon), np.sin(lat)], -1)


def _dirs_to_latlon(dirs):
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    n = np.sqrt(x * x + y * y + z * z) + 1e-12
    return np.arcsin(np.clip(z / n, -1, 1)), -np.arctan2(y, x)


def aep_dirs(width: int, height: int, beta: float = 1.0 / 1.4) -> np.ndarray:
    """Adjusted equal-area (reference: TAdjustedEqualArea.cpp:52 BETA=1/1.4;
    map2DTo3D — pitch = asin((1 - 2v/H) sin(pi*beta/2)) / beta)."""
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    lon = -2.0 * PI * ((xx + 0.5) / width - 0.5)
    lat = np.arcsin((1.0 - 2.0 * (yy + 0.5) / height)
                    * math.sin(0.5 * PI * beta)) / beta
    return _latlon_to_dirs(lat, -lon)


def aep_coords(dirs: np.ndarray, width: int, height: int,
               beta: float = 1.0 / 1.4) -> np.ndarray:
    lat, lon = _dirs_to_latlon(dirs)
    px = (0.5 + lon / (2.0 * PI)) * width - 0.5
    py = (0.5 - 0.5 * np.sin(lat * beta) / math.sin(0.5 * PI * beta)) \
        * height - 0.5
    return np.stack([px, py], -1)


# Segmented sphere (SSP) — reference: TSegmentedSphere.cpp map2DTo3D /
# map3DTo2D: two azimuthal-equidistant pole disks (|lat| > 45 deg) + four
# 90x90-degree equatorial ERP faces.  Packing here: 3x2 grid of f x f faces,
# row 0 = [north disk, south disk, equator seg 0], row 1 = [seg 1..3].
_SSP_EQ_POS = {0: (2, 0), 1: (0, 1), 2: (1, 1), 3: (2, 1)}


def ssp_dirs(width: int, height: int) -> np.ndarray:
    f = width // 3
    assert width == 3 * f and height == 2 * f, "SSP expects 3x2 packing"
    xx, yy = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5)
    fx, fy = (xx // f).astype(int), (yy // f).astype(int)
    u, v = xx % f, yy % f
    lat = np.zeros_like(xx)
    lon = np.zeros_like(xx)
    # pole disks (reference: faceIdx 0/1 — azimuthal equidistant)
    px_, py_ = u - f / 2.0, v - f / 2.0
    d = np.sqrt(px_ * px_ + py_ * py_)
    north = (fy == 0) & (fx == 0)
    south = (fy == 0) & (fx == 1)
    yaw_n = np.where(d > 0, np.arccos(np.clip(
        np.divide(py_, d, out=np.zeros_like(d), where=d > 0), -1, 1)), 0.0)
    yaw_n = np.where(px_ < 0, 2 * PI - yaw_n, yaw_n)
    lat = np.where(north, PI / 2 - d * (PI / 2) / f, lat)
    lon = np.where(north, yaw_n, lon)
    yaw_s = np.where(d > 0, np.arctan2(py_, px_) + PI / 2, 0.0)
    lat = np.where(south, d * (PI / 2) / f - PI / 2, lat)
    lon = np.where(south, yaw_s, lon)
    # equatorial segments: 90 deg of longitude each, |lat| <= 45 deg
    for seg, (cx, cy) in _SSP_EQ_POS.items():
        m = (fx == cx) & (fy == cy)
        lat = np.where(m, PI / 4 - v * (PI / 2) / f, lat)
        lon = np.where(m, (seg + u / f) * (PI / 2), lon)
    return _latlon_to_dirs(lat, lon)


def ssp_coords(dirs: np.ndarray, width: int, height: int) -> np.ndarray:
    f = width // 3
    lat, lon = _dirs_to_latlon(dirs)
    lon = np.mod(lon, 2 * PI)
    px = np.zeros_like(lat)
    py = np.zeros_like(lat)
    north = lat > PI / 4
    south = lat < -PI / 4
    eq = ~(north | south)
    # pole disks (inverse of the equidistant maps above)
    d_n = (PI / 2 - lat) * f / (PI / 2)
    px = np.where(north, f / 2 + d_n * np.sin(lon) - 0.5, px)
    py = np.where(north, f / 2 + d_n * np.cos(lon) - 0.5, py)
    d_s = (lat + PI / 2) * f / (PI / 2)
    px = np.where(south, f + f / 2 + d_s * np.cos(lon - PI / 2) - 0.5, px)
    py = np.where(south, f / 2 + d_s * np.sin(lon - PI / 2) - 0.5, py)
    # equator
    seg = np.clip((lon / (PI / 2)).astype(int), 0, 3)
    u = (lon / (PI / 2) - seg) * f
    v = (PI / 4 - lat) * f / (PI / 2)
    for sid, (cx, cy) in _SSP_EQ_POS.items():
        m = eq & (seg == sid)
        px = np.where(m, cx * f + u - 0.5, px)
        py = np.where(m, cy * f + v - 0.5, py)
    return np.stack([px, py], -1)


# Equatorial cylindrical (ECP) — reference: TEquatorialCylindrical.cpp:
# equator (|sin lat| <= 2/3) as four cylindrical faces with v = -1.5 sin(lat);
# poles as squircle-warped disks.  Packing: 3x2, row 0 = [north, south, eq0],
# row 1 = [eq1..eq3]; pole yaw offset pi/4, no padding margins.
def _ecp_squircle_fwd(x, y):
    """Disk -> square (reference: map3DTo2D face 0/1 w-term)."""
    r2 = x * x + y * y
    inner = np.maximum(r2 * (r2 - 4 * x * x * y * y), 0.0)
    sgn = np.where(x * y >= 0, 1.0, -1.0)
    w = sgn / math.sqrt(2) * np.sqrt(np.maximum(r2 - np.sqrt(inner), 0.0))
    eps = 1e-9
    px = np.where(np.abs(w) > eps,
                  np.divide(w, y, out=np.copysign(np.ones_like(w), x * y),
                            where=np.abs(y) > eps), x)
    py = np.where(np.abs(w) > eps,
                  np.divide(w, x, out=np.copysign(np.ones_like(w), x * y),
                            where=np.abs(x) > eps), y)
    return px, py


def _ecp_squircle_inv(x, y):
    """Square -> disk (reference: map2DTo3D face 0/1 sqc-term)."""
    r2 = x * x + y * y
    sqc = np.sqrt(np.maximum(r2 - x * x * y * y, 0.0)) \
        / np.sqrt(np.maximum(r2, 1e-18))
    return np.where(r2 > 0, x * sqc, 0.0), np.where(r2 > 0, y * sqc, 0.0)


_ECP_LAT0 = math.asin(2.0 / 3.0)


def ecp_dirs(width: int, height: int) -> np.ndarray:
    f = width // 3
    assert width == 3 * f and height == 2 * f, "ECP expects 3x2 packing"
    xx, yy = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5)
    fx, fy = (xx // f).astype(int), (yy // f).astype(int)
    u = 2.0 * (xx % f) / f - 1.0
    v = 2.0 * (yy % f) / f - 1.0
    lat = np.zeros_like(xx)
    lon = np.zeros_like(xx)
    b = 0.2
    for pole, (pfx, sign) in {0: (0, 1.0), 1: (1, -1.0)}.items():
        m = (fy == 0) & (fx == pfx)
        cu = 1.0 + np.tanh((-sign * v - 1.0) / b)
        x_ = np.tan(np.arctan(cu) * u) / np.maximum(cu, 1e-9)
        du, dv = _ecp_squircle_inv(x_, v)
        d = np.sqrt(du * du + dv * dv) * (f / 2.0)
        if pole == 0:
            yaw = np.where(d > 0, np.arccos(np.clip(
                np.divide(dv * f / 2, d, out=np.zeros_like(d), where=d > 0),
                -1, 1)), 0.0)
            yaw = np.where(du < 0, 2 * PI - yaw, yaw) - PI / 4
            la = PI / 2 - 2.0 * d * (PI / 2 - _ECP_LAT0) / f
        else:
            yaw = np.where(d > 0, np.arctan2(dv, du) + PI / 2, 0.0) - PI / 4
            la = 2.0 * d * (PI / 2 - _ECP_LAT0) / f - PI / 2
        lat = np.where(m, la, lat)
        lon = np.where(m, yaw, lon)
    for seg, (cx, cy) in _SSP_EQ_POS.items():
        m = (fx == cx) & (fy == cy)
        lat = np.where(m, np.arcsin(np.clip(-2.0 * v / 3.0, -1, 1)), lat)
        lon = np.where(m, (u + 1.0) * PI / 4 + seg * PI / 2, lon)
    return _latlon_to_dirs(lat, lon)


def ecp_coords(dirs: np.ndarray, width: int, height: int) -> np.ndarray:
    f = width // 3
    lat, lon = _dirs_to_latlon(dirs)
    px = np.zeros_like(lat)
    py = np.zeros_like(lat)
    north = np.sin(lat) > 2.0 / 3.0
    south = np.sin(lat) < -2.0 / 3.0
    eq = ~(north | south)
    b = 0.2
    for pole, mask in ((0, north), (1, south)):
        yaw = lon + PI / 4
        scale = (PI / 2 - np.abs(lat)) / (PI / 2 - _ECP_LAT0)
        if pole == 0:
            du, dv = np.sin(yaw) * scale, np.cos(yaw) * scale
        else:
            du, dv = np.sin(yaw) * scale, -np.cos(yaw) * scale
        sx, sy = _ecp_squircle_fwd(du, dv)
        cu = 1.0 + np.tanh((-np.where(pole == 0, sy, -sy) - 1.0) / b)
        u = np.arctan(cu * sx) / np.arctan(np.maximum(cu, 1e-9))
        v = sy
        px = np.where(mask, (u + 1.0) / 2.0 * f + pole * f - 0.5, px)
        py = np.where(mask, (v + 1.0) / 2.0 * f - 0.5, py)
    lon_m = np.mod(lon, 2 * PI)
    seg = np.clip((lon_m / (PI / 2)).astype(int), 0, 3)
    u_eq = (lon_m / (PI / 2) - seg) * f
    v_eq = (1.0 - 1.5 * np.sin(lat)) / 2.0 * f
    for sid, (cx, cy) in _SSP_EQ_POS.items():
        m = eq & (seg == sid)
        px = np.where(m, cx * f + u_eq - 0.5, px)
        py = np.where(m, cy * f + v_eq - 0.5, py)
    return np.stack([px, py], -1)


# Rotated sphere (RSP) — reference: TRotatedSphere.cpp: two 270x90-degree
# ERP-parameterized segments; the second covers the remainder through the
# fixed rotation (x,y,z)->(-x,-z,-y) (mapToOtherFace:159).  Packing: 3f x 2f,
# row 0 = front segment, row 1 = rotated segment.
def _rsp_rot(d):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return np.stack([-x, -z, -y], -1)


def rsp_dirs(width: int, height: int) -> np.ndarray:
    f = height // 2
    assert width == 3 * f and height == 2 * f, "RSP expects 3x2 packing"
    xx, yy = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5)
    back = yy >= f
    v = np.where(back, yy - f, yy) / f
    lat = PI / 2 * (0.5 - v)
    lon = (xx / width - 0.5) * 1.5 * PI
    d = _latlon_to_dirs(lat, lon)
    return np.where(back[..., None], _rsp_rot(d), d)


def rsp_coords(dirs: np.ndarray, width: int, height: int) -> np.ndarray:
    f = height // 2
    lat, lon = _dirs_to_latlon(dirs)
    lat2, lon2 = _dirs_to_latlon(_rsp_rot(dirs))
    front = (np.abs(lat) <= PI / 4 + 1e-9) & (np.abs(lon) <= 0.75 * PI)
    la = np.where(front, lat, lat2)
    lo = np.where(front, lon, lon2)
    px = (lo / (1.5 * PI) + 0.5) * width - 0.5
    py = (0.5 - 2.0 * la / PI) * f - 0.5 + np.where(front, 0.0, float(f))
    return np.stack([px, py], -1)


# Hybrid equi-angular cubemap (HEC) — reference:
# THybridEquiAngularCubeMap.cpp: tan-warp horizontally on all faces and
# vertically on top/bottom; side faces use pv' = pv / (1 + 0.4(1-pu^2)(1-pv^2))
def _hec_v_inv(w, pu):
    """Solve pv from w = pv / (1 + a (1-pv^2)), a = 0.4 (1 - pu^2)."""
    a = 0.4 * (1.0 - pu * pu)
    wa = w * a
    disc = np.sqrt(np.maximum(1.0 + 4.0 * wa * w * (1.0 + a), 0.0))
    return np.where(np.abs(wa) > 1e-9, (disc - 1.0) / (2.0 * wa),
                    w * (1.0 + a))


def hec_dirs(width: int, height: int) -> np.ndarray:
    f = width // 3
    xx, yy = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5)
    face = (yy // f).astype(int) * 3 + (xx // f).astype(int)
    pu = 2.0 * (xx % f) / f - 1.0
    pv = 2.0 * (yy % f) / f - 1.0
    t = 1.0 + 0.4 * (1.0 - pu * pu) * (1.0 - pv * pv)
    pu_w = np.tan(pu * PI / 4)
    top_bottom = (face == 4) | (face == 5)
    pv_w = np.where(top_bottom, np.tan(pv * PI / 4), pv / t)
    dirs = np.zeros(xx.shape + (3,))
    for fid in range(6):
        m = face == fid
        dx, dy, dz = _CMP_FACES[fid](pu_w[m], pv_w[m])
        n = np.sqrt(dx * dx + dy * dy + dz * dz)
        dirs[m] = np.stack([dx / n, dy / n, dz / n], -1)
    return dirs


def hec_coords(dirs: np.ndarray, width: int, height: int) -> np.ndarray:
    f = width // 3
    face, u, v = _cmp_face_uv(dirs)
    pu = (4.0 / PI) * np.arctan(u)
    top_bottom = (face == 4) | (face == 5)
    pv = np.where(top_bottom, (4.0 / PI) * np.arctan(v), _hec_v_inv(v, pu))
    px = (np.clip(pu, -1, 1) + 1) / 2 * f - 0.5 + (face % 3) * f
    py = (np.clip(pv, -1, 1) + 1) / 2 * f - 0.5 + (face // 3) * f
    return np.stack([px, py], -1)


def gcmp_dirs(width: int, height: int, warps=("eac",) * 6) -> np.ndarray:
    """Generalized cubemap (reference: TGeneralizedCubeMap.cpp) — per-face
    warp selection from the cube warp family (None/'eac'/'acp')."""
    f = width // 3
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    face = (yy // f) * 3 + (xx // f)
    u = ((xx % f) + 0.5) / f * 2 - 1
    v = ((yy % f) + 0.5) / f * 2 - 1
    dirs = np.zeros((height, width, 3))
    for fid in range(6):
        m = face == fid
        uu = _cube_uv_unwarp(u[m], warps[fid])
        vv = _cube_uv_unwarp(v[m], warps[fid])
        dx, dy, dz = _CMP_FACES[fid](uu, vv)
        n = np.sqrt(dx * dx + dy * dy + dz * dz)
        dirs[m] = np.stack([dx / n, dy / n, dz / n], -1)
    return dirs


def gcmp_coords(dirs: np.ndarray, width: int, height: int,
                warps=("eac",) * 6) -> np.ndarray:
    f = width // 3
    face, u, v = _cmp_face_uv(dirs)
    uw = np.zeros_like(u)
    vw = np.zeros_like(v)
    for fid in range(6):
        m = face == fid
        uw[m] = _cube_uv_warp(u[m], warps[fid])
        vw[m] = _cube_uv_warp(v[m], warps[fid])
    px = (np.clip(uw, -1, 1) + 1) / 2 * f - 0.5 + (face % 3) * f
    py = (np.clip(vw, -1, 1) + 1) / 2 * f - 0.5 + (face // 3) * f
    return np.stack([px, py], -1)


# ---------------------------------------------------------------------------
# Triangle-face polyhedra: octahedron (OHP) and icosahedron (ISP).
# reference: TOctahedron.cpp / TIcosahedron.cpp — gnomonic projection onto
# triangular faces, compactly packed.  Packing here: each packed fxf square
# holds two faces that share an edge, split along the square's main
# anti-diagonal (v00 | shared edge v10-v01 | v11) — the standard
# triangle-pair compaction.  Forward map is barycentric interpolation of
# the face vertices + normalization (gnomonic); inverse solves the 3x3
# barycentric system for every face and picks the face with non-negative
# weights (vectorized over all faces at once).
# ---------------------------------------------------------------------------
def _poly_quads_ohp() -> np.ndarray:
    """(4, 4, 3) vertex quads [v00, v10, v01, v11] per packed square."""
    n = np.array([0.0, 0.0, 1.0])
    s = -n
    ring = [np.array([math.cos(k * PI / 2), math.sin(k * PI / 2), 0.0])
            for k in range(5)]
    return np.stack([np.stack([n, ring[q], ring[q + 1], s])
                     for q in range(4)])


def _poly_quads_isp() -> np.ndarray:
    """(10, 4, 3) icosahedron packed-square vertex quads: row-0 squares
    hold (top_k, upper-mid_k), row-1 squares (lower-mid_k, bottom_k)."""
    n = np.array([0.0, 0.0, 1.0])
    s = -n
    latu = math.atan(0.5)
    up = [np.array([math.cos(latu) * math.cos(2 * PI * k / 5),
                    math.cos(latu) * math.sin(2 * PI * k / 5),
                    math.sin(latu)]) for k in range(6)]
    lo = [np.array([math.cos(latu) * math.cos(2 * PI * (k + 0.5) / 5),
                    math.cos(latu) * math.sin(2 * PI * (k + 0.5) / 5),
                    -math.sin(latu)]) for k in range(6)]
    quads = [np.stack([n, up[k], up[k + 1], lo[k]]) for k in range(5)]
    quads += [np.stack([up[k + 1], lo[k], lo[k + 1], s]) for k in range(5)]
    return np.stack(quads)


def _poly_dirs(quads: np.ndarray, cols: int, width: int, height: int
               ) -> np.ndarray:
    """Forward map for a triangle-pair packing: quads (Q, 4, 3), packed as
    `cols` squares per row."""
    rows = len(quads) // cols
    f = width // cols
    assert width == cols * f and height == rows * f
    xx, yy = np.meshgrid((np.arange(width) + 0.5) / f,
                         (np.arange(height) + 0.5) / f)
    q = (yy.astype(int) // 1) * 0  # placeholder shape
    qi = np.minimum((xx).astype(int), cols - 1) \
        + np.minimum((yy).astype(int), rows - 1) * cols
    a = xx - np.floor(xx)
    b = yy - np.floor(yy)
    v00, v10, v01, v11 = (quads[qi, i] for i in range(4))
    upper = (a + b) <= 1.0
    wa = np.where(upper, a, 1.0 - b)
    wb = np.where(upper, b, 1.0 - a)
    w0 = np.where(upper, 1.0 - a - b, a + b - 1.0)
    apex = np.where(upper[..., None], v00, v11)
    p = (apex * w0[..., None] + v10 * wa[..., None] + v01 * wb[..., None])
    return p / (np.linalg.norm(p, axis=-1, keepdims=True) + 1e-12)


def _poly_coords(quads: np.ndarray, cols: int, dirs: np.ndarray,
                 width: int, height: int) -> np.ndarray:
    """Inverse map: solve barycentrics for all 2Q triangle faces, select
    the face containing each direction."""
    rows = len(quads) // cols
    f = width // cols
    tris = []        # (T, 3, 3): [apex, v10, v01]
    meta = []        # (square, upper?)
    for qi, (v00, v10, v01, v11) in enumerate(quads):
        tris.append(np.stack([v00, v10, v01]))
        meta.append((qi, True))
        tris.append(np.stack([v11, v10, v01]))
        meta.append((qi, False))
    tinv = np.stack([np.linalg.inv(t.T) for t in tris])      # (T, 3, 3)
    d = dirs.reshape(-1, 3)
    w = np.einsum("tij,nj->nti", tinv, d)                    # (N, T, 3)
    ws = w.sum(-1, keepdims=True)
    w = w / np.where(np.abs(ws) < 1e-12, 1e-12, ws)
    score = np.min(w, -1)
    # the antipodal face yields all-negative weights whose sum-normalized
    # form looks valid — reject faces behind the ray (sum <= 0)
    score = np.where(ws[..., 0] > 0, score, -np.inf)
    pick = np.argmax(score, axis=1)                          # (N,)
    wsel = np.take_along_axis(w, pick[:, None, None], 1)[:, 0]
    sq = np.array([m[0] for m in meta])[pick]
    up = np.array([m[1] for m in meta])[pick]
    a = np.where(up, wsel[:, 1], 1.0 - wsel[:, 2])
    b = np.where(up, wsel[:, 2], 1.0 - wsel[:, 1])
    px = (sq % cols + a) * f - 0.5
    py = (sq // cols + b) * f - 0.5
    return np.stack([px, py], -1).reshape(dirs.shape[:-1] + (2,))


def ohp_dirs(width: int, height: int) -> np.ndarray:
    """Octahedron projection, 4x1 triangle-pair squares (reference:
    TOctahedron.cpp map2DTo3D — gnomonic on 8 faces)."""
    return _poly_dirs(_poly_quads_ohp(), 4, width, height)


def ohp_coords(dirs: np.ndarray, width: int, height: int) -> np.ndarray:
    return _poly_coords(_poly_quads_ohp(), 4, dirs, width, height)


def isp_dirs(width: int, height: int) -> np.ndarray:
    """Icosahedron projection, 5x2 triangle-pair squares (reference:
    TIcosahedron.cpp — gnomonic on 20 faces)."""
    return _poly_dirs(_poly_quads_isp(), 5, width, height)


def isp_coords(dirs: np.ndarray, width: int, height: int) -> np.ndarray:
    return _poly_coords(_poly_quads_isp(), 5, dirs, width, height)


# Truncated square pyramid (TSP) — reference: TTsp.cpp (JVET-D0071): the
# cube re-parameterized so the front face (+x) keeps full resolution (left
# half of the frame) and the back face (-x) shrinks to the central square
# of the right half, with the four side faces as frustum trapezoids
# between the right half's border and the back square.
_TSP_B0, _TSP_B1 = 0.25, 0.75          # back-face extent in the right half


def tsp_dirs(width: int, height: int) -> np.ndarray:
    f = width // 2
    assert width == 2 * f and height == f, "TSP expects 2x1 packing"
    b0, b1 = _TSP_B0, _TSP_B1
    xx, yy = np.meshgrid((np.arange(width) + 0.5) / f,
                         (np.arange(height) + 0.5) / f)
    front = xx < 1.0
    u = np.clip(xx - 1.0, 0.0, 1.0)      # right-half local coords
    v = yy
    # sector classification by the two diagonals of the right half (the
    # back square's corners lie on them)
    back = (u >= b0) & (u < b1) & (v >= b0) & (v < b1)
    left = (v >= u) & (v <= 1 - u) & ~back
    right = (v <= u) & (v >= 1 - u) & ~back
    top = (v <= u) & (v <= 1 - u) & ~back
    bot = (v >= u) & (v >= 1 - u) & ~back
    eps = 1e-12
    # left trapezoid: depth t = u/b0 in [0,1], lateral s = (v-u)/(1-2u)
    t_l, s_l = u / b0, (v - u) / np.maximum(1 - 2 * u, eps)
    t_r, s_r = (1 - u) / b0, (v - 1 + u) / np.maximum(2 * u - 1, eps)
    t_t, s_t = v / b0, (u - v) / np.maximum(1 - 2 * v, eps)
    t_b, s_b = (1 - v) / b0, (u - 1 + v) / np.maximum(2 * v - 1, eps)
    sb_u = (u - b0) / (b1 - b0)
    sb_v = (v - b0) / (b1 - b0)
    x = np.select(
        [front, back, left, right, top, bot],
        [np.ones_like(u), -np.ones_like(u), 1 - 2 * t_l, 1 - 2 * t_r,
         1 - 2 * t_t, 1 - 2 * t_b])
    y = np.select(
        [front, back, left, right, top, bot],
        [1 - 2 * xx, 1 - 2 * sb_u, np.ones_like(u), -np.ones_like(u),
         1 - 2 * s_t, 1 - 2 * s_b])
    z = np.select(
        [front, back, left, right, top, bot],
        [1 - 2 * yy, 1 - 2 * sb_v, 1 - 2 * s_l, 1 - 2 * s_r,
         np.ones_like(u), -np.ones_like(u)])
    p = np.stack([x, y, z], -1)
    return p / (np.linalg.norm(p, axis=-1, keepdims=True) + 1e-12)


def tsp_coords(dirs: np.ndarray, width: int, height: int) -> np.ndarray:
    """Exact inverse of tsp_dirs (cube-face classification, then the
    per-region linear maps inverted)."""
    f = width // 2
    b0, b1 = _TSP_B0, _TSP_B1
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    m = np.maximum(ax, np.maximum(ay, az)) + 1e-12
    front = (ax >= ay) & (ax >= az) & (x > 0)
    back = (ax >= ay) & (ax >= az) & (x <= 0)
    left = (ay >= ax) & (ay >= az) & (y > 0) & ~front & ~back
    right = (ay >= ax) & (ay >= az) & (y <= 0) & ~front & ~back
    top = (az > ay) & (az >= ax) & (z > 0) & ~front & ~back
    bot = (az > ay) & (az >= ax) & (z <= 0) & ~front & ~back
    xn, yn, zn = x / m, y / m, z / m
    t = np.clip((1 - xn) / 2, 0.0, 1.0)      # frustum depth on side faces
    # left: u = t*b0, v = u + s*(1-2u), s = (1-zn)/2
    u_l = t * b0
    v_l = u_l + (1 - zn) / 2 * (1 - 2 * u_l)
    u_r = 1 - t * b0
    v_r = (1 - u_r) + (1 - zn) / 2 * (2 * u_r - 1)
    v_t = t * b0
    u_t = v_t + (1 - yn) / 2 * (1 - 2 * v_t)
    v_b = 1 - t * b0
    u_b = (1 - v_b) + (1 - yn) / 2 * (2 * v_b - 1)
    u_bk = b0 + (1 - yn) / 2 * (b1 - b0)
    v_bk = b0 + (1 - zn) / 2 * (b1 - b0)
    px = np.select(
        [front, back, left, right, top, bot],
        [(1 - yn) / 2, 1 + u_bk, 1 + u_l, 1 + u_r, 1 + u_t, 1 + u_b])
    py = np.select(
        [front, back, left, right, top, bot],
        [(1 - zn) / 2, v_bk, v_l, v_r, v_t, v_b])
    return np.stack([px * f - 0.5, py * f - 0.5], -1)


def hcmp_dirs(width: int, height: int) -> np.ndarray:
    """Hemisphere cubemap (HCMP, reference: THCMP.cpp map2DTo3D — layout
    [PZ PX NZ / NY NX PY], faces of the x>=0 hemisphere; the far halves of
    the side faces are inactive).  Inactive samples are clamped onto the
    hemisphere boundary so every pixel still carries a direction."""
    a = width // 3
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64) + 0.5
    col = np.minimum((xx // a).astype(int), 2)
    row = np.minimum((yy // (height // 2)).astype(int), 1)
    u = (xx - col * a) / a * 2.0 - 1.0
    v = (yy - row * (height // 2)) / (height // 2) * 2.0 - 1.0
    face = np.choose(row * 3 + col, [4, 0, 5, 3, 1, 2])
    x = np.zeros_like(u)
    y = np.zeros_like(u)
    z = np.zeros_like(u)
    # clamp the coordinate that leaves the hemisphere (x >= 0)
    up = np.maximum(u, 0.0)
    vp = np.maximum(v, 0.0)
    un = np.minimum(u, 0.0)
    for f in range(6):
        m = face == f
        if f == 0:                       # PX: full front face
            x[m], y[m], z[m] = 1.0, -v[m], -u[m]
        elif f == 1:                     # NX: inactive (boundary ring)
            x[m], y[m], z[m] = 0.0, -v[m], u[m]
        elif f == 2:                     # PY: near-front half
            x[m], y[m], z[m] = up[m], 1.0, v[m]
        elif f == 3:                     # NY
            x[m], y[m], z[m] = up[m], -1.0, -v[m]
        elif f == 4:                     # PZ
            x[m], y[m], z[m] = up[m], -v[m], 1.0
        else:                            # NZ
            x[m], y[m], z[m] = -un[m], -v[m], -1.0
    d = np.stack([x, y, z], axis=-1)
    n = np.linalg.norm(d, axis=-1, keepdims=True)
    return d / np.maximum(n, 1e-12)


def hcmp_coords(dirs: np.ndarray, width: int, height: int) -> np.ndarray:
    """Inverse of hcmp_dirs for hemisphere directions (x < 0 clamps to the
    front boundary)."""
    a = width // 3
    hh = height // 2
    x = np.maximum(dirs[..., 0], 0.0)
    y, z = dirs[..., 1], dirs[..., 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    # face choice among the hemisphere's five visible faces
    face = np.zeros(x.shape, dtype=int)
    face[(ax >= ay) & (ax >= az)] = 0
    face[(ay > ax) & (ay >= az) & (y > 0)] = 2
    face[(ay > ax) & (ay >= az) & (y <= 0)] = 3
    face[(az > ax) & (az > ay) & (z > 0)] = 4
    face[(az > ax) & (az > ay) & (z <= 0)] = 5
    u = np.zeros_like(x)
    v = np.zeros_like(x)
    eps = 1e-12
    for f in (0, 2, 3, 4, 5):
        m = face == f
        if f == 0:
            u[m] = -z[m] / np.maximum(x[m], eps)
            v[m] = -y[m] / np.maximum(x[m], eps)
        elif f == 2:
            u[m] = x[m] / np.maximum(ay[m], eps)
            v[m] = z[m] / np.maximum(ay[m], eps)
        elif f == 3:
            u[m] = x[m] / np.maximum(ay[m], eps)
            v[m] = -z[m] / np.maximum(ay[m], eps)
        elif f == 4:
            u[m] = x[m] / np.maximum(az[m], eps)
            v[m] = -y[m] / np.maximum(az[m], eps)
        else:   # NZ: active half is u <= 0 (x = -u in the forward map)
            u[m] = -x[m] / np.maximum(az[m], eps)
            v[m] = -y[m] / np.maximum(az[m], eps)
    u = np.clip(u, -1.0, 1.0)
    v = np.clip(v, -1.0, 1.0)
    colrow = {0: (1, 0), 2: (2, 1), 3: (0, 1), 4: (0, 0), 5: (2, 0)}
    px = np.zeros_like(u)
    py = np.zeros_like(u)
    for f, (c, r) in colrow.items():
        m = face == f
        px[m] = c * a + (u[m] + 1.0) * 0.5 * a - 0.5
        py[m] = r * hh + (v[m] + 1.0) * 0.5 * hh - 0.5
    return np.stack([px, py], axis=-1)


GEOMETRIES = {"erp": (erp_dirs, erp_coords),
              "hcmp": (hcmp_dirs, hcmp_coords),
              "cmp": (cmp_dirs, cmp_coords),
              "eac": (functools.partial(cmp_dirs, eac=True),
                      functools.partial(cmp_coords, eac=True)),
              # adjusted cubemap (ACP) via the generalized warp family
              "acp": (functools.partial(cmp_dirs, eac="acp"),
                      functools.partial(cmp_coords, eac="acp")),
              "eap": (eap_dirs, eap_coords),
              "aep": (aep_dirs, aep_coords),
              "cpp": (cpp_dirs, cpp_coords),
              "ssp": (ssp_dirs, ssp_coords),
              "ecp": (ecp_dirs, ecp_coords),
              "rsp": (rsp_dirs, rsp_coords),
              "hec": (hec_dirs, hec_coords),
              "gcmp": (gcmp_dirs, gcmp_coords),
              "ohp": (ohp_dirs, ohp_coords),
              "isp": (isp_dirs, isp_coords),
              "tsp": (tsp_dirs, tsp_coords),
              "fisheye": (fisheye_dirs, fisheye_coords)}


@functools.lru_cache(maxsize=None)
def _conversion_map(src_geo: str, sw: int, sh: int, dst_geo: str,
                    dw: int, dh: int) -> np.ndarray:
    dirs = GEOMETRIES[dst_geo][0](dw, dh)
    return GEOMETRIES[src_geo][1](dirs, sw, sh).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _lanczos_lut(a: int, phases: int = 32) -> np.ndarray:
    """Per-phase Lanczos-a kernels (reference: TGeometry Lanczos filters)."""
    taps = 2 * a
    k = np.zeros((phases, taps))
    for p in range(phases):
        frac = p / phases
        xs = np.arange(-a + 1, a + 1) - frac
        w = np.sinc(xs) * np.sinc(xs / a)
        k[p] = w / w.sum()
    return k.astype(np.float32)


def _taps(plane: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
          dys, dxs) -> torch.Tensor:
    """plane at (clip(y0 + dy), (x0 + dx) mod W) for every tap (dy, dx)
    pair of dys x dxs: (len(dys), len(dxs), H', W'), one gather (x wraps,
    y clamps)."""
    h, w = plane.shape
    dev = plane.device
    yi = torch.clamp(y0[None] + torch.as_tensor(dys, device=dev)[:, None,
                                                                  None],
                     0, h - 1)
    xi = torch.remainder(x0[None] + torch.as_tensor(dxs, device=dev)[
        :, None, None], w)
    flat = yi[:, None] * w + xi[None]
    return plane.reshape(-1)[flat.reshape(-1)].reshape(flat.shape)


def _resample(plane: torch.Tensor, coords: torch.Tensor,
              method: str = "bilinear") -> torch.Tensor:
    """Sample `plane` at continuous float32 coords (H', W', 2); x wraps
    (ERP), y clamps.  The weights and sums are float32 in the form XLA
    compiles the JAX package's jit to: the bilinear taps summed in (dy, dx)
    order; Lanczos rows of 2a taps (kx * sample) and then ky * row, each
    sum of products a chain of FMAs."""
    x, y = coords[..., 0], coords[..., 1]
    if method == "nn":
        h, w = plane.shape
        xi = torch.remainder(torch.round(x).to(torch.int32), w)
        yi = torch.clamp(torch.round(y).to(torch.int32), 0, h - 1)
        return plane[yi.long(), xi.long()]
    if method == "bilinear":
        x0 = torch.floor(x).to(torch.int32)
        y0 = torch.floor(y).to(torch.int32)
        fx = x - x0
        fy = y - y0
        s = _taps(plane, y0, x0, (0, 1), (0, 1)).to(torch.float32)
        out = torch.zeros_like(x)
        for dy in (0, 1):
            for dx in (0, 1):
                wgt = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                out = out + wgt * s[dy, dx]
        return torch.round(out).to(plane.dtype)
    if method in ("lanczos2", "lanczos3"):
        a = 2 if method == "lanczos2" else 3
        lut = torch.as_tensor(_lanczos_lut(a), device=plane.device)
        phases = lut.shape[0]
        x0 = torch.floor(x).to(torch.int32)
        y0 = torch.floor(y).to(torch.int32)
        px = torch.clamp((x - x0) * phases, 0, phases - 1).to(torch.int64)
        py = torch.clamp((y - y0) * phases, 0, phases - 1).to(torch.int64)
        kx = lut[px]                                    # (..., 2a)
        ky = lut[py]
        taps = range(-a + 1, a + 1)
        s = _taps(plane, y0, x0, taps, taps).to(torch.float32)

        def dot(w, v):
            # XLA's order: the first two products, the first fused into
            # the sum (an FMA), then each further product fused in turn
            acc = fma32(w[0], v[0], w[1] * v[1])
            for i in range(2, 2 * a):
                acc = fma32(w[i], v[i], acc)
            return acc

        rows = [dot([kx[..., t] for t in range(2 * a)], s[ty])
                for ty in range(2 * a)]
        out = dot([ky[..., t] for t in range(2 * a)], rows)
        # Lanczos overshoots; clamp into the plane's dynamic range
        lo = plane.min().to(torch.float32)
        hi = plane.max().to(torch.float32)
        out = torch.minimum(torch.maximum(torch.round(out), lo), hi)
        return out.to(plane.dtype)
    raise ValueError(method)


def _device_plane(plane, device) -> torch.Tensor:
    dev = resolve_device(device)
    return torch.as_tensor(np.asarray(plane) if not torch.is_tensor(plane)
                           else plane, device=dev)


def geo_convert(plane, src_geo: str, dst_geo: str,
                dst_size: tuple[int, int], method: str = "lanczos3",
                device=None) -> np.ndarray:
    """Convert one plane between geometries on `device` (CUDA unless
    another is named; reference: TGeometry::geoConvert)."""
    p = _device_plane(plane, device)
    sh, sw = p.shape
    dh, dw = dst_size
    coords = torch.as_tensor(_conversion_map(src_geo, sw, sh, dst_geo, dw,
                                             dh), device=p.device)
    return _resample(p, coords, method).cpu().numpy()


def render_viewport(plane, width: int, height: int,
                    fov_deg: float = 90.0, yaw_deg: float = 0.0,
                    pitch_deg: float = 0.0, method: str = "lanczos3",
                    device=None) -> np.ndarray:
    """Render a rectilinear viewport from an ERP plane on `device`
    (reference: TViewPort; feeds viewport PSNR)."""
    p = _device_plane(plane, device)
    sh, sw = p.shape
    dirs = viewport_dirs(width, height, fov_deg, yaw_deg, pitch_deg)
    coords = torch.as_tensor(erp_coords(dirs, sw, sh).astype(np.float32),
                             device=p.device)
    return _resample(p, coords, method).cpu().numpy()
