"""Spherical quality metrics: WS-PSNR, S-PSNR-NN, S-PSNR-I, CPP-PSNR,
viewport PSNR and MS-SSIM.

PyTorch counterpart of `vvc_mm_tpu/lib360/metrics.py` (reference:
source/Lib/Lib360/TWSPSNRMetricCalc.{cpp,h} — WS-PSNR weights each ERP row
by cos(theta); TSPSNRMetricCalc — S-PSNR-NN samples a uniform sphere point
set with nearest-neighbour lookup; TCPPPSNRMetricCalc — PSNR in the
Craster parabolic projection domain; wired per POC by TExt360EncGop,
EncGOP.cpp:4914 m_ext360.calculatePSNRs).

The sample maps and weights are numpy float64 on the host, computed once
per size exactly as in the JAX package (the sphere point set is the same
Fibonacci lattice), then kept on the device.  The sums run on the device in
float32, as the JAX package's do (it runs without x64, so its float64 casts
are float32); their reduction order is the device's, so a value may differ
from the JAX package's in the last bits (within 1e-3 dB).  MS-SSIM is
float64 numpy/scipy on the host, as in the JAX package.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import resolve_device


def _planes(orig, recon, device):
    dev = resolve_device(device)
    return (torch.as_tensor(np.asarray(orig) if not torch.is_tensor(orig)
                            else orig, device=dev).to(torch.int32),
            torch.as_tensor(np.asarray(recon) if not torch.is_tensor(recon)
                            else recon, device=dev).to(torch.int32))


@functools.lru_cache(maxsize=None)
def _on_device(key: tuple, device: torch.device):
    """A cached host map (key: (builder, *args, index)) as a device
    tensor."""
    fn, *args, i = key
    arr = fn(*args)
    return torch.as_tensor(np.ascontiguousarray(
        arr if i is None else arr[i]), device=device)


def _psnr_db(mse: torch.Tensor, bit_depth: int) -> float:
    maxv = (1 << bit_depth) - 1
    num = torch.tensor(float(maxv * maxv), dtype=torch.float32,
                       device=mse.device)
    return float(10.0 * torch.log10(num / torch.clamp(mse, min=1e-10)))


@functools.lru_cache(maxsize=None)
def _ws_weights(height: int) -> np.ndarray:
    """Per-row cos(theta) weights (reference: TWSPSNRMetricCalc ERP
    weights w(i) = cos((i + 0.5 - H/2) * pi / H))."""
    i = np.arange(height, dtype=np.float64)
    return np.cos((i + 0.5 - height / 2.0) * math.pi / height)


def ws_psnr(orig, recon, bit_depth: int = 8, device=None) -> float:
    """WS-PSNR of one ERP plane."""
    o, r = _planes(orig, recon, device)
    h, w = o.shape
    wts = _on_device((_ws_weights, h, None), o.device).to(
        torch.float32)[:, None]
    d = (o - r).to(torch.float32)
    wse = torch.sum(d * d * wts) / (torch.sum(wts) * w)
    return _psnr_db(wse, bit_depth)


@functools.lru_cache(maxsize=None)
def fibonacci_sphere(n: int = 655362) -> np.ndarray:
    """Quasi-uniform sphere sampling (stand-in for 360Lib's
    sphere_655362.txt): (n, 2) theta in [0, pi], phi in [-pi, pi]."""
    i = np.arange(n, dtype=np.float64)
    golden = (1 + 5 ** 0.5) / 2
    z = 1 - 2 * (i + 0.5) / n
    theta = np.arccos(np.clip(z, -1, 1))
    phi = 2 * math.pi * i / golden
    return np.stack([theta, np.mod(phi + math.pi, 2 * math.pi) - math.pi],
                    axis=1)


@functools.lru_cache(maxsize=None)
def _sphere_to_erp_nn(n_points: int, width: int, height: int
                      ) -> np.ndarray:
    """Nearest-neighbour ERP sample indices for the sphere point set
    (reference: TSPSNRMetricCalc nearest-sample lookup)."""
    tp = fibonacci_sphere(n_points)
    x = np.round(-tp[:, 1] / (2 * math.pi) * width - 0.5).astype(np.int64)
    y = np.round(tp[:, 0] / math.pi * height - 0.5).astype(np.int64)
    x = np.mod(x, width)
    y = np.clip(y, 0, height - 1)
    return y * width + x


def s_psnr_nn(orig, recon, bit_depth: int = 8, n_points: int = 65536,
              device=None) -> float:
    """S-PSNR-NN: PSNR over a uniform sphere sampling, nearest
    neighbour."""
    o, r = _planes(orig, recon, device)
    h, w = o.shape
    idx = _on_device((_sphere_to_erp_nn, n_points, w, h, None), o.device)
    d = (o.reshape(-1)[idx] - r.reshape(-1)[idx]).to(torch.float32)
    return _psnr_db(torch.mean(d * d), bit_depth)


@functools.lru_cache(maxsize=None)
def _cpp_map(width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
    """ERP -> Craster parabolic projection sample map and validity mask
    (reference: TCPPPSNRMetricCalc::sphToCart / createTable)."""
    xx, yy = np.meshgrid(np.arange(width, dtype=np.float64),
                         np.arange(height, dtype=np.float64))
    x = (xx + 0.5) / width * 2 - 1            # [-1, 1]
    y = ((yy + 0.5) / height * 2 - 1)         # [-1, 1]
    lat = 3.0 * np.arcsin(np.clip(y / 2.0, -1, 1) * 2 / 3.0)
    valid = np.abs(lat) <= math.pi / 2
    lon = math.pi * x / (2 * np.cos(2 * lat / 3) - 1 + 1e-12)
    valid &= np.abs(lon) <= math.pi
    theta = math.pi / 2 - lat
    phi = -lon
    sx = np.mod(np.round(-phi / (2 * math.pi) * width - 0.5), width)
    sy = np.clip(np.round(theta / math.pi * height - 0.5), 0, height - 1)
    return (sy.astype(np.int64) * width + sx.astype(np.int64),
            valid)


def cpp_psnr(orig, recon, bit_depth: int = 8, device=None) -> float:
    """CPP-PSNR: PSNR in the equal-area Craster parabolic domain."""
    o, r = _planes(orig, recon, device)
    h, w = o.shape
    idx = _on_device((_cpp_map, w, h, 0), o.device).reshape(-1)
    mask = _on_device((_cpp_map, w, h, 1), o.device).reshape(-1).to(
        torch.float32)
    d = (o.reshape(-1)[idx] - r.reshape(-1)[idx]).to(torch.float32)
    mse = torch.sum(d * d * mask) / torch.clamp(torch.sum(mask), min=1)
    return _psnr_db(mse, bit_depth)


@functools.lru_cache(maxsize=None)
def _sphere_to_erp_bilin(n_points: int, width: int, height: int):
    """The four ERP sample indices and the float32 bilinear fractions of
    the sphere point set (reference: TSPSNRIMetricCalc — S-PSNR-I
    interpolates instead of snapping to the nearest sample)."""
    tp = fibonacci_sphere(n_points)
    x = -tp[:, 1] / (2 * math.pi) * width - 0.5
    y = tp[:, 0] / math.pi * height - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0).astype(np.float32)
    fy = (y - y0).astype(np.float32)
    idx = []
    for dy in (0, 1):
        for dx in (0, 1):
            xi = np.mod(x0 + dx, width)
            yi = np.clip(y0 + dy, 0, height - 1)
            idx.append(yi * width + xi)
    return np.stack(idx), fx, fy


def s_psnr_i(orig, recon, bit_depth: int = 8, n_points: int = 65536,
             device=None) -> float:
    """S-PSNR-I: PSNR over a uniform sphere sampling with bilinear
    interpolation (reference: TSPSNRIMetricCalc.cpp)."""
    o, r = _planes(orig, recon, device)
    h, w = o.shape
    key = (_sphere_to_erp_bilin, n_points, w, h)
    idx = _on_device(key + (0,), o.device)
    fx = _on_device(key + (1,), o.device)
    fy = _on_device(key + (2,), o.device)
    wts = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy),
                       (1 - fx) * fy, fx * fy])

    def interp(plane):
        flat = plane.reshape(-1).to(torch.float32)
        return torch.sum(flat[idx] * wts, dim=0)

    d = interp(o) - interp(r)
    return _psnr_db(torch.mean(d * d), bit_depth)


# default dynamic-viewport trajectory (reference: TViewPortPSNR — the CTC
# uses two 75x75-degree viewports; yaw drifts over the sequence)
DEFAULT_VIEWPORTS = ((0.0, 0.0), (-90.0, 0.0))


def viewport_psnr(orig, recon, bit_depth: int = 8, fov_deg: float = 75.0,
                  size: tuple[int, int] = (128, 128),
                  viewports=DEFAULT_VIEWPORTS, device=None) -> float:
    """Viewport PSNR: render rectilinear viewports from both ERP planes and
    average their PSNR (reference: TViewPortPSNR.cpp)."""
    from .geometry import render_viewport
    from ..utils.content import psnr as plane_psnr
    vals = []
    for (yaw, pitch) in viewports:
        vo = render_viewport(orig, size[1], size[0], fov_deg, yaw, pitch,
                             method="bilinear", device=device)
        vr = render_viewport(recon, size[1], size[0], fov_deg, yaw, pitch,
                             method="bilinear", device=device)
        vals.append(plane_psnr(vo, vr, bit_depth))
    return float(np.mean(vals))


def _ssim(a: np.ndarray, b: np.ndarray, maxv: float):
    """Single-scale SSIM and contrast-structure (cs) with an 11x11
    separable Gaussian window — numpy, float64."""
    from scipy.ndimage import convolve1d
    sigma, rad = 1.5, 5
    xs = np.arange(-rad, rad + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2 * sigma * sigma))
    k /= k.sum()

    def filt(x):
        return convolve1d(convolve1d(x, k, axis=0, mode="reflect"),
                          k, axis=1, mode="reflect")

    c1 = (0.01 * maxv) ** 2
    c2 = (0.03 * maxv) ** 2
    mu_a, mu_b = filt(a), filt(b)
    saa = filt(a * a) - mu_a * mu_a
    sbb = filt(b * b) - mu_b * mu_b
    sab = filt(a * b) - mu_a * mu_b
    cs = (2 * sab + c2) / (saa + sbb + c2)
    ssim = ((2 * mu_a * mu_b + c1) / (mu_a * mu_a + mu_b * mu_b + c1)) * cs
    return ssim.mean(), cs.mean()


MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(orig, recon, bit_depth: int = 8) -> float:
    """MS-SSIM (5 dyadic scales, Wang et al. weights) — the reference
    encoder's optional quality metric (reference: EncGOP
    xCalculateAddPSNR MS-SSIM path); float64 on the host."""
    a = np.asarray(orig, dtype=np.float64)
    b = np.asarray(recon, dtype=np.float64)
    maxv = float((1 << bit_depth) - 1)
    vals = []
    for lvl in range(5):
        s, cs = _ssim(a, b, maxv)
        vals.append(s if lvl == 4 else cs)
        if lvl < 4:
            h2, w2 = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
            a = a[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean((1, 3))
            b = b[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean((1, 3))
    vals = np.clip(np.asarray(vals), 1e-6, None)
    return float(np.prod(vals ** np.asarray(MS_SSIM_WEIGHTS)))


def metrics_360(orig, recon, bit_depth: int = 8, viewport: bool = False,
                device=None) -> dict:
    """All 360 metrics of one luma plane, on `device` (CUDA unless another
    is named; reference: TExt360EncGop per-POC metric block,
    EncGOP.cpp:4960-5060)."""
    o, r = _planes(orig, recon, device)
    out = dict(ws_psnr=ws_psnr(o, r, bit_depth, o.device),
               s_psnr_nn=s_psnr_nn(o, r, bit_depth, device=o.device),
               s_psnr_i=s_psnr_i(o, r, bit_depth, device=o.device),
               cpp_psnr=cpp_psnr(o, r, bit_depth, o.device))
    if viewport:
        out["viewport_psnr"] = viewport_psnr(o, r, bit_depth,
                                             device=o.device)
    return out
