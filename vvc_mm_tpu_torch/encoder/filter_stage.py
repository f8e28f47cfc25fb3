"""Per-frame in-loop filter stage (SAO -> ALF -> chroma ALF -> CC-ALF).

PyTorch counterpart of `vvc_mm_tpu/encoder/filter_stage.py` (reference:
EncGOP.cpp:3495 SAOProcess, EncGOP.cpp:3527 ALFProcess,
EncAdaptiveLoopFilter deriveCcAlfFilterCoeff).  Four device stages with one
packed pull each, so the host waits for the device once per stage:

  A. SAO estimate+apply (3 planes)          -> pull packed params
  B. ALF classify + all Wiener stats        -> pull packed stats
     (host solves the 25 luma + 2 chroma systems)
  C. gated ALF apply + CC-ALF stats         -> pull decisions + cc stats
     (host solves + power-of-two-quantizes the 2 CC-ALF filters)
  D. gated CC-ALF apply                     -> pull decisions

Filter application is bit-identical to the shared enc/dec functions in
common/alf.py / common/sao.py (the decoder re-applies from the signalled
parameters).  The Wiener statistics and the frame gain are exact float64
sums here (common/alf.py says why).
"""
from __future__ import annotations

import numpy as np
import torch

from ..common import alf, sao
from ..common.alf import (COEFF_SHIFT, NUM_CLASSES, NUM_COEFF, NUM_COEFF_C,
                          NUM_COEFF_CC, REGION)


def _rep(en: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return en.repeat_interleave(REGION, 0).repeat_interleave(
        REGION, 1)[:h, :w]


def _grid(h: int, w: int) -> tuple[int, int]:
    return -(-h // REGION), -(-w // REGION)


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).to(torch.float64)


# --------------------------------------------------------------- stage A

def _sao_stage(oy, ry, ou, ru, ov, rv, lam, bit_depth):
    outs, params = [], []
    for o, r in ((oy, ry), (ou, ru), (ov, rv)):
        t, off, bp = sao.estimate_sao(o, r, lam, bit_depth)
        outs.append(sao.apply_sao(r, t, off, bp, bit_depth))
        params += [t.reshape(-1), off.reshape(-1), bp.reshape(-1)]
    packed = torch.cat([p.to(torch.int32) for p in params])
    return outs[0], outs[1], outs[2], packed


# --------------------------------------------------------------- stage B

def _alf_stats_stage(oy, ry, ou, ru, ov, rv, bit_depth):
    cls4 = alf.classify(ry, bit_depth)
    a, b = alf.gather_stats(ry, oy, cls4)
    au, bu = alf._stats_c(ru, ou)
    av, bv = alf._stats_c(rv, ov)
    packed = torch.cat([_f64(x) for x in (a, b, au, bu, av, bv)])
    return cls4, packed


# --------------------------------------------------------------- stage C

def _sq_err(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b).to(torch.float64) ** 2).sum()


def _alf_apply_stage(oy, ry, ou, ru, ov, rv, cls4, cl, cu, cv,
                     use_cu, use_cv, thr_y, lam, bit_depth):
    h, w = ry.shape
    filtered_y = alf.filter_frame(ry, cls4, cl, bit_depth)
    en_y = alf.region_decide(oy, ry, filtered_y, lam, bit_depth)
    gated = torch.where(_rep(en_y, h, w), filtered_y, ry)
    gain = _sq_err(oy, ry) - _sq_err(oy, gated)
    use_y = (gain >= thr_y) & en_y.any()
    y_out = torch.where(use_y, gated, ry)

    chroma = []
    dec = [_f64(use_y), _f64(en_y)]
    for o, r, c, use in ((ou, ru, cu, use_cu), (ov, rv, cv, use_cv)):
        ch, cw = r.shape
        f = alf.filter_chroma(r, c, bit_depth)
        en = alf.region_decide(o, r, f, lam, bit_depth)
        app = en.any() & use
        chroma.append(torch.where(app & _rep(en, ch, cw), f, r))
        dec += [_f64(app), _f64(en)]
    u_out, v_out = chroma

    ccau, ccbu = alf._ccalf_stats(y_out, ou, u_out)
    ccav, ccbv = alf._ccalf_stats(y_out, ov, v_out)
    packed = torch.cat(dec + [_f64(x) for x in (ccau, ccbu, ccav, ccbv)])
    return y_out, u_out, v_out, packed


# --------------------------------------------------------------- stage D

def _ccalf_apply_stage(y, ou, u, ov, v, ccu, ccv, use_u, use_v, lam,
                       bit_depth):
    outs, dec = [], []
    for o, r, c, use in ((ou, u, ccu, use_u), (ov, v, ccv, use_v)):
        ch, cw = r.shape
        filt = alf.filter_ccalf(r, y, c, bit_depth)
        en = alf.region_decide(o, r, filt, lam, bit_depth)
        app = en.any() & use
        outs.append(torch.where(app & _rep(en, ch, cw), filt, r))
        dec += [_f64(app), _f64(en)]
    return outs[0], outs[1], torch.cat(dec)


# ------------------------------------------------------ host side, per frame

def _split(flat, shapes, dtype=np.int32):
    out, off = [], 0
    for s in shapes:
        n = int(np.prod(s))
        out.append(flat[off:off + n].reshape(s).astype(dtype))
        off += n
    return out


def sao_dispatch(recon: dict, dev, lam: float, bit_depth: int):
    """Enqueue the SAO stage; returns device handles (no host wait).
    Pair with sao_finish — lets the caller overlap host work (entropy
    coding) with the device filter chain."""
    ry, ru, rv = recon["y"], recon["u"], recon["v"]
    return _sao_stage(dev[0], ry, dev[1], ru, dev[2], rv, lam, bit_depth)


def sao_finish(recon: dict, handles):
    """Pull the packed SAO params and build the header tuple."""
    y2, u2, v2, packed = handles
    ry, ru, rv = recon["y"], recon["u"], recon["v"]
    flat = packed.cpu().numpy()
    params = []
    off = 0
    any_on = False
    for r in (ry, ru, rv):
        gy, gx = _grid(*r.shape)
        t, o, bp = _split(flat[off:], [(gy, gx), (gy, gx, 4), (gy, gx)])
        off += gy * gx * 6
        if t.any():
            params.append((t, o, bp))
            any_on = True
        else:
            params.append(None)
    if not any_on:
        return recon, None
    return dict(y=y2, u=u2, v=v2), tuple(params)


def run_sao(recon: dict, dev, lam: float, bit_depth: int):
    """Returns (recon, sao_params-or-None) with ONE host wait."""
    return sao_finish(recon, sao_dispatch(recon, dev, lam, bit_depth))


def _solve_chroma(a: np.ndarray, b: np.ndarray):
    a = a + np.eye(NUM_COEFF_C) * (1.0 + float(a.trace()) * 1e-4)
    try:
        c = np.linalg.solve(a, b)
    except np.linalg.LinAlgError:
        return None
    coeffs = np.clip(np.round(c * (1 << COEFF_SHIFT)), -1024, 1023
                     ).astype(np.int32)
    return coeffs if coeffs.any() else None


def _solve_ccalf(a: np.ndarray, b: np.ndarray):
    a = a + np.eye(NUM_COEFF_CC) * (1.0 + float(a.trace()) * 1e-4)
    try:
        c = np.linalg.solve(a, b)
    except np.linalg.LinAlgError:
        return None
    # power-of-two quantization in {-64..64} (reference CC-ALF coeff code)
    cq = np.round(c * (1 << COEFF_SHIFT))
    mag = np.abs(cq)
    p2 = np.where(mag >= 1, 2.0 ** np.round(np.log2(np.maximum(mag, 1))), 0)
    coeffs = (np.sign(cq) * np.clip(p2, 0, 64)).astype(np.int32)
    return coeffs if coeffs.any() else None


def alf_stats_dispatch(recon: dict, dev, bit_depth: int):
    """Enqueue classification + all Wiener statistics (no host wait)."""
    ry, ru, rv = recon["y"], recon["u"], recon["v"]
    return _alf_stats_stage(dev[0], ry, dev[1], ru, dev[2], rv, bit_depth)


def _decisions(flat, off, n_planes, gy, gx):
    out = []
    for _ in range(n_planes):
        app = bool(flat[off] != 0)
        off += 1
        en = (flat[off:off + gy * gx] != 0).reshape(gy, gx)
        off += gy * gx
        out.append((app, en))
    return out, off


def run_alf(recon: dict, dev, lam: float, bit_depth: int,
            stats_handles=None):
    """Full ALF family in 3 host waits.  Returns
    (recon, luma_params, chroma_params, ccalf_params) with the None-able
    tuple shapes the slice header writer expects."""
    ry, ru, rv = recon["y"], recon["u"], recon["v"]
    oy, ou, ov = dev
    tdev = ry.device
    if stats_handles is None:
        stats_handles = alf_stats_dispatch(recon, dev, bit_depth)
    cls4, stats = stats_handles
    flat = stats.cpu().numpy()
    a, b, au, bu, av, bv = _split(
        flat, [(NUM_CLASSES, NUM_COEFF, NUM_COEFF),
               (NUM_CLASSES, NUM_COEFF), (NUM_COEFF_C, NUM_COEFF_C),
               (NUM_COEFF_C,), (NUM_COEFF_C, NUM_COEFF_C), (NUM_COEFF_C,)],
        dtype=np.float64)
    coeffs = alf.solve_coeffs(a, b)
    cu = _solve_chroma(au, bu)
    cv = _solve_chroma(av, bv)
    gy, gx = _grid(*ry.shape)
    coeff_bits = sum(2 * (abs(int(c)).bit_length() + 1)
                     for c in coeffs.reshape(-1)) + gy * gx
    thr_y = float(lam * coeff_bits)
    zc = np.zeros(NUM_COEFF_C, np.int32)

    def t(x):
        return torch.as_tensor(x, device=tdev)

    y3, u3, v3, packed = _alf_apply_stage(
        oy, ry, ou, ru, ov, rv, cls4, t(coeffs),
        t(cu if cu is not None else zc), t(cv if cv is not None else zc),
        cu is not None, cv is not None, thr_y, lam, bit_depth)
    flat = packed.cpu().numpy()
    cgy, cgx = _grid(*ru.shape)
    (dec_y,), off = _decisions(flat, 0, 1, gy, gx)
    use_y, en_y = dec_y
    ch_dec, off = _decisions(flat, off, 2, cgy, cgx)
    ccau, ccbu, ccav, ccbv = _split(
        flat[off:], [(NUM_COEFF_CC, NUM_COEFF_CC), (NUM_COEFF_CC,),
                     (NUM_COEFF_CC, NUM_COEFF_CC), (NUM_COEFF_CC,)],
        dtype=np.float64)

    luma_params = (coeffs, en_y) if use_y else None
    chroma_params = tuple(
        (c, d[1]) if (c is not None and d[0]) else None
        for c, d in zip((cu, cv), ch_dec))
    if all(p is None for p in chroma_params):
        chroma_params = None

    ccu = _solve_ccalf(ccau, ccbu)
    ccv = _solve_ccalf(ccav, ccbv)
    zcc = np.zeros(NUM_COEFF_CC, np.int32)
    if ccu is None and ccv is None:
        return dict(y=y3, u=u3, v=v3), luma_params, chroma_params, None
    u4, v4, packed = _ccalf_apply_stage(
        y3, ou, u3, ov, v3, t(ccu if ccu is not None else zcc),
        t(ccv if ccv is not None else zcc), ccu is not None,
        ccv is not None, lam, bit_depth)
    cc_dec, _ = _decisions(packed.cpu().numpy(), 0, 2, cgy, cgx)
    ccalf_params = tuple(
        (c, d[1]) if (c is not None and d[0]) else None
        for c, d in zip((ccu, ccv), cc_dec))
    if all(p is None for p in ccalf_params):
        ccalf_params = None
    return dict(y=y3, u=u4, v=v4), luma_params, chroma_params, ccalf_params
