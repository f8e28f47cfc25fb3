"""Bjontegaard-delta harness: BD-rate / BD-PSNR between two encoder

The PyTorch port's copy of the JAX package's apps/bd_rate.py: the
encodes run the port's EncLib, on the card unless --Device names
another.
configurations over a QP ladder.

This is the compensating methodology for the deliberate non-conformant
HLS decision (see README "Conformance posture"): because the bitstream
syntax is self-defined (not VVC-decodable), compression claims are made
as BD-rate *against this codec's own anchors* — tool-on vs tool-off on
the same content — exactly how the reference extension reports its gains
vs VTM (the cited paper's tables are BD-rate vs the VTM anchor).

Usage:
  python -m vvc_mm_tpu_torch.apps.bd_rate --Width=128 --Height=64 --Frames=4 \
      --GOP=LDP --QPs=32,37,42 --Tool=tmvp
prints the BD-rate (%) of tool-on vs tool-off.
"""
from __future__ import annotations

import sys

import numpy as np

from ..common.typedefs import ChromaFormat
from ..encoder.enclib import EncCfg, EncLib
from ..utils.options import OptionParser
from ..utils.yuv_io import VideoFormat, YuvReader, synthetic_sequence


def bd_rate(r1, p1, r2, p2) -> float:
    """Bjontegaard delta-rate (%) of curve 2 vs curve 1 (negative =
    curve 2 needs fewer bits at equal quality).  Piecewise-cubic fit of
    log-rate over PSNR, integrated over the overlapping PSNR range (the
    standard BD metric, VCEG-M33)."""
    lr1, lr2 = np.log(np.asarray(r1, float)), np.log(np.asarray(r2, float))
    p1 = np.asarray(p1, float)
    p2 = np.asarray(p2, float)
    c1 = np.polyfit(p1, lr1, min(3, len(p1) - 1))
    c2 = np.polyfit(p2, lr2, min(3, len(p2) - 1))
    lo = max(p1.min(), p2.min())
    hi = min(p1.max(), p2.max())
    if hi <= lo:
        return float("nan")
    i1 = np.polyint(c1)
    i2 = np.polyint(c2)
    avg1 = (np.polyval(i1, hi) - np.polyval(i1, lo)) / (hi - lo)
    avg2 = (np.polyval(i2, hi) - np.polyval(i2, lo)) / (hi - lo)
    return float((np.exp(avg2 - avg1) - 1.0) * 100.0)


def bd_psnr(r1, p1, r2, p2) -> float:
    """Bjontegaard delta-PSNR (dB) of curve 2 vs curve 1."""
    lr1, lr2 = np.log(np.asarray(r1, float)), np.log(np.asarray(r2, float))
    p1 = np.asarray(p1, float)
    p2 = np.asarray(p2, float)
    c1 = np.polyfit(lr1, p1, min(3, len(p1) - 1))
    c2 = np.polyfit(lr2, p2, min(3, len(p2) - 1))
    lo = max(lr1.min(), lr2.min())
    hi = min(lr1.max(), lr2.max())
    if hi <= lo:
        return float("nan")
    i1 = np.polyint(c1)
    i2 = np.polyint(c2)
    avg1 = (np.polyval(i1, hi) - np.polyval(i1, lo)) / (hi - lo)
    avg2 = (np.polyval(i2, hi) - np.polyval(i2, lo)) / (hi - lo)
    return float(avg2 - avg1)


def rd_curve(frames, base_cfg: EncCfg, qps, device=None, **overrides):
    """(rates, psnrs) over the QP ladder for base_cfg (+overrides), the
    port's EncLib on `device` (CUDA unless another is named)."""
    import copy
    rates, psnrs = [], []
    for qp in qps:
        cfg = copy.deepcopy(base_cfg)
        cfg.qp = qp
        for k, v in overrides.items():
            setattr(cfg, k, v)
        enc = EncLib(cfg, device=device)
        enc.encode_sequence(frames)
        s = enc.summary()
        rates.append(s["bits"])
        psnrs.append(float(s["psnr_y"]))
    return rates, psnrs


def build_parser() -> OptionParser:
    p = OptionParser()
    p.add("InputFile", "", "input YUV (empty = synthetic clip)")
    p.add("Width", 128, "frame width")
    p.add("Height", 64, "frame height")
    p.add("Frames", 4, "frames to encode")
    p.add("GOP", "LDP", "AI | LDP | RA")
    p.add("QPs", "32,37,42", "comma-separated QP ladder")
    p.add("Tool", "merge", "EncCfg boolean attribute to A/B")
    p.add("Device", "", "torch device to encode on (empty = the CUDA "
          "device; cpu for tests)")
    return p


def main(argv: list[str] | None = None) -> int:
    opts = build_parser().parse(sys.argv[1:] if argv is None else argv)
    w, h = opts["Width"], opts["Height"]
    fmt = VideoFormat(w, h, 8, ChromaFormat.C420)
    if opts["InputFile"]:
        rd = YuvReader(opts["InputFile"], fmt)
        frames = [rd.read_frame()
                  for _ in range(min(opts["Frames"], rd.num_frames))]
        rd.close()
    else:
        frames = synthetic_sequence(fmt, opts["Frames"], motion=(3.0, 1.0))
    qps = [int(q) for q in opts["QPs"].split(",")]
    tool = opts["Tool"]
    base = EncCfg(width=w, height=h, gop=opts["GOP"])
    device = opts["Device"] or None
    r_off, p_off = rd_curve(frames, base, qps, device, **{tool: False})
    r_on, p_on = rd_curve(frames, base, qps, device, **{tool: True})
    bdr = bd_rate(r_off, p_off, r_on, p_on)
    bdp = bd_psnr(r_off, p_off, r_on, p_on)
    print(f"anchor ({tool}=off): " + " ".join(
        f"QP{q}:{r}b/{p:.2f}dB" for q, r, p in zip(qps, r_off, p_off)))
    print(f"test   ({tool}=on):  " + " ".join(
        f"QP{q}:{r}b/{p:.2f}dB" for q, r, p in zip(qps, r_on, p_on)))
    print(f"BD-rate {bdr:+.2f}%  BD-PSNR {bdp:+.3f} dB  "
          f"({tool} on vs off)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
