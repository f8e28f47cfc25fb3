"""BitrateTargeting analog: offline QP search to hit a target bitrate.

The PyTorch port's copy of the JAX package's apps/bitrate_targeting.py:
the probe encodes run the port's EncLib, on the card unless --Device
names another.

Reference: source/App/utils/BitrateTargeting (1,165 LoC) — guesses lambda
modifiers from trial encodes to land on a target rate.  Here: trial
encodes of a short prefix at probe QPs, a log-linear rate model fit
(ln(bits) is near-linear in QP over the usual range), and the recommended
QP (optionally running the full encode with it).

Usage:
  python -m vvc_mm_tpu_torch.apps.bitrate_targeting -i in.yuv -wdt W -hgt H \
      --TargetBitrate=BPS [-f N] [-b out.bin] [--GOP=RA]
"""
from __future__ import annotations

import math
import sys

from ..common.typedefs import ChromaFormat
from ..encoder.enclib import EncCfg, EncLib
from ..utils.options import OptionParser
from ..utils.yuv_io import VideoFormat, YuvReader

PROBE_QPS = (27, 32, 37)


def fit_qp_for_target(trial: list[tuple[int, int]], target_bits: float
                      ) -> int:
    """Least-squares fit of ln(bits) = a - b*qp; solve for the target."""
    n = len(trial)
    xs = [q for q, _ in trial]
    ys = [math.log(max(b, 1)) for _, b in trial]
    mx, my = sum(xs) / n, sum(ys) / n
    den = sum((x - mx) ** 2 for x in xs) or 1.0
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / den
    if slope >= 0:           # degenerate content; fall back to middle QP
        return xs[len(xs) // 2]
    qp = mx + (math.log(max(target_bits, 1)) - my) / slope
    return int(round(min(max(qp, 1), 51)))


def main(argv: list[str] | None = None) -> int:
    p = OptionParser()
    p.add("InputFile", "", "input YUV")
    p.add("SourceWidth", 0, "width")
    p.add("SourceHeight", 0, "height")
    p.add("FramesToBeEncoded", 0, "0 = all")
    p.add("TargetBitrate", 0, "target bits per second")
    p.add("FrameRate", 30, "fps")
    p.add("GOP", "RA", "AI | LDP | RA")
    p.add("BitstreamFile", "", "optional: run the full encode at the "
          "recommended QP")
    p.add("Device", "", "torch device to encode on (empty = the CUDA "
          "device; cpu for tests)")
    opts = p.parse(sys.argv[1:] if argv is None else argv)
    w, h = opts["SourceWidth"], opts["SourceHeight"]
    if not opts["InputFile"] or not w or not h or not opts["TargetBitrate"]:
        raise SystemExit("need -i/-wdt/-hgt/--TargetBitrate (see --help)")
    device = opts["Device"] or None
    fmt = VideoFormat(w, h, 8, ChromaFormat.C420)
    reader = YuvReader(opts["InputFile"], fmt)
    n = reader.num_frames
    if opts["FramesToBeEncoded"]:
        n = min(n, opts["FramesToBeEncoded"])
    frames = [reader.read_frame() for _ in range(n)]
    reader.close()

    probe = frames[:min(len(frames), 9)]
    target_total = opts["TargetBitrate"] / opts["FrameRate"] * len(frames)
    target_probe = opts["TargetBitrate"] / opts["FrameRate"] * len(probe)
    trial = []
    for q in PROBE_QPS:
        enc = EncLib(EncCfg(width=w, height=h, qp=q, gop=opts["GOP"],
                            gop_size=4, sao=False, alf=False), device=device)
        enc.encode_sequence(probe)
        bits = sum(r.bits for r in enc.results)
        trial.append((q, bits))
        print(f"probe QP{q}: {bits} bits "
              f"({bits * opts['FrameRate'] / len(probe):.0f} bps)")
    qp = fit_qp_for_target(trial, target_probe)
    print(f"recommended QP: {qp} for {opts['TargetBitrate']} bps "
          f"(~{target_total:.0f} bits over {len(frames)} frames)")
    if opts["BitstreamFile"]:
        enc = EncLib(EncCfg(width=w, height=h, qp=qp, gop=opts["GOP"]),
                     device=device)
        stream = enc.encode_sequence(frames)
        with open(opts["BitstreamFile"], "wb") as f:
            f.write(stream)
        bits = sum(r.bits for r in enc.results)
        print(f"final encode: {bits} bits "
              f"({bits * opts['FrameRate'] / len(frames):.0f} bps) "
              f"-> {opts['BitstreamFile']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
