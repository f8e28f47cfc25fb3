"""SEIFilmGrainApp analog: decode a bitstream and apply its film-grain SEI.

The PyTorch port's copy of the JAX package's apps/film_grain_app.py: the
port's DecLib (on the card unless --Device names another) and
common/film_grain.py.

Reference: source/App/SEIFilmGrainApp (904 LoC) — decodes, then runs the
SMPTE RDD-5 grain synthesizer parameterized by the fgc SEI, writing the
grained YUV.

Usage:
  python -m vvc_mm_tpu_torch.apps.film_grain_app -b in.bin -o grained.yuv \
      [--Device=cpu]
"""
from __future__ import annotations

import sys

from ..common.film_grain import apply_grain
from ..decoder.declib import DecLib
from ..utils.yuv_io import VideoFormat, YuvWriter


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)

    def opt(name):
        i = args.index(name)
        v = args[i + 1]
        del args[i:i + 2]
        return v

    device = None
    for a in list(args):
        if a.startswith("--Device="):
            device = a.split("=", 1)[1] or None
            args.remove(a)
    bs = opt("-b")
    out = opt("-o")
    dec = DecLib(device=device)
    dec.decode_bytes(open(bs, "rb").read())
    sps = dec.sps
    if sps is None:
        raise SystemExit("no decodable pictures")
    fmt = VideoFormat(sps.width, sps.height, sps.bit_depth,
                      sps.chroma_format)
    wr = YuvWriter(out, fmt)
    n = 0
    for fr in dec.output_frames():
        planes = fr.numpy()
        if dec.film_grain is not None:
            planes = apply_grain(planes, dec.film_grain, fr.poc,
                                 sps.bit_depth)
        wr.write_frame(planes)
        n += 1
    wr.close()
    grain = "with grain" if dec.film_grain is not None else "NO fgc SEI"
    print(f"wrote {n} frames ({grain})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
