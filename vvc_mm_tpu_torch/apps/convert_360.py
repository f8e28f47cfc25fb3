"""360ConvertApp analog: standalone projection-format converter.

The PyTorch port's copy of the JAX package's apps/convert_360.py: the
resampling runs in the port's lib360/geometry.py, on the card unless
--Device names another.

Reference: source/App/utils/360ConvertApp (360ConvertApp.cpp:43) — reads a
YUV sequence in one projection geometry, resamples every frame through the
unit sphere into another geometry (TGeometry::geoConvert), writes YUV.

Usage:
  python -m vvc_mm_tpu_torch.apps.convert_360 -i in.yuv -o out.yuv \
      -wdt 2048 -hgt 1024 --src erp --dst eac -ow 1536 -oh 1024 \
      [--method lanczos3] [--frames N] [--viewport FOV,YAW,PITCH]

Geometries: erp cmp eac acp gcmp hec eap aep cpp ssp ecp rsp fisheye
(lib360/geometry.py GEOMETRIES), plus a rectilinear viewport render.
"""
from __future__ import annotations

import sys

import numpy as np

from ..common.typedefs import ChromaFormat
from ..lib360 import geometry
from ..utils.yuv_io import VideoFormat, YuvReader, YuvWriter


def convert_frame(planes, src, dst, out_size, method, device=None):
    oh, ow = out_size
    out = []
    for i, p in enumerate(planes):
        scale = 1 if i == 0 else 2
        size = (oh // scale, ow // scale)
        out.append(geometry.geo_convert(p.astype(np.int32), src, dst, size,
                                        method=method, device=device
                                        ).astype(p.dtype))
    return out


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)

    def opt(name, default=None, cast=str):
        if name in args:
            i = args.index(name)
            v = cast(args[i + 1])
            del args[i:i + 2]
            return v
        return default

    inp = opt("-i")
    out = opt("-o")
    w = opt("-wdt", cast=int)
    h = opt("-hgt", cast=int)
    src = opt("--src", "erp")
    dst = opt("--dst", "eac")
    ow = opt("-ow", w, int)
    oh = opt("-oh", h, int)
    method = opt("--method", "lanczos3")
    nframes = opt("--frames", 0, int)
    bd = opt("--bitdepth", 8, int)
    vp = opt("--viewport")
    device = opt("--Device")
    if not all([inp, out, w, h]):
        raise SystemExit(__doc__)
    fmt = VideoFormat(w, h, bd, ChromaFormat.C420)
    reader = YuvReader(inp, fmt)
    wfmt = VideoFormat(ow, oh, bd, ChromaFormat.C420)
    writer = YuvWriter(out, wfmt)
    n = 0
    while True:
        planes = reader.read_frame()
        if planes is None or (nframes and n >= nframes):
            break
        if vp:
            fov, yaw, pitch = (float(x) for x in vp.split(","))
            planes = [geometry.render_viewport(
                p.astype(np.int32), ow // (1 if i == 0 else 2),
                oh // (1 if i == 0 else 2), fov, yaw, pitch,
                method=method, device=device).astype(p.dtype)
                for i, p in enumerate(planes)]
        else:
            planes = convert_frame(planes, src, dst, (oh, ow), method,
                                   device)
        writer.write_frame(planes)
        n += 1
    reader.close()
    writer.close()
    print(f"converted {n} frames {src}({w}x{h}) -> "
          f"{'viewport' if vp else dst}({ow}x{oh}) [{method}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
