"""Decoder CLI of the PyTorch port: the JAX package's apps/decoder_app.py
options and output (MD5 lines, --BitStats, --CacheModel, --TraceFile,
--FilmGrain, --OutputBitDepth, the HRD CPB check), plus --Device and
--Profile (the stage timers, seconds by picture kind and host waits by
stage, utils/profiling.py).

The analog of the reference DecoderApp (reference:
source/App/DecoderApp/decmain.cpp:51 main; DecApp.cpp:143-355 NAL loop;
xWriteOutput:739 DPB-ordered YUV writing; per-picture MD5 like the
decoded-picture-hash check DecLib.cpp:868).

Usage:
  python -m vvc_mm_tpu_torch.apps.decoder_app -b in.bin -o out.yuv

It decodes on the CUDA device unless --Device names another.
"""
from __future__ import annotations

import sys
import time

from ..decoder.declib import DecLib
from ..utils import profiling
from ..utils.options import OptionParser
from ..utils.yuv_io import VideoFormat, YuvWriter


def build_parser() -> OptionParser:
    p = OptionParser()
    p.add("BitstreamFile", "", "input bitstream")
    p.add("ReconFile", "", "output YUV")
    p.add("OutputBitDepth", 0, "0 = keep internal")
    p.add("BitStats", False, "per-syntax bit statistics (analyser mode)")
    p.add("CacheModel", False, "reference-bandwidth cache model "
          "(JVET-J0090 analog: direct-mapped line cache over MC reads)")
    p.add("TraceFile", "", "dtrace-analog event log file")
    p.add("TraceRule", "motion_model,mvd", "comma-separated trace "
          "channels (dtrace channel:condition rules)")
    p.add("FilmGrain", False, "apply film-grain SEI on output (reference: "
          "SEIFilmGrainApp / DecApp FGS post-filter)")
    p.add("Device", "", "torch device to decode on (empty = the CUDA "
          "device; cpu for tests)")
    p.add("Profile", False, "per-stage decoder timers (parse, recon, "
          "filters, hash; serializes the pipeline), seconds by picture "
          "kind and host waits by stage; also VVC_PROFILE=1")
    return p


def main(argv: list[str] | None = None) -> int:
    opts = build_parser().parse(sys.argv[1:] if argv is None else argv)
    if not opts["BitstreamFile"]:
        raise SystemExit("need -b bitstream.bin (see --help)")
    with open(opts["BitstreamFile"], "rb") as f:
        data = f.read()
    profile = opts["Profile"] or profiling.ENABLED
    if profile:
        profiling.enable()
    t0 = time.time()
    stats = None
    if opts["BitStats"]:
        from ..utils.trace import BitStats
        stats = BitStats()
    cache = None
    if opts["CacheModel"]:
        from ..utils.cache_model import CacheModel
        cache = CacheModel()
    trace = None
    if opts["TraceFile"]:
        from ..utils.trace import enable_trace
        trace = enable_trace(opts["TraceRule"].split(","),
                             opts["TraceFile"])
    dec = DecLib(device=opts["Device"] or None, stats=stats,
                 cache_model=cache)
    frames = dec.decode_bytes(data)
    if trace is not None:
        from ..utils.trace import disable_trace
        disable_trace()
    dt = time.time() - t0
    sps = dec.sps
    if sps is None or not frames:
        raise SystemExit(f"{opts['BitstreamFile']}: no decodable pictures "
                         "(not a vvc_mm_tpu bitstream?)")
    for fr in frames:
        status = dec.hash_status.get(fr.poc, "")
        suffix = f" ({status})" if status else ""
        print(f"POC {fr.poc:4d} [MD5:{fr.md5(sps.bit_depth)}]{suffix}")
    if any(v != "OK" for v in dec.hash_status.values()):
        print("WARNING: decoded-picture-hash mismatch detected")
    print(f"decoded {len(frames)} pictures ({sps.width}x{sps.height}) "
          f"in {dt:.2f}s ({len(frames) / max(dt, 1e-9):.2f} fps)")
    if stats is not None:
        print(stats.report())
    if cache is not None:
        print(cache.report())
    if profile:
        spans, _ = profiling.take_spans()
        profiling.enable(False)
        print(profiling.report(spans))
    if sps.hrd is not None:
        # CPB conformance: leaky-bucket check of the signaled HRD params
        # (reference: the HRD's CPB arrival/removal model, HRD.h; a
        # picture whose removal would underflow the CPB is a violation)
        hrd = sps.hrd
        rate_per_pic = (hrd.bit_rate_kbps * 1000.0
                        * hrd.num_units_in_tick / max(hrd.time_scale, 1))
        cpb_size = hrd.cpb_size_kbits * 1000.0
        fullness = cpb_size            # start with a full buffer
        violations = 0
        for poc in sorted(dec.picture_bits):
            fullness = min(fullness + rate_per_pic, cpb_size)
            fullness -= dec.picture_bits[poc]
            if fullness < 0:
                violations += 1
                fullness = 0.0
        print(f"HRD: CPB {hrd.cpb_size_kbits} kbit @ "
              f"{hrd.bit_rate_kbps} kbps -> "
              + ("conformant" if violations == 0
                 else f"{violations} CPB underflow(s)"))
    if opts["ReconFile"] and frames:
        fmt = VideoFormat(sps.width, sps.height, sps.bit_depth,
                          sps.chroma_format)
        wr = YuvWriter(opts["ReconFile"], fmt)
        for fr in dec.output_frames():    # LMCS inverse-mapped if active
            planes = fr.numpy()           # host copies of the planes
            if opts["FilmGrain"] and dec.film_grain is not None:
                from ..common.film_grain import apply_grain
                planes = apply_grain(planes, dec.film_grain, fr.poc,
                                     sps.bit_depth)
            wr.write_frame(planes)
        wr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
