"""Encoder CLI of the PyTorch port: the JAX package's apps/encoder_app.py
options, log lines and reconstruction output, plus --Device.

The analog of the reference EncoderApp (reference:
source/App/EncoderApp/encmain.cpp:83 main; EncAppCfg.cpp:1013-1020 the MM
options --MPA/--3DT/--TAN/--ROT/--GED/--GEDA/--MMMVP/--Epipole;
EncApp.cpp:1522 encodePrep frame loop; per-POC log lines + summary like
EncGOP.cpp:4767/printOutSummary:4244).

Usage:
  python -m vvc_mm_tpu_torch.apps.encoder_app -c cfg/encoder_randomaccess.cfg \
      -i in.yuv -b out.bin -o rec.yuv -wdt 416 -hgt 240 -f 8 -q 37

It encodes on the CUDA device unless --Device names another (--Device=cpu
for tests); without a card and without --Device it raises.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from ..common.slice_ps import MMConfig
from ..common.typedefs import ChromaFormat, GeodesicFlavor, ProjectionID
from ..device import resolve_device
from ..encoder.enclib import EncCfg, EncLib
from ..utils import profiling
from ..utils.options import OptionParser, parse_epipole
from ..utils.yuv_io import VideoFormat, YuvReader, YuvWriter


def build_parser() -> OptionParser:
    p = OptionParser()
    p.add("InputFile", "", "input YUV file")
    p.add("BitstreamFile", "", "output bitstream")
    p.add("ReconFile", "", "output reconstruction YUV")
    p.add("SourceWidth", 0, "frame width")
    p.add("SourceHeight", 0, "frame height")
    p.add("InputBitDepth", 8, "input bit depth")
    p.add("InputChromaFormat", 420, "400/420/422/444")
    p.add("FramesToBeEncoded", 0, "0 = all")
    p.add("FrameSkip", 0, "frames to skip at start")
    p.add("QP", 32, "base quantization parameter")
    p.add("RateControl", False, "enable lambda-domain rate control")
    p.add("TargetBitrate", 0, "target bitrate in bps")
    p.add("FrameRate", 30, "frames per second")
    p.add("IntraPeriod", -1, "IDR period (-1 = only first)")
    p.add("GOPSize", 8, "RA mini-GOP size")
    p.add("DecodingRefreshType", 1, "")
    p.add("Profile", "main", "")
    p.add("GOP", "RA", "AI | LDP | RA")
    p.add("SearchRange", 24, "ME search range")
    p.add("CTUSize", 16, "inter top block size (quadtree root)")
    p.add("QTDepth", 0, "inter quadtree split depth (0 = fixed grid)")
    p.add("Affine", False, "4-param affine motion (classic fixed grid)")
    p.add("LMCS", False, "luma mapping with reshaper (LMCS analog)")
    p.add("BDOF", False, "bi-directional optical flow (BIO)")
    p.add("DMVR", False, "decoder-side motion vector refinement")
    p.add("DepQuant", False, "dependent quantization (trellis, DQ)")
    p.add("RDOQ", False, "rate-distortion-optimized quantization "
          "(encoder-only level decision)")
    p.add("CCLM", False, "cross-component linear-model chroma prediction")
    p.add("MIP", False, "matrix-based intra prediction")
    p.add("LFNST", False, "low-frequency non-separable secondary transform")
    p.add("MRL", False, "multi-reference-line intra prediction")
    p.add("IntraSplit", False, "two-level intra partitioning (16 vs 8x8)")
    p.add("MaxNumRef", 2, "active references per list (plain P path)")
    p.add("TMVP", False, "temporal + history-based MV prediction")
    p.add("Merge", True, "merge/skip candidate list (merge_flag/merge_idx)")
    p.add("Log2ParallelMergeLevel", 2, "merge-estimation region size "
          "(log2; reference: sps_log2_parallel_merge_level)")
    p.add("IMV", False, "adaptive MV resolution (AMVR; reference --IMV)")
    p.add("MTS", False, "explicit multiple transform selection (intra)")
    p.add("MCTSTiles", "", "cols,rows: motion-constrained tile sets")
    p.add("WPP", False, "entropy substreams with entry points (WPP/tiles)")
    p.add("WeightedPredP", False, "explicit weighted prediction (P)")
    p.add("WeightedPredB", False,
          "explicit weighted prediction (B, per-list tables)")
    p.add("TransformSkip", False, "per-block transform skip")
    p.add("BDPCM", False, "block DPCM on transform-skip blocks")
    p.add("FilmGrain", False, "film grain characteristics SEI (analyzer)")
    p.add("Lossless", False, "lossless intra coding (all-TS, qStep 1)")
    p.add("Profile", False, "per-stage encoder timers (INTERPRED_PROFILING "
          "analog; serializes the pipeline), seconds by picture kind and "
          "host waits by stage; also VVC_PROFILE=1")
    p.add("NumSubstreams", 4, "substream count for --WPP")
    p.add("WrapAround", False, "ERP horizontal wrap-around")
    p.add("Deblocking", True, "in-loop deblocking")
    p.add("SphereVideo", False, "enable 360 metrics")
    p.add("TemporalFilter", False, "MCTF GOP-based pre-filter "
          "(reference: --TemporalFilter, EncTemporalFilter)")
    # multi-model motion (reference: EncAppCfg.cpp:1013-1020)
    p.add("MPA", False, "motion-plane-adaptive models")
    p.add("3DT", False, "3-D translational model")
    p.add("TAN", False, "tangential model")
    p.add("ROT", False, "rotational model")
    p.add("GED", False, "geodesic (camera pose) model")
    p.add("GEDA", False, "geodesic fixed-axis models")
    p.add("GEDFlavor", 1, "0 original / 1 modulated")
    p.add("MMMVP", False, "multi-model MVP")
    p.add("MMOffset4x4", 1, "subblock center offset code (4 -> 1.5)")
    p.add("Projection", 3, "0 equisolid/2 perspective/3 ERP")
    p.add("Epipole", [], "curPOC,refPOC,x,y,z (repeatable)",
          parse=parse_epipole)
    p.add("Device", "", "torch device to encode on (empty = the CUDA "
          "device; cpu for tests)")
    return p


def main(argv: list[str] | None = None) -> int:
    opts = build_parser().parse(sys.argv[1:] if argv is None else argv)
    if not opts["InputFile"] or not opts["BitstreamFile"]:
        raise SystemExit("need -i input.yuv and -b out.bin (see --help)")
    w, h = opts["SourceWidth"], opts["SourceHeight"]
    if not w or not h:
        raise SystemExit("need -wdt/-hgt (SourceWidth/SourceHeight)")

    mm = MMConfig(
        mpa=opts["MPA"], t3d=opts["3DT"], tan=opts["TAN"], rot=opts["ROT"],
        ged=opts["GED"], geda=opts["GEDA"],
        ged_flavor=GeodesicFlavor(opts["GEDFlavor"]), mmmvp=opts["MMMVP"],
        mm_offset_4x4=opts["MMOffset4x4"],
        projection=ProjectionID(opts["Projection"]))
    cfg = EncCfg(width=w, height=h, bit_depth=opts["InputBitDepth"],
                 qp=opts["QP"], gop=opts["GOP"],
                 intra_period=max(opts["IntraPeriod"], 0),
                 gop_size=opts["GOPSize"], search_range=opts["SearchRange"],
                 inter_block_size=opts["CTUSize"], qt_depth=opts["QTDepth"],
                 affine=opts["Affine"],
                 wrap_around=opts["WrapAround"],
                 deblocking=opts["Deblocking"], mm=mm,
                 epipoles=list(opts["Epipole"]),
                 metrics_360=opts["SphereVideo"],
                 mctf=opts["TemporalFilter"], lmcs=opts["LMCS"],
                 bdof=opts["BDOF"], dmvr=opts["DMVR"],
                 dep_quant=opts["DepQuant"], rdoq=opts["RDOQ"],
                 cclm=opts["CCLM"],
                 mip=opts["MIP"], lfnst=opts["LFNST"], mrl=opts["MRL"],
                 tmvp=opts["TMVP"], merge=opts["Merge"],
                 intra_split=opts["IntraSplit"],
                 max_num_ref=opts["MaxNumRef"],
                 log2_parallel_merge_level=opts["Log2ParallelMergeLevel"],
                 amvr=opts["IMV"], mts=opts["MTS"],
                 mcts_tiles=(tuple(int(x) for x in
                                   opts["MCTSTiles"].split(","))
                             if opts["MCTSTiles"] else ()), wpp=opts["WPP"],
                 weighted_pred=opts["WeightedPredP"],
                 weighted_bipred=opts["WeightedPredB"],
                 transform_skip=opts["TransformSkip"],
                 bdpcm=opts["BDPCM"], lossless=opts["Lossless"],
                 film_grain=opts["FilmGrain"],
                 num_substreams=opts["NumSubstreams"],
                 target_bitrate_kbps=(opts["TargetBitrate"] // 1000
                                      if opts["RateControl"] else 0),
                 frame_rate=float(opts["FrameRate"]))

    if opts["InputChromaFormat"] != 420:
        # the coding pipeline is 4:2:0-only (CHROMA_SCALE assumptions in
        # the transform/MC paths); reject other formats with a clear error
        # instead of miscoding (reference supports 400/422/444 via
        # ChromaFormat-generic ops — a later generalization here)
        raise SystemExit(
            f"InputChromaFormat {opts['InputChromaFormat']} is not "
            "supported: this encoder codes 4:2:0 only. Convert the input "
            "(e.g. ffmpeg -pix_fmt yuv420p) or use --InputChromaFormat "
            "420.")
    fmt = VideoFormat(w, h, opts["InputBitDepth"], ChromaFormat.C420)
    reader = YuvReader(opts["InputFile"], fmt)
    if opts["FrameSkip"]:
        reader.skip_frames(opts["FrameSkip"])
    n = reader.num_frames - opts["FrameSkip"]
    if opts["FramesToBeEncoded"]:
        n = min(n, opts["FramesToBeEncoded"])
    frames = [reader.read_frame() for _ in range(n)]
    reader.close()

    profile = opts["Profile"] or profiling.ENABLED
    if profile:
        profiling.enable()
    device = resolve_device(opts["Device"] or None)
    print(f"vvc_mm_tpu encoder: {w}x{h} {n} frames QP{opts['QP']} "
          f"GOP={opts['GOP']} MM={'on' if mm.any_enabled() else 'off'}")
    t0 = time.time()
    enc = EncLib(cfg, device=device)
    stream = enc.encode_sequence(frames)
    with open(opts["BitstreamFile"], "wb") as f:
        f.write(stream)
    for r in enc.results:
        extra = ""
        if r.metrics_360:
            extra = (f" WS {r.metrics_360['ws_psnr']:6.3f}"
                     f" S-NN {r.metrics_360['s_psnr_nn']:6.3f}")
        print(f"POC {r.poc:4d} [{r.bits:8d} bits] "
              f"Y {r.psnr_y:6.3f} U {r.psnr_u:6.3f} V {r.psnr_v:6.3f} dB"
              + extra)
    s = enc.summary()
    dt = time.time() - t0
    print(f"SUMMARY: {s['frames']} frames, {s['bits']} bits, "
          f"Y {s['psnr_y']:.3f} U {s['psnr_u']:.3f} V {s['psnr_v']:.3f} dB, "
          f"{s['frames'] / dt:.2f} fps")
    if profile:
        spans, _ = profiling.take_spans()
        profiling.enable(False)
        print(profiling.report(spans))
    if "ws_psnr" in s:
        print(f"360:     WS-PSNR {s['ws_psnr']:.3f}  "
              f"S-PSNR-NN {s['s_psnr_nn']:.3f}  CPP-PSNR {s['cpp_psnr']:.3f}")

    if opts["ReconFile"]:
        wr = YuvWriter(opts["ReconFile"], fmt)
        for r in enc.results:
            wr.write_frame(r.output)      # display domain (LMCS inverse)
        wr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
