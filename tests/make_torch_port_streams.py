"""Write the committed streams that the PyTorch port's tests and its chip
smoke run decode.

The multi-model streams are ERP at QP37, RA with a GOP of 4 and the CTC
QP cascade, search range 24, horizontal wrap-around, 5 frames of
`bench.realistic_sequence` content.  Three configurations:

  mm       the headline tools (`bench.py:127-129`): MPA+ROT, the MM quadtree
           at depth 1 on P slices;
  mpa      bench configuration 3 (`bench.py:110-112`): MPA only, flat grid;
  fullmm   bench configuration 4 (`bench.py:114-117`): MPA+GED+ROT+MMMVP on
           the flat grid, with the signalled epipole (1, 0, 0, 0, 1); the
           `fullmm_ep` variant signals (4, 0, 0.3, -0.5, 0.8) instead, so
           that the P anchor codes a non-zero picture-header epipole delta
           and a GED rotation that is not the identity;
  allmm_dmvr bench configuration 4 plus the last two motion models and
           projected DMVR: MPA+3DT+TAN+ROT+GED+MMMVP (8 active models) on
           the flat grid with the epipole (1, 0, 0, 0, 1), `dmvr=True`;
  ctcpreset the headline tools with `make_bd_r05.py:75-77`'s "CTC-like
           preset": TMVP, RDOQ, dependent quantization, MTS and LFNST
           (TMVP is inert on multi-model pictures and dependent
           quantization shadows RDOQ, so the I picture carries the new
           tools).

Beside them, the classic (single-model) inter path: no multi-model tool,
no wrap-around, QP37, search range 24, every other `EncCfg` field at its
default, `bench.realistic_sequence` content:

  ra192x96_qp37_9f          RA, GOP 4, 9 frames: POC 8 is a two-reference
                            P anchor, and 96 rows leave a ragged 64-row
                            SAO/ALF region;
  ldp192x96_qp37_4f         LDP, 4 frames: POC 2 and 3 are two-reference
                            P pictures;
  ra192x96_nomerge_qp37_5f  RA, GOP 4, 5 frames, merge off;
  ra832x480_qp37_17f        bench configuration 2 (`bench.py:106-108`,
                            `ra832x480_qp37_encode_fps`): RA, GOP 16, 17
                            frames;
  ra192x96_bdof_dmvr_qp37_9f    RA, GOP 4, 9 frames, with BDOF and DMVR;
  ra832x480_bdof_dmvr_qp37_17f  bench configuration 2 with BDOF and DMVR
                            (the random-access common test conditions turn
                            both on);
  ai416x240_qp37_2f         bench configuration 1 (`bench.py:101-102`,
                            `ai416x240_qp37_encode_fps`): AI, 2 frames;
  ra192x96_ctc_tools_qp37_9f    the random-access tool set: RA, GOP 4, 9
                            frames, TMVP/HMVP, AMVR, GPM, CIIP, BDOF and
                            DMVR (the P anchors take the two-reference
                            merge path with TMVP and AMVR);
  ra832x480_ctc_tools_qp37_17f  bench configuration 2 with that tool set;
  ldp192x96_affine_qp37_4f  LDP, 4 frames, affine (three affine P
                            pictures);
  ldp832x480_affine_qp37_9f bench configuration 2's clip, LDP, 9 frames,
                            affine;
  ra192x96_fade_wp_qp37_9f  a fade (`fade_sequence`, step 0.04) of the
                            clip, RA, GOP 4, 9 frames, weighted prediction
                            on P and B slices with BDOF, DMVR, GPM and CIIP
                            (off on the slices that carry weights);
  ra832x480_fade_wp_qp37_17f    the same at bench configuration 2's size,
                            GOP 16, 17 frames;
  ai192x96_rdoq_ts_bdpcm_qp37_2f  AI, 2 frames, RDOQ (not shadowed),
                            transform skip and BDPCM;
  ai192x96_lfnst_dq_qp37_2f AI, 2 frames, LFNST and dependent
                            quantization without MTS;
  ai192x96_lossless_2f      AI, 2 frames, lossless (QP 4 transform skip,
                            filters off: decoded == source);
  ldp192x96_scaling_qp37_4f LDP, 4 frames, a non-flat scaling list (the
                            steep matrix of tests/test_scaling_list.py,
                            16 + 2 (x + y)): one- and two-reference P;
  ai416x240_tools_qp37_2f   bench configuration 1 with dependent
                            quantization, MTS, LFNST, transform skip and
                            BDPCM;
  ai416x240_lossless_2f     bench configuration 1, lossless;
  ldp832x480_scaling_qp37_9f    bench configuration 2's clip, LDP, 9
                            frames, the steep scaling list;
  ai192x96_intra_pred_tools_qp37_2f  AI, 2 frames, the prediction tools
                            CCLM, MIP, MRL and IBC;
  ai192x96_intra_pred_resid_tools_qp37_2f  the same with dependent
                            quantization, MTS, LFNST, transform skip and
                            BDPCM, on the clip with its left quarter
                            replaced by screen content (the TS/BDPCM pick
                            overrides an IBC and three MRL choices; two of
                            the MRL blocks go to plain transform skip,
                            which the JAX encoder reconstructs from ring 1
                            though it codes no MRL flag, so POC 0's MD5
                            fails in the JAX decoder as in the port's);
  ai64x64_ibc_screen_qp30_1f    AI, 1 frame at QP 30 of screen content
                            (tests/test_ibc.py's tiled glyph, seed 0), the
                            four prediction tools: IBC wins blocks;
  ai416x240_intra_pred_dq_qp37_2f   bench configuration 1 with the four
                            prediction tools and dependent quantization;
  ldp96x64_qt_qp37_4f       the classic quadtree (top 32, depth 2), LDP,
                            4 frames, merge off;
  ra96x64_qt_qp37_5f        the same, RA, GOP 4, 5 frames, merge on;
  ldp64x64_mtt_qp37_4f      the multi-type tree (BT/TT) on that quadtree,
                            LDP, 4 frames, merge off;
  ra64x64_mtt_qp37_5f       the same, RA, GOP 4, 5 frames, merge on;
  ai64x32_intra_split_qp37_2f   AI, 2 frames, the two-level intra
                            partitioning (16x16 or four 8x8);
  ra832x480_qt2_qp37_5f     bench configuration 2's clip with the
                            quadtree (`inter_block_size=32, qt_depth=2`),
                            RA, GOP 4, 5 frames;
  ra832x480_mtt_qp37_5f     the same with `mtt=True`;
  ai416x240_intra_split_qp37_2f bench configuration 1 with
                            `intra_split=True`.

Each intra-prediction sidecar counts the blocks that chose MIP, MRL, CCLM
and IBC, and the blocks whose IBC or MRL choice the transform-skip pick
overrode (counted by the port's encoder, whose stream is checked equal).
Two more sidecars have no stream: `erp2048x1024_ai_ctcpreset_predtools_qp37`
(`... 2048x1024i`), one 2048x1024 I picture of the CTC-like preset with the
four prediction tools, and `erp2048x1024_ai_intra_split_qp37`
(`... 2048x1024s`), one 2048x1024 I picture of the headline configuration
with the two-level intra partitioning: their bits and the SHA-256 of their
IDR NAL, for the chip smoke run's encodes on the card.

Each gets a JSON sidecar with every POC's MD5, the encoder's Y/U/V PSNR
and bits, and the tools it turns on.

    python tests/make_torch_port_streams.py                   # all streams
    python tests/make_torch_port_streams.py 256x128           # one size
    python tests/make_torch_port_streams.py erp256x128_ra_mpa_qp37_5f
    python tests/make_torch_port_streams.py classic           # the 32
    python tests/make_torch_port_streams.py 2048x1024i        # sidecar
    python tests/make_torch_port_streams.py 2048x1024s        # sidecar
    python tests/make_torch_port_streams.py partitioning      # the 8

This script imports the JAX package; pytest does not collect it (its name
does not start with `test_`).
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

OUT_DIR = os.path.join(HERE, "data", "torch_port")
SIZES = {"256x128": (256, 128), "2048x1024": (2048, 1024)}
NUM_FRAMES = 5
QP = 37
# configuration -> (MMConfig fields, qt_depth, epipoles, sizes)
CONFIGS = {
    "mm": (dict(mpa=True, rot=True), 1, [], ("256x128", "2048x1024")),
    "mpa": (dict(mpa=True), 0, [], ("256x128", "2048x1024")),
    "fullmm": (dict(mpa=True, ged=True, rot=True, mmmvp=True), 0,
               [(1, 0, 0.0, 0.0, 1.0)], ("256x128", "2048x1024")),
    "fullmm_ep": (dict(mpa=True, ged=True, rot=True, mmmvp=True), 0,
                  [(4, 0, 0.3, -0.5, 0.8)], ("256x128",)),
    "allmm_dmvr": (dict(mpa=True, t3d=True, tan=True, rot=True, ged=True,
                        mmmvp=True), 0, [(1, 0, 0.0, 0.0, 1.0)],
                   ("256x128", "2048x1024")),
    "ctcpreset": (dict(mpa=True, rot=True), 1, [], ("256x128",
                                                    "2048x1024")),
}
# configurations that also turn on other tools (EncCfg fields): decoder-side
# refinement, the CTC-like preset (make_bd_r05.py:75-77)
TOOLS = {"allmm_dmvr": dict(dmvr=True),
         "ctcpreset": dict(tmvp=True, rdoq=True, dep_quant=True, mts=True,
                           lfnst=True)}


def stream_name(w: int, h: int, config: str = "mm") -> str:
    return f"erp{w}x{h}_ra_{config}_qp37_{NUM_FRAMES}f"


STREAMS = {stream_name(*SIZES[size], config): (config, size)
           for config, (_, _, _, sizes) in CONFIGS.items()
           for size in sizes}
# the random-access tool set of the classic path (VTM's CTC turns these on)
CTC_TOOLS = dict(tmvp=True, amvr=True, gpm=True, ciip=True, bdof=True,
                 dmvr=True)
# weighted prediction on P and B slices beside the B tools it gates per slice
WP_TOOLS = dict(weighted_pred=True, weighted_bipred=True, bdof=True,
                dmvr=True, gpm=True, ciip=True)
# the intra residual tools of bench configuration 1's tool stream
INTRA_TOOLS = dict(dep_quant=True, mts=True, lfnst=True, transform_skip=True,
                   bdpcm=True)
# the I picture's prediction tools (ROADMAP queue 1 items 9d and 9e)
PRED_TOOLS = dict(cclm=True, mip=True, mrl=True, ibc=True)
# a non-flat scaling list: heavier quantization toward high frequencies
# (tests/test_scaling_list.py's STEEP)
STEEP = tuple(int(16 + 2 * (x + y)) for y in range(8) for x in range(8))
# the classic quadtree (top 32, depth 2) and its multi-type tree
QT_TOOLS = dict(inter_block_size=32, qt_depth=2)
MTT_TOOLS = dict(QT_TOOLS, mtt=True)
# classic stream -> (width, height, gop, gop_size, frames, merge, tools)
CLASSIC = {
    "ra192x96_qp37_9f": (192, 96, "RA", 4, 9, True, {}),
    "ldp192x96_qp37_4f": (192, 96, "LDP", 4, 4, True, {}),
    "ra192x96_nomerge_qp37_5f": (192, 96, "RA", 4, 5, False, {}),
    "ra832x480_qp37_17f": (832, 480, "RA", 16, 17, True, {}),
    "ra192x96_bdof_dmvr_qp37_9f": (192, 96, "RA", 4, 9, True,
                                   dict(bdof=True, dmvr=True)),
    "ra832x480_bdof_dmvr_qp37_17f": (832, 480, "RA", 16, 17, True,
                                     dict(bdof=True, dmvr=True)),
    "ai416x240_qp37_2f": (416, 240, "AI", 8, 2, True, {}),
    "ra192x96_ctc_tools_qp37_9f": (192, 96, "RA", 4, 9, True, CTC_TOOLS),
    "ra832x480_ctc_tools_qp37_17f": (832, 480, "RA", 16, 17, True,
                                     CTC_TOOLS),
    "ldp192x96_affine_qp37_4f": (192, 96, "LDP", 4, 4, True,
                                 dict(affine=True)),
    "ldp832x480_affine_qp37_9f": (832, 480, "LDP", 4, 9, True,
                                  dict(affine=True)),
    "ra192x96_fade_wp_qp37_9f": (192, 96, "RA", 4, 9, True, WP_TOOLS),
    "ra832x480_fade_wp_qp37_17f": (832, 480, "RA", 16, 17, True, WP_TOOLS),
    "ai192x96_rdoq_ts_bdpcm_qp37_2f": (192, 96, "AI", 8, 2, True,
                                       dict(rdoq=True, transform_skip=True,
                                            bdpcm=True)),
    "ai192x96_lfnst_dq_qp37_2f": (192, 96, "AI", 8, 2, True,
                                  dict(lfnst=True, dep_quant=True)),
    "ai192x96_lossless_2f": (192, 96, "AI", 8, 2, True,
                             dict(lossless=True)),
    "ldp192x96_scaling_qp37_4f": (192, 96, "LDP", 4, 4, True,
                                  dict(scaling_list=STEEP)),
    "ai416x240_tools_qp37_2f": (416, 240, "AI", 8, 2, True, INTRA_TOOLS),
    "ai416x240_lossless_2f": (416, 240, "AI", 8, 2, True,
                              dict(lossless=True)),
    "ldp832x480_scaling_qp37_9f": (832, 480, "LDP", 4, 9, True,
                                   dict(scaling_list=STEEP)),
    "ai192x96_intra_pred_tools_qp37_2f": (192, 96, "AI", 8, 2, True,
                                          PRED_TOOLS),
    "ai192x96_intra_pred_resid_tools_qp37_2f": (
        192, 96, "AI", 8, 2, True, dict(PRED_TOOLS, **INTRA_TOOLS)),
    "ai64x64_ibc_screen_qp30_1f": (64, 64, "AI", 8, 1, True, PRED_TOOLS),
    "ai416x240_intra_pred_dq_qp37_2f": (416, 240, "AI", 8, 2, True,
                                        dict(PRED_TOOLS, dep_quant=True)),
    "ldp96x64_qt_qp37_4f": (96, 64, "LDP", 4, 4, False, QT_TOOLS),
    "ra96x64_qt_qp37_5f": (96, 64, "RA", 4, 5, True, QT_TOOLS),
    "ldp64x64_mtt_qp37_4f": (64, 64, "LDP", 4, 4, False, MTT_TOOLS),
    "ra64x64_mtt_qp37_5f": (64, 64, "RA", 4, 5, True, MTT_TOOLS),
    "ai64x32_intra_split_qp37_2f": (64, 32, "AI", 8, 2, True,
                                    dict(intra_split=True)),
    "ra832x480_qt2_qp37_5f": (832, 480, "RA", 4, 5, True, QT_TOOLS),
    "ra832x480_mtt_qp37_5f": (832, 480, "RA", 4, 5, True, MTT_TOOLS),
    "ai416x240_intra_split_qp37_2f": (416, 240, "AI", 8, 2, True,
                                      dict(intra_split=True)),
}
# the partitioning streams (ROADMAP queue 1 items 9f and 11)
PARTITIONING = tuple(n for n in CLASSIC if "_qt" in n or "mtt" in n
                     or "intra_split" in n)
# streams at another QP than QP
STREAM_QP = {"ai64x64_ibc_screen_qp30_1f": 30}
# streams of screen content: tests/test_ibc.py's tiled glyph (seed 0)
SCREEN = ("ai64x64_ibc_screen_qp30_1f",)
# streams whose clip has this left fraction of its width screen content
MIXED = {"ai192x96_intra_pred_resid_tools_qp37_2f": 0.25}
# the 2048x1024 I picture of the CTC-like preset (make_bd_r05.py:75-77)
# with the prediction tools: a sidecar without a stream
PRESET_I = "erp2048x1024_ai_ctcpreset_predtools_qp37"
# the 2048x1024 I picture of the headline configuration with the two-level
# intra partitioning: a sidecar without a stream
SPLIT_I = "erp2048x1024_ai_intra_split_qp37"
# streams whose clip is the fade of `bench.realistic_sequence` at this step
FADE = {"ra192x96_fade_wp_qp37_9f": 0.04, "ra832x480_fade_wp_qp37_17f": 0.04}
# the EncCfg tool fields a classic sidecar records
SIDECAR_TOOLS = ("dmvr", "bdof", "tmvp", "amvr", "gpm", "ciip", "affine",
                 "weighted_pred", "weighted_bipred", "rdoq", "dep_quant",
                 "mts", "lfnst", "transform_skip", "bdpcm", "lossless",
                 "cclm", "mip", "mrl", "ibc", "mtt", "intra_split")


def screen_frame(w: int, h: int, seed: int = 0) -> list[np.ndarray]:
    """tests/test_ibc.py's screen content: a tiled 8x8 glyph, chroma the
    luma subsampled and halved."""
    tile = np.random.default_rng(seed).integers(0, 256, size=(8, 8)) \
        .astype(np.int32)
    y = np.tile(tile, (h // 8, w // 8))
    u = (y[::2, ::2] // 2).astype(np.int32)
    return [y, u, u.copy()]


def mixed_sequence(frames, cut: float) -> list[list[np.ndarray]]:
    """The clip with the left `cut` of each plane's width replaced by the
    screen frame's."""
    h, w = frames[0][0].shape
    scr = screen_frame(w, h)
    return [[np.concatenate([s[:, :int(s.shape[1] * cut)],
                             np.asarray(p)[:, int(p.shape[1] * cut):]], 1)
             .astype(np.int32) for s, p in zip(scr, f)] for f in frames]


def _count_intra_tools(cfg, frames, data: bytes) -> dict:
    """Blocks of the stream's I pictures that chose each prediction tool,
    and the TS/BDPCM overrides, from the port's CPU encode of the same
    frames (its stream must equal the JAX one)."""
    from vvc_mm_tpu_torch.common import wavefront
    from vvc_mm_tpu_torch.encoder import enclib
    from vvc_mm_tpu_torch.encoder.enclib import EncCfg as TEncCfg

    counts = dict(mip=0, mrl=0, cclm=0, ibc=0)
    stats: dict = {}
    encode = wavefront.encode_intra_frame

    def counted(*a, **kw):
        outs, recon = encode(*a, stats=stats, **kw)
        mode, lm, _, mrl = (o.cpu().numpy() for o in outs[:4])
        h, w = a[0].shape
        s = a[4]
        coords, valid = wavefront.wavefront_coords(h // s, w // s)
        mode, lm, mrl = (wavefront.steps_to_grid(g, coords, valid)
                         for g in (mode, lm, mrl))
        counts["mip"] += int(((mode >= 67) & (mode < 128)).sum())
        counts["ibc"] += int((mode >= wavefront.IBC_BASE).sum())
        counts["mrl"] += int((mrl > 0).sum())
        counts["cclm"] += int((lm > 0).sum())
        return outs, recon

    tcfg = TEncCfg(**{k: getattr(cfg, k) for k in
                      TEncCfg.__dataclass_fields__ if hasattr(cfg, k)
                      and k != "mm"})
    enclib.wavefront.encode_intra_frame = counted
    try:
        tdata = enclib.EncLib(tcfg, device="cpu").encode_sequence(frames)
    finally:
        enclib.wavefront.encode_intra_frame = encode
    assert tdata == data, "the port's stream differs from the JAX stream"
    counts.update({k: stats.get(k, 0) for k in ("ts_over_ibc", "ts_over_mrl",
                                                "ts1_over_mrl")})
    return counts


def models_label(mm: dict) -> str:
    return "+".join(k.upper() for k in ("mpa", "t3d", "tan", "ged", "rot",
                                        "mmmvp") if mm.get(k))


def make(w: int, h: int, config: str = "mm") -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from bench import realistic_sequence
    from vvc_mm_tpu.common.slice_ps import MMConfig
    from vvc_mm_tpu.common.typedefs import ProjectionID
    from vvc_mm_tpu.encoder.enclib import EncCfg, EncLib

    mm, qt_depth, epipoles, _ = CONFIGS[config]
    tools = TOOLS.get(config, {})
    cfg = EncCfg(width=w, height=h, qp=QP, gop="RA", gop_size=4,
                 qt_depth=qt_depth, search_range=24, wrap_around=True,
                 mm=MMConfig(projection=ProjectionID.EQUIRECTANGULAR, **mm),
                 epipoles=list(epipoles), **tools)
    frames = realistic_sequence(w, h, NUM_FRAMES)
    enc = EncLib(cfg)
    t0 = time.perf_counter()
    data = enc.encode_sequence(frames)
    secs = time.perf_counter() - t0
    name = stream_name(w, h, config)
    with open(os.path.join(OUT_DIR, name + ".bin"), "wb") as f:
        f.write(data)
    pocs = _sidecar_pocs(enc.results)
    side = dict(width=w, height=h, frames=NUM_FRAMES, qp=QP, gop="RA",
                gop_size=4, qt_depth=qt_depth, models=models_label(mm),
                projection="ERP", search_range=24, wrap_around=True,
                content="bench.realistic_sequence(seed=11)",
                bytes=len(data), pocs=pocs)
    if config != "mm":
        side.update(config=config, merge=True,
                    epipoles=[list(e) for e in epipoles])
    if tools:
        side.update(t3d=bool(mm.get("t3d")), tan=bool(mm.get("tan")),
                    dmvr=bool(tools.get("dmvr")),
                    bdof=bool(tools.get("bdof")))
        side.update({k: True for k, v in tools.items() if v})
    with open(os.path.join(OUT_DIR, name + ".json"), "w") as f:
        json.dump(side, f, indent=1)
        f.write("\n")
    print(f"{name}: {len(data)} bytes, encode {secs:.1f} s on CPU")
    return side


def _sidecar_pocs(results) -> list[dict]:
    pocs = []
    for r in sorted(results, key=lambda r: r.poc):
        m = hashlib.md5()
        for p in r.recon:
            m.update(np.asarray(p).astype(np.uint8).tobytes())
        pocs.append(dict(poc=int(r.poc), md5=m.hexdigest(),
                         psnr_y=float(r.psnr_y),
                         psnr_u=float(r.psnr_u), psnr_v=float(r.psnr_v),
                         bits=int(r.bits)))
    return pocs


def make_classic(name: str) -> dict:
    """One classic stream of CLASSIC and its sidecar."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from bench import realistic_sequence
    from vvc_mm_tpu.encoder.enclib import EncCfg, EncLib

    w, h, gop, gop_size, n, merge, tools = CLASSIC[name]
    qp = STREAM_QP.get(name, QP)
    if gop == "AI":     # bench configuration 1 sets no other field
        cfg = EncCfg(width=w, height=h, qp=qp, gop=gop, **tools)
    else:
        cfg = EncCfg(width=w, height=h, qp=qp, gop=gop, gop_size=gop_size,
                     search_range=24, merge=merge, **tools)
    frames = (realistic_sequence(w, h, n) if name not in SCREEN
              else [screen_frame(w, h)] * n)
    if name in MIXED:
        frames = mixed_sequence(frames, MIXED[name])
    fade = FADE.get(name)
    if fade:
        from vvc_mm_tpu_torch.utils.content import fade_sequence
        frames = fade_sequence(frames, fade)
    enc = EncLib(cfg)
    t0 = time.perf_counter()
    data = enc.encode_sequence(frames)
    secs = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, name + ".bin"), "wb") as f:
        f.write(data)
    side = dict(width=w, height=h, frames=n, qp=qp, gop=gop,
                gop_size=cfg.gop_size, qt_depth=cfg.qt_depth,
                inter_block_size=cfg.inter_block_size, models="CLASSIC",
                search_range=cfg.search_range, wrap_around=False,
                merge=merge, content=(
                    "tests/test_ibc.py screen frame (seed 0)"
                    if name in SCREEN else
                    f"bench.realistic_sequence(seed=11), the left "
                    f"{MIXED[name]} of the width screen content"
                    if name in MIXED else
                    "bench.realistic_sequence(seed=11)"),
                bytes=len(data), pocs=_sidecar_pocs(enc.results))
    if any(tools.get(k) for k in PRED_TOOLS):
        side.update(intra_tool_blocks=_count_intra_tools(cfg, frames, data))
        # the JAX decoder's verdicts: a block that plain transform skip
        # takes from an MRL choice is coded without the MRL flag but
        # reconstructed from ring 1 by the JAX encoder, so no decoder
        # reproduces it (ts1_over_mrl)
        from vvc_mm_tpu.decoder.declib import DecLib
        dec = DecLib()
        dec.decode_bytes(data)
        side.update(jax_decoder_md5={str(k): v for k, v in
                                     sorted(dec.hash_status.items())})
    if tools:
        side.update(t3d=False, tan=False)
        side.update({k: bool(tools.get(k)) for k in SIDECAR_TOOLS})
        if "scaling_list" in tools:
            side.update(scaling_list=list(tools["scaling_list"]))
    if fade:
        side.update(fade=fade)
    with open(os.path.join(OUT_DIR, name + ".json"), "w") as f:
        json.dump(side, f, indent=1)
        f.write("\n")
    print(f"{name}: {len(data)} bytes, encode {secs:.1f} s on CPU")
    return side


def port_cfg(name: str):
    """The PyTorch port's EncCfg of a CLASSIC stream (the fields
    make_classic sets)."""
    from vvc_mm_tpu_torch.encoder.enclib import EncCfg

    w, h, gop, gop_size, _, merge, tools = CLASSIC[name]
    qp = STREAM_QP.get(name, QP)
    if gop == "AI":
        return EncCfg(width=w, height=h, qp=qp, gop=gop, **tools)
    return EncCfg(width=w, height=h, qp=qp, gop=gop, gop_size=gop_size,
                  search_range=24, merge=merge, **tools)


def make_preset_i(name: str = PRESET_I) -> dict:
    """The sidecar of one 2048x1024 I picture of the headline
    configuration, RA, one frame (a one-frame sequence codes its I picture
    at the configuration's QP 37; the cascade's 34 applies from two
    frames): PRESET_I takes the CTC-like preset (make_bd_r05.py:75-77: the
    headline tools with TMVP, RDOQ, dependent quantization, MTS and LFNST)
    with CCLM, MIP, MRL and IBC, SPLIT_I the two-level intra partitioning
    alone."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from bench import realistic_sequence
    from vvc_mm_tpu.common.bitstream import NAL_IDR, read_annexb
    from vvc_mm_tpu.common.slice_ps import MMConfig
    from vvc_mm_tpu.common.typedefs import ProjectionID
    from vvc_mm_tpu.encoder.enclib import EncCfg, EncLib

    w, h = SIZES["2048x1024"]
    tools = (dict(tmvp=True, rdoq=True, dep_quant=True, mts=True,
                  lfnst=True, **PRED_TOOLS) if name == PRESET_I
             else dict(intra_split=True))
    cfg = EncCfg(width=w, height=h, qp=QP, gop="RA", gop_size=4,
                 qt_depth=1, search_range=24, wrap_around=True,
                 mm=MMConfig(projection=ProjectionID.EQUIRECTANGULAR,
                             mpa=True, rot=True), **tools)
    frames = realistic_sequence(w, h, 1)
    enc = EncLib(cfg)
    t0 = time.perf_counter()
    data = enc.encode_sequence(frames)
    secs = time.perf_counter() - t0
    idr = [n for n in read_annexb(data) if n.nal_type == NAL_IDR]
    assert len(idr) == 1
    side = dict(width=w, height=h, frames=1, qp=QP, gop="RA", gop_size=4,
                qt_depth=1, models="MPA+ROT", projection="ERP",
                search_range=24, wrap_around=True,
                content="bench.realistic_sequence(seed=11)",
                **({"preset": "make_bd_r05.py:75-77 (CTC-like)"}
                   if name == PRESET_I else {}),
                **tools, bytes=len(data),
                idr_sha256=hashlib.sha256(idr[0].payload).hexdigest(),
                pocs=_sidecar_pocs(enc.results))
    with open(os.path.join(OUT_DIR, name + ".json"), "w") as f:
        json.dump(side, f, indent=1)
        f.write("\n")
    print(f"{name}: {len(data)} bytes, encode {secs:.1f} s on CPU")
    return side


def main(argv: list[str]) -> None:
    """Each argument names a stream, a size (every multi-model stream of
    it), `classic` (every classic stream) or `partitioning` (the quadtree,
    MTT and intra-split ones)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    names = []
    for key in (argv or list(STREAMS) + list(CLASSIC)):
        if key in SIZES:
            names += [n for n, (_, size) in STREAMS.items() if size == key]
        elif key == "classic":
            names += list(CLASSIC)
        elif key == "2048x1024i":
            names.append(PRESET_I)
        elif key == "2048x1024s":
            names.append(SPLIT_I)
        elif key == "partitioning":
            names += list(PARTITIONING)
        else:
            names.append(key)
    for name in names:
        if name in (PRESET_I, SPLIT_I):
            make_preset_i(name)
        elif name in CLASSIC:
            make_classic(name)
        else:
            make(*SIZES[STREAMS[name][1]], STREAMS[name][0])


if __name__ == "__main__":
    main(sys.argv[1:])
