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

The sequence tools and 10-bit coding (TOOL_STREAMS; each small one
mirrors a test of the JAX package, its sizes, settings and content):

  ra64x64_wpp_tmvp_qp32_6f      tests/test_wpp.py:85, WPP in 2 substreams;
  ldp128x128_wpp_tmvp_qp28_6f   tests/test_wpp.py:109, 4 substreams, the
                                HMVP resets of the P merge selection;
  ldp64x64_lmcs_qp34_3f         tests/test_lmcs.py:33;
  ldp128x64_mcts_qp32_3f        tests/test_mcts.py:49 (2x1 tiles);
  ai96x64_film_grain_qp37_2f    tests/test_utility_apps.py:127;
  ldp96x64_conceal_qp35_4f      tests/test_apps.py:98, whose sidecar also
                                records the JAX decoder's decode with POC
                                1's slice NAL dropped;
  ai64x32_10bit_qp32_3f, ldp64x32_10bit_qp32_3f
                                tests/test_highbitdepth.py:19-30;
  ra832x480_wpp_lmcs_fg_qp37_5f bench configuration 2's clip, RA, GOP 4,
                                WPP (4 substreams, TMVP), LMCS and film
                                grain together (chip smoke phase 8r);
  ldp832x480_mcts_qp37_3f       that clip, LDP, MCTS 2x2 (phase 8s), and
                                its concealed decode.

Their sidecars add the JAX decoder's MD5 verdicts and pictures and, by
tool, its display-domain (LMCS) pictures, film grain parameters and the
grain it applies to POC 0, and the MCTS tile grid.  `erp6144x3072_ldp_
qp37_3f` is a sidecar without a stream: bench configuration 5's 3 frames
(bits, Y-PSNR and the slice NAL's SHA-256 per picture, the stream's
SHA-256) for phase 8d.  The 832x480 streams and that sidecar were written
on the card machine's CPU, one process each in parallel (55, 25 and 180
s of JAX encode), the small ones here (`... tools16`, 3 minutes).

Equisolid (fisheye) content, rate control, MCTF and the 360 metrics
(LIB360_STREAMS, `bench.realistic_sequence` content, QP 37, RA GOP 4,
search range 24, the MM quadtree at depth 1, 5 frames):

  fish128x128_ra_mm_qp37_5f     Equisolid at the default focal (a
                                1088-pixel sensor), MPA+ROT, no
                                wrap-around;
  fish128x128_ra_t3d_tan_ged_qp37_5f  the same Equisolid with 3DT, TAN,
                                GED (a signalled epipole) and GEDA;
  fish1088x1088_ra_mm_qp37_5f   the same at the sensor's width (chip
                                smoke phase 8u);
  erp256x128_ra_mm_rc_mctf_5f   the headline tools with the MCTF
                                pre-filter, rate control (30 kbit/s) and
                                the 360 metrics;
  erp2048x1024_ra_mm_rc_mctf_5f the same at 2048x1024 and 1,920 kbit/s
                                (phase 8t).

Their sidecars record every POC's MD5, bits, PSNRs and 360 metrics, the
summary, the JAX decoder's verdicts, the stream's SHA-256 and, with MCTF,
the MD5 of each filtered source picture (`mctf_md5`; `python
tests/make_torch_port_streams.py mctf_md5:NAME` adds it to a sidecar).  The two
large ones were written on the card machine's CPU, one process each in
parallel; the small ones here (`... lib360`).

    python tests/make_torch_port_streams.py                   # all streams
    python tests/make_torch_port_streams.py 256x128           # one size
    python tests/make_torch_port_streams.py erp256x128_ra_mpa_qp37_5f
    python tests/make_torch_port_streams.py classic           # the 32
    python tests/make_torch_port_streams.py 2048x1024i        # sidecar
    python tests/make_torch_port_streams.py 2048x1024s        # sidecar
    python tests/make_torch_port_streams.py partitioning      # the 8
    python tests/make_torch_port_streams.py tools16           # the small
    python tests/make_torch_port_streams.py erp6144x3072_ldp_qp37_3f
    python tests/make_torch_port_streams.py lib360            # the small 3
    python tests/make_torch_port_streams.py equisolid_sha256  # 1088 hashes
    python tests/make_torch_port_streams.py apps              # app records

This script imports the JAX package; pytest does not collect it (its name
does not start with `test_`).
"""
from __future__ import annotations

import dataclasses
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


# ---- the tools of ROADMAP queue 1 items 10b and 11a-11e: WPP, MCTS, LMCS,
# the film grain SEI, lost-picture concealment and 10-bit coding.  The
# small streams mirror the JAX package's own tests (sizes, settings and
# content); the two 832x480 ones take bench configuration 2's clip for the
# chip smoke run's phases 8r and 8s.
# name -> (EncCfg fields, content, frames)
TOOL_STREAMS = {
    # tests/test_wpp.py:85 (RA, TMVP, 2 substreams)
    "ra64x64_wpp_tmvp_qp32_6f": (
        dict(width=64, height=64, qp=32, gop="RA", gop_size=4,
             inter_block_size=16, merge=True, tmvp=True, wpp=True,
             num_substreams=2), "synthetic(3, 1)", 6),
    # tests/test_wpp.py:109 (LDP, TMVP, 4 substreams, noisy block rows)
    "ldp128x128_wpp_tmvp_qp28_6f": (
        dict(width=128, height=128, qp=28, gop="LDP", inter_block_size=16,
             merge=True, tmvp=True, wpp=True, num_substreams=4),
        "synthetic(5, 3) + noise(7)", 6),
    # tests/test_lmcs.py:33
    "ldp64x64_lmcs_qp34_3f": (
        dict(width=64, height=64, qp=34, gop="LDP", intra_period=0,
             lmcs=True), "lmcs(1234)", 3),
    # tests/test_mcts.py:49
    "ldp128x64_mcts_qp32_3f": (
        dict(width=128, height=64, qp=32, gop="LDP", intra_period=0,
             search_range=16, mcts_tiles=(2, 1), alf=False),
        "synthetic(6, 2)", 3),
    # tests/test_utility_apps.py:127
    "ai96x64_film_grain_qp37_2f": (
        dict(width=96, height=64, qp=37, film_grain=True),
        "synthetic(3, 1) + grain(1234)", 2),
    # tests/test_apps.py:98 (POC 1's slice NAL is dropped before decoding)
    "ldp96x64_conceal_qp35_4f": (
        dict(width=96, height=64, qp=35, gop="LDP",
             picture_hash_sei=False), "synthetic(2, 1)", 4),
    # tests/test_highbitdepth.py:19-30
    "ai64x32_10bit_qp32_3f": (
        dict(width=64, height=32, bit_depth=10, qp=32, gop="AI",
             intra_period=0, search_range=8), "synthetic10(2, 1)", 3),
    "ldp64x32_10bit_qp32_3f": (
        dict(width=64, height=32, bit_depth=10, qp=32, gop="LDP",
             intra_period=0, search_range=8), "synthetic10(2, 1)", 3),
    # phase 8r: WPP (I, P and B arms, the HMVP resets under TMVP), LMCS and
    # the film grain SEI on bench configuration 2's clip
    "ra832x480_wpp_lmcs_fg_qp37_5f": (
        dict(width=832, height=480, qp=37, gop="RA", gop_size=4,
             search_range=24, tmvp=True, wpp=True, num_substreams=4,
             lmcs=True, film_grain=True), "realistic", 5),
    # phase 8s: MCTS (2x2 tiles) on that clip; POC 1 dropped for the
    # concealed decode
    "ldp832x480_mcts_qp37_3f": (
        dict(width=832, height=480, qp=37, gop="LDP", search_range=24,
             mcts_tiles=(2, 2)), "realistic", 3),
}
# if the JAX decoder does not decode phase 8r's combined stream with every
# MD5 OK, these two split it (WPP alone; LMCS and the film grain SEI)
SPLIT_8R = {
    "ra832x480_wpp_qp37_5f": (
        dict(width=832, height=480, qp=37, gop="RA", gop_size=4,
             search_range=24, tmvp=True, wpp=True, num_substreams=4),
        "realistic", 5),
    "ra832x480_lmcs_fg_qp37_5f": (
        dict(width=832, height=480, qp=37, gop="RA", gop_size=4,
             search_range=24, lmcs=True, film_grain=True), "realistic", 5),
}
# the streams whose concealed decode (POC 1's slice NAL dropped) the
# sidecar records
CONCEAL = ("ldp96x64_conceal_qp35_4f", "ldp832x480_mcts_qp37_3f")
# bench configuration 5 (`bench.py:121-123`, erp6144x3072_ldp_qp37): a
# sidecar of the JAX encoder's 3-frame encode, without the stream
CONFIG5 = "erp6144x3072_ldp_qp37_3f"


def tool_frames(content: str, w: int, h: int, n: int
                ) -> list[list[np.ndarray]]:
    """The source frames of a TOOL_STREAMS entry, as the JAX package's test
    that it mirrors makes them (its `rng` fixture is default_rng(1234))."""
    from vvc_mm_tpu_torch.utils.content import realistic_sequence
    from vvc_mm_tpu_torch.utils.yuv_io import VideoFormat, \
        synthetic_sequence

    if content == "realistic":
        return realistic_sequence(w, h, n)
    if content.startswith("lmcs"):
        rng = np.random.default_rng(1234)
        base = np.clip(rng.normal(120, 15, size=(h + 8, w + 8)), 0,
                       255).astype(np.int32)
        frames = []
        for t in range(n):
            y = base[t:t + h, 2 * t:2 * t + w].astype(np.int32)
            u = (y[::2, ::2] // 2 + 40).astype(np.int32)
            frames.append([y, u, u.copy()])
        return frames
    bd = 10 if content.startswith("synthetic10") else 8
    motion = tuple(float(v) for v in
                   content.split("(")[1].split(")")[0].split(","))
    frames = synthetic_sequence(VideoFormat(w, h, bd), n, motion=motion)
    if "noise(7)" in content:
        # tests/test_wpp.py:109: block-level noise so that the HMVP
        # entries vary across rows
        rng = np.random.default_rng(7)
        for f in frames:
            f[0][32:64, 48:96] = rng.integers(0, 256, size=(32, 48))
    if "grain(1234)" in content:
        rng = np.random.default_rng(1234)
        frames = [[np.clip(f[0].astype(np.int64)
                           + rng.integers(-6, 7, f[0].shape), 0, 255
                           ).astype(f[0].dtype), f[1], f[2]] for f in frames]
    return frames


def tool_stream(name: str):
    """(EncCfg fields, source frames) of a TOOL_STREAMS / SPLIT_8R
    entry."""
    fields, content, n = {**TOOL_STREAMS, **SPLIT_8R}[name]
    return dict(fields), tool_frames(content, fields["width"],
                                     fields["height"], n)


def plane_md5(planes, bit_depth: int = 8) -> str:
    """The decoded-picture-hash MD5 of a picture (16-bit samples above 8
    bits)."""
    m = hashlib.md5()
    for p in planes:
        p = np.asarray(p)
        m.update(p.astype("<u2" if bit_depth > 8 else np.uint8).tobytes())
    return m.hexdigest()


def drop_first_trail(data: bytes) -> bytes:
    """The stream without its first TRAIL slice NAL (POC 1 of an LDP
    stream), as tests/test_apps.py:98 drops it."""
    from vvc_mm_tpu_torch.common.bitstream import (NAL_TRAIL, read_annexb,
                                                   write_annexb)
    nalus = read_annexb(data)
    first = next(i for i, n in enumerate(nalus) if n.nal_type == NAL_TRAIL)
    return write_annexb([n for i, n in enumerate(nalus) if i != first])


def film_grain_record(params) -> dict | None:
    """Either package's FilmGrainParams as its sidecar records them."""
    return None if params is None else json.loads(json.dumps(
        dataclasses.asdict(params)))


def port_tool_run(name: str) -> dict:
    """The port's CPU encode of a TOOL_STREAMS entry's source, and its CPU
    decode of the committed JAX stream: {fields, frames, sd (the sidecar),
    committed, enc, data (the port's stream), dec, out (dec's
    pictures)}."""
    from vvc_mm_tpu_torch.decoder.declib import DecLib
    from vvc_mm_tpu_torch.encoder.enclib import EncCfg, EncLib

    fields, frames = tool_stream(name)
    with open(os.path.join(OUT_DIR, name + ".json")) as f:
        sd = json.load(f)
    with open(os.path.join(OUT_DIR, name + ".bin"), "rb") as f:
        committed = f.read()
    enc = EncLib(EncCfg(**fields), device="cpu")
    data = enc.encode_sequence(frames)
    dec = DecLib(device="cpu")
    out = dec.decode_bytes(committed)
    return dict(fields=fields, frames=frames, sd=sd, committed=committed,
                enc=enc, data=data, dec=dec, out=out)


def assert_tool_run(run: dict) -> None:
    """A port_tool_run against its sidecar: the port's stream equals the
    JAX stream byte for byte, its pictures' MD5s, bits and PSNRs equal the
    JAX encoder's, and the port decodes the JAX stream to the JAX
    decoder's MD5 verdicts and pictures.  The JAX encoder's PSNRs are
    float32, the port's float64 of the same sums: they agree within 1e-4
    dB."""
    sd, bd = run["sd"], run["fields"].get("bit_depth", 8)
    assert run["data"] == run["committed"]
    res = sorted(run["enc"].results, key=lambda r: r.poc)
    assert [(r.poc, plane_md5(r.recon, bd), r.bits) for r in res] == \
        [(p["poc"], p["md5"], p["bits"]) for p in sd["pocs"]]
    for r, p in zip(res, sd["pocs"]):
        assert np.allclose([r.psnr_y, r.psnr_u, r.psnr_v],
                           [p["psnr_y"], p["psnr_u"], p["psnr_v"]],
                           rtol=0, atol=1e-4), r.poc
    assert {str(k): v for k, v in sorted(run["dec"].hash_status.items())} \
        == sd["jax_decoder_md5"]
    assert all(v == "OK" for v in sd["jax_decoder_md5"].values())
    assert [plane_md5(f.numpy(), bd) for f in run["out"]] == \
        sd["jax_decoder_frame_md5"]


def make_tool_stream(name: str) -> dict:
    """One TOOL_STREAMS / SPLIT_8R stream and its sidecar: every POC's MD5,
    PSNR and bits, the JAX decoder's MD5 verdicts and, by tool, its
    display-domain (LMCS) MD5s, the film grain parameters and the MD5 of
    the grain it applies to POC 0, the MCTS tile grid and the concealed
    decode."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from vvc_mm_tpu.common import film_grain as fg
    from vvc_mm_tpu.decoder.declib import DecLib
    from vvc_mm_tpu.encoder.enclib import EncCfg, EncLib

    fields, frames = tool_stream(name)
    bd = fields.get("bit_depth", 8)
    enc = EncLib(EncCfg(**fields))
    t0 = time.perf_counter()
    data = enc.encode_sequence(frames)
    secs = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, name + ".bin"), "wb") as f:
        f.write(data)
    pocs = [dict(poc=int(r.poc), md5=plane_md5(r.recon, bd),
                 psnr_y=float(r.psnr_y), psnr_u=float(r.psnr_u),
                 psnr_v=float(r.psnr_v), bits=int(r.bits))
            for r in sorted(enc.results, key=lambda r: r.poc)]
    dec = DecLib()
    out = dec.decode_bytes(data)
    side = dict(fields, mcts_tiles=list(fields.get("mcts_tiles", ())),
                frames=len(frames), content={**TOOL_STREAMS,
                                             **SPLIT_8R}[name][1],
                bytes=len(data), encode_seconds_cpu=round(secs, 1),
                pocs=pocs, jax_decoder_md5={
                    str(k): v for k, v in sorted(dec.hash_status.items())},
                jax_decoder_frame_md5=[plane_md5(f.planes, bd) for f in out])
    if fields.get("lmcs"):
        side.update(lmcs_cw=[int(c) for c in dec.sps.lmcs_cw],
                    output_md5=[plane_md5(f.planes, bd)
                                for f in dec.output_frames()],
                    encoder_output_md5=[
                        plane_md5(r.output, bd) for r in
                        sorted(enc.results, key=lambda r: r.poc)])
    if fields.get("film_grain"):
        side.update(film_grain_params=film_grain_record(dec.film_grain))
        if dec.film_grain is not None:
            grain = fg.apply_grain(out[0].planes, dec.film_grain, 0, bd)
            side.update(grain_poc0_md5=plane_md5(grain, bd))
    if fields.get("mcts_tiles"):
        side.update(jax_decoder_mcts_tiles=list(dec.mcts_tiles))
    if name in CONCEAL:
        cdec = DecLib()
        cout = cdec.decode_bytes(drop_first_trail(data))
        side.update(concealed=dict(
            concealed=list(cdec.concealed), pocs=[f.poc for f in cout],
            md5=[plane_md5(f.planes, bd) for f in cout],
            hash_status={str(k): v for k, v in
                         sorted(cdec.hash_status.items())}))
    with open(os.path.join(OUT_DIR, name + ".json"), "w") as f:
        json.dump(side, f, indent=1)
        f.write("\n")
    print(f"{name}: {len(data)} bytes, encode {secs:.1f} s on CPU, JAX "
          f"decoder {side['jax_decoder_md5']}", flush=True)
    return side


def make_8r() -> None:
    """Phase 8r's stream; the split pair too where the JAX decoder does not
    give every MD5 OK on the combined one."""
    side = make_tool_stream("ra832x480_wpp_lmcs_fg_qp37_5f")
    if any(v != "OK" for v in side["jax_decoder_md5"].values()):
        for name in SPLIT_8R:
            make_tool_stream(name)


def config5_cfg():
    """Bench configuration 5's EncCfg fields (bench.py:121-123)."""
    return dict(width=6144, height=3072, qp=37, gop="LDP", search_range=24,
                wrap_around=True)


def make_config5() -> dict:
    """The JAX encoder's 3-frame encode of bench configuration 5: bits,
    Y-PSNR and the slice NAL's SHA-256 per picture, and the stream's
    SHA-256 (the 1.8 MB stream itself is not committed)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from vvc_mm_tpu.common.bitstream import NAL_IDR, NAL_TRAIL, read_annexb
    from vvc_mm_tpu.encoder.enclib import EncCfg, EncLib
    from vvc_mm_tpu_torch.utils.content import realistic_sequence

    fields = config5_cfg()
    frames = realistic_sequence(fields["width"], fields["height"], 3)
    enc = EncLib(EncCfg(**fields))
    t0 = time.perf_counter()
    for kind in ("encode_intra_frame", "encode_p_frame"):
        def timed(*a, _f=getattr(enc, kind), **kw):
            out = _f(*a, **kw)
            print(f"{CONFIG5}: POC {a[0]} done at "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            return out
        setattr(enc, kind, timed)
    data = enc.encode_sequence(frames)
    secs = time.perf_counter() - t0
    slices = [n for n in read_annexb(data)
              if n.nal_type in (NAL_IDR, NAL_TRAIL)]
    res = sorted(enc.results, key=lambda r: r.poc)
    side = dict(fields, frames=3, content="bench.realistic_sequence(seed=11)",
                bytes=len(data), sha256=hashlib.sha256(data).hexdigest(),
                encode_seconds_cpu=round(secs, 1),
                pocs=[dict(poc=int(r.poc), bits=int(r.bits),
                           psnr_y=float(r.psnr_y),
                           slice_sha256=hashlib.sha256(n.payload).hexdigest())
                      for r, n in zip(res, slices)])
    with open(os.path.join(OUT_DIR, CONFIG5 + ".json"), "w") as f:
        json.dump(side, f, indent=1)
        f.write("\n")
    print(f"{CONFIG5}: {len(data)} bytes, encode {secs:.1f} s on CPU",
          flush=True)
    return side


# ---- ROADMAP queue 1 items 11f and 11g: multi-model coding of Equisolid
# (fisheye) content, rate control, the MCTF pre-filter and the 360
# metrics.  name -> (EncCfg fields, MMConfig fields, frames); the content
# is bench.realistic_sequence.
RC_MCTF = dict(mctf=True, metrics_360=True)
LIB360_STREAMS = {
    # Equisolid at the default focal, the headline tools (MPA+ROT, the MM
    # quadtree at depth 1), RA GOP 4, no wrap-around (a fisheye image has
    # no horizontal wrap)
    "fish128x128_ra_mm_qp37_5f": (
        dict(width=128, height=128, qp=37, gop="RA", gop_size=4,
             qt_depth=1, search_range=24),
        dict(mpa=True, rot=True, projection="EQUISOLID"), 5),
    # the other sphere models on the same Equisolid: 3DT, TAN, GED with a
    # signalled epipole and the three GEDA axes (the merged positions'
    # compiled forms of every model but MPA and ROT)
    "fish128x128_ra_t3d_tan_ged_qp37_5f": (
        dict(width=128, height=128, qp=37, gop="RA", gop_size=4,
             qt_depth=1, search_range=24,
             epipoles=[(4, 0, 0.3, -0.5, 0.8)]),
        dict(t3d=True, tan=True, ged=True, geda=True,
             projection="EQUISOLID"), 5),
    # phase 8u: the same at the default focal's sensor width
    "fish1088x1088_ra_mm_qp37_5f": (
        dict(width=1088, height=1088, qp=37, gop="RA", gop_size=4,
             qt_depth=1, search_range=24),
        dict(mpa=True, rot=True, projection="EQUISOLID"), 5),
    # the headline tools with the MCTF pre-filter, rate control and the
    # 360 metrics (ERP, wrap-around); the target is 30 kbit/s per 32,768
    # luma samples at 30 frames a second
    "erp256x128_ra_mm_rc_mctf_5f": (
        dict(width=256, height=128, qp=37, gop="RA", gop_size=4,
             qt_depth=1, search_range=24, wrap_around=True,
             target_bitrate_kbps=30, **RC_MCTF),
        dict(mpa=True, rot=True, projection="EQUIRECTANGULAR"), 5),
    # phase 8t: the same at 2048x1024
    "erp2048x1024_ra_mm_rc_mctf_5f": (
        dict(width=2048, height=1024, qp=37, gop="RA", gop_size=4,
             qt_depth=1, search_range=24, wrap_around=True,
             target_bitrate_kbps=1920, **RC_MCTF),
        dict(mpa=True, rot=True, projection="EQUIRECTANGULAR"), 5),
}


def lib360_cfg(name: str, port: bool = True):
    """The EncCfg of a LIB360_STREAMS entry, the port's or (port=False)
    the JAX package's."""
    if port:
        from vvc_mm_tpu_torch.common.slice_ps import MMConfig
        from vvc_mm_tpu_torch.common.typedefs import ProjectionID
        from vvc_mm_tpu_torch.encoder.enclib import EncCfg
    else:
        from vvc_mm_tpu.common.slice_ps import MMConfig
        from vvc_mm_tpu.common.typedefs import ProjectionID
        from vvc_mm_tpu.encoder.enclib import EncCfg
    fields, mm, _ = LIB360_STREAMS[name]
    mm = dict(mm, projection=ProjectionID[mm["projection"]])
    return EncCfg(mm=MMConfig(**mm), **fields)


def lib360_frames(name: str) -> list[list[np.ndarray]]:
    from vvc_mm_tpu_torch.utils.content import realistic_sequence
    fields, _, n = LIB360_STREAMS[name]
    return realistic_sequence(fields["width"], fields["height"], n)


def port_lib360_run(name: str, device: str = "cpu") -> dict:
    """The port's encode of a LIB360_STREAMS entry's source on `device`,
    and its decode there of the committed JAX stream: {sd (the sidecar),
    committed, enc, data (the port's stream), dec}."""
    from vvc_mm_tpu_torch.decoder.declib import DecLib
    from vvc_mm_tpu_torch.encoder.enclib import EncLib

    with open(os.path.join(OUT_DIR, name + ".json")) as f:
        sd = json.load(f)
    with open(os.path.join(OUT_DIR, name + ".bin"), "rb") as f:
        committed = f.read()
    enc = EncLib(lib360_cfg(name), device=device)
    data = enc.encode_sequence(lib360_frames(name))
    dec = DecLib(device=device)
    dec.decode_bytes(committed)
    return dict(sd=sd, committed=committed, enc=enc, data=data, dec=dec)


def metrics_360_diff(results, sd: dict) -> float:
    """The largest |port - JAX| of the per-POC 360 metrics and the
    summary's averages, in dB (the JAX encoder's are float32 sums in its
    own reduction order)."""
    res = sorted(results, key=lambda r: r.poc)
    diffs = [abs(r.metrics_360[k] - p["metrics_360"][k])
             for r, p in zip(res, sd["pocs"]) for k in p["metrics_360"]]
    assert len(diffs) == 4 * len(sd["pocs"])
    return max(diffs)


def assert_lib360_run(run: dict) -> None:
    """A port_lib360_run against its sidecar: the port's stream equals the
    JAX stream byte for byte, its pictures' MD5s and bits equal the JAX
    encoder's, and the port decodes the JAX stream with every MD5 OK, as
    the JAX decoder does; with metrics_360 every metric is within 1e-3 dB
    of the JAX encoder's."""
    sd = run["sd"]
    assert run["data"] == run["committed"]
    res = sorted(run["enc"].results, key=lambda r: r.poc)
    assert [(r.poc, plane_md5(r.recon), r.bits) for r in res] == \
        [(p["poc"], p["md5"], p["bits"]) for p in sd["pocs"]]
    assert {str(k): v for k, v in sorted(run["dec"].hash_status.items())} \
        == sd["jax_decoder_md5"]
    assert all(v == "OK" for v in sd["jax_decoder_md5"].values())
    if sd.get("metrics_360"):
        assert metrics_360_diff(res, sd) <= 1e-3
        summ = run["enc"].summary()
        for k in ("ws_psnr", "s_psnr_nn", "cpp_psnr"):
            assert abs(summ[k] - sd["summary"][k]) <= 1e-3, k


def jax_mctf_md5(name: str) -> dict:
    """POC -> MD5 of the JAX package's MCTF-filtered source picture (the
    RA anchors prefilter_sequence changes) of a LIB360_STREAMS entry."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from vvc_mm_tpu.encoder.mctf import prefilter_sequence

    fields, _, _ = LIB360_STREAMS[name]
    frames = lib360_frames(name)
    out = prefilter_sequence(frames, fields["qp"], 8,
                             period=max(fields["gop_size"], 1))
    return {str(p): plane_md5([np.asarray(c) for c in out[p]])
            for p in range(0, len(frames), fields["gop_size"])}


def add_mctf_md5(name: str) -> None:
    """Record jax_mctf_md5 in an existing sidecar."""
    path = os.path.join(OUT_DIR, name + ".json")
    with open(path) as f:
        side = json.load(f)
    side["mctf_md5"] = jax_mctf_md5(name)
    with open(path, "w") as f:
        json.dump(side, f, indent=1)
        f.write("\n")
    print(f"{name}: MCTF MD5s {side['mctf_md5']}", flush=True)


def make_lib360_stream(name: str) -> dict:
    """One LIB360_STREAMS stream and its sidecar: every POC's MD5, bits,
    PSNRs and (metrics_360) 360 metrics, the JAX decoder's MD5 verdicts and
    the stream's SHA-256."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from vvc_mm_tpu.decoder.declib import DecLib
    from vvc_mm_tpu.encoder.enclib import EncLib

    fields, mm, n = LIB360_STREAMS[name]
    frames = lib360_frames(name)
    enc = EncLib(lib360_cfg(name, port=False))
    t0 = time.perf_counter()
    data = enc.encode_sequence(frames)
    secs = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, name + ".bin"), "wb") as f:
        f.write(data)
    res = sorted(enc.results, key=lambda r: r.poc)
    pocs = [dict(poc=int(r.poc), md5=plane_md5(r.recon),
                 psnr_y=float(r.psnr_y), psnr_u=float(r.psnr_u),
                 psnr_v=float(r.psnr_v), bits=int(r.bits),
                 **({"metrics_360": {k: float(v) for k, v in
                                     r.metrics_360.items()}}
                    if r.metrics_360 else {}))
            for r in res]
    dec = DecLib()
    dec.decode_bytes(data)
    side = dict(fields, mm=mm, frames=n,
                content="bench.realistic_sequence(seed=11)",
                bytes=len(data), sha256=hashlib.sha256(data).hexdigest(),
                encode_seconds_cpu=round(secs, 1), pocs=pocs,
                summary={k: float(v) for k, v in enc.summary().items()
                         if k != "fps"},
                jax_decoder_md5={str(k): v for k, v in
                                 sorted(dec.hash_status.items())})
    if fields.get("mctf"):
        side.update(mctf_md5=jax_mctf_md5(name))
    with open(os.path.join(OUT_DIR, name + ".json"), "w") as f:
        json.dump(side, f, indent=1)
        f.write("\n")
    print(f"{name}: {len(data)} bytes, encode {secs:.1f} s on CPU, JAX "
          f"decoder {side['jax_decoder_md5']}", flush=True)
    return side


def equisolid_sha256() -> dict:
    """Model -> SHA-256 of the JAX package's merged positions (its jit of
    merged_positions, little-endian int32) on a 1088x1088 Equisolid with
    tests/test_torch_equisolid.py's seeded fields: SHA256_1088 there."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from vvc_mm_tpu.common.mm import frame_codec, reprojection
    from vvc_mm_tpu.common.typedefs import ProjectionID
    from vvc_mm_tpu.lib360 import projection
    from tests.test_torch_equisolid import equisolid_fields

    w = 1088
    jr = reprojection.MVReprojection(projection.make_projection(
        ProjectionID.EQUISOLID, w, w), w, w, 1)
    out = {}
    for model in (5, 7, 8):
        idx, mv, eps = equisolid_fields(w, model)
        pos = np.asarray(frame_codec.merged_positions(
            jr, [model], jnp.asarray(idx), jnp.asarray(mv[None]), 16, eps))
        out[model] = hashlib.sha256(np.ascontiguousarray(
            pos, "<i4").tobytes()).hexdigest()
        print(f"{model}: {out[model]}", flush=True)
    return out


# ------------------------------------------------------------ app records
# The CLI apps' reference outputs: the JAX package's apps run in this
# process on the CPU (`python tests/make_torch_port_streams.py apps`) and
# their outputs recorded in tests/data/torch_port/apps.json (with the
# encoder app's stream app_ra128x64_mm_qp37_5f.bin).  Arguments name their
# files by placeholder ({IN}, {BIN}, {REC}, {OUT}, {CFG}, {TRACE},
# {STREAM:name}); `app_args` fills them in.
APP_RECORD = "apps"
APP_W, APP_H, APP_FRAMES = 128, 64, 5
APP_CFG = "QP : 37            # the CTC QP\nGOP : RA\nGOPSize : 4\n" \
    "SearchRange : 24\n"
APP_ENC_ARGS = ["-c", "{CFG}", "-i", "{IN}", "-b", "{BIN}", "-o", "{REC}",
                "-wdt", str(APP_W), "-hgt", str(APP_H), "-f",
                str(APP_FRAMES), "--MPA", "--ROT", "--QTDepth=1",
                "--WrapAround", "--Epipole=1,0,0.0,0.0,1.0"]
APP_DEC_RUNS = {
    # the encoder app's stream: cache model, trace, output YUV
    "cache_trace": ["-b", "{BIN}", "-o", "{OUT}", "--CacheModel",
                    "--TraceFile={TRACE}"],
    # the Python spec coder's per-syntax bits of the headline tools
    "bitstats": ["-b", "{STREAM:erp256x128_ra_mm_qp37_5f}", "--BitStats"],
    # rate control signals HRD parameters: the CPB check
    "hrd": ["-b", "{STREAM:erp256x128_ra_mm_rc_mctf_5f}", "--CacheModel"],
    # the film grain SEI applied on output
    "film_grain": ["-b", "{STREAM:ai96x64_film_grain_qp37_2f}", "-o",
                   "{OUT}", "--FilmGrain", "--OutputBitDepth=8"],
    # the flat MM P parser's trace events (GED, MM-MVP), a classic
    # stream's cache model
    "trace_flat": ["-b", "{STREAM:erp256x128_ra_fullmm_qp37_5f}",
                   "--TraceFile={TRACE}", "--TraceRule=motion_model,mvd"],
    "cache_classic": ["-b", "{STREAM:ra192x96_ctc_tools_qp37_9f}",
                      "--CacheModel"],
}
APP_BD_ARGS = ["--Width=64", "--Height=32", "--Frames=2", "--GOP=LDP",
               "--QPs=32,37,42", "--Tool=merge"]
APP_TARGET_ARGS = ["-i", "{IN}", "-wdt", str(APP_W), "-hgt", str(APP_H),
                   "-f", "3", "--TargetBitrate=40000", "--GOP=LDP"]


def app_args(args: list[str], files: dict) -> list[str]:
    """An app's argument list with its placeholders filled in from
    `files` ({"IN": path, ...}); {STREAM:name} is a committed stream."""
    out = []
    for a in args:
        for k, v in files.items():
            a = a.replace("{" + k + "}", v)
        if "{STREAM:" in a:
            pre, rest = a.split("{STREAM:", 1)
            name, post = rest.split("}", 1)
            a = pre + os.path.join(OUT_DIR, name + ".bin") + post
        out.append(a)
    return out


def app_lines(text: str) -> list[str]:
    """An app's standard output without its clock readings: the
    encoder's SUMMARY fps and the decoder's seconds and fps."""
    import re
    out = []
    for line in text.splitlines():
        line = re.sub(r", [0-9.]+ fps$", "", line)
        line = re.sub(r" in [0-9.]+s \([0-9.]+ fps\)$", "", line)
        out.append(line)
    return out


def app_source(path: str) -> None:
    """The apps' source YUV: realistic_sequence(APP_W, APP_H,
    APP_FRAMES)."""
    from vvc_mm_tpu_torch.common.typedefs import ChromaFormat
    from vvc_mm_tpu_torch.utils.content import realistic_sequence
    from vvc_mm_tpu_torch.utils.yuv_io import VideoFormat, YuvWriter

    with YuvWriter(path, VideoFormat(APP_W, APP_H, 8,
                                     ChromaFormat.C420)) as wr:
        for f in realistic_sequence(APP_W, APP_H, APP_FRAMES):
            wr.write_frame(f)


def file_md5(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def run_app(main, args: list[str]) -> list[str]:
    """main(args)'s standard output lines (app_lines)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(args) == 0
    return app_lines(buf.getvalue())


def make_app_records() -> dict:
    """Run the JAX package's apps on the CPU and record their outputs in
    apps.json (the encoder app's stream beside it)."""
    import tempfile
    import jax
    jax.config.update("jax_platforms", "cpu")
    from vvc_mm_tpu.apps import (bd_rate, bitrate_targeting, decoder_app,
                                 encoder_app)

    rec: dict = dict(width=APP_W, height=APP_H, frames=APP_FRAMES,
                     content="realistic_sequence", cfg=APP_CFG,
                     enc_args=APP_ENC_ARGS, dec_runs=APP_DEC_RUNS,
                     bd_args=APP_BD_ARGS, target_args=APP_TARGET_ARGS)
    with tempfile.TemporaryDirectory() as d:
        files = {k: os.path.join(d, v) for k, v in dict(
            IN="in.yuv", BIN="app.bin", REC="rec.yuv", OUT="out.yuv",
            CFG="enc.cfg", TRACE="trace.txt").items()}
        app_source(files["IN"])
        with open(files["CFG"], "w") as f:
            f.write(APP_CFG)
        rec["enc_stdout"] = run_app(encoder_app.main,
                                    app_args(APP_ENC_ARGS, files))
        with open(files["BIN"], "rb") as f:
            data = f.read()
        with open(os.path.join(OUT_DIR, "app_ra128x64_mm_qp37_5f.bin"),
                  "wb") as f:
            f.write(data)
        rec["stream_sha256"] = hashlib.sha256(data).hexdigest()
        rec["recon_md5"] = file_md5(files["REC"])
        files["BIN"] = os.path.join(OUT_DIR, "app_ra128x64_mm_qp37_5f.bin")
        rec["dec"] = {}
        for name, args in APP_DEC_RUNS.items():
            for k in ("OUT", "TRACE"):
                if os.path.exists(files[k]):
                    os.remove(files[k])
            out = dict(stdout=run_app(decoder_app.main,
                                      app_args(args, files)))
            if "{OUT}" in args:
                out["yuv_md5"] = file_md5(files["OUT"])
            if any("{TRACE}" in a for a in args):
                with open(files["TRACE"]) as f:
                    out["trace"] = f.read().splitlines()
            rec["dec"][name] = out
            print(f"decoder app {name}: {len(out['stdout'])} lines",
                  flush=True)
        rec["bd_stdout"] = run_app(bd_rate.main, APP_BD_ARGS)
        rec["target_stdout"] = run_app(bitrate_targeting.main,
                                       app_args(APP_TARGET_ARGS, files))
    with open(os.path.join(OUT_DIR, APP_RECORD + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(f"app records: stream {rec['stream_sha256'][:8]}..., "
          f"{len(rec['enc_stdout'])} encoder lines", flush=True)
    return rec


def main(argv: list[str]) -> None:
    """Each argument names a stream, a size (every multi-model stream of
    it), `classic` (every classic stream) or `partitioning` (the quadtree,
    MTT and intra-split ones)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    names = []
    for key in (argv or list(STREAMS) + list(CLASSIC) + list(TOOL_STREAMS)
                + [CONFIG5] + list(LIB360_STREAMS)):
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
        elif key == "tools16":     # the small TOOL_STREAMS
            names += [n for n in TOOL_STREAMS if "832x480" not in n]
        elif key == "lib360":      # the small LIB360_STREAMS
            names += [n for n in LIB360_STREAMS
                      if n.split("_")[0] in ("fish128x128", "erp256x128")]
        else:
            names.append(key)
    for name in names:
        if name in (PRESET_I, SPLIT_I):
            make_preset_i(name)
        elif name == "ra832x480_wpp_lmcs_fg_qp37_5f":
            make_8r()
        elif name in TOOL_STREAMS or name in SPLIT_8R:
            make_tool_stream(name)
        elif name == CONFIG5:
            make_config5()
        elif name in LIB360_STREAMS:
            make_lib360_stream(name)
        elif name == APP_RECORD:
            make_app_records()
        elif name == "equisolid_sha256":
            equisolid_sha256()
        elif name.startswith("mctf_md5:"):
            add_mctf_md5(name.split(":", 1)[1])
        elif name in CLASSIC:
            make_classic(name)
        else:
            make(*SIZES[STREAMS[name][1]], STREAMS[name][0])


if __name__ == "__main__":
    main(sys.argv[1:])
