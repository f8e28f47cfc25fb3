"""Top-level encoder library.

PyTorch counterpart of `vvc_mm_tpu/encoder/enclib.py` (reference:
source/Lib/EncoderLib/EncLib.cpp — init:147, encode:734; EncGOP.cpp:2253
compressGOP).  `EncLib(cfg).encode_sequence(frames)` turns source pictures
into Annex-B bytes: parameter sets, then per picture a slice NAL and its
decoded-picture-hash SEI, in AI, LDP or RA (hierarchical B, CTC QP
cascade) order.  The pictures it encodes:

  I    wavefront intra encode on the device (common/wavefront.py, with
       the residual tools: RDOQ, dependent quantization through kernels
       D1/D2, MTS, LFNST, transform skip, BDPCM, lossless; or the two-level
       16x16/8x8 partitioning of common/intra_part.py) -> one packed
       pull -> host CABAC (encoder/intra_coder.py);
  P/B  classic quadtree pictures (common/qtree.py; with `mtt` the
       multi-type tree, common/mtt.py): every node size's and shape's
       pass, the tree resolve and the reconstruction on the device
       (plain torch operations) -> one packed pull -> host CABAC;
  P/B  classic (single-model) pictures on the fixed grid: P with one
       reference or two (a per-block ref_idx), merge on or off, and B
       pictures (whole-motion merge, or per-list AMVP): ME and the merge
       candidates' SADs on the device (common/inter_frame.py,
       encoder/me.py; plain torch operations, no kernel) -> one packed
       pull -> host merge selection (encoder/inter_coder.py) -> finish on
       the device (MC, transform/quant, deblock).  The random-access
       tools ride these paths: TMVP/HMVP and AMVR on P, GPM and CIIP on
       B, explicit weights (estimated per slice on the host) on both;
  P    affine pictures: the per-block translational/affine decision
       (common/affine.py), predicted by kernels K1/K2 from the affine
       subblock positions;
  P/B  multi-model P pictures (flat grid or quadtree lattice, merge on
       or off) and B pictures (whole-motion merge, or per-list AMVP),
       with GED epipoles coded in the picture header and MM-MVP: search
       on the device (common/mm: kernels K3/K4/K5 rank the candidates) ->
       one packed pull -> host selection (encoder/inter_coder.py) ->
       finish on the device (K1/K2 predict, transform/quant, deblock);
  all  SAO/ALF on the device while the host writes CABAC -> slice NAL.

The sequence-level tools ride these paths as in the JAX package: LMCS
forward-maps each source luma plane once (common/reshape.py) and codes the
whole sequence in the mapped domain; WPP codes the fixed-grid I slice and
the classic merge P and B slices as substreams with fresh contexts (the P
merge selection resets its HMVP FIFO where they start); MCTS clamps the
classic P searches' MVs into their tiles and signals the tile grid in an
SEI; the film grain SEI carries the parameters that common/film_grain.py
estimates from the first picture.  The MCTF pre-filter (encoder/mctf.py)
blends each RA anchor's source with its aligned neighbours before any
coding; rate control (encoder/rate_ctrl.py) picks each picture's QP from a
bit budget; with `metrics_360` every picture gets its WS-PSNR, S-PSNR-NN,
S-PSNR-I and CPP-PSNR (lib360/metrics.py, on the device).  The source
projection is ERP or Equisolid (fisheye); multi-model coding refuses a
calibrated projection, which has no focal length for the MPA plane.
"""
from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ..common import affine as affine_mod
from ..common import deblock, inter_frame, intra_part, qtree, quant, wavefront
from ..common import film_grain as fg
from ..common import reshape
from ..common import mtt as mtt_mod
from ..common.bitstream import (BitWriter, NalUnit, NAL_IDR, NAL_PPS,
                                NAL_SEI, NAL_SPS, NAL_TRAIL, write_annexb)
from ..common.mm import epipole as epipole_mod
from ..common.mm import frame_codec as mm_codec
from ..common.mm import qt_codec
from ..common.mm.mvp_convert import MMVPConverter
from ..common.mm.reprojection import MVReprojection
from ..common.slice_ps import MMConfig, PPS, SPS, SliceHeader
from ..common.typedefs import MotionModelID, SliceType
from ..device import resolve_device
from ..lib360.metrics import metrics_360
from ..lib360.projection import make_projection
from ..utils import profiling, xfer
from ..utils.content import psnr
from . import filter_stage
from .mctf import prefilter_sequence
from .rate_ctrl import RateControl
from .inter_coder import (encode_b_slice, encode_b_slice_mm,
                          encode_p_slice, encode_p_slice_2ref,
                          encode_b_slice_mtt, encode_b_slice_qt,
                          encode_p_slice_affine, encode_p_slice_mm,
                          encode_p_slice_mtt, encode_p_slice_qt,
                          encode_p_slice_qt_mm, encode_b_slice_wpp,
                          encode_p_slice_wpp,
                          mer_blocks_log2, resolve_tree_qt_mm, select_merge_b,
                          select_merge_b_mm, select_merge_mm,
                          select_merge_p, select_merge_p_2ref, select_qt_mm,
                          wpp_substream_starts)
from .intra_coder import (encode_intra_slice, encode_intra_slice_part,
                          encode_intra_slice_wpp)


def _wp_table(wp) -> tuple | None:
    """A slice header's weight table: ((w, o) per plane) as ints."""
    return None if wp is None else tuple((int(a), int(b)) for a, b in wp)


# CTC-style RA QP cascade at fixed QP (reference:
# cfg/encoder_randomaccess_vtm_gop16.cfg QPoffset per temporal layer +
# IntraQPOffset -3)
_B_QP_OFFSETS = (1, 1, 4, 5, 6)


def ctc_qp(base_qp: int, kind: str, tid: int = 0) -> int:
    """QP of a picture in the random-access cascade: kind "I" -3, "P" +1,
    "B" +1/+1/+4/+5/+6 by temporal id."""
    if kind == "I":
        return max(1, base_qp - 3)
    if kind == "P":
        return base_qp + 1
    return base_qp + _B_QP_OFFSETS[min(tid, len(_B_QP_OFFSETS) - 1)]


@dataclass
class EncCfg:
    """Encoder configuration (reference: EncCfg.h 'setter soup' — here a
    plain dataclass).  Every field of the JAX package's EncCfg is here;
    EncLib raises for a field whose tool the port does not carry yet."""
    width: int = 0
    height: int = 0
    bit_depth: int = 8
    qp: int = 32
    intra_block_size: int = 8
    inter_block_size: int = 16
    frames: int = 0
    wrap_around: bool = False
    gop: str = "AI"              # "AI" | "LDP" | "RA" (hierarchical B)
    intra_period: int = 32       # IDR refresh interval (LDP / RA)
    gop_size: int = 8            # RA mini-GOP (reference:
                                 # cfg/encoder_randomaccess_vtm.cfg GOP table)
    ctc_qp_offsets: bool = True  # CTC-style per-temporal-layer QP
                                 # offsets for RA at fixed QP: I -3,
                                 # anchors +1, B layers +1/+4/+5/+6
                                 # (reference:
                                 # cfg/encoder_randomaccess_vtm_gop16.cfg
                                 # QPoffset column, IntraQPOffset)
    search_range: int = 24
    max_num_ref: int = 2         # active references per list (plain-grid
                                 # P path; reference: per-ref ME loop
                                 # InterSearch.cpp:4937, RPL selection
                                 # EncLib.cpp:2213).  2 = ref_idx syntax
                                 # on, 1 = single-ref like round 3
    qt_depth: int = 0            # inter quadtree depth (0 = fixed grid;
                                 # QTMT analog — common/qtree.py)
    mtt: bool = False            # BT/TT splits on top of the quadtree
                                 # lattice (common/mtt.py; needs
                                 # qt_depth > 0)
    affine: bool = False         # per-block 4-param affine motion
                                 # (common/affine.py; CLASSIC fixed grid)
    # multi-model motion tools (reference: EncAppCfg.cpp:1013-1020
    # --MPA/--3DT/--TAN/--ROT/--GED/--GEDA/--MMMVP/--Epipole)
    mm: MMConfig = field(default_factory=MMConfig)
    epipoles: list[tuple[int, int, float, float, float]] = field(
        default_factory=list)    # (curPOC, refPOC, x, y, z)
    metrics_360: bool = False    # per-POC WS-PSNR/S-PSNR/CPP-PSNR
                                 # (reference: TExt360EncGop)
    picture_hash_sei: bool = True  # decoded-picture-hash SEI (the
                                   # conformance oracle, EncGOP.cpp:4124)
    deblocking: bool = True      # in-loop deblocking filter
    target_bitrate_kbps: int = 0  # 0 = fixed QP; else lambda-domain RC
    frame_rate: float = 30.0
    sao: bool = True             # sample adaptive offset (luma)
    alf: bool = True             # adaptive loop filter (luma)
    mctf: bool = False           # GOP-based temporal pre-filter (reference:
                                 # EncTemporalFilter, EncApp.cpp:1547-1551)
    lmcs: bool = False           # luma mapping / reshaper (reference:
                                 # Reshape.{cpp,h}, EncReshape)
    bdof: bool = False           # bi-directional optical flow refinement
                                 # of bi-predicted blocks (common/bdof.py)
    dmvr: bool = False           # decoder-side MV refinement by bilateral
                                 # matching (common/dmvr.py)
    gpm: bool = False            # geometric partitioning merge blend
                                 # (common/gpm.py; reference: --Geo)
    ciip: bool = False           # combined inter/intra prediction
                                 # (common/gpm.py; reference: --CIIP)
    ibc: bool = False            # intra block copy (wavefront BV search;
                                 # reference: --IBC, IbcHashMap)
    rdoq: bool = False           # RDOQ-lite: rate-aware per-coefficient
                                 # level decision, encoder-only
                                 # (quant.quantize_rdoq; reference:
                                 # QuantRDOQ.cpp; --RDOQ)
    dep_quant: bool = False      # dependent quantization trellis
                                 # (common/depquant.py; reference:
                                 # DepQuant.cpp, --DepQuant)
    cclm: bool = False           # chroma-from-luma linear model
                                 # (common/cclm.py; reference: --CCLM)
    mip: bool = False            # matrix intra prediction
                                 # (common/mip.py; reference: --MIP)
    lfnst: bool = False          # low-frequency non-separable secondary
                                 # transform (common/lfnst.py; --LFNST)
    tmvp: bool = False           # TMVP + HMVP AMVP candidates (--TMVP)
    merge: bool = True           # merge/skip candidate machinery on the
                                 # dense-grid inter paths: 6-candidate list
                                 # (spatial/TMVP/HMVP/pairwise/zero),
                                 # merge_flag + merge_idx, encoder snapping
                                 # (reference: UnitTools.cpp:1059
                                 # getInterMergeCandidates; --Merge)
    log2_parallel_merge_level: int = 2  # merge-estimation region size:
                                 # spatial candidates inside the current
                                 # block's region are excluded so a region
                                 # derives lists in parallel (reference:
                                 # sps_log2_parallel_merge_level)
    mts: bool = False            # explicit MTS for intra luma: per-block
                                 # DCT2/DST7/DCT8 pair RD choice + mts_idx
                                 # syntax (reference: TrQuant getTrTypes,
                                 # --MTS)
    amvr: bool = False           # adaptive MV resolution (quarter/full/
                                 # 4-pel per block; reference: IMV loop
                                 # EncCu.cpp:775, --IMV)
    mrl: bool = False            # multi-reference-line intra (--MRL)
    intra_split: bool = False    # two-level intra partitioning: 16x16
                                 # superblocks split into 8x8 quads by RD
                                 # (common/intra_part.py; reference: one
                                 # level of QTMT intra, EncCu.cpp:499).
                                 # Base toolset only (no CCLM/MIP/... —
                                 # those ride the fixed-grid path)
    wpp: bool = False            # entropy substreams + entry points (--WPP)
    num_substreams: int = 4
    weighted_bipred: bool = False  # explicit weighted prediction on B
                                 # slices: per-list weight tables, the
                                 # weighted bi combine (reference:
                                 # xWeightedPredictionBi; --WeightedPredB).
                                 # Composes with BDOF/DMVR/GPM/CIIP per
                                 # SLICE with reference precedence:
                                 # weights win where present, the tools
                                 # stay on elsewhere (BDOF biocheck0,
                                 # InterPrediction.cpp:566)
    weighted_pred: bool = False  # explicit weighted prediction P slices
                                 # (reference: WeightPrediction.cpp,
                                 # WeightPredAnalysis; --WeightedPredP)
    transform_skip: bool = False  # per-block transform skip RD choice
                                  # (reference: transform_skip_flag;
                                  # --TransformSkip)
    bdpcm: bool = False          # BDPCM on TS blocks (--BDPCM)
    film_grain: bool = False     # film grain characteristics SEI +
                                 # analyzer (reference:
                                 # SEIFilmGrainAnalyzer/Synthesizer)
    lossless: bool = False       # all-TS qStep-1 lossless intra coding
                                 # (--Lossless; forces QP 4, filters off)
    scaling_list: tuple = ()     # 64-entry 8x8 quant scaling matrix
                                 # (--ScalingList; classic P path +
                                 # decoder; empty = flat)
    mcts_tiles: tuple = ()       # (cols, rows): motion-constrained tile
                                 # sets — ME clamped so every prediction
                                 # stays inside its block's tile, MCTS SEI
                                 # emitted (reference: MCTS.{cpp,h},
                                 # SEI temporal MCTS; --MCTSTiles)

    def make_sps(self) -> SPS:
        from ..common.slice_ps import HRDParams
        hrd = (HRDParams(bit_rate_kbps=self.target_bitrate_kbps,
                         cpb_size_kbits=2 * self.target_bitrate_kbps,
                         time_scale=int(self.frame_rate * 1000),
                         num_units_in_tick=1000)
               if self.target_bitrate_kbps > 0 else None)
        return SPS(width=self.width, height=self.height, hrd=hrd,
                   max_num_ref=self.max_num_ref,
                   log2_parallel_merge_level=self.log2_parallel_merge_level,
                   scaling_list=tuple(int(v) for v in self.scaling_list),
                   bit_depth=self.bit_depth,
                   intra_block_size=self.intra_block_size,
                   inter_block_size=self.inter_block_size,
                   wrap_around=self.wrap_around, deblocking=self.deblocking,
                   sao=self.sao, alf=self.alf, mm=self.mm,
                   inter_qt_depth=self.qt_depth, mtt=self.mtt,
                   affine=self.affine,
                   bdof=self.bdof, dmvr=self.dmvr, gpm=self.gpm,
                   ciip=self.ciip, ibc=self.ibc,
                   dep_quant=self.dep_quant, cclm=self.cclm, mip=self.mip,
                   lfnst=self.lfnst, tmvp=self.tmvp, merge=self.merge,
                   mrl=self.mrl,
                   mts=self.mts, amvr=self.amvr,
                   wpp=self.wpp, intra_split=self.intra_split,
                   num_substreams=self.num_substreams,
                   ts=self.transform_skip or self.lossless,
                   bdpcm=self.bdpcm, lossless=self.lossless)


@dataclass
class FrameResult:
    poc: int
    bits: int
    psnr_y: float
    psnr_u: float
    psnr_v: float
    recon: list[np.ndarray]           # internal domain (mapped under LMCS)
    seconds: float = 0.0              # the picture span's (perf_counter)
    metrics_360: dict | None = None   # WS-PSNR/S-PSNR-NN/CPP-PSNR (luma)
    recon_out: list[np.ndarray] | None = None  # display domain (LMCS
                                               # inverse-mapped); None ->
                                               # same as recon

    @property
    def output(self) -> list[np.ndarray]:
        return self.recon_out if self.recon_out is not None else self.recon


def ra_coding_order(n: int, gop_size: int) -> list[tuple[int, int, int,
                                                         int]]:
    """Hierarchical-B coding order: list of (poc, ref0_poc, ref1_poc,
    temporal_id); ref1_poc == -1 means P frame (trailing partial GOP).
    Mirrors the dyadic GOP tables of the reference CTC configs."""
    order: list[tuple[int, int, int, int]] = []

    def bisect(lo: int, hi: int, tid: int) -> None:
        if hi - lo < 2:
            return
        mid = (lo + hi) // 2
        order.append((mid, lo, hi, tid))
        bisect(lo, mid, tid + 1)
        bisect(mid, hi, tid + 1)

    pos = 0
    while pos + 1 < n:
        end = min(pos + gop_size, n - 1)
        order.append((end, pos, -1, 0))       # GOP anchor: P frame
        bisect(pos, end, 1)
        pos = end
    return order


def _picture(kind: str):
    """An EncLib picture method (`poc` first) inside a picture span of
    `kind`; its FrameResult takes the span's seconds."""
    def wrap(method):
        @functools.wraps(method)
        def call(self, poc, *args, **kw):
            with profiling.picture(kind, poc, self.seq_id) as pic:
                nal, res = method(self, poc, *args, **kw)
            res.seconds = pic.seconds
            return nal, res
        return call
    return wrap


class EncLib:
    """reference: EncLib (EncLib.cpp:147 init / :734 encode).  State lives
    on `device`: CUDA unless another is named (raises without a card)."""

    def __init__(self, cfg: EncCfg, device=None) -> None:
        self.device = resolve_device(device)
        self.seq_id = profiling.sequence_id()    # its spans' sequence
        if cfg.lossless:
            # the lossless operating point: qStep 1 (QP 4 after the TS
            # clamp), in-loop filters off so that recon == source exactly
            # (reference: the lossless cfg turns deblock/SAO/ALF/LMCS/DQ
            # off); the configuration is changed in place, as in the JAX
            # package
            cfg.qp = 4
            cfg.deblocking = cfg.sao = cfg.alf = cfg.lmcs = False
            cfg.dep_quant = cfg.lfnst = cfg.mts = False
        mm = cfg.mm
        self.cfg = cfg
        self.sps = cfg.make_sps()
        self.pps = PPS(base_qp=cfg.qp)
        self.results: list[FrameResult] = []
        # POC -> device-resident reconstruction (y, u, v): the DPB stays
        # on the device so reference planes never cross to the host twice
        self._dpb_dev: dict[int, tuple] = {}
        # previous frame's per-model MV stack (device): temporal seed for
        # the model search diamonds (encoder-side state, non-normative)
        self._mm_seed = None
        self._mm_seed_qt = None
        # POC -> final classic P MV field (host): the co-located field
        # that TMVP reads; pruned with the DPB
        self._mv_fields: dict[int, np.ndarray] = {}
        self._pending_alf_chroma = None
        self._pending_ccalf = None
        # reference: EncLib.cpp:335-357 projection + MVReprojection init
        proj = make_projection(int(mm.projection), cfg.width, cfg.height,
                               motion=mm.any_enabled())
        self.reproj = MVReprojection(proj, cfg.width, cfg.height,
                                     mm.mm_offset_4x4, int(mm.ged_flavor),
                                     device=self.device)
        # GED epipoles: the configuration's (curPOC, refPOC) list, and the
        # decoder's mirror of the epipoles already signalled in picture
        # headers — the predictor must be derivable on the decoder side
        # (reference: EpipoleList availability gating, makeAvailable)
        self.epipole_list = epipole_mod.EpipoleList(mm.global_epipole)
        self.coded_epipoles = epipole_mod.EpipoleList(mm.global_epipole)
        for (c, r, x, y, z) in cfg.epipoles:
            self.epipole_list.set_epipole(c, r, (x, y, z))
        # MM-MVP: cross-model MVP candidates converted on the host
        self.mvp_conv = (MMVPConverter(cfg.width, cfg.height,
                                       int(mm.ged_flavor))
                         if mm.mmmvp else None)
        # of the picture encoded last, for tests and the smoke run: the
        # deblocked reconstruction before SAO/ALF (device), the CABAC
        # payload and the slice header
        self.prefilter_recon = None
        self.payload = b""
        self.slice_header = None
        # LMCS: the forward and inverse LUTs on the device (set by
        # encode_sequence); the film grain SEI's parameters once sent
        self._fwd_lut = self._inv_lut = None
        self.film_grain_params = None

    ra_coding_order = staticmethod(ra_coding_order)

    def _make_rc(self) -> RateControl | None:
        """reference: RateCtrl.h EncRCSeq init from the target bit rate."""
        if self.cfg.target_bitrate_kbps <= 0:
            return None
        return RateControl(self.cfg.target_bitrate_kbps * 1000.0,
                           self.cfg.frame_rate, self.cfg.width,
                           self.cfg.height)

    def _prune_mv_fields(self) -> None:
        """Keep the MV fields of the pictures still in the DPB only."""
        for p in list(self._mv_fields):
            if p not in self._dpb_dev:
                del self._mv_fields[p]

    def _hash_sei(self, poc: int, recon: list[np.ndarray],
                  tid: int = 0) -> NalUnit:
        """Decoded-picture-hash SEI (reference: EncGOP.cpp:4124-4127,
        SEIEncoder::initDecodedPictureHashSEI — MD5 of the final
        reconstruction, verified by the decoder)."""
        m = hashlib.md5()
        for p in recon:
            if self.cfg.bit_depth > 8:
                m.update(p.astype("<u2").tobytes())
            else:
                m.update(p.astype(np.uint8).tobytes())
        bw = BitWriter()
        bw.write(0, 8)                    # payload type 0: MD5
        bw.write_uvlc(poc)
        for b in m.digest():
            bw.write(b, 8)
        bw.align()
        # the SEI rides its picture's temporal id so temporal extraction
        # drops them together
        return NalUnit(NAL_SEI, tid, bw.get_bytes())

    def _refs(self, poc: int, planes):
        """The device planes of a reference: the encoder's own DPB entry,
        else an upload of the host planes."""
        dev = self._dpb_dev.get(poc)
        if dev is None:
            dev = xfer.upload_planes(planes, self.cfg.bit_depth,
                                     self.device)
        return dev

    def _film_grain_sei(self, planes, recon) -> NalUnit | None:
        """Source-against-recon grain analysis -> an fgc SEI (reference:
        SEIFilmGrainAnalyzer -> SEI payload type 19); None when no band
        has grain."""
        params = fg.analyze(planes[0], recon[0], self.cfg.bit_depth)
        if params is None:
            return None
        self.film_grain_params = params
        bw = BitWriter()
        bw.write(fg.SEI_FILM_GRAIN, 8)
        params.write(bw)
        bw.align()
        return NalUnit(NAL_SEI, 0, bw.get_bytes())

    SEI_MCTS = inter_frame.SEI_MCTS

    def _mcts_sei(self) -> NalUnit:
        """The tile grid whose sets are motion-constrained, so that an
        extractor can pull any tile on its own (reference: MCTS.{cpp,h} +
        the temporal MCTS SEI; the ME side is
        inter_frame.mcts_clamp_mvs)."""
        cols, rows = self.cfg.mcts_tiles
        bw = BitWriter()
        bw.write(self.SEI_MCTS, 8)
        bw.write_uvlc(cols)
        bw.write_uvlc(rows)
        bw.align()
        return NalUnit(NAL_SEI, 0, bw.get_bytes())

    def encode_headers(self) -> list[NalUnit]:
        """The SPS and PPS NAL units, and the MCTS SEI where tiles are
        set."""
        bw = BitWriter()
        self.sps.write(bw)
        sps_nal = NalUnit(NAL_SPS, 0, bw.get_bytes())
        bw = BitWriter()
        self.pps.write(bw)
        out = [sps_nal, NalUnit(NAL_PPS, 0, bw.get_bytes())]
        if self.cfg.mcts_tiles:
            out.append(self._mcts_sei())
        return out

    @_picture("I")
    def encode_intra_frame(self, poc: int, planes: list[np.ndarray],
                           qp: int | None = None
                           ) -> tuple[NalUnit, FrameResult]:
        """IDR picture: closed-loop wavefront intra encode on the device,
        one packed pull of the nine per-step outputs, host CABAC while the
        device runs SAO and the ALF statistics."""
        cfg = self.cfg
        qp = cfg.qp if qp is None else qp
        s = cfg.intra_block_size
        self._mm_seed = None        # closed GOP: no temporal seed across IDR
        self._mm_seed_qt = None
        dev = xfer.upload_planes(planes, cfg.bit_depth, self.device)
        if cfg.intra_split:
            return self._encode_intra_frame_part(poc, planes, dev, qp)
        nby, nbx = cfg.height // s, cfg.width // s
        with profiling.stage("intra_search") as ps:
            outs, recon = wavefront.encode_intra_frame(
                dev[0], dev[1], dev[2], qp, s, cfg.bit_depth,
                dep_quant=cfg.dep_quant, use_lfnst=cfg.lfnst,
                use_ts=cfg.transform_skip and not cfg.lossless,
                use_bdpcm=cfg.bdpcm, lossless=cfg.lossless,
                use_mts=cfg.mts, use_rdoq=cfg.rdoq, use_cclm=cfg.cclm,
                use_mip=cfg.mip, use_mrl=cfg.mrl, use_ibc=cfg.ibc)
            if cfg.deblocking:
                bs_v, bs_h = deblock.boundary_strengths_intra(nby, nbx,
                                                              self.device)
                ry, ru, rv = deblock.deblock_frame(
                    recon["y"], recon["u"], recon["v"], bs_v, bs_h, s, qp,
                    cfg.bit_depth)
                recon = dict(y=ry, u=ru, v=rv)
            ps.set_sync(self.device)

        def make_payload():
            # ONE packed int16 copy for all mode/level outputs (modes fit
            # uint8, levels int16)
            pulled = xfer.pull_levels(*outs)
            coords, valid = wavefront.wavefront_coords(nby, nbx)
            modes, lm, lf, mrl, tsg, mtsg, ly, lu, lv = (
                wavefront.steps_to_grid(p, coords, valid) for p in pulled)
            use_ts = cfg.transform_skip and not cfg.lossless
            args = dict(cclm=lm if cfg.cclm else None, mip=cfg.mip,
                        lfnst=lf if cfg.lfnst else None,
                        mrl=mrl if cfg.mrl else None,
                        ts=tsg if use_ts else None, bdpcm=cfg.bdpcm,
                        ibc=cfg.ibc, mts=mtsg if cfg.mts else None)
            if cfg.wpp:
                return encode_intra_slice_wpp(
                    modes, ly, lu, lv, num_substreams=cfg.num_substreams,
                    **args)
            return encode_intra_slice(modes, ly, lu, lv, **args)

        return self._finish_slice_overlap(
            poc, planes, recon, make_payload, qp, SliceType.I, [], [],
            None, 0, dev, NAL_IDR)

    def _encode_intra_frame_part(self, poc, planes, dev, qp):
        """Two-level (16x16 against four 8x8) intra picture
        (common/intra_part.py), deblocked on the 8x8 grid (every possible
        transform edge) on both sides."""
        cfg = self.cfg
        with profiling.stage("intra_search") as ps:
            outs, recon = intra_part.encode_intra_frame_part(
                *dev, qp, cfg.bit_depth)
            if cfg.deblocking:
                bs_v, bs_h = deblock.boundary_strengths_intra(
                    cfg.height // 8, cfg.width // 8, self.device)
                recon = dict(zip("yuv", deblock.deblock_frame(
                    recon["y"], recon["u"], recon["v"], bs_v, bs_h, 8, qp,
                    cfg.bit_depth)))
            ps.set_sync(self.device)

        def make_payload():
            coords, valid = wavefront.wavefront_coords(
                cfg.height // intra_part.SB, cfg.width // intra_part.SB)
            return encode_intra_slice_part(*(
                wavefront.steps_to_grid(p, coords, valid)
                for p in xfer.pull_levels(*outs)))

        return self._finish_slice_overlap(
            poc, planes, recon, make_payload, qp, SliceType.I, [], [],
            None, 0, dev, NAL_IDR)

    def _p_epipoles(self, poc: int, ref_poc: int):
        """GED epipole of a P picture (reference: EncGOP.cpp:3105): the
        configured one, coded in the PH as a 2^-24 fixed-point delta
        against the predictor the decoder derives from the epipoles
        already coded.  Returns (epipoles dict or None, PH delta or
        None)."""
        if not self.cfg.mm.ged:
            return None, None
        ep = self.epipole_list.find_epipole(poc, ref_poc)
        pred = self.coded_epipoles.derive_predictor(poc, ref_poc)
        delta = tuple(a - b for a, b in zip(epipole_mod.to_fixed(ep),
                                            epipole_mod.to_fixed(pred)))
        ep_used = epipole_mod.from_fixed(tuple(
            a + b for a, b in zip(epipole_mod.to_fixed(pred), delta)))
        self.coded_epipoles.set_epipole(poc, ref_poc, ep_used)
        return {MotionModelID.GEODESIC_CAMPOSE: ep_used}, delta

    @_picture("P")
    def encode_p_frame(self, poc: int, planes: list[np.ndarray],
                       ref: list[np.ndarray], ref_poc: int,
                       qp: int | None = None,
                       ref2: list[np.ndarray] | None = None,
                       ref2_poc: int = -1
                       ) -> tuple[NalUnit, FrameResult]:
        """P encode against one or two reference reconstructions
        (reference: EncGOP::compressGOP inter picture path; per-ref ME
        InterSearch.cpp:4937).  `ref2` activates a per-block ref_idx on
        the classic merge path; a multi-model configuration ignores it."""
        cfg = self.cfg
        qp = cfg.qp if qp is None else qp
        dev = xfer.upload_planes(planes, cfg.bit_depth, self.device)
        rdev = self._refs(ref_poc, ref)
        if not cfg.mm.any_enabled():
            if cfg.qt_depth > 0:
                recon, make_payload = self._tree_picture(dev, rdev, None, qp)
                return self._finish_slice_overlap(
                    poc, planes, recon, make_payload, qp, SliceType.P,
                    [ref_poc], [], None, 0, dev)
            if cfg.affine:
                recon, make_payload = self._p_affine(dev, rdev, qp)
                return self._finish_slice_overlap(
                    poc, planes, recon, make_payload, qp, SliceType.P,
                    [ref_poc], [], None, 0, dev)
            use_2ref = (ref2 is not None and cfg.max_num_ref >= 2
                        and cfg.merge and not cfg.mcts_tiles
                        and not cfg.wpp)
            r2dev = self._refs(ref2_poc, ref2) if use_2ref else None
            wp = (self._estimate_wp(planes, ref) if cfg.weighted_pred
                  else None)
            recon, make_payload = self._p_classic(poc, dev, rdev, r2dev, qp,
                                                  ref_poc, wp)
            return self._finish_slice_overlap(
                poc, planes, recon, make_payload, qp, SliceType.P,
                [ref_poc, ref2_poc] if use_2ref else [ref_poc], [], None, 0,
                dev, wp_params=wp)
        active = cfg.mm.active_models()
        epipoles, epipole_delta = self._p_epipoles(poc, ref_poc)
        if cfg.qt_depth > 0:
            recon, make_payload = self._p_quadtree(active, dev, rdev, qp,
                                                   epipoles)
        else:
            recon, make_payload = self._p_flat(active, dev, rdev, qp,
                                               epipoles)
        return self._finish_slice_overlap(
            poc, planes, recon, make_payload, qp, SliceType.P,
            [ref_poc], [], epipole_delta, 0, dev)

    def _p_classic(self, poc, dev, rdev, r2dev, qp, ref_poc, wp):
        """Classic P picture on the fixed grid.  With merge, the device
        search (ME, the AMVR decision, the candidate fields' SADs, per
        reference when `r2dev` is given) -> one pull -> host merge
        selection in coding order -> the device finish from the FINAL
        fields (reference: merge candidates UnitTools.cpp:1059, EncCu
        xCheckRDCostMerge2Nx2N); without it, one program codes the
        search's MVs.  TMVP reads the reference's final MV field (none
        after an I picture); `wp` ((w, o) per plane, or None) weights the
        prediction.  MCTS clamps the search's MVs and turns off snapping to
        other candidates (a neighbour's MV can leave this block's tile);
        WPP codes the merge slice in substreams, and with TMVP the
        selection resets its HMVP FIFO where they start.  Returns (recon,
        make_payload)."""
        cfg = self.cfg
        s = cfg.inter_block_size
        bd = cfg.bit_depth
        nby, nbx = cfg.height // s, cfg.width // s
        lam_sqrt = quant.lambda_from_qp(qp, intra=False) ** 0.5
        mer = mer_blocks_log2(self.sps.log2_parallel_merge_level, s)
        col_h = self._mv_fields.get(ref_poc) if cfg.tmvp else None
        imv = None

        def t(a):
            return torch.from_numpy(a.astype(np.int32)).to(self.device)

        wp_d = None if wp is None else t(np.asarray(wp))
        # the scaling list reaches the P passes only (the JAX package's B,
        # affine and multi-model passes do not take it)
        scaling = tuple(cfg.scaling_list) or None
        mcts = tuple(cfg.mcts_tiles) or None
        if not cfg.merge:
            with profiling.stage("finish") as ps:
                out = inter_frame.encode_p_frame(
                    *dev, *rdev, qp, s, bd, cfg.search_range,
                    cfg.wrap_around, wp=wp_d, scaling=scaling,
                    amvr=cfg.amvr, mcts=mcts)
                mvs, ly, lu, lv, recon = out[0], *out[-4:]
                imv = out[1] if cfg.amvr else None
                recon = self._deblock_inter(recon, mvs, (ly, lu, lv), qp)
                ps.set_sync(self.device)
        else:
            col = (t(col_h) if col_h is not None else
                   torch.zeros((nby, nbx, 2), dtype=torch.int32,
                               device=self.device))
            with profiling.stage("search") as ps:
                if r2dev is not None:
                    out = inter_frame.search_p_frame_2ref(
                        dev[0], rdev[0], r2dev[0], col, qp, s, bd,
                        cfg.search_range, cfg.wrap_around, amvr=cfg.amvr)
                else:
                    out = inter_frame.search_p_frame(
                        dev[0], rdev[0], col, qp, s, bd, cfg.search_range,
                        cfg.wrap_around, amvr=cfg.amvr, mcts=mcts)
                ps.set_sync(self.device)
            with profiling.stage("select+pull"):
                pulled = xfer.pull_i32(*out)
                if r2dev is not None:
                    (ref_h, mvs_h, imv_h, sad_h, cref_h, cmv_h,
                     csad_h) = pulled
                    f_ref, final, mflag, midx = select_merge_p_2ref(
                        ref_h, mvs_h, sad_h, cref_h, cmv_h, csad_h, col_h,
                        lam_sqrt, cfg.tmvp, mer)
                else:
                    mvs_h, imv_h, sad_h, cmv_h, csad_h = pulled
                    starts = (wpp_substream_starts(nby, cfg.num_substreams)
                              if cfg.wpp and cfg.tmvp else ())
                    final, mflag, midx = select_merge_p(
                        mvs_h, sad_h, cmv_h, csad_h, col_h, lam_sqrt,
                        cfg.tmvp, mer, snap=not mcts,
                        substream_starts=starts)
                imv = imv_h if cfg.amvr else None
            self._mv_fields[poc] = final
            mvs = t(final)
            with profiling.stage("finish") as ps:
                if r2dev is not None:
                    ly, lu, lv, recon = inter_frame.finish_p_frame_2ref(
                        *dev, tuple(rdev), tuple(r2dev), t(f_ref), mvs, qp,
                        s, bd, cfg.wrap_around, wp=wp_d, scaling=scaling)
                else:
                    ly, lu, lv, recon = inter_frame.finish_p_frame(
                        *dev, *rdev, mvs, qp, s, bd, cfg.wrap_around,
                        wp=wp_d, scaling=scaling)
                recon = self._deblock_inter(recon, mvs, (ly, lu, lv), qp)
                ps.set_sync(self.device)

        def make_payload():
            tools = dict(col_mvs=col_h, use_tmvp=cfg.tmvp)
            if not cfg.merge:
                lyh, luh, lvh, mvs_h, *imv_h = xfer.pull_levels(
                    ly, lu, lv, mvs, *([] if imv is None else [imv]))
                self._mv_fields[poc] = mvs_h.astype(np.int64)
                return encode_p_slice(mvs_h, lyh, luh, lvh,
                                      imv=imv_h[0] if imv_h else None,
                                      **tools)
            lyh, luh, lvh = xfer.pull_levels(ly, lu, lv)
            if r2dev is not None:
                return encode_p_slice_2ref(f_ref, final, lyh, luh, lvh,
                                           imv=imv, merge_flag=mflag,
                                           merge_idx=midx, **tools)
            if cfg.wpp:
                return encode_p_slice_wpp(
                    final, lyh, luh, lvh, imv=imv, merge_flag=mflag,
                    merge_idx=midx, num_substreams=cfg.num_substreams,
                    **tools)
            return encode_p_slice(final, lyh, luh, lvh, imv=imv,
                                  merge_flag=mflag, merge_idx=midx, **tools)

        return recon, make_payload

    def _p_affine(self, dev, rdev, qp):
        """Affine P picture (common/affine.py): the translational ME, the
        batched affine search (K1 three times) and the per-block decision,
        then one prediction of all planes from the mixed positions (K1
        once, K2 twice) and the residual pass.  Returns (recon,
        make_payload)."""
        cfg = self.cfg
        s = cfg.inter_block_size
        with profiling.stage("affine") as ps:
            mvs, aff, dmv, ly, lu, lv, recon = \
                affine_mod.encode_p_frame_affine(
                    *dev, *rdev, qp, s, cfg.bit_depth, cfg.search_range,
                    cfg.wrap_around)
            recon = self._deblock_inter(recon, mvs, (ly, lu, lv), qp)
            ps.set_sync(self.device)

        def make_payload():
            lyh, luh, lvh, mvs_h, aff_h, dmv_h = xfer.pull_levels(
                ly, lu, lv, mvs, aff, dmv)
            return encode_p_slice_affine(mvs_h, aff_h, dmv_h, lyh, luh, lvh)

        return recon, make_payload

    def _estimate_wp(self, planes, ref):
        """DC/AC weight estimation (reference: WeightPredAnalysis): match
        each plane's mean/std to the reference; identity -> None."""
        out = []
        for o, r in zip(planes, ref):
            so, sr = float(np.std(o)), float(np.std(r))
            w = int(np.clip(round(64.0 * so / sr), 1, 255)) if sr > 1e-3 \
                else 64
            off = int(np.clip(round(float(np.mean(o))
                                    - w * float(np.mean(r)) / 64.0),
                              -128, 127))
            out.append((w, off))
        # signal only on a clear luma-level change (fades); chroma stats on
        # ordinary content are too noisy to pay the table for
        wy, oy = out[0]
        return out if (abs(wy - 64) > 2 or abs(oy) > 2) else None

    def _deblock_inter(self, recon, mvs, levels, qp):
        """Deblock a classic inter picture: bs from the per-block MVs and
        coded residual (reference: xGetBoundaryStrengthSingle)."""
        cfg = self.cfg
        if not cfg.deblocking:
            return recon
        has_resid = (levels[0] != 0).any(3).any(2)
        for lev in levels[1:]:
            has_resid = has_resid | (lev != 0).any(3).any(2)
        bs_v, bs_h = deblock.boundary_strengths_inter(
            mvs.to(torch.int32), has_resid)
        ry, ru, rv = deblock.deblock_frame(
            recon["y"], recon["u"], recon["v"], bs_v, bs_h,
            cfg.inter_block_size, qp, cfg.bit_depth)
        return dict(y=ry, u=ru, v=rv)

    def _deblock_tree(self, recon, mv_unit, has_resid_unit, leaf_id_unit,
                      qp):
        """Deblock a quadtree / MTT picture on its unit grid, at the
        leaves' boundaries only."""
        cfg = self.cfg
        if not cfg.deblocking:
            return recon
        bs_v, bs_h = qtree.qt_boundary_strengths(mv_unit, has_resid_unit,
                                                 leaf_id_unit)
        return dict(zip("yuv", deblock.deblock_frame(
            recon["y"], recon["u"], recon["v"], bs_v, bs_h,
            cfg.inter_block_size >> cfg.qt_depth, qp, cfg.bit_depth)))

    def _tree_picture(self, dev, r0, r1, qp):
        """Classic quadtree P (r1 None) or B picture, with `mtt` the
        multi-type tree: every node size's and shape's pass, the tree
        resolve, the reconstruction and the deblocking on the device, then
        one pull of the coded grids and the host CABAC.  B pictures of the
        quadtree take BDOF and DMVR in their reconstruction, as in the JAX
        package (its MTT path takes neither).  Returns (recon,
        make_payload)."""
        cfg = self.cfg
        s, nd = cfg.inter_block_size, cfg.qt_depth
        args = (qp, s, nd, cfg.bit_depth, cfg.search_range, cfg.wrap_around)
        with profiling.stage("tree") as ps:
            if r1 is None:
                enc = (mtt_mod.encode_p_frame_mtt if cfg.mtt
                       else qtree.encode_p_frame_qt)
                out = enc(*dev, *r0, *args)
                mv_unit = out["mv_unit"]
            else:
                if cfg.mtt:
                    out = mtt_mod.encode_b_frame_mtt(*dev, tuple(r0),
                                                     tuple(r1), *args)
                else:
                    out = qtree.encode_b_frame_qt(*dev, tuple(r0), tuple(r1),
                                                  *args, cfg.bdof, cfg.dmvr)
                mv_unit = torch.where(out["dirs_unit"][..., None] == 1,
                                      out["mv1_unit"], out["mv0_unit"])
            recon = self._deblock_tree(out["recon"], mv_unit,
                                       out["has_resid_unit"],
                                       out["leaf_id_unit"], qp)
            ps.set_sync(self.device)

        if cfg.mtt:
            keys = (("codes", "sq_mv", "sq_levels", "rect_mv", "rect_levels")
                    if r1 is None else
                    ("codes", "sq_mv0", "sq_mv1", "sq_dirs", "sq_levels",
                     "rect_mv0", "rect_mv1", "rect_dirs", "rect_levels"))
            writer = encode_p_slice_mtt if r1 is None else encode_b_slice_mtt
        else:
            keys = (("splits", "mvs", "levels") if r1 is None else
                    ("splits", "mv0", "mv1", "dirs", "levels"))
            writer = encode_p_slice_qt if r1 is None else encode_b_slice_qt

        def make_payload():
            grids = xfer.pull_nested([out[k] for k in keys])
            return writer(*grids, s, nd, use_merge=cfg.merge)

        return recon, make_payload

    def _p_quadtree(self, active, dev, rdev, qp, epipoles):
        """MM x partitioning, merge-aware: the unit level runs the
        flat-path search (identical decisions), parents are evaluated from
        their children, the tree resolves on the host, and leaves get the
        flat merge/skip syntax (reference: EncCu.cpp:499 xCompressCU + the
        per-model mode loop EncCu.cpp:775-798).  Returns (recon,
        make_payload)."""
        cfg = self.cfg
        s = cfg.inter_block_size
        nd = cfg.qt_depth
        with profiling.stage("mm_search") as ps:
            per_dev, stack = qt_codec.search_qt_mm(
                self.reproj, active, dev[0], rdev[0], qp, s, nd,
                cfg.bit_depth, cfg.search_range, epipoles, cfg.wrap_around,
                seed=self._mm_seed_qt)
            rd_dev = [qt_codec.qt_rd_stats(
                self.reproj, active, t[0], t[1], dev[0], dev[1], dev[2],
                rdev[0], rdev[1], rdev[2], qp, s >> i, cfg.bit_depth,
                epipoles, cfg.wrap_around) for i, t in enumerate(per_dev)]
            ps.set_sync(self.device)
        self._mm_seed_qt = stack
        with profiling.stage("mm_select+pull"):
            flat = [a for tup in per_dev for a in tup]
            flat += [a for tup in rd_dev for a in tup]
            pulled = xfer.pull_i32(*flat)
            per_h = [tuple(pulled[6 * i:6 * i + 6])
                     for i in range(len(per_dev))]
            off = 6 * len(per_dev)
            rd_h = [tuple(pulled[off + 2 * i:off + 2 * i + 2])
                    for i in range(len(rd_dev))]
            lam = quant.lambda_from_qp(qp, intra=False)
            splits, leaf = resolve_tree_qt_mm(per_h, rd_h, len(active), lam,
                                              nd)
            midx_u, mv_u, decisions = select_qt_mm(
                per_h, splits, leaf, active, lam ** 0.5, s, nd)
        mv_u_dev = torch.from_numpy(mv_u.astype(np.int32)).to(self.device)
        with profiling.stage("mm_finish") as ps:
            levels, recon, has_resid_u, leaf_id_u = \
                qt_codec.enc_finish_qt_mm(
                    self.reproj, active,
                    torch.from_numpy(midx_u).to(self.device), mv_u_dev,
                    [torch.from_numpy(m).to(self.device) for m in leaf],
                    dev[0], dev[1], dev[2], rdev[0], rdev[1], rdev[2], qp,
                    s, nd, cfg.bit_depth, epipoles, cfg.wrap_around)
            recon = self._deblock_tree(recon, mv_u_dev, has_resid_u,
                                       leaf_id_u, qp)
            ps.set_sync(self.device)

        def make_payload():
            lev_h = xfer.pull_levels(*[l for trio in levels for l in trio])
            lev_h = [tuple(lev_h[3 * i:3 * i + 3]) for i in range(nd + 1)]
            return encode_p_slice_qt_mm(splits, decisions, lev_h, s, nd,
                                        len(active))

        return recon, make_payload

    def _p_flat(self, active, dev, rdev, qp, epipoles):
        """Flat-grid MM P picture.  With merge, the candidate-field SADs
        ride the search, the host snaps blocks to (model, mv) candidates
        in coding order, and the positions/finish run from the FINAL grids
        (model inheritance through merge, reference: UnitTools.cpp:
        872-885); without it the search's grids are coded as they are.
        Returns (recon, make_payload)."""
        cfg = self.cfg
        s = cfg.inter_block_size
        ep_mvp = (epipoles or {}).get(MotionModelID.GEODESIC_CAMPOSE)
        if cfg.merge:
            with profiling.stage("mm_search") as ps:
                out = mm_codec.search_p_mm_merge(
                    self.reproj, active, dev[0], rdev[0], qp, s,
                    cfg.bit_depth, cfg.search_range, epipoles,
                    cfg.wrap_around, seed=self._mm_seed)
                ps.set_sync(self.device)
            with profiling.stage("mm_select+pull"):
                pulled = xfer.pull_i32(*out)
                lam_sqrt = quant.lambda_from_qp(qp, intra=False) ** 0.5
                f_midx, f_stack, mflag, midx_m = select_merge_mm(
                    *pulled, active, lam_sqrt, s, self.mvp_conv, ep_mvp,
                    mer_blocks_log2(self.sps.log2_parallel_merge_level, s))
            model_idx = torch.from_numpy(f_midx).to(self.device)
            mvs_stack = torch.from_numpy(
                f_stack.astype(np.int32)).to(self.device)
        else:
            with profiling.stage("mm_search") as ps:
                model_idx, mvs_stack = mm_codec.search_p_mm(
                    self.reproj, active, dev[0], rdev[0], qp, s,
                    cfg.bit_depth, cfg.search_range, epipoles,
                    cfg.wrap_around, seed=self._mm_seed)
                ps.set_sync(self.device)
        self._mm_seed = mvs_stack
        with profiling.stage("mm_finish") as ps:
            ly, lu, lv, recon = mm_codec.enc_finish_p_mm_fused(
                self.reproj, active, model_idx, mvs_stack, dev, rdev, qp, s,
                cfg.bit_depth, epipoles, cfg.wrap_around, cfg.deblocking)
            ps.set_sync(self.device)

        def make_payload():
            if cfg.merge:
                lyh, luh, lvh = xfer.pull_levels(ly, lu, lv)
                return encode_p_slice_mm(
                    f_midx, active, f_stack, lyh, luh, lvh, s,
                    self.mvp_conv, ep_mvp, merge_flag=mflag,
                    merge_idx=midx_m)
            lyh, luh, lvh, midx_h, stack_h = xfer.pull_levels(
                ly, lu, lv, model_idx, mvs_stack)
            return encode_p_slice_mm(
                midx_h, active, stack_h.astype(np.int64), lyh, luh, lvh, s,
                self.mvp_conv, ep_mvp)

        return recon, make_payload

    @_picture("B")
    def encode_b_frame(self, poc: int, planes: list[np.ndarray],
                       ref0: list[np.ndarray], ref0_poc: int,
                       ref1: list[np.ndarray], ref1_poc: int, tid: int = 0,
                       qp: int | None = None
                       ) -> tuple[NalUnit, FrameResult]:
        """Hierarchical-B encode against past+future references (reference:
        EncGOP compressGOP B pictures; RA GOP table
        cfg/encoder_randomaccess_vtm.cfg:13-33).  GED epipoles come from
        the decoder-mirrored list (exact -> per-POC -> global), so B
        slices carry no epipole syntax."""
        cfg = self.cfg
        qp = cfg.qp if qp is None else qp
        s = cfg.inter_block_size
        dev = xfer.upload_planes(planes, cfg.bit_depth, self.device)
        r0 = self._refs(ref0_poc, ref0)
        r1 = self._refs(ref1_poc, ref1)
        if not cfg.mm.any_enabled() and cfg.qt_depth > 0:
            recon, make_payload = self._tree_picture(dev, r0, r1, qp)
            return self._finish_slice_overlap(
                poc, planes, recon, make_payload, qp, SliceType.B,
                [ref0_poc], [ref1_poc], None, tid, dev)
        if not cfg.mm.any_enabled():
            wp0 = wp1 = None
            if cfg.weighted_bipred:
                wp0 = self._estimate_wp(planes, ref0)
                wp1 = self._estimate_wp(planes, ref1)
                if wp0 is not None or wp1 is not None:
                    ident = [(64, 0)] * 3
                    wp0 = wp0 if wp0 is not None else ident
                    wp1 = wp1 if wp1 is not None else ident
            recon, make_payload = self._b_classic(dev, r0, r1, qp, wp0, wp1)
            return self._finish_slice_overlap(
                poc, planes, recon, make_payload, qp, SliceType.B,
                [ref0_poc], [ref1_poc], None, tid, dev, wp_params=wp0,
                wp_params_l1=wp1)
        active = cfg.mm.active_models()
        eps0 = eps1 = None
        if cfg.mm.ged:
            eps0 = {MotionModelID.GEODESIC_CAMPOSE:
                    self.coded_epipoles.find_epipole(poc, ref0_poc)}
            eps1 = {MotionModelID.GEODESIC_CAMPOSE:
                    self.coded_epipoles.find_epipole(poc, ref1_poc)}
        ep0 = (eps0 or {}).get(MotionModelID.GEODESIC_CAMPOSE)
        ep1 = (eps1 or {}).get(MotionModelID.GEODESIC_CAMPOSE)
        mflag = midx = None
        if cfg.merge:
            # whole-motion MM merge: candidate-field SADs ride the search;
            # host selection snaps (dir, model, mv) triples in coding order
            with profiling.stage("mm_search_b") as ps:
                out = mm_codec.search_b_mm_merge(
                    self.reproj, active, dev[0], r0[0], r1[0], qp, s,
                    cfg.bit_depth, cfg.search_range, eps0, eps1,
                    cfg.wrap_around)
                ps.set_sync(self.device)
            with profiling.stage("mm_select_b+pull"):
                pulled = xfer.pull_i32(*out)
                lam_sqrt = quant.lambda_from_qp(qp, intra=False) ** 0.5
                (f_m0, f_m1, f_s0, f_s1, f_d, mflag,
                 midx) = select_merge_b_mm(
                    *pulled, active, lam_sqrt, s, self.mvp_conv, ep0, ep1,
                    mer_blocks_log2(self.sps.log2_parallel_merge_level, s))

            def t(a):
                return torch.from_numpy(a.astype(np.int32)).to(self.device)

            midx0, midx1, dirs = t(f_m0), t(f_m1), t(f_d)
            stack0, stack1 = t(f_s0), t(f_s1)
        else:
            with profiling.stage("mm_search_b") as ps:
                midx0, midx1, stack0, stack1, dirs = mm_codec.search_b_mm(
                    self.reproj, active, dev[0], r0[0], r1[0], qp, s,
                    cfg.bit_depth, cfg.search_range, eps0, eps1,
                    cfg.wrap_around, seed=self._mm_seed)
                ps.set_sync(self.device)
        self._mm_seed = stack0
        rstack0, rstack1 = stack0, stack1
        if cfg.dmvr:
            # projected DMVR refines the PREDICTION's MVs (the decoder runs
            # the same on the signalled stacks); the signalled stacks and
            # the deblocking MV field stay unrefined
            with profiling.stage("mm_dmvr_b") as ps:
                rstack0, rstack1 = mm_codec.projected_dmvr(
                    self.reproj, active, midx0, midx1, stack0, stack1, dirs,
                    r0[0], r1[0], s, cfg.bit_depth, eps0, eps1,
                    cfg.wrap_around)
                ps.set_sync(self.device)
        with profiling.stage("mm_finish_b") as ps:
            ly, lu, lv, recon = mm_codec.enc_finish_b_mm_fused(
                self.reproj, active, midx0, midx1, stack0, stack1, rstack0,
                rstack1, dirs, dev, tuple(r0), tuple(r1), qp, s,
                cfg.bit_depth, eps0, eps1, cfg.wrap_around, cfg.deblocking)
            ps.set_sync(self.device)

        def make_payload():
            if cfg.merge:
                lyh, luh, lvh = xfer.pull_levels(ly, lu, lv)
                return encode_b_slice_mm(
                    f_m0, f_m1, active, f_s0, f_s1, f_d, lyh, luh, lvh, s,
                    self.mvp_conv, ep0, ep1, merge_flag=mflag,
                    merge_idx=midx)
            (lyh, luh, lvh, m0h, m1h, s0h, s1h,
             dh) = xfer.pull_levels(ly, lu, lv, midx0, midx1, stack0,
                                    stack1, dirs)
            return encode_b_slice_mm(
                m0h, m1h, active, s0h.astype(np.int64),
                s1h.astype(np.int64), dh, lyh, luh, lvh, s, self.mvp_conv,
                ep0, ep1)

        return self._finish_slice_overlap(
            poc, planes, recon, make_payload, qp, SliceType.B,
            [ref0_poc], [ref1_poc], None, tid, dev)

    def _b_classic(self, dev, r0, r1, qp, wp0, wp1):
        """Classic B picture on the fixed grid: per-list ME and the
        uni/bi/GPM/CIIP decision on the device; with merge, the
        whole-motion candidate fields' SADs ride the search and the host
        snaps blocks to (dir, mv0, mv1) candidates in coding order; then
        prediction, residual, recon and deblock from the FINAL grids.
        Explicit weights win per slice: where `wp0`/`wp1` are given, BDOF,
        DMVR, GPM and CIIP are off for this slice (reference: BDOF's
        biocheck0 / DMVR's no-WP condition, InterPrediction.cpp:566,252;
        GPM/CIIP never combine with explicit weights in VVC); the decoder
        mirrors it from the slice header.  Returns (recon, make_payload)."""
        cfg = self.cfg
        s = cfg.inter_block_size
        bd = cfg.bit_depth
        use_wpb = wp0 is not None
        sl_bdof, sl_dmvr, sl_gpm, sl_ciip = (
            on and not use_wpb for on in (cfg.bdof, cfg.dmvr, cfg.gpm,
                                          cfg.ciip))
        mflag = midx = None
        with profiling.stage("search_b") as ps:
            if cfg.merge:
                out = inter_frame.search_b_frame_merge(
                    dev[0], r0[0], r1[0], qp, s, bd, cfg.search_range,
                    cfg.wrap_around, sl_gpm, sl_ciip)
            else:
                mv0, mv1, dirs, gpm_modes = inter_frame.search_b_frame(
                    dev[0], r0[0], r1[0], qp, s, bd, cfg.search_range,
                    cfg.wrap_around, sl_gpm, sl_ciip)
            ps.set_sync(self.device)

        def t(a):
            return torch.from_numpy(a.astype(np.int32)).to(self.device)

        if cfg.merge:
            with profiling.stage("select_b+pull"):
                (mv0_h, mv1_h, dirs_h, gpm_h, sad_h, c0_h, c1_h, cd_h,
                 cs_h) = xfer.pull_i32(*out)
                lam_sqrt = quant.lambda_from_qp(qp, intra=False) ** 0.5
                mv0_h, mv1_h, dirs_h, mflag, midx = select_merge_b(
                    mv0_h, mv1_h, dirs_h, sad_h, c0_h, c1_h, cd_h, cs_h,
                    lam_sqrt, mer_blocks_log2(
                        self.sps.log2_parallel_merge_level, s))
            mv0, mv1, dirs, gpm_modes = (t(a) for a in (mv0_h, mv1_h,
                                                        dirs_h, gpm_h))
        wp = [None if w is None else t(np.asarray(w)) for w in (wp0, wp1)]
        with profiling.stage("finish_b") as ps:
            ly, lu, lv, recon = inter_frame.bpred_and_residual(
                *dev, tuple(r0), tuple(r1), mv0, mv1, dirs, qp, s, bd,
                cfg.wrap_around, sl_bdof, sl_dmvr, gpm_modes=gpm_modes,
                gpm=sl_gpm, ciip=sl_ciip, wp0=wp[0], wp1=wp[1])
            # prediction and deblock both read the USED list, so the
            # entropy pass's unused-list replacements never reach them
            recon = self._deblock_inter(
                recon, torch.where(dirs[..., None] == 1, mv1, mv0),
                (ly, lu, lv), qp)
            ps.set_sync(self.device)

        def make_payload():
            if cfg.merge:
                lyh, luh, lvh = xfer.pull_levels(ly, lu, lv)
                m0, m1, d, g = mv0_h, mv1_h, dirs_h, gpm_h
            else:
                lyh, luh, lvh, m0, m1, d, g = xfer.pull_levels(
                    ly, lu, lv, mv0, mv1, dirs, gpm_modes)
            args = dict(gpm_modes=g, use_gpm=sl_gpm, use_ciip=sl_ciip,
                        merge_flag=mflag, merge_idx=midx)
            if cfg.wpp and cfg.merge:
                return encode_b_slice_wpp(
                    m0, m1, d, lyh, luh, lvh,
                    num_substreams=cfg.num_substreams, **args)
            return encode_b_slice(m0, m1, d, lyh, luh, lvh, **args)[0]

        return recon, make_payload

    def _finish_slice_overlap(self, poc, planes, recon, make_payload, qp,
                              slice_type, ref_pocs_l0, ref_pocs_l1,
                              epipole_delta, tid, dev, nal_type=NAL_TRAIL,
                              wp_params=None, wp_params_l1=None):
        """Picture tail with entropy/filter overlap: enqueue the
        SAO + ALF-stats device stages first (no host wait), run the host
        entropy pass (make_payload pulls the coded grids and writes CABAC)
        while the device chain executes, then finish the filters.  The
        filter chain never reads the entropy-coded grids, so the two are
        independent (reference analog: EncGOP's separate compressSlice /
        encodeSlice passes)."""
        cfg = self.cfg
        lam = quant.lambda_from_qp(qp, intra=False)
        self.prefilter_recon = recon     # deblocked, before SAO/ALF
        sao_h = (filter_stage.sao_dispatch(recon, dev, lam, cfg.bit_depth)
                 if cfg.sao else None)
        post_sao = (dict(y=sao_h[0], u=sao_h[1], v=sao_h[2]) if cfg.sao
                    else recon)
        alf_h = (filter_stage.alf_stats_dispatch(post_sao, dev,
                                                 cfg.bit_depth)
                 if cfg.alf else None)
        with profiling.stage("entropy"):
            payload = make_payload()    # host entropy overlaps device filters
        self.payload = payload
        self._pending_alf_chroma = None
        self._pending_ccalf = None
        sao_params = None
        with profiling.stage("filters") as ps:
            if cfg.sao:
                recon, sao_params = filter_stage.sao_finish(recon, sao_h)
                recon = post_sao   # same values; keep the device chain's view
            alf_params = None
            if cfg.alf:
                recon, alf_params, self._pending_alf_chroma, \
                    self._pending_ccalf = filter_stage.run_alf(
                        post_sao, dev, lam, cfg.bit_depth,
                        stats_handles=alf_h)
            ps.set_sync(self.device)
        sh = SliceHeader(poc=poc, slice_type=slice_type, qp=qp,
                         temporal_id=tid, ref_pocs_l0=ref_pocs_l0,
                         ref_pocs_l1=ref_pocs_l1,
                         epipole_delta=epipole_delta,
                         sao_params=sao_params, alf_params=alf_params,
                         alf_chroma_params=self._pending_alf_chroma,
                         ccalf_params=self._pending_ccalf,
                         wp_params=_wp_table(wp_params),
                         wp_params_l1=_wp_table(wp_params_l1))
        self.slice_header = sh
        bw = BitWriter()
        sh.write(bw, self.sps)
        bw.write_bytes(payload)
        nal = NalUnit(nal_type, tid, bw.get_bytes())
        self._dpb_dev[poc] = (recon["y"], recon["u"], recon["v"])
        with profiling.stage("recon_pull"):
            rec, psnrs = xfer.finalize_recon(recon, dev, cfg.bit_depth)
        res = FrameResult(
            poc=poc, bits=len(nal.payload) * 8,
            psnr_y=psnrs[0], psnr_u=psnrs[1], psnr_v=psnrs[2],
            recon=rec)
        self._finish_frame(res, planes)
        self.results.append(res)
        return nal, res

    def encode_sequence(self, frames: list[list[np.ndarray]]) -> bytes:
        """Encode a frame list -> Annex-B bytes (AI / LDP / RA GOP).  With
        LMCS the luma planes are forward-mapped first and the results get
        their display-domain pictures (`_lmcs_outputs`); with film grain
        the first picture's analysis rides an SEI.  A `sequence` span
        while tracing."""
        with profiling.span("sequence", self.seq_id):
            return self._encode_sequence(frames)

    def _encode_sequence(self, frames: list[list[np.ndarray]]) -> bytes:
        cfg = self.cfg
        originals = frames
        if cfg.lmcs:
            # one forward map a source picture; the whole pipeline (the
            # picture hash included) runs in the mapped domain
            cw = reshape.estimate_codewords(frames[0][0], cfg.bit_depth)
            self.sps.lmcs_cw = tuple(int(c) for c in cw)
            self.sps.lmcs = True
            self._fwd_lut = reshape.build_fwd_lut(cw, cfg.bit_depth,
                                                  self.device)
            self._inv_lut = reshape.build_inv_lut(cw, cfg.bit_depth,
                                                  self.device)
            frames = [[reshape.map_plane(self._fwd_lut, f[0]), f[1], f[2]]
                      for f in frames]
        if cfg.mctf and len(frames) > 1:
            # MCTF on the RA anchors before any coding (reference:
            # EncApp.cpp:1547-1551 -> EncTemporalFilter::filter)
            frames = prefilter_sequence(frames, cfg.qp, cfg.bit_depth,
                                        period=max(cfg.gop_size, 1),
                                        device=self.device)
        nalus = self.encode_headers()
        rc = self._make_rc()
        cascade = cfg.ctc_qp_offsets and cfg.gop == "RA"

        def rc_qp(kind, tid=0):
            return rc.pick_qp(kind, tid) if rc is not None else None

        def qp_of(kind, tid=0):
            # the RA loop: rate control's pick, else the CTC cascade at a
            # fixed QP
            if rc is not None:
                return rc_qp(kind, tid)
            return ctc_qp(cfg.qp, kind, tid) if cascade else None

        def rc_update(res):
            if rc is not None:
                rc.update(res.bits)

        if cfg.gop == "RA" and len(frames) > 1:
            dpb: dict[int, list[np.ndarray]] = {}
            nal, res = self.encode_intra_frame(0, frames[0], qp=qp_of("I"))
            rc_update(res)
            nalus.append(nal)
            if cfg.film_grain:
                fg_nal = self._film_grain_sei(frames[0], res.recon)
                if fg_nal is not None:
                    nalus.append(fg_nal)
            if cfg.picture_hash_sei:
                nalus.append(self._hash_sei(0, res.recon))
            dpb[0] = res.recon
            # GOP-anchor P frames take the previous TWO anchors as their
            # reference list (RPL from the GOP structure; reference:
            # EncLib.cpp:2213 RPL selection, cfg GOP tables)
            anchors = [0]
            order = []
            for poc, r0, r1, tid in ra_coding_order(len(frames),
                                                    cfg.gop_size):
                r2 = -1
                if r1 < 0:
                    r2 = anchors[-2] if len(anchors) >= 2 else -1
                    anchors.append(poc)
                order.append((poc, r0, r1, r2, tid))
            for i, (poc, r0, r1, r2, tid) in enumerate(order):
                if r1 < 0:
                    nal, res = self.encode_p_frame(
                        poc, frames[poc], dpb[r0], r0, qp=qp_of("P"),
                        ref2=dpb.get(r2) if r2 >= 0 else None, ref2_poc=r2)
                else:
                    nal, res = self.encode_b_frame(
                        poc, frames[poc], dpb[r0], r0, dpb[r1], r1, tid,
                        qp=qp_of("B", tid))
                rc_update(res)
                dpb[poc] = res.recon
                nalus.append(nal)
                if cfg.picture_hash_sei:
                    nalus.append(self._hash_sei(
                        poc, res.recon, max(tid, 0) if r1 >= 0 else 0))
                # prune the device-side DPB: keep only pictures still
                # needed as references by the remaining coding order
                needed = {p for (_, a, b, c, _t) in order[i + 1:]
                          for p in (a, b, c) if p >= 0}
                for p in list(self._dpb_dev):
                    if p not in needed:
                        del self._dpb_dev[p]
                self._prune_mv_fields()
            self.results.sort(key=lambda r: r.poc)
            self._lmcs_outputs(originals)
            return write_annexb(nalus)
        last_rec = prev2_rec = None
        last_poc = prev2_poc = -1
        for poc, planes in enumerate(frames):
            is_intra = (cfg.gop == "AI" or last_rec is None
                        or (cfg.intra_period > 0
                            and poc % cfg.intra_period == 0))
            if is_intra:
                nal, res = self.encode_intra_frame(poc, planes,
                                                   qp=rc_qp("I"))
            else:
                nal, res = self.encode_p_frame(
                    poc, planes, last_rec, last_poc, qp=rc_qp("P"),
                    ref2=prev2_rec, ref2_poc=prev2_poc)
            rc_update(res)
            if poc == 0 and cfg.film_grain:
                # AI/LDP: the SEI goes before the first picture's NAL, as
                # in the JAX package
                fg_nal = self._film_grain_sei(planes, res.recon)
                if fg_nal is not None:
                    nalus.append(fg_nal)
            # LDP: the last TWO recons stay referenceable
            for p in list(self._dpb_dev):
                if p not in (poc, last_poc):
                    del self._dpb_dev[p]
            self._prune_mv_fields()
            if is_intra:
                prev2_rec, prev2_poc = None, -1   # closed GOP: IDR only
            else:
                prev2_rec, prev2_poc = last_rec, last_poc
            last_rec, last_poc = res.recon, poc
            nalus.append(nal)
            if cfg.picture_hash_sei:
                nalus.append(self._hash_sei(poc, res.recon))
        self._lmcs_outputs(originals)
        return write_annexb(nalus)

    def _lmcs_outputs(self, originals) -> None:
        """Under LMCS: every result's display-domain picture (the luma
        inverse-mapped on the device) and its Y-PSNR against the true
        original (reference: the encoder reports PSNR on the
        inverse-reshaped picture, EncGOP xCalculateAddPSNR)."""
        if not self.cfg.lmcs:
            return
        for res in self.results:
            out_y = reshape.map_plane(self._inv_lut, res.recon[0])
            res.recon_out = [out_y, res.recon[1], res.recon[2]]
            res.psnr_y = psnr(originals[res.poc][0], out_y,
                              self.cfg.bit_depth)

    def _finish_frame(self, res: FrameResult, orig: list[np.ndarray]
                      ) -> FrameResult:
        """Per-POC metric hook (reference: EncGOP.cpp:4914
        m_ext360.calculatePSNRs): the 360 metrics of the luma plane, on
        this encoder's device."""
        if self.cfg.metrics_360:
            res.metrics_360 = metrics_360(orig[0], res.recon[0],
                                          self.cfg.bit_depth,
                                          device=self.device)
        return res

    def summary(self) -> dict:
        """reference: EncGOP::printOutSummary (EncGOP.cpp:4244); with
        metrics_360 the 360 metrics' averages too."""
        n = max(len(self.results), 1)
        out = dict(
            frames=len(self.results),
            bits=sum(r.bits for r in self.results),
            psnr_y=sum(r.psnr_y for r in self.results) / n,
            psnr_u=sum(r.psnr_u for r in self.results) / n,
            psnr_v=sum(r.psnr_v for r in self.results) / n,
            fps=n / max(sum(r.seconds for r in self.results), 1e-9))
        ms = [r.metrics_360 for r in self.results if r.metrics_360]
        if self.cfg.metrics_360 and ms:
            for key in ("ws_psnr", "s_psnr_nn", "cpp_psnr"):
                out[key] = sum(m[key] for m in ms) / len(ms)
        return out
