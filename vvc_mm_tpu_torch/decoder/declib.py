"""Top-level decoder library of the PyTorch port.

PyTorch counterpart of `vvc_mm_tpu/decoder/declib.py` (reference:
source/Lib/DecoderLib/DecLib.cpp — decode:3615 NAL dispatch,
xDecodeSlice:2699, finishPicture:785 incl. the MD5 hash check at :868).

It decodes SPS/PPS activation, the decoded-picture-hash SEI check, I
slices (the fixed grid, or the two-level intra partitioning of
`intra_split`), classic quadtree and multi-type-tree P and B slices,
classic (single-model) P slices with one reference or two (a
per-block ref_idx) and classic B slices, merge on or off, with the
random-access tools (TMVP/HMVP, AMVR, GPM, CIIP, explicit weights from the
slice header, and affine P slices predicted through K1/K2), and MM P slices
on the flat grid or the quadtree (`inter_qt_depth > 0`) and MM B slices,
with merge on or off, GED epipoles (PH delta against the coded predictor)
and MM-MVP, each followed by deblocking, SAO and ALF.  The sequence-level
tools: WPP substreams (the fixed-grid I slice and the classic merge P and
B slices), LMCS (the DPB holds mapped pictures; `output_frames` gives the
display-domain ones), the film grain SEI (`film_grain`) and the temporal
MCTS SEI (`mcts_tiles`), and a lost reference concealed by a clone of the
nearest decoded picture (`concealed`).  Entropy decoding runs on the host
(numpy + the native CABAC coder); reconstruction, the DPB and the loop
filters run on `device`, the MC through kernels K1/K2 on CUDA.

The analyser hooks, as the JAX DecLib's: `stats` (a utils.trace.BitStats)
parses every slice with the Python spec coder and per-syntax accounting,
`cache_model` (a utils.cache_model.CacheModel) records each picture's
reference traffic, and `picture_bits` keeps each slice NAL's size for the
decoder app's HRD check.  With both hooks None the decode path is the
native one.

The tracer's view (utils/profiling.py): `decode_bytes` is a `sequence`
span and each slice a picture span (kind, POC, the instance's sequence
id); every picture path runs the stages `parse` (the CABAC parse and the
host grid work up to the upload), `recon` (the upload, prediction,
residual and the boundary strengths) and `filters` (deblocking, SAO, ALF
and the DPB's int32 planes), and each hash SEI the stage `hash`.  Each
stage waits for the device on exit while the stage timers are on.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ..common import affine as affine_mod
from ..common import alf, deblock, inter_frame, intra_part, qtree, sao
from ..common import film_grain as fg
from ..common import mtt as mtt_mod
from ..common import reshape
from ..common import wavefront
from ..common.bitstream import (BitReader, read_annexb, NAL_SPS, NAL_PPS,
                                NAL_IDR, NAL_SEI, NAL_TRAIL)
from ..common.mm import epipole as epipole_mod
from ..common.mm import frame_codec as mm_codec
from ..common.mm import qt_codec
from ..common.mm.mvp_convert import MMVPConverter
from ..common.mm.reprojection import MVReprojection
from ..common.slice_ps import PPS, SPS, SliceHeader
from ..common.typedefs import MotionModelID, SliceType
from ..device import check_device, resolve_device
from ..lib360.projection import make_projection
from ..encoder.inter_coder import mer_blocks_log2
from ..utils import profiling
from .inter_parser import (decode_b_slice, decode_b_slice_mm,
                           decode_b_slice_mtt, decode_b_slice_qt,
                           decode_p_slice, decode_p_slice_2ref,
                           decode_p_slice_affine, decode_p_slice_mm,
                           decode_p_slice_mtt, decode_p_slice_qt,
                           decode_p_slice_qt_mm, decode_b_slice_wpp,
                           decode_p_slice_wpp)
from .intra_parser import (decode_intra_slice, decode_intra_slice_part,
                           decode_intra_slice_wpp)


@dataclass
class DecodedFrame:
    poc: int
    planes: list[torch.Tensor]        # int32 (y, u, v) on the DPB's device

    def numpy(self) -> list[np.ndarray]:
        return [p.cpu().numpy() for p in self.planes]

    def md5(self, bit_depth: int = 8) -> str:
        m = hashlib.md5()
        for p in self.numpy():
            if bit_depth > 8:
                m.update(p.astype("<u2").tobytes())
            else:
                m.update(p.astype(np.uint8).tobytes())
        return m.hexdigest()


class DecLib:
    """reference: DecLib.cpp:3615 decode — NAL loop lives here.

    positions_fn, when given, replaces the port's merged-positions
    computation: positions_fn(active_models, model_idx, mvs_stack,
    block_size, epipoles, row_step) -> (nsy // row_step, nsx, 2) int
    positions, where epipoles is the picture's (list's)
    {GEODESIC_CAMPOSE: epipole} dict or None.  The merged positions of a
    picture take row_step 1; projected DMVR's candidate positions are
    requested as those of the one-model list [model] at the search's row
    step.  Everything downstream of the positions tensors is the port's."""

    def __init__(self, device=None, positions_fn=None, stats=None,
                 cache_model=None) -> None:
        self.device = resolve_device(device)
        self.positions_fn = positions_fn
        self.stats = stats        # utils.trace.BitStats: analyser mode
        self.cache_model = cache_model  # utils.cache_model.CacheModel
        # POC -> bits of its slice NAL (the HRD's CPB check)
        self.picture_bits: dict[int, int] = {}
        self.sps: SPS | None = None
        self.pps: PPS | None = None
        self.frames: list[DecodedFrame] = []
        self.reproj: MVReprojection | None = None
        self.epipole_list: epipole_mod.EpipoleList | None = None
        self.mvp_conv: MMVPConverter | None = None
        # POC -> "OK"/"MISMATCH"/"MISSING" from decoded-picture-hash SEI
        self.hash_status: dict[int, str] = {}
        # POC -> decoded classic P MV field (host): the co-located field
        # TMVP reads (mirrors EncLib._mv_fields)
        self._mv_fields: dict[int, np.ndarray] = {}
        self.film_grain: fg.FilmGrainParams | None = None   # fgc SEI
        self.mcts_tiles: tuple | None = None  # (cols, rows), MCTS SEI
        self.concealed: list[int] = []  # POCs created by loss concealment
        self._conceal_cache: dict[int, DecodedFrame] = {}
        self._inv_lut: torch.Tensor | None = None   # LMCS, on the device
        self.seq_id = profiling.sequence_id()    # its spans' sequence

    def _activate_sps(self, sps: SPS) -> None:
        """reference: DecLib.cpp:1904 xActivateParameterSets; under LMCS
        the inverse LUT is rebuilt on the device from the SPS's codeword
        counts."""
        self.sps = sps
        self._inv_lut = (reshape.build_inv_lut(
            np.asarray(sps.lmcs_cw, dtype=np.int32), sps.bit_depth,
            self.device) if sps.lmcs else None)
        if sps.mm.any_enabled():
            proj = make_projection(int(sps.mm.projection), sps.width,
                                   sps.height, motion=True)
            self.reproj = MVReprojection(proj, sps.width, sps.height,
                                         sps.mm.mm_offset_4x4,
                                         int(sps.mm.ged_flavor),
                                         device=self.device)
            self.epipole_list = epipole_mod.EpipoleList(
                sps.mm.global_epipole)
            self.mvp_conv = (MMVPConverter(sps.width, sps.height,
                                           int(sps.mm.ged_flavor))
                             if sps.mm.mmmvp else None)
        else:
            self.mvp_conv = None

    def decode_bytes(self, data: bytes) -> list[DecodedFrame]:
        with profiling.span("sequence", self.seq_id):
            return self._decode_nals(data)

    def _decode_nals(self, data: bytes) -> list[DecodedFrame]:
        for nalu in read_annexb(data):
            if nalu.nal_type == NAL_SPS:
                self._activate_sps(SPS.read(BitReader(nalu.payload)))
            elif nalu.nal_type == NAL_PPS:
                self.pps = PPS.read(BitReader(nalu.payload))
            elif nalu.nal_type == NAL_SEI:
                kind = nalu.payload[0] if nalu.payload else None
                if kind in (fg.SEI_FILM_GRAIN, inter_frame.SEI_MCTS):
                    br = BitReader(nalu.payload)
                    br.read(8)
                    if kind == fg.SEI_FILM_GRAIN:
                        # film grain characteristics (reference: SEIread
                        # fgc)
                        self.film_grain = fg.FilmGrainParams.read(br)
                    else:
                        # temporal MCTS: the (cols, rows) tile grid whose
                        # motion is self-contained
                        self.mcts_tiles = (br.read_uvlc(), br.read_uvlc())
                else:
                    self._check_hash_sei(nalu.payload)
            elif nalu.nal_type in (NAL_IDR, NAL_TRAIL):
                self.decode_slice(nalu.payload)
        self.frames.sort(key=lambda f: f.poc)
        return self.frames

    def output_frames(self) -> list[DecodedFrame]:
        """Display-domain pictures: under LMCS the DPB holds mapped
        reconstructions, and the luma is inverse-mapped on the device at
        output (reference: the Reshape inverse LUT at picture output)."""
        if self._inv_lut is None:
            return self.frames
        return [DecodedFrame(f.poc, [reshape.map_plane(self._inv_lut,
                                                       f.planes[0]),
                                     f.planes[1], f.planes[2]])
                for f in self.frames]

    def _check_hash_sei(self, payload: bytes) -> None:
        """Verify a decoded-picture-hash SEI against the just-decoded
        picture (reference: DecLib.cpp:868)."""
        br = BitReader(payload)
        if br.read(8) != 0:          # only MD5 supported
            return
        poc = br.read_uvlc()
        digest = bytes(br.read(8) for _ in range(16))
        with profiling.stage("hash", self.device):
            for f in self.frames:
                if f.poc == poc:
                    ok = bytes.fromhex(f.md5(self.sps.bit_depth)) == digest
                    self.hash_status[poc] = "OK" if ok else "MISMATCH"
                    return
            self.hash_status[poc] = "MISSING"

    def _apply_sao(self, recon: dict, sh) -> dict:
        """SAO then ALF (luma, chroma, CC-ALF) after deblocking (reference:
        DecLib executeLoopFilters)."""
        bd = self.sps.bit_depth
        if self.sps.sao and sh.sao_params is not None:
            recon = dict(recon)
            for key, plane_params in zip(("y", "u", "v"), sh.sao_params):
                if plane_params is None:
                    continue
                types, offsets, band_pos = plane_params
                recon[key] = sao.apply_sao(recon[key], types, offsets,
                                           band_pos, bd)
        if self.sps.alf and sh.alf_params is not None:
            coeffs, enable = sh.alf_params
            cls4 = alf.classify(recon["y"], bd)
            recon = dict(recon, y=alf.apply_alf(recon["y"], cls4, coeffs,
                                                enable, bd))
        if self.sps.alf and (sh.alf_chroma_params is not None
                             or sh.ccalf_params is not None):
            recon = dict(recon)
            for i, key in enumerate(("u", "v")):
                if sh.alf_chroma_params is not None \
                        and sh.alf_chroma_params[i] is not None:
                    c, e = sh.alf_chroma_params[i]
                    recon[key] = alf.apply_alf_chroma(recon[key], c, e, bd)
                if sh.ccalf_params is not None \
                        and sh.ccalf_params[i] is not None:
                    c, e = sh.ccalf_params[i]
                    recon[key] = alf.apply_ccalf(recon[key], recon["y"], c,
                                                 e, bd)
        return recon

    def _store(self, poc: int, recon: dict, sh, bs, unit: int):
        """Deblock (with `bs` = (bs_ver, bs_hor) on a `unit` grid), SAO,
        ALF, then add the picture to the DPB: the stage `filters`."""
        with profiling.stage("filters", self.device):
            if self.sps.deblocking:
                recon = dict(zip("yuv", deblock.deblock_frame(
                    recon["y"], recon["u"], recon["v"], bs[0], bs[1], unit,
                    sh.qp, self.sps.bit_depth)))
            recon = self._apply_sao(recon, sh)
            self.frames.append(DecodedFrame(
                poc, [recon[k].to(torch.int32) for k in "yuv"]))

    def _positions(self, active, model_idx, mvs_stack, block_size,
                   epipoles, row_step: int = 1):
        """positions_fn's positions as int32 on the decoder's device, None
        without a positions_fn."""
        if self.positions_fn is None:
            return None
        pos = self.positions_fn(active, model_idx, mvs_stack, block_size,
                                epipoles, row_step)
        if not torch.is_tensor(pos):
            pos = torch.from_numpy(np.array(pos))
        return pos.to(device=self.device, dtype=torch.int32)

    def decode_slice(self, payload: bytes) -> None:
        """Decode one slice NAL payload into the DPB."""
        sps = self.sps
        br = BitReader(payload)
        sh = SliceHeader.read(br, sps)
        cabac_bytes = bytes(payload[br._pos // 8:])
        self.picture_bits[sh.poc] = len(payload) * 8
        if self.cache_model is not None:
            self.cache_model.start_frame(sh.poc)
        if sh.slice_type not in _KIND:
            raise NotImplementedError(f"slice type {sh.slice_type}")
        with profiling.picture(_KIND[sh.slice_type], sh.poc, self.seq_id):
            if sh.slice_type == SliceType.I:
                self._decode_i(sh, cabac_bytes)
            elif not sps.mm.any_enabled():
                self._decode_classic(sh, cabac_bytes)
            elif sh.slice_type == SliceType.P:
                self._decode_p_mm(sh, cabac_bytes)
            else:
                self._decode_b_mm(sh, cabac_bytes)

    def _decode_i(self, sh, cabac_bytes: bytes) -> None:
        sps = self.sps
        if sps.intra_split:
            self._decode_i_part(sh, cabac_bytes)
            return
        s = sps.intra_block_size
        nby, nbx = sps.height // s, sps.width // s
        parse = decode_intra_slice_wpp if sps.wpp else decode_intra_slice
        with profiling.stage("parse", self.device):
            modes, lm, lf, mr, tsg, mtsg, ly, lu, lv = parse(
                cabac_bytes, nby, nbx, s, cclm=sps.cclm, mip=sps.mip,
                lfnst=sps.lfnst, mrl=sps.mrl, ts=sps.ts and not sps.lossless,
                bdpcm=sps.bdpcm, ibc=sps.ibc, mts=sps.mts, stats=self.stats)
            if sps.lossless:
                tsg = np.ones_like(tsg)
            coords, valid = wavefront.wavefront_coords(nby, nbx)
            lm, mr, lf, tsg, mtsg, *steps = (
                wavefront.grid_to_steps(g, coords, valid)
                for g in (lm, mr, lf, tsg, mtsg, modes, ly, lu, lv))
        with profiling.stage("recon", self.device):
            recon = wavefront.decode_intra_frame(
                *steps, sh.qp, sps.height, sps.width, s, sps.bit_depth,
                device=self.device, dep_quant=sps.dep_quant,
                use_lfnst=sps.lfnst, lfnst_steps=lf, use_ts=sps.ts,
                ts_steps=tsg, lossless=sps.lossless, use_mts=sps.mts,
                mts_steps=mtsg, use_cclm=sps.cclm, cclm_steps=lm,
                use_mip=sps.mip, use_mrl=sps.mrl, mrl_steps=mr,
                use_ibc=sps.ibc)
            bs = deblock.boundary_strengths_intra(nby, nbx, self.device)
        self._store(sh.poc, recon, sh, bs, s)

    def _decode_i_part(self, sh, cabac_bytes: bytes) -> None:
        """Two-level intra slice (common/intra_part.py), deblocked on the
        8x8 grid as the encoder does."""
        sps = self.sps
        nsy, nsx = sps.height // intra_part.SB, sps.width // intra_part.SB
        with profiling.stage("parse", self.device):
            coords, valid = wavefront.wavefront_coords(nsy, nsx)
            steps = [wavefront.grid_to_steps(g, coords, valid)
                     for g in decode_intra_slice_part(cabac_bytes, nsy, nsx,
                                                      self.stats)]
        with profiling.stage("recon", self.device):
            recon = intra_part.decode_intra_frame_part(
                *steps, sh.qp, sps.height, sps.width, sps.bit_depth,
                device=self.device)
            bs = deblock.boundary_strengths_intra(
                sps.height // 8, sps.width // 8, self.device)
        self._store(sh.poc, recon, sh, bs, 8)

    def _decode_tree(self, sh, cabac_bytes: bytes) -> None:
        """Classic quadtree P and B slices, with `mtt` the multi-type tree
        (common/qtree.py, common/mtt.py): the tree and the leaves parsed on
        the host, the unit-grid reconstruction on the device, deblocked at
        the leaves' boundaries."""
        sps = self.sps
        s, nd = sps.inter_block_size, sps.inter_qt_depth
        ref0 = self._ref_by_poc(sh.ref_pocs_l0[0])
        args = (sh.qp, s, nd, sps.bit_depth, sps.wrap_around)
        parse_args = (cabac_bytes, sps.height, sps.width, s, nd)
        stats = self.stats
        is_p = sh.slice_type == SliceType.P
        with profiling.stage("parse", self.device):
            if is_p and sps.mtt:
                mv_u, sq, rect, hr, lid = decode_p_slice_mtt(
                    *parse_args, use_merge=sps.merge, stats=stats)
            elif is_p:
                mv_u, sq, hr, lid = decode_p_slice_qt(
                    *parse_args, use_merge=sps.merge, stats=stats)
            elif sps.mtt:
                mv0, mv1, dirs, sq, rect, hr, lid = decode_b_slice_mtt(
                    *parse_args, use_merge=sps.merge, stats=stats)
            else:
                mv0, mv1, dirs, sq, hr, lid = decode_b_slice_qt(
                    *parse_args, use_merge=sps.merge, stats=stats)
            if not is_p:
                mv_u = np.where(dirs[..., None] == 1, mv1, mv0)
        with profiling.stage("recon", self.device):
            if is_p and sps.mtt:
                recon = mtt_mod.reconstruct_mtt(
                    *self._tensors(mv_u), self._level_tensors(sq),
                    self._level_tensors(rect), *ref0.planes, *args)
            elif is_p:
                recon = qtree.reconstruct_qt(
                    *self._tensors(mv_u), self._level_tensors(sq),
                    *ref0.planes, *args)
            else:
                ref1 = self._ref_by_poc(sh.ref_pocs_l1[0])
                if sps.mtt:
                    recon = mtt_mod.reconstruct_mtt_b(
                        *self._tensors(mv0, mv1, dirs),
                        self._level_tensors(sq), self._level_tensors(rect),
                        ref0.planes, ref1.planes, *args)
                else:
                    recon = qtree.reconstruct_qt_b(
                        *self._tensors(mv0, mv1, dirs),
                        self._level_tensors(sq), ref0.planes, ref1.planes,
                        *args, sps.bdof, sps.dmvr)
            bs = qtree.qt_boundary_strengths(*self._tensors(mv_u, hr, lid))
        self._store(sh.poc, recon, sh, bs, s >> nd)

    def _level_tensors(self, levels):
        """Level trios (a list, or a dict of rect grids) on the device."""
        if isinstance(levels, dict):
            return {k: self._tensors(*t) for k, t in levels.items()}
        return [self._tensors(*t) for t in levels]

    def _p_epipoles(self, sh):
        """Epipole reconstruction of a GED P picture (reference:
        DecLib.cpp:3136-3143): the predictor from the epipoles decoded so
        far plus the PH delta.  Returns the epipoles dict or None."""
        if not self.sps.mm.ged:
            return None
        ref_poc = sh.ref_pocs_l0[0]
        pred = self.epipole_list.derive_predictor(sh.poc, ref_poc)
        delta = sh.epipole_delta or (0, 0, 0)
        ep = epipole_mod.from_fixed(tuple(
            a + b for a, b in zip(epipole_mod.to_fixed(pred), delta)))
        self.epipole_list.set_epipole(sh.poc, ref_poc, ep)
        return {MotionModelID.GEODESIC_CAMPOSE: ep}

    def _decode_classic(self, sh, cabac_bytes: bytes) -> None:
        """Classic (single-model) P and B slices on the fixed grid
        (reference: DecCu + InterPrediction motionCompensation:1681).  A P
        slice with two references and merge on carries a per-block
        ref_idx; an affine SPS makes every P slice affine.  Explicit
        weights win per slice: a B slice whose header carries weight
        tables has BDOF, DMVR, GPM and CIIP off (reference: BDOF
        biocheck0 / DMVR's no-WP condition, InterPrediction.cpp:566,252;
        the encoder's mirror is EncLib._b_classic).  Under WPP the
        one-reference P and the B slices with merge on come in
        substreams."""
        sps = self.sps
        if sps.inter_qt_depth > 0:
            self._decode_tree(sh, cabac_bytes)
            return
        s = sps.inter_block_size
        nby, nbx = sps.height // s, sps.width // s
        mer = mer_blocks_log2(sps.log2_parallel_merge_level, s)
        ref = self._ref_by_poc(sh.ref_pocs_l0[0])
        args = (sh.qp, s, sps.bit_depth, sps.wrap_around)
        scaling = tuple(sps.scaling_list) or None     # P pictures only
        col = (self._mv_fields.get(sh.ref_pocs_l0[0]) if sps.tmvp
               else None)
        tools = dict(col_mvs=col, use_tmvp=sps.tmvp, use_amvr=sps.amvr,
                     stats=self.stats)
        cache = self.cache_model
        is_b = sh.slice_type == SliceType.B
        two_ref = len(sh.ref_pocs_l0) >= 2 and sps.merge
        with profiling.stage("parse", self.device):
            if is_b:
                no_wp = sh.wp_params is None and sh.wp_params_l1 is None
                sl_bdof, sl_dmvr, sl_gpm, sl_ciip = (
                    on and no_wp
                    for on in (sps.bdof, sps.dmvr, sps.gpm, sps.ciip))
                parse = (decode_b_slice_wpp if sps.wpp and sps.merge
                         else decode_b_slice)
                mv0, mv1, dirs, ly, lu, lv, gpm_modes = parse(
                    cabac_bytes, nby, nbx, s, use_gpm=sl_gpm,
                    use_ciip=sl_ciip, use_merge=sps.merge,
                    mer_blocks_log2=mer, stats=self.stats)
                mvs = np.where(dirs[..., None] == 1, mv1, mv0)
            elif sps.affine:
                mvs, aff, dmv, ly, lu, lv = decode_p_slice_affine(
                    cabac_bytes, nby, nbx, s, stats=self.stats)
            elif two_ref:
                ridx, mvs, ly, lu, lv = decode_p_slice_2ref(
                    cabac_bytes, nby, nbx, s, mer_blocks_log2=mer, **tools)
                self._mv_fields[sh.poc] = mvs
            else:
                parse = (decode_p_slice_wpp if sps.wpp and sps.merge
                         else decode_p_slice)
                mvs, ly, lu, lv = parse(
                    cabac_bytes, nby, nbx, s, use_merge=sps.merge,
                    mer_blocks_log2=mer, **tools)
                self._mv_fields[sh.poc] = mvs
            if cache is not None and (is_b or not sps.affine):
                cache.simulate_mc(mvs, s, sps.width)
            has_resid = ((ly != 0).any((2, 3)) | (lu != 0).any((2, 3))
                         | (lv != 0).any((2, 3)))
        with profiling.stage("recon", self.device):
            wp0, wp1 = (None if w is None
                        else self._tensors(np.asarray(w))[0]
                        for w in (sh.wp_params, sh.wp_params_l1))
            if is_b:
                ref1 = self._ref_by_poc(sh.ref_pocs_l1[0])
                recon = inter_frame.reconstruct_b_frame(
                    *self._tensors(mv0, mv1, dirs, ly, lu, lv), ref.planes,
                    ref1.planes, *args, bdof=sl_bdof, dmvr=sl_dmvr,
                    gpm_modes=self._tensors(gpm_modes)[0], gpm=sl_gpm,
                    ciip=sl_ciip, wp0=wp0, wp1=wp1)
            elif sps.affine:
                recon = affine_mod.reconstruct_p_frame_affine(
                    *self._tensors(mvs, aff, dmv, ly, lu, lv), *ref.planes,
                    *args)
            elif two_ref:
                ref2 = self._ref_by_poc(sh.ref_pocs_l0[1])
                recon = inter_frame.reconstruct_p_frame_2ref(
                    *self._tensors(ridx, mvs, ly, lu, lv), ref.planes,
                    ref2.planes, *args, wp=wp0, scaling=scaling)
            else:
                recon = inter_frame.reconstruct_p_frame(
                    *self._tensors(mvs, ly, lu, lv), *ref.planes, *args,
                    wp=wp0, scaling=scaling)
            bs = deblock.boundary_strengths_inter(
                *self._tensors(mvs, has_resid))
        self._store(sh.poc, recon, sh, bs, s)

    def _tensors(self, *arrays):
        """Host grids as int32 tensors on the decoder's device (bool grids
        stay bool)."""
        return tuple(torch.from_numpy(
            a if a.dtype == np.bool_ else a.astype(np.int32)).to(self.device)
            for a in arrays)

    def _decode_p_mm(self, sh, cabac_bytes: bytes) -> None:
        sps = self.sps
        s = sps.inter_block_size
        ref = self._ref_by_poc(sh.ref_pocs_l0[0])
        active = sps.mm.active_models()
        epipoles = self._p_epipoles(sh)
        depth = sps.inter_qt_depth
        if depth <= 0:
            self._decode_p_flat(sh, cabac_bytes, ref, active, epipoles)
            return
        u = s >> depth
        with profiling.stage("parse", self.device):
            (midx_u, mv_u, levels, has_resid_u,
             leaf_id_u) = decode_p_slice_qt_mm(
                cabac_bytes, sps.height, sps.width, s, depth, len(active),
                stats=self.stats)
            stack = None
            if self.positions_fn is not None:
                stack = np.where(
                    (midx_u[None] == np.arange(len(active))[:, None, None])
                    [..., None], mv_u[None], 0)
        with profiling.stage("recon", self.device):
            positions = None
            if stack is not None:
                positions = self._positions(active, midx_u, stack, u,
                                            epipoles)
            recon = qt_codec.reconstruct_qt_mm(
                self.reproj, active, midx_u, mv_u, levels, *ref.planes,
                sh.qp, s, depth, sps.bit_depth, epipoles, sps.wrap_around,
                positions=positions)
            bs = qtree.qt_boundary_strengths(mv_u, has_resid_u, leaf_id_u)
        self._store(sh.poc, recon, sh, bs, u)

    def _decode_p_flat(self, sh, cabac_bytes: bytes, ref, active,
                       epipoles) -> None:
        """Flat-grid MM P slice (reference: the per-block model syntax of
        CABACReader, DecCu + InterPrediction.cpp:520-528 model dispatch)."""
        sps = self.sps
        s = sps.inter_block_size
        nby, nbx = sps.height // s, sps.width // s
        ep_mvp = (epipoles or {}).get(MotionModelID.GEODESIC_CAMPOSE)
        with profiling.stage("parse", self.device):
            model_idx, mvs, ly, lu, lv = decode_p_slice_mm(
                cabac_bytes, nby, nbx, s, active, self.mvp_conv, ep_mvp,
                use_merge=sps.merge, mer_blocks_log2=mer_blocks_log2(
                    sps.log2_parallel_merge_level, s), stats=self.stats)
            stack = _stack_of(model_idx, mvs, len(active))
            if self.cache_model is not None:
                self.cache_model.report_subblock_mc(
                    (sps.height // 4) * (sps.width // 4))
            has_resid = ((ly != 0).any((2, 3)) | (lu != 0).any((2, 3))
                         | (lv != 0).any((2, 3)))
        with profiling.stage("recon", self.device):
            positions = self._positions(active, model_idx, stack, s,
                                        epipoles)
            recon = mm_codec.reconstruct_p_frame_mm(
                self.reproj, active, model_idx, stack, ly, lu, lv,
                *ref.planes, sh.qp, s, sps.bit_depth, epipoles,
                sps.wrap_around, positions=positions)
            bs = deblock.boundary_strengths_inter(
                torch.as_tensor(mvs, dtype=torch.int32),
                torch.as_tensor(has_resid))
        self._store(sh.poc, recon, sh, bs, s)

    def _decode_b_mm(self, sh, cabac_bytes: bytes) -> None:
        sps = self.sps
        s = sps.inter_block_size
        nby, nbx = sps.height // s, sps.width // s
        ref0 = self._ref_by_poc(sh.ref_pocs_l0[0])
        ref1 = self._ref_by_poc(sh.ref_pocs_l1[0])
        active = sps.mm.active_models()
        eps0 = eps1 = None
        if sps.mm.ged:
            eps0 = {MotionModelID.GEODESIC_CAMPOSE:
                    self.epipole_list.find_epipole(sh.poc,
                                                   sh.ref_pocs_l0[0])}
            eps1 = {MotionModelID.GEODESIC_CAMPOSE:
                    self.epipole_list.find_epipole(sh.poc,
                                                   sh.ref_pocs_l1[0])}
        with profiling.stage("parse", self.device):
            (midx0, midx1, mv0, mv1, dirs, ly, lu,
             lv) = decode_b_slice_mm(
                cabac_bytes, nby, nbx, s, active, self.mvp_conv,
                (eps0 or {}).get(MotionModelID.GEODESIC_CAMPOSE),
                (eps1 or {}).get(MotionModelID.GEODESIC_CAMPOSE),
                use_merge=sps.merge, mer_blocks_log2=mer_blocks_log2(
                    sps.log2_parallel_merge_level, s), stats=self.stats)
            n_active = len(active)
            stacks = [_stack_of(midx0, mv0, n_active),
                      _stack_of(midx1, mv1, n_active)]
            has_resid = ((ly != 0).any((2, 3)) | (lu != 0).any((2, 3))
                         | (lv != 0).any((2, 3)))
            sel_mv = np.where(dirs[..., None] == 1, mv1, mv0)
        with profiling.stage("recon", self.device):
            # projected DMVR refines the prediction's MVs; deblocking reads
            # the signalled ones
            recon = mm_codec.reconstruct_b_frame_mm(
                self.reproj, active, midx0, midx1, stacks[0], stacks[1],
                dirs, ly, lu, lv, ref0.planes, ref1.planes, sh.qp, s,
                sps.bit_depth, eps0, eps1, sps.wrap_around, sps.dmvr,
                None if self.positions_fn is None else self._positions)
            bs = deblock.boundary_strengths_inter(
                torch.as_tensor(sel_mv, dtype=torch.int32),
                torch.as_tensor(has_resid))
        self._store(sh.poc, recon, sh, bs, s)

    def _ref_by_poc(self, poc: int) -> DecodedFrame:
        """DPB lookup with lost-picture concealment (reference:
        DecLib.cpp:1000 xCreateLostPicture): a missing reference is
        concealed by a clone, on the decoder's device, of the nearest
        decoded picture (the first in decoding order on a tie), kept for
        later lookups of the same POC, so that decoding goes on.  A
        reference picture must lie on the decoder's device; KeyError when
        no picture is there to clone."""
        best = None
        for f in self.frames:
            if f.poc == poc:
                for p in f.planes:
                    check_device(p, self.device, f"reference POC {poc}")
                return f
            if best is None or abs(f.poc - poc) < abs(best.poc - poc):
                best = f
        if poc in self._conceal_cache:
            return self._conceal_cache[poc]
        if best is None:
            raise KeyError(f"reference POC {poc} not in DPB and no picture "
                           "available for concealment")
        self.concealed.append(poc)
        clone = DecodedFrame(poc, [p.clone() for p in best.planes])
        self._conceal_cache[poc] = clone
        return clone


_KIND = {SliceType.I: "I", SliceType.P: "P", SliceType.B: "B"}


def _stack_of(model_idx: np.ndarray, mvs: np.ndarray, n_active: int
              ) -> np.ndarray:
    """(n_active, nby, nbx, 2) stack with each block's MV in its model's
    layer, zero elsewhere."""
    stack = np.zeros((n_active,) + mvs.shape, np.int64)
    np.put_along_axis(stack, model_idx[None, :, :, None].astype(np.int64),
                      mvs[None], axis=0)
    return stack
