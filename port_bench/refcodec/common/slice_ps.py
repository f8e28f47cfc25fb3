"""Parameter sets: SPS / PPS / picture header / slice header.

TPU-native analog of the reference Slice/parameter-set layer (reference:
source/Lib/CommonLib/Slice.{cpp,h} (8,216 LoC) — SPS holds the MMConfig at
Slice.h:1925-1944, PicHeader holds epipoleDelta at Slice.h:2692-2693;
HLS read/write in VLCReader.cpp:1336 parseSPS / VLCWriter.cpp).

Round-1 HLS is a compact self-defined syntax (not the full VVC SPS): enough
to carry everything the decoder needs, written with exp-Golomb/flags through
bitstream.BitWriter.  The MM fields mirror the reference's SPS extension
(VLCReader.cpp:1921-1987: sps_mpa/3dt/tan/rot/ged/geda_enabled_flag,
sps_ged_flavor, sps_mmmvp_enabled_flag, sps_mm_offset_4x4,
sps_projection_fct + params, sps_global_epipole).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .bitstream import BitReader, BitWriter
from .typedefs import ChromaFormat, GeodesicFlavor, ProjectionID, SliceType


@dataclass
class MMConfig:
    """Multi-model motion config (reference: MMConfig.{cpp,h} — active-model
    list ordering at MMConfig.cpp:7-40)."""
    mpa: bool = False
    t3d: bool = False
    tan: bool = False
    rot: bool = False
    ged: bool = False            # GED_CAMPOSE (signaled epipole)
    geda: bool = False           # fixed-axis epipoles X/Y/Z
    ged_flavor: GeodesicFlavor = GeodesicFlavor.VISHWANATH_MODULATED
    mmmvp: bool = False
    mm_offset_4x4: int = 1       # subblock-center offset code 0..4 (-> +0..1.5)
    projection: ProjectionID = ProjectionID.EQUIRECTANGULAR
    global_epipole: tuple[float, float, float] = (0.0, 0.0, 1.0)

    def any_enabled(self) -> bool:
        return any([self.mpa, self.t3d, self.tan, self.rot, self.ged,
                    self.geda])

    def active_models(self) -> list[int]:
        """Active-model id list in the reference's fixed order
        (MMConfig.cpp:7-40): CLASSIC, MPA x3, 3DT, TAN, ROT, GED_CAMPOSE,
        GEDA X/Y/Z."""
        from .typedefs import MotionModelID as M
        out = [M.CLASSIC]
        if self.mpa:
            out += [M.MPA_FRONT_BACK, M.MPA_LEFT_RIGHT, M.MPA_TOP_BOTTOM]
        if self.t3d:
            out.append(M.THREE_D_TRANSLATIONAL)
        if self.tan:
            out.append(M.TANGENTIAL)
        if self.rot:
            out.append(M.ROTATIONAL)
        if self.ged:
            out.append(M.GEODESIC_CAMPOSE)
        if self.geda:
            out += [M.GEODESIC_AXIS_X, M.GEODESIC_AXIS_Y, M.GEODESIC_AXIS_Z]
        return [int(m) for m in out]


@dataclass
class ProfileTierLevel:
    """profile_tier_level() (reference: ProfileLevelTier.{cpp,h},
    VLCWriter::codeProfileTierLevel).  Carried at the top of the SPS."""
    profile_idc: int = 1         # 1 = Main 10 analog
    tier_flag: bool = False      # False = Main tier, True = High
    level_idc: int = 51          # level 5.1-style code

    def write(self, bw: BitWriter) -> None:
        bw.write(self.profile_idc, 7)
        bw.write_flag(self.tier_flag)
        bw.write(self.level_idc, 8)

    @classmethod
    def parse(cls, br: BitReader) -> "ProfileTierLevel":
        p = cls()
        p.profile_idc = br.read(7)
        p.tier_flag = br.read_flag()
        p.level_idc = br.read(8)
        return p


@dataclass
class HRDParams:
    """Hypothetical-reference-decoder parameters (reference: HRD.h,
    general_timing_hrd_parameters) — CPB size / bitrate / timing for
    buffer conformance.  Optional SPS payload."""
    bit_rate_kbps: int = 0
    cpb_size_kbits: int = 0
    time_scale: int = 30
    num_units_in_tick: int = 1

    def write(self, bw: BitWriter) -> None:
        bw.write_uvlc(self.bit_rate_kbps)
        bw.write_uvlc(self.cpb_size_kbits)
        bw.write_uvlc(self.time_scale)
        bw.write_uvlc(self.num_units_in_tick)

    @classmethod
    def parse(cls, br: BitReader) -> "HRDParams":
        h = cls()
        h.bit_rate_kbps = br.read_uvlc()
        h.cpb_size_kbits = br.read_uvlc()
        h.time_scale = br.read_uvlc()
        h.num_units_in_tick = br.read_uvlc()
        return h


@dataclass
class SPS:
    width: int = 0
    height: int = 0
    bit_depth: int = 8
    chroma_format: ChromaFormat = ChromaFormat.C420
    ctu_size: int = 64
    intra_block_size: int = 8
    inter_block_size: int = 16
    max_num_ref: int = 4
    inter_qt_depth: int = 0       # quadtree split depth below the top size
                                  # inter_block_size: 0 = fixed grid; d > 0
                                  # allows leaves down to size >> d (QTMT
                                  # analog, UnitPartitioner.h:56-64)
    mtt: bool = False             # multi-type tree: BT/TT splits on top of
                                  # the quadtree lattice (common/mtt.py;
                                  # reference: sps_max_mtt_hierarchy_depth)
    ptl: "ProfileTierLevel" = field(default_factory=lambda: ProfileTierLevel())
    hrd: "HRDParams | None" = None   # optional HRD timing/buffer params
    log2_parallel_merge_level: int = 2   # merge-candidate independence
                                  # region (reference: VLCReader.cpp:1987
                                  # sps_log2_parallel_merge_level_minus2)
    scaling_list: tuple = ()      # 64-entry 8x8 quant scaling matrix
                                  # (empty = flat; reference: APS/SPS
                                  # scaling_list_data, Quant.cpp
                                  # xSetScalingListDec)
    affine: bool = False          # 4-param affine motion (CLASSIC only;
                                  # reference: sps_affine_enabled_flag)
    wrap_around: bool = False     # ERP horizontal wrap (pps in VVC; SPS here)
    deblocking: bool = True       # in-loop deblocking enable
    sao: bool = True              # sample adaptive offset enable
    alf: bool = True              # adaptive loop filter enable
    bdof: bool = False            # bi-directional optical flow (B slices)
    dmvr: bool = False            # decoder-side MV refinement (B slices)
    gpm: bool = False             # geometric partitioning (reference:
                                  # sps_gpm_enabled_flag, GEO merge mode)
    ciip: bool = False            # combined inter/intra prediction
                                  # (reference: sps_ciip_enabled_flag)
    ibc: bool = False             # intra block copy (reference:
                                  # sps_ibc_enabled_flag, IbcHashMap)
    lmcs: bool = False            # luma mapping (reshaper) enable
    lmcs_cw: tuple = ()           # 16 signaled codeword counts
    dep_quant: bool = False       # dependent quantization (reference:
                                  # sps_dep_quant_enabled_flag, DepQuant.cpp)
    cclm: bool = False            # cross-component linear-model chroma
                                  # (reference: sps_cclm_enabled_flag,
                                  # IntraPrediction.cpp:267)
    mip: bool = False             # matrix intra prediction (reference:
                                  # sps_mip_enabled_flag,
                                  # MatrixIntraPrediction.cpp)
    lfnst: bool = False           # secondary transform (reference:
                                  # sps_lfnst_enabled_flag, TrQuant.cpp:238)
    tmvp: bool = False            # temporal + history MVP in the AMVP list
                                  # (reference: sps_temporal_mvp_enabled_flag
                                  # + HMVP, UnitTools.cpp:2272/3178)
    merge: bool = False           # merge/skip candidate machinery: spatial/
                                  # TMVP/HMVP/pairwise/zero list, merge_flag
                                  # + merge_idx (reference: six-candidate
                                  # merge, UnitTools.cpp:1059
                                  # getInterMergeCandidates)
    mrl: bool = False             # multi-reference-line intra (reference:
                                  # sps_mrl_enabled_flag, MRL refs)
    mts: bool = False             # explicit MTS for intra luma (reference:
                                  # sps_mts_enabled_flag +
                                  # sps_explicit_mts_intra_enabled_flag,
                                  # TrQuant.cpp:619 getTrTypes)
    amvr: bool = False            # adaptive MV resolution on P blocks
                                  # (reference: sps_amvr_enabled_flag,
                                  # EncCu.cpp:775-782 IMV mode loop)
    wpp: bool = False             # entropy substreams with entry points
                                  # (reference: WPP/tiles, EncSlice.cpp:
                                  # 2024-2113 substream termination)
    num_substreams: int = 4       # substream count when wpp
    ts: bool = False              # transform skip (reference:
                                  # sps_transform_skip_enabled_flag,
                                  # TrQuant.cpp transformSkip path)
    bdpcm: bool = False           # block DPCM on TS blocks (reference:
                                  # sps_bdpcm_enabled_flag)
    lossless: bool = False        # all-TS qStep-1 lossless coding (the
                                  # reference lossless cfg path, cfg/lossless)
    intra_split: bool = False     # two-level intra partitioning: 16x16
                                  # superblocks with a per-SB split into
                                  # 8x8 quads (common/intra_part.py;
                                  # reference: one level of the QTMT intra
                                  # recursion, EncCu.cpp:499 +
                                  # split_cu_flag)
    mm: MMConfig = field(default_factory=MMConfig)

    def write(self, bw: BitWriter) -> None:
        bw.write_uvlc(self.width)
        bw.write_uvlc(self.height)
        bw.write_uvlc(self.bit_depth - 8)
        bw.write(int(self.chroma_format), 2)
        bw.write_uvlc(self.ctu_size.bit_length() - 1)
        bw.write_uvlc(self.intra_block_size.bit_length() - 1)
        bw.write_uvlc(self.inter_block_size.bit_length() - 1)
        bw.write_uvlc(self.max_num_ref)
        bw.write_uvlc(self.inter_qt_depth)
        bw.write_flag(self.mtt)
        self.ptl.write(bw)
        bw.write_uvlc(self.log2_parallel_merge_level - 2)
        bw.write_flag(self.hrd is not None)
        if self.hrd is not None:
            self.hrd.write(bw)
        bw.write_flag(bool(self.scaling_list))
        for v in self.scaling_list:
            bw.write_uvlc(int(v))
        bw.write_flag(self.affine)
        bw.write_flag(self.wrap_around)
        bw.write_flag(self.deblocking)
        bw.write_flag(self.sao)
        bw.write_flag(self.alf)
        bw.write_flag(self.bdof)
        bw.write_flag(self.dmvr)
        bw.write_flag(self.gpm)
        bw.write_flag(self.ciip)
        bw.write_flag(self.ibc)
        bw.write_flag(self.lmcs)
        if self.lmcs:
            for c in self.lmcs_cw:
                bw.write_uvlc(int(c))
        bw.write_flag(self.dep_quant)
        bw.write_flag(self.cclm)
        bw.write_flag(self.mip)
        bw.write_flag(self.lfnst)
        bw.write_flag(self.tmvp)
        bw.write_flag(self.merge)
        bw.write_flag(self.mrl)
        bw.write_flag(self.mts)
        bw.write_flag(self.amvr)
        bw.write_flag(self.wpp)
        if self.wpp:
            bw.write_uvlc(self.num_substreams)
        bw.write_flag(self.ts)
        bw.write_flag(self.bdpcm)
        bw.write_flag(self.lossless)
        bw.write_flag(self.intra_split)
        mm = self.mm
        bw.write_flag(mm.any_enabled())
        if mm.any_enabled():
            for f in (mm.mpa, mm.t3d, mm.tan, mm.rot, mm.ged, mm.geda):
                bw.write_flag(f)
            bw.write(int(mm.ged_flavor), 1)
            bw.write_flag(mm.mmmvp)
            bw.write_uvlc(mm.mm_offset_4x4)
            bw.write(int(mm.projection), 2)
            for c in mm.global_epipole:
                # fixed-point 2^-24 (reference: CommonDef.h:441)
                v = int(round(c * (1 << 24)))
                bw.write_svlc(v)
        bw.align()

    @classmethod
    def read(cls, br: BitReader) -> "SPS":
        sps = cls()
        sps.width = br.read_uvlc()
        sps.height = br.read_uvlc()
        sps.bit_depth = 8 + br.read_uvlc()
        sps.chroma_format = ChromaFormat(br.read(2))
        sps.ctu_size = 1 << br.read_uvlc()
        sps.intra_block_size = 1 << br.read_uvlc()
        sps.inter_block_size = 1 << br.read_uvlc()
        sps.max_num_ref = br.read_uvlc()
        sps.inter_qt_depth = br.read_uvlc()
        sps.mtt = br.read_flag()
        sps.ptl = ProfileTierLevel.parse(br)
        sps.log2_parallel_merge_level = br.read_uvlc() + 2
        sps.hrd = HRDParams.parse(br) if br.read_flag() else None
        if br.read_flag():
            sps.scaling_list = tuple(br.read_uvlc() for _ in range(64))
        sps.affine = br.read_flag()
        sps.wrap_around = br.read_flag()
        sps.deblocking = br.read_flag()
        sps.sao = br.read_flag()
        sps.alf = br.read_flag()
        sps.bdof = br.read_flag()
        sps.dmvr = br.read_flag()
        sps.gpm = br.read_flag()
        sps.ciip = br.read_flag()
        sps.ibc = br.read_flag()
        sps.lmcs = br.read_flag()
        if sps.lmcs:
            sps.lmcs_cw = tuple(br.read_uvlc() for _ in range(16))
        sps.dep_quant = br.read_flag()
        sps.cclm = br.read_flag()
        sps.mip = br.read_flag()
        sps.lfnst = br.read_flag()
        sps.tmvp = br.read_flag()
        sps.merge = br.read_flag()
        sps.mrl = br.read_flag()
        sps.mts = br.read_flag()
        sps.amvr = br.read_flag()
        sps.wpp = br.read_flag()
        if sps.wpp:
            sps.num_substreams = br.read_uvlc()
        sps.ts = br.read_flag()
        sps.bdpcm = br.read_flag()
        sps.lossless = br.read_flag()
        sps.intra_split = br.read_flag()
        if br.read_flag():
            mm = sps.mm
            mm.mpa, mm.t3d, mm.tan, mm.rot, mm.ged, mm.geda = (
                br.read_flag() for _ in range(6))
            mm.ged_flavor = GeodesicFlavor(br.read(1))
            mm.mmmvp = br.read_flag()
            mm.mm_offset_4x4 = br.read_uvlc()
            mm.projection = ProjectionID(br.read(2))
            mm.global_epipole = tuple(
                br.read_svlc() / (1 << 24) for _ in range(3))
        return sps


@dataclass
class PPS:
    base_qp: int = 32

    def write(self, bw: BitWriter) -> None:
        bw.write_svlc(self.base_qp - 26)
        bw.align()

    @classmethod
    def read(cls, br: BitReader) -> "PPS":
        pps = cls()
        pps.base_qp = 26 + br.read_svlc()
        return pps


@dataclass
class SliceHeader:
    """reference: VLCReader.cpp:3612 parseSliceHeader + picture header
    epipole delta (VLCReader.cpp:3355-3370)."""
    poc: int = 0
    slice_type: SliceType = SliceType.I
    qp: int = 32
    temporal_id: int = 0
    ref_pocs_l0: list[int] = field(default_factory=list)
    ref_pocs_l1: list[int] = field(default_factory=list)
    epipole_delta: tuple[int, int, int] | None = None  # 2^-24 fixed point
    # per-plane per-region SAO params: tuple of 3 entries (Y, Cb, Cr),
    # each (types, offsets(4), band_pos) or None
    sao_params: tuple | None = None
    # ALF params: (coeffs (25,12) int32, enable (gy,gx) bool), luma
    alf_params: tuple | None = None
    # chroma ALF: ((coeffs (6,), enable) or None for Cb, same for Cr)
    # (reference: 5x5 chroma ALF, AdaptiveLoopFilter filter5x5Blk)
    alf_chroma_params: tuple | None = None
    # CC-ALF: ((coeffs (7,), enable) or None for Cb, same for Cr)
    # (reference: applyCcAlfFilter)
    ccalf_params: tuple | None = None
    # explicit weighted prediction (reference: WeightPrediction.{cpp,h},
    # pred_weight_table): per-plane (weight, offset), log2 denom 6
    wp_params: tuple | None = None
    # list-1 weight table for B slices (reference: the l1 half of
    # pred_weight_table)
    wp_params_l1: tuple | None = None

    def write(self, bw: BitWriter, sps: SPS) -> None:
        bw.write_uvlc(self.poc)
        bw.write(int(self.slice_type), 2)
        bw.write_svlc(self.qp - 26)
        bw.write_uvlc(self.temporal_id)
        if self.slice_type != SliceType.I:
            for lst in (self.ref_pocs_l0, self.ref_pocs_l1):
                bw.write_uvlc(len(lst))
                for rp in lst:
                    bw.write_svlc(self.poc - rp)
        if self.slice_type != SliceType.I:
            bw.write_flag(self.wp_params is not None)
            if self.wp_params is not None:
                for w, o in self.wp_params:
                    bw.write_svlc(int(w) - 64)
                    bw.write_svlc(int(o))
        if self.slice_type == SliceType.B:
            bw.write_flag(self.wp_params_l1 is not None)
            if self.wp_params_l1 is not None:
                for w, o in self.wp_params_l1:
                    bw.write_svlc(int(w) - 64)
                    bw.write_svlc(int(o))
        if sps.mm.ged:
            bw.write_flag(self.epipole_delta is not None)
            if self.epipole_delta is not None:
                for d in self.epipole_delta:
                    bw.write_svlc(d)
        if sps.sao:
            bw.write_flag(self.sao_params is not None)
            if self.sao_params is not None:
                for plane_params in self.sao_params:
                    bw.write_flag(plane_params is not None)
                    if plane_params is None:
                        continue
                    types, offsets, band_pos = plane_params
                    gy, gx = types.shape
                    for y in range(gy):
                        for x in range(gx):
                            t = int(types[y, x])
                            bw.write(t, 3)
                            if t:
                                for c in range(4):
                                    bw.write_svlc(int(offsets[y, x, c]))
                            if t == 1:
                                bw.write(int(band_pos[y, x]), 5)
        if sps.alf:
            bw.write_flag(self.alf_params is not None)
            if self.alf_params is not None:
                coeffs, enable = self.alf_params
                for k in range(coeffs.shape[0]):
                    for i in range(coeffs.shape[1]):
                        bw.write_svlc(int(coeffs[k, i]))
                gy, gx = enable.shape
                for y in range(gy):
                    for x in range(gx):
                        bw.write_flag(bool(enable[y, x]))
            for params in (self.alf_chroma_params, self.ccalf_params):
                bw.write_flag(params is not None)
                if params is None:
                    continue
                for plane in params:
                    bw.write_flag(plane is not None)
                    if plane is None:
                        continue
                    coeffs, enable = plane
                    for c in coeffs:
                        bw.write_svlc(int(c))
                    for y in range(enable.shape[0]):
                        for x in range(enable.shape[1]):
                            bw.write_flag(bool(enable[y, x]))
        bw.align()

    @classmethod
    def read(cls, br: BitReader, sps: SPS) -> "SliceHeader":
        sh = cls()
        sh.poc = br.read_uvlc()
        sh.slice_type = SliceType(br.read(2))
        sh.qp = 26 + br.read_svlc()
        sh.temporal_id = br.read_uvlc()
        if sh.slice_type != SliceType.I:
            sh.ref_pocs_l0 = [sh.poc - br.read_svlc()
                              for _ in range(br.read_uvlc())]
            sh.ref_pocs_l1 = [sh.poc - br.read_svlc()
                              for _ in range(br.read_uvlc())]
            if br.read_flag():
                sh.wp_params = tuple((64 + br.read_svlc(), br.read_svlc())
                                     for _ in range(3))
            if sh.slice_type == SliceType.B and br.read_flag():
                sh.wp_params_l1 = tuple(
                    (64 + br.read_svlc(), br.read_svlc())
                    for _ in range(3))
        if sps.mm.ged:
            if br.read_flag():
                sh.epipole_delta = tuple(br.read_svlc() for _ in range(3))
        if sps.sao:
            if br.read_flag():
                import numpy as np
                from .sao import REGION
                from .typedefs import CHROMA_SCALE_X, CHROMA_SCALE_Y
                plane_dims = [(sps.height, sps.width)]
                ch = sps.height >> CHROMA_SCALE_Y[sps.chroma_format]
                cw = sps.width >> CHROMA_SCALE_X[sps.chroma_format]
                plane_dims += [(ch, cw), (ch, cw)]
                params = []
                for (hh, ww) in plane_dims:
                    if not br.read_flag():
                        params.append(None)
                        continue
                    gy = -(-hh // REGION)
                    gx = -(-ww // REGION)
                    types = np.zeros((gy, gx), dtype=np.int32)
                    offsets = np.zeros((gy, gx, 4), dtype=np.int32)
                    band_pos = np.zeros((gy, gx), dtype=np.int32)
                    for y in range(gy):
                        for x in range(gx):
                            t = br.read(3)
                            types[y, x] = t
                            if t:
                                for c in range(4):
                                    offsets[y, x, c] = br.read_svlc()
                            if t == 1:
                                band_pos[y, x] = br.read(5)
                    params.append((types, offsets, band_pos))
                sh.sao_params = tuple(params)
        if sps.alf:
            if br.read_flag():
                import numpy as np
                from .alf import NUM_CLASSES, NUM_COEFF, REGION as AREG
                coeffs = np.zeros((NUM_CLASSES, NUM_COEFF), dtype=np.int32)
                for k in range(NUM_CLASSES):
                    for i in range(NUM_COEFF):
                        coeffs[k, i] = br.read_svlc()
                gy = -(-sps.height // AREG)
                gx = -(-sps.width // AREG)
                enable = np.zeros((gy, gx), dtype=bool)
                for y in range(gy):
                    for x in range(gx):
                        enable[y, x] = br.read_flag()
                sh.alf_params = (coeffs, enable)
            import numpy as np
            from .alf import NUM_COEFF_C, NUM_COEFF_CC, REGION as AREG
            from .typedefs import CHROMA_SCALE_X, CHROMA_SCALE_Y
            ch = sps.height >> CHROMA_SCALE_Y[sps.chroma_format]
            cw = sps.width >> CHROMA_SCALE_X[sps.chroma_format]
            cgy, cgx = -(-ch // AREG), -(-cw // AREG)
            for attr, ncoef in (("alf_chroma_params", NUM_COEFF_C),
                                ("ccalf_params", NUM_COEFF_CC)):
                if not br.read_flag():
                    continue
                planes = []
                for _ in range(2):
                    if not br.read_flag():
                        planes.append(None)
                        continue
                    coeffs = np.asarray([br.read_svlc()
                                         for _ in range(ncoef)],
                                        dtype=np.int32)
                    enable = np.zeros((cgy, cgx), dtype=bool)
                    for y in range(cgy):
                        for x in range(cgx):
                            enable[y, x] = br.read_flag()
                    planes.append((coeffs, enable))
                setattr(sh, attr, tuple(planes))
        br.byte_align()
        return sh
