"""Core type system, enums and constants.

TPU-native re-design of the reference's TypeDef.h / CommonDef.h
(reference: source/Lib/CommonLib/TypeDef.h, CommonDef.h).  Only the constants
that drive tensor shapes and fixed-point math live here; tool on/off switches
are runtime config (see encoder/cfg.py), not compile-time macros.
"""
from __future__ import annotations

import enum

# ---------------------------------------------------------------------------
# Block geometry (reference: CommonDef.h:297-298  MAX_CU_DEPTH=7 -> CTU 128)
# ---------------------------------------------------------------------------
MAX_CTU_SIZE = 128
DEFAULT_CTU_SIZE = 64          # we default to 64 (VTM CTC also uses 128; config)
MIN_CU_SIZE = 4
MAX_TB_SIZE = 64               # max transform block
MIN_TB_SIZE = 4
MAX_TR_DYNAMIC_RANGE = 15      # transform coeff dynamic range (16-bit signed)

# Motion vector fixed point (reference: CommonDef.h:267
# MV_FRACTIONAL_BITS_INTERNAL = 4 -> 1/16-pel internal precision)
MV_FRACTIONAL_BITS = 4
MV_FRAC = 1 << MV_FRACTIONAL_BITS     # 16
MV_MAX = (1 << 17) - 1
MV_MIN = -(1 << 17)

# Epipole fixed point (reference: CommonDef.h:441 EPIPOLE_PRECISION_FIXED=24)
EPIPOLE_PRECISION_BITS = 24

# Interpolation filter taps (reference: CommonDef.h:409-413)
NTAPS_LUMA = 8
NTAPS_CHROMA = 4
NTAPS_BILINEAR = 2

# DPB (reference: CommonDef.h:142 MAX_NUM_REF=16)
MAX_NUM_REF = 16

# Subblock granularity of the motion buffer and of projected MC
# (reference: CodingStructure.h:273-289 motion buffer at 4x4 granularity;
#  MVReprojection.cpp:81 per-4x4-subblock reprojection)
MIN_PU_SIZE = 4


class SliceType(enum.IntEnum):
    """reference: TypeDef.h SliceType (B=0, P=1, I=2 order kept)."""
    B = 0
    P = 1
    I = 2


class ChromaFormat(enum.IntEnum):
    """reference: TypeDef.h ChromaFormat."""
    C400 = 0
    C420 = 1
    C422 = 2
    C444 = 3


CHROMA_SCALE_X = {ChromaFormat.C400: 0, ChromaFormat.C420: 1,
                  ChromaFormat.C422: 1, ChromaFormat.C444: 0}
CHROMA_SCALE_Y = {ChromaFormat.C400: 0, ChromaFormat.C420: 1,
                  ChromaFormat.C422: 0, ChromaFormat.C444: 0}


class MotionModelID(enum.IntEnum):
    """The multi-model motion model ids.

    reference: TypeDef.h:865-881 (MotionModelID CLASSIC..GEODESIC_CAMPOSE) and
    MMConfig.cpp:7-40 (active-model list ordering CLASSIC -> MPA(front/left/top)
    -> 3DT -> TAN -> ROT -> GED_CAMPOSE -> GEDA(X,Y,Z)).
    """
    CLASSIC = 0
    MPA_FRONT_BACK = 1
    MPA_LEFT_RIGHT = 2
    MPA_TOP_BOTTOM = 3
    THREE_D_TRANSLATIONAL = 4
    TANGENTIAL = 5
    ROTATIONAL = 6
    GEODESIC_CAMPOSE = 7
    GEODESIC_AXIS_X = 8
    GEODESIC_AXIS_Y = 9
    GEODESIC_AXIS_Z = 10


class GeodesicFlavor(enum.IntEnum):
    """reference: GeodesicMotionModel.cpp:104-130 (VISHWANATH_ORIGINAL moves
    theta linearly; VISHWANATH_MODULATED sin-modulates the delta)."""
    VISHWANATH_ORIGINAL = 0
    VISHWANATH_MODULATED = 1


class ProjectionID(enum.IntEnum):
    """reference: Projection.h:12-141 (Equisolid / Calibrated / Perspective /
    Equirectangular image-plane <-> unit-sphere maps)."""
    EQUISOLID = 0
    CALIBRATED = 1
    PERSPECTIVE = 2
    EQUIRECTANGULAR = 3


# Intra modes (reference: IntraPrediction.cpp — 67-mode angular + planar/DC)
PLANAR_IDX = 0
DC_IDX = 1
NUM_LUMA_MODE = 67
HOR_IDX = 18
VER_IDX = 50
NUM_INTRA_ANGULAR = 65


