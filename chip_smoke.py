"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build every CUDA kernel of the port (one nvcc per source, in parallel);
  2. print the card's name and power limit (nvidia-smi);
  3. hold kernels K1 (luma MC), K2 (chroma MC), K3 (block-band SAD), K4
     (block-band MC), K5 (per-subblock SAD) and K6 (bilinear per-subblock
     SAD) against their plain PyTorch versions on the card, on random and
     on extreme (clamped) positions at the main paths' shapes, K1/K2 also
     on coherent positions, at 256x128, at 832x480 (the affine path's
     grid) and at 10 bit on 536x1000, K3/K4
     also on diamond-like positions, at block widths 24 and 32, K = 1 and
     10 bit, K5/K6 also on coherent and diamond positions, at 10 bit on
     536x1000 and K = 1, all six on a plane whose rows are not 16-byte
     aligned and on an 8-bit 6144x3072 plane: bit-exact (tolerance 0); and
     D1 (dependent quantization's trellis) and D2 (its dequantizer) at the
     I picture's shapes (896, 8, 8) and (256, 4, 4) and at (4096, 16, 16),
     on Laplacian, all-zero and saturating blocks, at QP 0, 37 and 51:
     levels and reconstructions equal; and L1's elementwise entry points
     (glibc's float32 sinf, cosf, tanf, atan2f) on 2^22 inputs a function
     (any float32 bit pattern, angles, arguments past the large-argument
     reduction, edge cases): bit for bit with its plain version (NaN as
     NaN); and L1's sphere positions (sphere_positions, sphere_centers)
     at 2048x1024 on random, extreme and zero MV fields, every form
     (merged, merge search, op by op) of MPA's three planes and ROT beside
     CLASSIC (and a GED layer the chain fills), block sizes 8-32, K = 1
     and 5, row and column subsampling: 0 positions apart from the plain
     version, one launch a call;
  4. decode the committed 2048x1024 ERP multi-model RA stream with
     DecLib() on CUDA, counting kernel launches: every MD5 must match, and
     every picture's Y-PSNR against the regenerated source must lie within
     0.1 dB of the encoder's recorded value; the small 256x128
     stream is decoded on the card too: all its MD5s must match; so must
     every picture's of each committed 256x128 multi-model stream (MPA,
     ROT, GED, 3DT, TAN, projected DMVR), and, in phases 8b, 8e and 8k,
     of each committed 2048x1024 one; and the two committed 10-bit streams
     (64x32, AI and LDP): every MD5 OK (the hash over 16-bit samples) and
     every picture the JAX decoder's;
  5. count, per multi-model picture, the subblock positions the card
     computes differently from the same code on the CPU (both streams;
     L1 computes the sphere math's libm calls on the card): any
     difference here, in 8b or in 8e fails the run at its end;
     then decode the 2048x1024 stream on the CPU from the card's
     positions: every picture must equal the card's bit for bit (all that
     follows the positions is integer math);
  6. sequence, against the JAX encoder's record: EncLib(cfg)
     .encode_sequence(frames) on CUDA for 5 frames at GOP 4, 2048x1024,
     the configuration of the committed stream (parameter sets, I picture,
     POC 4 (P), 2, 1, 3 (B), hash SEIs), counting launches (K1-K4 must be
     launched); DecLib() on the card decodes the port's stream: every MD5
     must match; per picture the bits and Y/U/V-PSNR are printed beside
     the recorded JAX encoder's, and the whole stream must be the
     committed one byte for byte (hold_bytes: both SHA-256s, or the first
     differing NAL and byte; ROADMAP queue 3 fault 4); a second encode
     with the stage timers on (the same bytes) prints the stage shares
     per picture;
  7. the same at 256x128 on the card: the path that launches K5 (and K1 in
     the B decision); every MD5 must match; a second encode with the
     stage timers on prints the stage shares per picture, a third under
     torch.profiler counts, per picture, every device operation (kernel,
     copy) and their summed device time.  The whole stream is compared
     with the committed one byte for byte: where the card's positions
     equal the CPU's at this size, a difference fails the run;
  8. sequence, full width: the headline configuration (2048x1024, RA,
     GOP 16, 17 frames, MPA+ROT, quadtree depth 1, QP 37 with the cascade)
     through encode_sequence on the card, then DecLib() on the card: 17 of
     17 MD5s must match, K1-K4 and the sphere kernel must be launched, one
     launch a codec call of the positions (frame_codec.POSITION_CALLS,
     printed beside the launches), K > 1 fields in the steps' launches,
     and the stream's SHA-256 must equal the JAX encoder's
     (HEADLINE_SHA256);
     per-picture bits, Y-PSNR, seconds and L1 launches and the frames per
     second are printed (one timed encode, no repeat); one more under
     torch.profiler (the same bytes) gives the device operations, device
     time and idle share of the first picture of each kind (the pictures
     of a kind have the same device operations within 1%; the
     other traced encodes below sample their P and B pictures so, and the
     I picture only where it is the subject: 7, 8k, 8n);
  8b. bench configurations 3 (MPA, flat grid) and 4 (MPA+GED+ROT+MMMVP
     with the signalled epipole (1, 0, 0, 0, 1), flat grid) of bench.py,
     5 frames at GOP 4: at 2048x1024 through encode_sequence on the card,
     per picture beside the committed JAX stream's sidecar and held to
     the committed stream byte for byte (hold_bytes), K1-K4 launched;
     the port's stream decoded on the card (every MD5 OK);
     seconds and frames per second printed, configuration 4's device
     operations per picture (a traced encode); the committed stream
     decoded on the card (every MD5 OK, every Y-PSNR within 0.1 dB of the
     sidecar) and its positions against the CPU's (epipoles through the
     positions hook; the CPU decode from the card's positions runs in 5
     and 8e, whose models cover these).  At 256x128 (configurations 3, 4
     and 4 with the off-pole epipole (4, 0, 0.3, -0.5, 0.8)) the card's
     stream must equal the committed JAX stream byte for byte (which the
     CPU tests hold the port's CPU encode to);
  8c. bench configuration 2 (`ra832x480_qp37_encode_fps`: 832x480, RA,
     GOP 16, 17 frames, the classic single-model inter path, no 360 tool):
     encode_sequence on the card, held to the committed JAX stream
     `ra832x480_qp37_17f` byte for byte; the port's stream and the
     committed one decoded on the card with 17 of 17 MD5 OK; seconds and
     frames per second of that encode,
     one with the stage timers on the stage shares, one under
     torch.profiler the device operations and idle share of its P and B
     pictures.
     The classic path launches none of K1-K6;
  8d. bench configuration 5 (`erp6144x3072_ldp_qp37_encode_fps`:
     6144x3072 ERP, LDP, wrap-around, classic tools), 3 frames: POC 2 is
     the first two-reference P picture; encode_sequence on the card held
     to the JAX encoder's sidecar `erp6144x3072_ldp_qp37_3f` (no stream is
     committed at this size): the stream's SHA-256, and on a difference
     each slice NAL's SHA-256 and bits; the stream decoded on the card
     with 3 of 3 MD5 OK; seconds per picture and the device memory peak
     printed;
  8e. bench configuration 4 plus the last two motion models and projected
     DMVR (`erp2048x1024_ra_qp37_allmm_dmvr`: MPA+3DT+TAN+ROT+GED+MMMVP,
     8 active models, epipole (1, 0, 0, 0, 1), dmvr on), 5 frames at GOP
     4, 2048x1024: held to the committed JAX stream byte for byte as in
     8b, the port's stream decoded on the card (every MD5 OK), K1
     launched by projected DMVR's bilateral costs (one row of the
     subblocks of a model pair's bi blocks) and held to its plain version
     on the largest of them (tolerance 0);
     device operations per picture; the committed stream decoded on the
     card (every MD5 OK, every Y-PSNR within 0.1 dB), its positions,
     projected DMVR's candidate positions among them, against the CPU's,
     and on the CPU fed the card's positions: bit-exact with the card;
  8f. bench configuration 2 with BDOF and DMVR on (`ra832x480_qp37_bdof_
     dmvr`): the card's stream equals the committed JAX stream byte for
     byte, both decode on the card with 17 of 17 MD5 OK; seconds, frames
     per second and device operations per picture;
  8g. bench configuration 1 (`ai416x240_qp37_encode_fps`: AI, 416x240, 2
     frames): the card's stream equals the committed JAX stream byte for
     byte and decodes on the card with 2 of 2 MD5 OK;
  8h. path C, configuration 2 with the random-access tool set (TMVP/HMVP,
     AMVR, GPM, CIIP, BDOF, DMVR; `ra832x480_ctc_tools_qp37_17f`): the
     card's stream equals the committed JAX stream byte for byte, both
     decode on the card with 17 of 17 MD5 OK, no kernel launched; an
     encode under torch.profiler gives the P and B pictures' device
     operations and idle share;
  8i. path D, affine (configuration 2's clip, LDP, 9 frames;
     `ldp832x480_affine_qp37_9f`): the encode byte for byte with the JAX
     stream, or within 0.1 dB and 2% of its sidecar with the IDR NAL
     equal; the blocks whose affine parameters differ are counted; the
     port's and the committed stream decode on the card with 9 of 9 MD5
     OK; K1/K2 launches by shape printed, their last launches on the
     (120, 208, 2) affine grid held to the plain versions (tolerance 0);
     device operations as in 8h;
  8j. path E, the fade (frame i at gain 1 - 0.04 i) with weighted
     prediction on P and B slices, BDOF, DMVR, GPM and CIIP
     (`ra832x480_fade_wp_qp37_17f`): as 8h, and the count of slices that
     carry weight tables;
  8k. the headline tools with make_bd_r05.py's CTC-like preset (TMVP,
     RDOQ, dependent quantization, MTS, LFNST) at 2048x1024, 5 frames at
     GOP 4: held to the committed JAX stream's sidecar (0.1 dB, 2%) and its
     IDR NAL byte for byte, D1/D2 launched on every wavefront step, the
     port's stream decoded on the card (every MD5 OK), the committed
     stream decoded on the card (every MD5 OK, every Y-PSNR
     within 0.1 dB); then the headline's 17 frames at GOP 16 with the
     preset: seconds, and for the I picture its seconds, device
     operations, D1/D2 launches and device time;
  8l. bench configuration 1 with dependent quantization, MTS, LFNST,
     transform skip and BDPCM, and lossless, and RDOQ with transform skip
     and BDPCM at 192x96: each byte for byte against its committed JAX
     stream, both decoded on the card with every MD5 OK, the lossless
     reconstruction and decode equal to the source;
  8m. configuration 2's clip and size, LDP, 9 frames, a non-flat scaling
     list on the P pictures: byte for byte against the committed JAX
     stream, both decoded on the card with every MD5 OK;
  8n. the I picture's prediction tools (CCLM, MIP, MRL, IBC): bench
     configuration 1 with them and dependent quantization, byte for byte
     against `ai416x240_intra_pred_dq_qp37_2f`, both decoded on the card
     with every MD5 OK, D1/D2 launched; one 2048x1024 I picture of the
     CTC-like preset with them, its IDR NAL's SHA-256 against the JAX
     encoder's sidecar; for both sizes the I picture's seconds, device
     operations and idle share (a traced encode);
  8o. the classic quadtree (`inter_block_size=32, qt_depth=2`) on
     configuration 2's clip at 832x480, RA, GOP 4, 5 frames: byte for
     byte against `ra832x480_qt2_qp37_5f`, the port's and the committed
     stream decoded on the card with every MD5 OK; per picture kind the
     seconds, and (a traced encode, the first picture of each kind) the
     device operations and idle share; the phase's wall seconds; no
     kernel launched;
  8p. the same with the multi-type tree (`mtt=True`) against
     `ra832x480_mtt_qp37_5f`;
  8q. the two-level intra partitioning (`intra_split=True`): bench
     configuration 1 against `ai416x240_intra_split_qp37_2f` as in 8o,
     then one 2048x1024 I picture of the headline configuration with it,
     its IDR NAL's SHA-256 against the JAX sidecar's and its seconds;
  8r. WPP (4 substreams: the I, P and B writers, and with TMVP the P merge
     selection's HMVP resets), LMCS and the film grain SEI together, on
     configuration 2's clip at 832x480, RA, GOP 4, 5 frames, QP 37: byte
     for byte against `ra832x480_wpp_lmcs_fg_qp37_5f`, the port's stream
     decoded on the card with every MD5 OK, the committed one too, its
     display-domain pictures (DecLib.output_frames), its film grain
     parameters and the grain applied to POC 0 equal to the JAX
     decoder's, the encoder's display-domain pictures to the JAX
     encoder's; per picture kind the seconds (host clock), the phase's
     wall seconds and its kernel launches;
  8s. MCTS (2x2 tiles) on that clip, LDP, 3 frames, QP 37: byte for byte
     against `ldp832x480_mcts_qp37_3f`, decoded on the card with every MD5
     OK and the SEI's tile grid read back; then the stream without POC 1's
     slice NAL: POC 1 concealed, and the decoded POCs, their MD5s and the
     hash verdicts equal to the JAX decoder's on the same bytes; seconds,
     wall seconds and launches as in 8r.
  8t. the headline tools at 2048x1024, RA, GOP 4, 5 frames, with the MCTF
     pre-filter, rate control (1,920 kbit/s) and the 360 metrics: byte
     for byte against `erp2048x1024_ra_mm_rc_mctf_5f`, decoded on the card
     with every MD5 OK (the JAX decoder's verdicts, from the sidecar, too);
     the card's
     filtered pictures equal to the JAX prefilter's (MD5), every QP to the
     rate control's pick, every per-POC metric within 1e-3 dB of the JAX
     encoder's sidecar (the largest difference printed); geo_convert of
     the first source picture to CMP (1536x1024) and fisheye (1024x1024)
     with lanczos3 on the card equal to the port's CPU result; seconds,
     seconds a picture and the phase's wall seconds;
  8u. Equisolid (fisheye) content at 1088x1088 (the default focal's
     sensor width), MPA+ROT, the MM quadtree, RA, GOP 4, 5 frames: byte
     for byte against `fish1088x1088_ra_mm_qp37_5f`, decoded on the card
     with every MD5 OK; K1-K4 and L1's elementwise entry
     points launched, the sphere kernel's entries not (it computes ERP's
     sphere math only); seconds as in 8t.
     The committed 128x128 Equisolid stream of 3DT, TAN, GED (a
     signalled epipole) and GEDA is decoded on the card too: every MD5 OK.
     Where a committed stream is the port's byte for byte (every phase
     from 8c on but 8i's possible difference), its decode is the port's
     stream's (check_run) and is not repeated;
  8v. the apps on the card: encoder_app.main on a 2048x1024
     realistic_sequence YUV written to smoke_out/, with the options of
     the committed `erp2048x1024_ra_mm_qp37_5f` (MPA+ROT, the MM quadtree,
     RA GOP 4, 5 frames): its stream byte for byte; decoder_app.main on it
     with --CacheModel and --TraceFile: every MD5 OK, its YUV the encoder
     app's reconstruction byte for byte; decoder_app --BitStats (the
     Python spec coder) on the committed 256x128 stream: its report the
     JAX decoder app's (tests/data/torch_port/apps.json); parcat of two
     chunks the encoder app codes at 256x128, decoded with every MD5 OK;
  8w. the sharded encodes (parallel/sharding.py) in 2 ranks on the one
     card, spawned, gloo for the exchanges: frame-parallel intra on 2
     pictures (1024x512), the row-sharded multi-model P encode (MPA+ROT,
     ERP 2048x1024, the reference replicated) and the row-sharded classic
     P encode with its reference's halo exchange (2048x1024): each bit for
     bit the unsharded encode of the same inputs on the card, the ranks'
     launches counted;
  9. decision SADs (K6's path): frame_codec._sad_fields_bilin with
     exact=False and exact=True on the tensors captured from the 256x128
     encodes' diamond steps and on one full 2048x1024 grid: the bilinear
     result must equal the plain version's, sad_bilinear_positions must be
     launched, and the blocks whose best candidate is the same under both
     filters are counted;
 10. time each kernel and its plain version on inputs captured from those
     runs (K1 also on projected DMVR's row, K1/K2 also on path D's affine
     grid, D1/D2 on phase 8k's I-picture luma batch, L1's elementwise
     entry points on a 2048x1024 picture's merged-position batch of
     131,072 subblocks, beside torch.sin / torch.atan2, which round
     otherwise, and L1's sphere positions and centres on the headline's own
     calls, each held to its plain version there first, bit for bit),
     after a launch floor
     (the
     device time of a one-element fill), print the `kernels` line (K1-K5
     launches also by shape), then the
     result line.  Before it, K5's and K6's launch rule is timed against
     its alternatives on the same inputs (each held to the plain version).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from vvc_mm_tpu_torch.common import bitstream as bs
from vvc_mm_tpu_torch.common import film_grain
from vvc_mm_tpu_torch.common.inter_frame import (MC_MARGIN, first_argmin,
                                                 pad_ref)
from vvc_mm_tpu_torch.common.mm import frame_codec, reprojection
from vvc_mm_tpu_torch.common.mm.reprojection import MVReprojection
from vvc_mm_tpu_torch.common.slice_ps import SPS, MMConfig, SliceHeader
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder.enclib import EncCfg, EncLib
from vvc_mm_tpu_torch.encoder.mctf import prefilter_sequence
from vvc_mm_tpu_torch.encoder.rate_ctrl import RateControl
from vvc_mm_tpu_torch.common.typedefs import ProjectionID
from vvc_mm_tpu_torch.lib360 import geometry
from vvc_mm_tpu_torch.lib360.projection import ERP
from vvc_mm_tpu_torch.common import depquant, libm_f32
from vvc_mm_tpu_torch.ops import (cuda_lib, depquant_kernel, libm_kernel,
                                  mc_kernel, sphere_kernel)
from vvc_mm_tpu_torch.utils import profiling
from vvc_mm_tpu_torch.decoder.inter_parser import decode_p_slice_affine
from vvc_mm_tpu_torch.utils import content
from vvc_mm_tpu_torch.utils.content import fade_sequence, psnr

DATA = os.path.join(ROOT, "tests", "data", "torch_port")
BIG = "erp2048x1024_ra_mm_qp37_5f"
SMALL = "erp256x128_ra_mm_qp37_5f"
CONFIG2 = "ra832x480_qp37_17f"      # bench.py:106-108, the JAX encoder's
CONFIG2_TOOLS = "ra832x480_bdof_dmvr_qp37_17f"  # the same, BDOF and DMVR on
CONFIG1 = "ai416x240_qp37_2f"       # bench.py:101-102
# configuration 2's clip and size with the classic random-access tools:
# path C (TMVP/HMVP, AMVR, GPM, CIIP, BDOF, DMVR), path D (affine, LDP) and
# path E (the fade with weighted prediction on P and B slices)
PATH_C = "ra832x480_ctc_tools_qp37_17f"
PATH_D = "ldp832x480_affine_qp37_9f"
PATH_E = "ra832x480_fade_wp_qp37_17f"
FADE_STEP = 0.04
ALLMM = "erp2048x1024_ra_allmm_dmvr_qp37_5f"
# the headline tools with make_bd_r05.py:75-77's CTC-like preset (phase 8k)
PRESET = "erp2048x1024_ra_ctcpreset_qp37_5f"
PRESET_TOOLS = dict(tmvp=True, rdoq=True, dep_quant=True, mts=True,
                    lfnst=True)
# I-picture blocks whose decisions on the card differ from the JAX
# encoder's at 2048x1024 with the preset: 0 measured, so the IDR NAL must
# equal the committed one byte for byte
PRESET_I_DECISIONS_OFF = 0
# bench configuration 1 with the I picture's residual tools, and lossless
# (phase 8l); configuration 2's clip with a scaling list (phase 8m)
CONFIG1_TOOLS = "ai416x240_tools_qp37_2f"
CONFIG1_LOSSLESS = "ai416x240_lossless_2f"
# RDOQ unshadowed, transform skip and BDPCM (AI 192x96; phase 8l)
RDOQ_TS = "ai192x96_rdoq_ts_bdpcm_qp37_2f"
SCALING = "ldp832x480_scaling_qp37_9f"
# the I picture's prediction tools (phase 8n): bench configuration 1 with
# them and dependent quantization, and the sidecar of one 2048x1024 I
# picture of the CTC-like preset with them
PRED_TOOLS = dict(cclm=True, mip=True, mrl=True, ibc=True)
CONFIG1_PRED = "ai416x240_intra_pred_dq_qp37_2f"
PRESET_I_PRED = "erp2048x1024_ai_ctcpreset_predtools_qp37"
# the partitioning phases 8o-8q: the classic quadtree and its multi-type
# tree on configuration 2's clip, the two-level intra partitioning on
# configuration 1, and the sidecar of one 2048x1024 headline I picture
# with it
PART_QT = "ra832x480_qt2_qp37_5f"
PART_MTT = "ra832x480_mtt_qp37_5f"
PART_INTRA = "ai416x240_intra_split_qp37_2f"
PART_INTRA_BIG = "erp2048x1024_ai_intra_split_qp37"
# the sequence tools (phases 8r and 8s), the 10-bit streams decoded in
# phase 4 and bench configuration 5's JAX sidecar (phase 8d)
TOOLS_8R = "ra832x480_wpp_lmcs_fg_qp37_5f"
MCTS_8S = "ldp832x480_mcts_qp37_3f"
TENBIT = ("ai64x32_10bit_qp32_3f", "ldp64x32_10bit_qp32_3f")
CONFIG5 = "erp6144x3072_ldp_qp37_3f"
# 256x128 committed multi-model streams decoded in phase 4
SMALL_MM = ("erp256x128_ra_mpa_qp37_5f", "erp256x128_ra_ctcpreset_qp37_5f",
            "erp256x128_ra_fullmm_qp37_5f", "erp256x128_ra_fullmm_ep_qp37_5f",
            "erp256x128_ra_allmm_dmvr_qp37_5f")
# L1's inputs a function in phase 3, and its timed batch in phase 10: the
# merged positions of a 2048x1024 picture
LIBM_CHECK_N = 1 << 22
LIBM_BATCH = 131072
# H100 SXM float64 rate outside the tensor cores (NVIDIA's data sheet)
F64_OPS_PER_S = 34e12
# L1's float64 operations an element on the common path (|x| < 120): the
# reduction's product and FMA, the sign product, x*x, and the polynomial's
# two products and three FMAs (an FMA two operations); tanf's double work
# is its reduction's product, difference and two conversions; atan2f is
# float32 throughout
LIBM_F64_OPS = {"sinf": 13, "cosf": 13, "tanf": 4, "atan2f": 0}
# The sphere kernel's operations a position, counted in
# csrc/sphere_positions.cu on the common path: (its own float32 operations,
# glibc atan2f calls, tanf calls, sinf / cosf calls), positions by (model,
# form), block centres by model; CLASSIC none.  Each __fmul_rn / __fadd_rn
# / __fsub_rn / __fdiv_rn / __fsqrt_rn is one float32 operation, each
# __fmaf_rn two; glibc's atan2f takes at least ATAN2F_F32 (its shortest
# path past the special cases: atanf's two products, two 6-term
# polynomials and their sum), tanf TANF_F32 float32 operations (its
# polynomial for |x| <= pi/4) and LIBM_F64_OPS["tanf"] float64 ones, a sinf
# or cosf LIBM_F64_OPS["sinf"] float64 ones.  MPA's merged form, for
# example: 54 of its own (the MV step 14, the radius 4, the angles' turn
# behind the camera 6, the sphere point 7, the rsqrt 12, the rest 11).
ATAN2F_F32, TANF_F32 = 25, 32
SPHERE_OPS = {("sphere_positions", "mpa"): {None: (46, 4, 0, 4),
                                             "merged": (54, 4, 0, 4),
                                             "search": (54, 4, 0, 4)},
              ("sphere_positions", "rot"): {None: (99, 4, 0, 20),
                                             "merged": (111, 4, 0, 12),
                                             "search": (129, 4, 0, 16)},
              ("sphere_centers", "mpa"): {None: (71, 6, 1, 10),
                                           "search": (80, 6, 1, 10)},
              ("sphere_centers", "rot"): {None: (95, 4, 0, 20),
                                           "search": (120, 4, 0, 16)}}
# the headline stream's SHA-256 on the card: the JAX encoder's own stream
# of the same sequence (its CPU encode of bench.py:127-129's 17 frames).
# The search's block centres took the op-by-op form up to PR 16 and gave
# eee9bbb4...; since they take the JAX search jits' compiled form the
# stream is the JAX encoder's
HEADLINE_SHA256 = ("c7470bcc98942252c31fba8f51637bb6a86162a0cb86acc07f78428"
                   "410497e04")
STEEP = tuple(int(16 + 2 * (x + y)) for y in range(8) for x in range(8))
PSNR_TOL_DB = 0.1
BITS_TOL = 1.02
MIN_PSNR_Y_DB = 25.0           # sanity floor where no record exists
HEADLINE_FRAMES, HEADLINE_GOP = 17, 16
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
# H100 SXM int32 multiply-add rate: 132 SMs x 64 IMAD a clock (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0: half the 128 of fp32 FMA) x 1.98 GHz x 2 operations.  Every kernel
# of the port filters in int32, so this rate, not the 67 TFLOP/s of fp32,
# bounds their operations.
I32_OPS_PER_S = 33.5e12
# H100 SXM float32 rate outside the tensor cores (NVIDIA's data sheet)
F32_OPS_PER_S = 67e12
SOURCES = {"mc_luma_positions": "mc_positions.cu",
           "mc_chroma_positions": "mc_positions.cu",
           "sad_block_positions": "sad_positions.cu",
           "mc_block_positions": "sad_positions.cu",
           "sad_luma_positions": "sad_positions.cu",
           "sad_bilinear_positions": "sad_positions.cu",
           "quantize_dep": "depquant.cu",
           "dequantize_dep": "depquant.cu",
           "libm_f32": "libm_f32.cu",
           "sphere_positions": "sphere_positions.cu",
           "sphere_centers": "sphere_positions.cu"}
REPLACES = {"mc_luma_positions": "vvc_mm_tpu/ops/mc_kernel.py:191",
            "mc_chroma_positions": "vvc_mm_tpu/ops/mc_kernel.py:817",
            "sad_block_positions": "vvc_mm_tpu/ops/mc_kernel.py:565",
            "mc_block_positions": "vvc_mm_tpu/ops/mc_kernel.py:505",
            "sad_luma_positions": "vvc_mm_tpu/ops/mc_kernel.py:291",
            "sad_bilinear_positions": "vvc_mm_tpu/ops/mc_kernel.py:688",
            "quantize_dep": "vvc_mm_tpu/common/depquant.py:70 (lax.scan, "
                            "no Pallas)",
            "dequantize_dep": "vvc_mm_tpu/common/depquant.py:165 (lax.scan, "
                              "no Pallas)",
            "libm_f32": "the glibc sinf/cosf/sincosf/tanf/atan2f calls of "
                        "XLA's CPU code for vvc_mm_tpu/lib360/projection.py"
                        ":25-42 and vvc_mm_tpu/common/mm/models.py (no "
                        "Pallas)",
            "sphere_positions": "the float32 sphere math of MPA and ROT "
                                "that XLA's CPU code runs for vvc_mm_tpu/"
                                "common/mm/frame_codec.py:344-360 "
                                "(merged_positions' jit), the merge "
                                "search's jit and reprojection.py:"
                                "reproject_frame (no Pallas)",
            "sphere_centers": "the float32 sphere math of "
                              "vvc_mm_tpu/common/mm/reprojection.py "
                              "reproject_block_centers for CLASSIC, MPA "
                              "and ROT (no Pallas)"}
# D1/D2: the block batch shapes of the I picture's launches at 2048x1024
# with MTS and LFNST, timed in phase 10: luma (128 blocks x 7 candidates),
# then U and V (2 x 128 blocks)
DQ_PATH_SHAPES = ((896, 8, 8), (256, 4, 4))


_T0 = time.perf_counter()


_CLIPS: dict = {}


def realistic_sequence(width: int, height: int, n: int) -> list:
    """content.realistic_sequence, made once a picture size (its frame t
    does not depend on the clip's length) and copied out."""
    have = _CLIPS.get((width, height))
    if have is None or len(have) < n:
        have = _CLIPS[(width, height)] = content.realistic_sequence(
            width, height, n)
    return [[p.copy() for p in f] for f in have[:n]]


def phase(title: str) -> None:
    print(f"[{time.perf_counter() - _T0:.0f} s] {title}")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int = 50) -> float:
    """Mean device time of fn() over `iters` launches (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, tag: str = "positions_kernel"
              ) -> float | None:
    """Mean device time of the one kernel a wrapper call fn() launches, from
    torch.profiler's device events of the port's kernels (their names hold
    "positions_kernel"): the gaps between launches, which the CUDA-event
    loop of cuda_ms includes, are left out.  The profiler misses the first
    few operations after it starts, so the mean is taken over the kernels
    it caught.  Where it traces none, or more than one for a call, four
    times in a row, the time is not measured (None) and the CUDA-event
    time of cuda_ms stands alone."""
    for _ in range(4):          # now and then a trace is unusable
        with _profiler() as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        own = [t for name, t in device_events(prof) if tag in name]
        if 0 < len(own) <= iters:
            return sum(own) / len(own) * 1e3
    print(f"  (the profiler caught {len(own)} kernels for {iters} calls)")
    return None


def launch_floor_ms(dev, iters: int = 20) -> float | None:
    """Mean device time of a one-element fill kernel under the profiler
    that device_ms uses: no launch's device time goes below it."""
    with _profiler() as prof:
        for _ in range(iters):
            torch.zeros(1, device=dev)
        torch.cuda.synchronize()
    evs = [t for _, t in device_events(prof)]
    return sum(evs) / len(evs) * 1e3 if evs else None


def bound_ms(n_words: int, macs: int) -> tuple[float, str]:
    """Least time on the card for one call: its bytes (every input and
    output int32 word once) over the memory rate, against its integer MACs
    (2 operations each) over the int32 multiply-add rate."""
    t_bytes = 4 * n_words / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / I32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mc_bound(ref, positions, margin: int, s: int, taps: int
             ) -> tuple[float, str]:
    """K1/K2: the reference words that the positions' windows cover (their
    union, each word once), the positions and the output; the separable
    filter's MACs per subblock.  The windows are placed as the plain
    versions place them (mc_kernel.mc_*_positions_plain)."""
    nsy, nsx, _ = positions.shape
    n = s + taps - 1
    shift = 4 if s == 4 else 5           # luma 1/16 pel, chroma 1/32 pel
    pos = positions.reshape(-1, 2)
    xi = torch.clamp((pos[:, 0] >> shift) + margin - (taps // 2 - 1), 0,
                     ref.shape[1] - n)
    yi = torch.clamp((pos[:, 1] >> shift) + margin - (taps // 2 - 1), 0,
                     ref.shape[0] - n)
    covered = torch.zeros(ref.shape, dtype=torch.bool, device=ref.device)
    cols = xi[:, None] + torch.arange(n, device=ref.device)
    for dy in range(n):
        covered[(yi + dy)[:, None], cols] = True
    return bound_ms(int(covered.sum()) + positions.numel() + nsy * nsx * s * s,
                    nsy * nsx * (n * s * taps + s * s * taps))


def search_bound(name: str, case: dict) -> tuple[float, str]:
    """K3-K6: padded reference + positions + original band or plane +
    output; MACs per (k, block) = 11*s*8 + 4*s*8 (K3, K4), 480 per
    subblock (K5), 72 per subblock (K6: 5*4*2 + 4*4*2)."""
    pos = case["positions"]
    k, ny, nx, _ = pos.shape
    words = case["ref_padded"].numel() + pos.numel()
    if case["orig"] is not None:
        words += case["orig"].numel()
    if name == "sad_luma_positions":
        return bound_ms(words + k * ny * nx, 480 * k * ny * nx)
    if name == "sad_bilinear_positions":
        return bound_ms(words + k * ny * nx, 72 * k * ny * nx)
    s = case["s"]
    out = k * ny * nx if name == "sad_block_positions" else k * ny * 4 * nx * s
    return bound_ms(words + out, k * ny * nx * (11 * s * 8 + 4 * s * 8))


def diamond_positions(rng, k: int, ny: int, nx: int, step: int,
                      margin_px: int = 40) -> np.ndarray:
    """A search step's positions, (k, ny, nx, 2) int32: each block's centre
    near the grid, then the other candidates 1-8 pel from it along x or
    y."""
    gx = np.arange(nx)[None, :] * step * 16
    gy = np.arange(ny)[:, None] * step * 16
    centre = np.stack(np.broadcast_arrays(gx, gy), -1) + rng.integers(
        -margin_px * 8, margin_px * 8, (ny, nx, 2))
    pos = np.repeat(centre[None], k, axis=0)
    for i in range(1, k):
        axis, sign = (i - 1) % 4 // 2, 1 - 2 * ((i - 1) % 2)
        pos[i, ..., axis] += sign * 16 * rng.integers(1, 9)
    return pos.astype(np.int32)


def positions_pair(rng, shape, step: int, margin_px: int = 40):
    """Random positions around the grid (`step` pixels between items) and
    extreme ones that clamp, as int32 numpy arrays of `shape` + (2,)."""
    ny, nx = shape[-2:]
    gx = np.broadcast_to(np.arange(nx)[None, :] * step * 16, shape)
    gy = np.broadcast_to(np.arange(ny)[:, None] * step * 16, shape)
    rand = np.stack([gx, gy], -1) + rng.integers(
        -margin_px * 16, margin_px * 16, shape + (2,))
    extreme = rng.integers(-(1 << 20), 1 << 20, shape + (2,))
    extreme[..., ::7, :, :] = np.array([-(1 << 30), (1 << 30)])
    return rand.astype(np.int32), extreme.astype(np.int32)


def coherent_positions(rng, ny: int, nx: int, step: int = 4
                       ) -> np.ndarray:
    """Positions as merged MM positions come, (ny, nx, 2) int32: each item
    at its own place (`step` pixels apart) plus one shared motion and a
    smooth variation of up to 12 pel, neighbours within 1.5 pel of it."""
    ys, xs = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    motion = np.stack([np.sin(ys / 17.0) * 96 + np.cos(xs / 23.0) * 96,
                       np.cos(ys / 13.0) * 96 + np.sin(xs / 29.0) * 96], -1)
    pos = np.stack([xs, ys], -1) * step * 16 + motion.astype(np.int64) + \
        rng.integers(-320, 320, (1, 1, 2)) + rng.integers(-24, 24,
                                                           (ny, nx, 2))
    return pos.astype(np.int32)


def plane_6k_cases(rng, margin: int, dev) -> list:
    """Every kernel on an 8-bit 6144x3072 plane, the size of bench.py's 6K
    configuration: K1/K2 on the subblock grid, K3 at s=8 K=5 and s=16 K=6,
    K4 at s=16 K=4, K5/K6 with K=5; random positions around the grid.
    (kernel, label, kernel call, plain call) each."""
    w, h = 6144, 3072
    ref = torch.as_tensor(rng.integers(0, 256, (h + 2 * margin,
                                                w + 2 * margin),
                                       dtype=np.int32), device=dev)
    chroma = ref[::2, ::2].contiguous()
    orig = torch.as_tensor(rng.integers(0, 256, (h, w), dtype=np.int32),
                           device=dev)
    label = "6144x3072 8 bit"

    def pos(shape, step):
        return torch.as_tensor(positions_pair(rng, shape, step)[0],
                               device=dev)

    calls = []          # (kernel, arguments)
    p = pos((h // 4, w // 4), 4)
    calls += [("mc_luma_positions", (ref, p, margin, 8)),
              ("mc_chroma_positions", (chroma, p, margin // 2, 8))]
    for s, k in ((8, 5), (16, 6)):
        bands = torch.as_tensor(rng.integers(0, 256, (h // s * 4, w),
                                             dtype=np.int32), device=dev)
        calls.append(("sad_block_positions",
                      (ref, bands, pos((k, h // s, w // s), s), margin, s,
                       8)))
    calls.append(("mc_block_positions",
                  (ref, pos((4, h // 16, w // 16), 16), margin, 16, 8)))
    p = pos((5, h // 4, w // 4), 4)
    calls += [("sad_luma_positions", (ref, orig, p, margin, 8)),
              ("sad_bilinear_positions", (ref, orig, p, margin))]
    return [(name, label, lambda fn=getattr(mc_kernel, name), a=args:
             fn(*a),
             lambda fn=getattr(mc_kernel, name + "_plain"), a=args: fn(*a))
            for name, args in calls]


def check_kernels(margin: int, dev) -> dict:
    """Phase 3: every kernel against its plain version, tolerance 0."""
    w, h = 2048, 1024
    rng = np.random.default_rng(7)

    def plane(ph, pw, m):
        return torch.as_tensor(rng.integers(0, 256, (ph + 2 * m, pw + 2 * m),
                                            dtype=np.int32), device=dev)

    def t(a):
        return torch.as_tensor(a, device=dev)

    ref_y = plane(h, w, margin)
    ref_c = plane(h // 2, w // 2, margin // 2)
    ref_small = plane(128, 256, margin)
    ref_832 = plane(480, 832, margin)      # the affine path's grid
    # 10 bit, 536x1000: no block count a row is a multiple of a K3/K4 tile
    ref_10 = torch.as_tensor(rng.integers(0, 1024, (536 + 2 * margin,
                                                    1000 + 2 * margin),
                                          dtype=np.int32), device=dev)
    ref_odd = ref_10[:, 3:].contiguous()    # rows not 16-byte aligned
    cases = []      # (kernel, label, kernel call, plain call) per positions
    # K1/K2: the main path's planes first, then 256x128, 10 bit at 536x1000
    # (250 subblocks a row: no multiple of a CTA's width) and a plane whose
    # rows are not 16-byte aligned (the scalar-load path); chroma planes are
    # the luma planes subsampled; random, clamped and coherent positions
    for luma, bd, label in ((ref_y, 8, "2048x1024"), (ref_small, 8, "256x128"),
                            (ref_832, 8, "832x480"),
                            (ref_10, 10, "536x1000"),
                            (ref_odd, 10, "536x1000 cut by 3 columns")):
        chroma = ref_c if luma is ref_y else luma[::2, ::2].contiguous()
        ny, nx = (luma.shape[0] - 2 * margin) // 4, \
            (luma.shape[1] - 2 * margin) // 4
        for pos in (*positions_pair(rng, (ny, nx), 4),
                    coherent_positions(rng, ny, nx)):
            p = t(pos)
            for name, r, m in (("mc_luma_positions", luma, margin),
                               ("mc_chroma_positions", chroma, margin // 2)):
                fn = getattr(mc_kernel, name)
                plain = getattr(mc_kernel, name + "_plain")
                cases.append((name, f"{label} {bd} bit, {ny}x{nx} subblocks, "
                              f"plane width {r.shape[1]}",
                              lambda fn=fn, r=r, p=p, m=m, bd=bd:
                              fn(r, p, m, bd),
                              lambda fn=plain, r=r, p=p, m=m, bd=bd:
                              fn(r, p, m, bd)))
    # K3/K4: the main path's (s, K) first, then widths 32 and 24, K = 1, 5,
    # 6, 10 bit, a plane whose rows are not 16-byte aligned (the kernels'
    # scalar-load path); random, clamped and diamond-like positions each
    for s, k, ref, bd in ((8, 5, ref_y, 8), (16, 6, ref_y, 8),
                          (16, 4, ref_y, 8), (32, 1, ref_y, 8),
                          (24, 5, ref_y, 8), (8, 1, ref_10, 10),
                          (16, 6, ref_10, 10), (24, 6, ref_10, 10),
                          (32, 5, ref_10, 10), (8, 5, ref_odd, 10),
                          (16, 4, ref_odd, 10)):
        ny, nx = (ref.shape[0] - 2 * margin) // s, \
            (ref.shape[1] - 2 * margin) // s
        bands = t(rng.integers(0, 1 << bd, (ny * 4, nx * s), dtype=np.int32))
        label = f"s={s} K={k} {bd} bit, {ny}x{nx} blocks, plane width " \
            f"{ref.shape[1]}"
        for pos in (*positions_pair(rng, (k, ny, nx), s),
                    diamond_positions(rng, k, ny, nx, s)):
            p = t(pos)
            cases.append(("sad_block_positions", label,
                          lambda p=p, b=bands, s=s, r=ref, bd=bd:
                          mc_kernel.sad_block_positions(r, b, p, margin, s,
                                                        bd),
                          lambda p=p, b=bands, s=s, r=ref, bd=bd:
                          mc_kernel.sad_block_positions_plain(
                              r, b, p, margin, s, bd)))
            cases.append(("mc_block_positions", label,
                          lambda p=p, s=s, r=ref, bd=bd:
                          mc_kernel.mc_block_positions(r, p, margin, s, bd),
                          lambda p=p, s=s, r=ref, bd=bd:
                          mc_kernel.mc_block_positions_plain(r, p, margin, s,
                                                             bd)))
    # K5, K6: the 256x128 search's grids (s=8 unsubsampled; s=16 keeps 1
    # of 4 subblock rows and 1 of 2 columns: both below K5's split size)
    # and one full 2048x1024 grid at 8 bit (above it); 10 bit at
    # 536x1000 (250 subblocks a row: no multiple of a tile), on a plane
    # whose rows are not 16-byte aligned, and K = 1; random, clamped,
    # coherent and diamond positions
    for (ny, nx), ref, k, bd, label in (
            ((32, 64), ref_small, 5, 8, "256x128"),
            ((8, 32), ref_small, 5, 8, "256x128"),
            ((h // 4, w // 4), ref_y, 5, 8, "2048x1024"),
            ((134, 250), ref_10, 5, 10, "536x1000"),
            ((134, 250), ref_10, 1, 10, "536x1000"),
            ((134, 250), ref_odd, 5, 10, "536x1000 cut by 3 columns"),
            ((8, 32), ref_odd, 1, 10, "536x1000 cut by 3 columns")):
        orig = t(rng.integers(0, 1 << bd, (ny * 4, nx * 4), dtype=np.int32))
        coherent = np.repeat(coherent_positions(rng, ny, nx)[None], k, 0)
        for pos in (*positions_pair(rng, (k, ny, nx), 4), coherent,
                    diamond_positions(rng, k, ny, nx, 4)):
            p = t(pos)
            sub_label = f"({k}, {ny}, {nx}, 2) {bd} bit, {label}"
            cases.append(("sad_luma_positions", sub_label,
                          lambda p=p, o=orig, r=ref, bd=bd:
                          mc_kernel.sad_luma_positions(r, o, p, margin, bd),
                          lambda p=p, o=orig, r=ref, bd=bd:
                          mc_kernel.sad_luma_positions_plain(r, o, p, margin,
                                                             bd)))
            cases.append(("sad_bilinear_positions", sub_label,
                          lambda p=p, o=orig, r=ref:
                          mc_kernel.sad_bilinear_positions(r, o, p, margin),
                          lambda p=p, o=orig, r=ref:
                          mc_kernel.sad_bilinear_positions_plain(r, o, p,
                                                                 margin)))
    cases += plane_6k_cases(rng, margin, dev)
    cases += depquant_cases(rng, dev)
    max_err = {name: 0 for name in SOURCES if name not in
               ("libm_f32", "sphere_positions", "sphere_centers")}
    for name, label, fn, plain in cases:
        got, want = fn(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name} {label}: {got.shape} {got.dtype} vs plain "
                 f"{want.shape} {want.dtype}")
        max_err[name] = max(max_err[name], int((got - want).abs().max()))
    for name, err in max_err.items():
        n = sum(1 for c in cases if c[0] == name)
        shapes = sorted({c[1] for c in cases if c[0] == name})
        print(f"{name}: max |kernel - plain| = {err} over {n} cases "
              f"(tolerance 0): {'; '.join(shapes)}")
        if err != 0:
            fail(f"{name} differs from its plain version")
    return max_err


def reset_launches() -> None:
    mc_kernel.reset_launches()
    depquant_kernel.reset_launches()
    libm_kernel.reset_launches()
    sphere_kernel.reset_launches()
    for k in frame_codec.POSITION_CALLS:
        frame_codec.POSITION_CALLS[k] = 0


def all_launches() -> dict:
    """Every kernel's launch count: K1-K6, D1/D2 and L1 (its elementwise
    entry points, libm_f32, and its sphere positions and centres)."""
    return dict(mc_kernel.LAUNCHES, **depquant_kernel.LAUNCHES,
                **libm_kernel.LAUNCHES, **sphere_kernel.LAUNCHES)


def libm_inputs(rng, n: int) -> np.ndarray:
    """L1's check inputs: any float32 bit pattern, angles, arguments on
    both sides of the large-argument reduction (|x| = 120), tiny values
    and the edge cases."""
    q = n // 4
    edges = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-40,
                      2 ** -12, 2 ** -126, 119.99, 120.0, 120.01, 3.4e38,
                      np.pi / 2, np.pi, -np.pi, 1.0], np.float32)
    x = np.concatenate([
        rng.integers(0, 1 << 32, q, dtype=np.uint64).astype(np.uint32)
        .view(np.float32), rng.uniform(-8, 8, q).astype(np.float32),
        rng.uniform(-130, 130, q).astype(np.float32),
        (rng.standard_normal(n - 3 * q - len(edges)) * 1e-3)
        .astype(np.float32), edges])
    return x


def check_libm(dev) -> int:
    """Phase 3, L1: each function's kernel against its plain version on
    LIBM_CHECK_N inputs, bit for bit (NaN as NaN).  Returns the count of
    differing results."""
    rng = np.random.default_rng(13)
    bad_total = 0
    for name, wrapper, plain in (("sinf", libm_kernel.sin, libm_f32.sinf),
                                 ("cosf", libm_kernel.cos, libm_f32.cosf),
                                 ("tanf", libm_kernel.tan, libm_f32.tanf),
                                 ("atan2f", libm_kernel.atan2,
                                  libm_f32.atan2f)):
        x = torch.as_tensor(libm_inputs(rng, LIBM_CHECK_N), device=dev)
        args = (x,) if name != "atan2f" else (
            x, torch.as_tensor(libm_inputs(rng, LIBM_CHECK_N)[::-1].copy(),
                               device=dev))
        got, want = wrapper(*args), plain(*args)
        torch.cuda.synchronize()
        same = (got.view(torch.int32) == want.view(torch.int32)) | (
            torch.isnan(got) & torch.isnan(want))
        bad = int((~same).sum())
        bad_total += bad
        print(f"libm_f32 {name}: {bad} of {x.numel()} results differ from "
              "the plain version (tolerance 0)")
    return bad_total


def sphere_fields(rng, k: int, n: int, nby: int, nbx: int, kind: str
                  ) -> torch.Tensor:
    """(k, n, nby, nbx, 2) int32 1/16-pel MVs on the CPU: "random" mixes
    +-24 pel with an eighth of the blocks each zero, zero along x, 40-200
    pel and +-2048 pel; "extreme" is +-2048 pel throughout; "zero" is
    zero."""
    shape = (k, n, nby, nbx, 2)
    if kind == "zero":
        return torch.zeros(shape, dtype=torch.int32)
    if kind == "extreme":
        return torch.as_tensor(rng.integers(-32768, 32769, shape),
                               dtype=torch.int32)
    mv = rng.integers(-384, 385, shape)
    pick = rng.integers(0, 8, shape[:4])
    mv[pick == 0] = 0
    mv[..., 0][pick == 1] = 0
    big = rng.integers(640, 3201, shape) * rng.choice([-1, 1], shape)
    mv[pick == 2] = big[pick == 2]
    mv[pick == 3] = rng.integers(-32768, 32769, shape)[pick == 3]
    return torch.as_tensor(mv, dtype=torch.int32)


def sphere_cases(dev) -> list:
    """Phase 3's sphere-kernel cases at 2048x1024: (kernel, label, kernel
    call, plain call).  Every form of sphere_positions with MPA's three
    planes and ROT beside CLASSIC (merged also with a GED layer, which the
    chain fills first), the op-by-op diamond fields of each model at the
    search's subsampling, and sphere_centers merged and per model, op by
    op and in the search form; random, extreme and zero fields."""
    w, h = 2048, 1024
    reproj = MVReprojection(ERP(w, h), w, h, 1, device=dev)
    rng = np.random.default_rng(14)
    models = [0, 1, 2, 3, 6]
    eps = {7: (0.3, -0.5, 0.8)}
    cases = []
    for kind in ("random", "extreme", "zero"):
        for s, k, row_step, col_step, form, ms in (
                (16, 1, 1, 1, "merged", models),
                (16, 1, 1, 1, "merged", models + [7]),
                (32, 1, 1, 1, "merged", models),
                (16, 5, 4, 1, "search", models),
                (8, 5, 1, 1, "search", models)):
            nby, nbx = h // s, w // s
            idx = torch.as_tensor(rng.integers(0, len(ms), (k, nby, nbx)),
                                  dtype=torch.int32, device=dev)
            mv = sphere_fields(rng, k, len(ms), nby, nbx, kind).to(dev)
            args = (ms, idx, mv, s, row_step, col_step, form, eps)
            cases.append((
                "sphere_positions", f"{form} s={s} K={k} row step "
                f"{row_step}, {len(ms)} models, {kind}",
                lambda a=args: reproj.positions(*a),
                lambda a=args: reproj.positions_plain(*a)))
        for model in (1, 2, 3, 6, 0):
            for s, row_step, col_step, k in ((16, 4, 2, 5), (8, 1, 1, 1)):
                nby, nbx = h // s, w // s
                mv = sphere_fields(rng, k, 1, nby, nbx, kind).to(dev)
                args = ([model], None, mv, s, row_step, col_step, None)
                cases.append((
                    "sphere_positions", f"op by op, model {model} s={s} "
                    f"K={k} row step {row_step} column step {col_step}, "
                    f"{kind}",
                    lambda a=args: reproj.positions(*a),
                    lambda a=args: reproj.positions_plain(*a)))
        for form in (None, "search"):
            for s, k, ms in ((16, 5, models), (8, 1, models + [7]),
                             (16, 5, [1]), (16, 5, [2]), (16, 5, [3]),
                             (16, 5, [6]), (8, 5, [0])):
                nby, nbx = h // s, w // s
                idx = None if len(ms) == 1 else torch.as_tensor(
                    rng.integers(0, len(ms), (k, nby, nbx)),
                    dtype=torch.int32, device=dev)
                mv = sphere_fields(rng, k, len(ms), nby, nbx, kind).to(dev)
                args = (ms, idx, mv, s, eps, form)
                cases.append((
                    "sphere_centers", f"{form or 'op by op'} s={s} K={k}, "
                    f"models {ms}, {kind}",
                    lambda a=args: reproj.centers(*a),
                    lambda a=args: reproj.centers_plain(*a)))
    return cases


def check_sphere(dev) -> dict:
    """Phase 3, the sphere kernel: each case's positions against the plain
    version on the card, bit for bit, one launch a call.  Returns each
    entry point's largest |kernel - plain| (1/16 pel)."""
    err = {"sphere_positions": 0, "sphere_centers": 0}
    off = {"sphere_positions": [0, 0], "sphere_centers": [0, 0]}
    cases = sphere_cases(dev)
    for name, label, fn, plain in cases:
        before = sphere_kernel.LAUNCHES[name]
        got = fn()
        if sphere_kernel.LAUNCHES[name] != before + 1:
            fail(f"{name} {label}: {sphere_kernel.LAUNCHES[name] - before} "
                 "launches for one call")
        want = plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name} {label}: {tuple(got.shape)} {got.dtype} vs "
                 f"plain {tuple(want.shape)} {want.dtype}")
        d = (got - want).abs()
        err[name] = max(err[name], int(d.max()))
        off[name][0] += int((d != 0).any(-1).sum())
        off[name][1] += d[..., 0].numel()
    for name in err:
        n = sum(1 for c in cases if c[0] == name)
        print(f"{name}: {off[name][0]} of {off[name][1]} positions differ "
              f"from the plain version over {n} cases at 2048x1024 "
              f"(tolerance 0; max |kernel - plain| {err[name]})")
        if off[name][0]:
            fail(f"{name} differs from its plain version")
    sphere_kernel.reset_launches()
    return err


def depquant_cases(rng, dev) -> list:
    """D1/D2 against their plain versions: at the I picture's shapes at
    2048x1024 (128 luma blocks x 7 MTS/LFNST candidates, U and V of 128
    blocks), at batches that leave D1's last CTA of 8 blocks short (1, 33,
    897), at (4096, 16, 16) (decisions in shared memory, staged 64
    positions at a time) and at 32x32 and 64x64 (decisions in the global
    scratch), on Laplacian, all-zero and saturating blocks, at QP 0, 37
    and 51 (the 32x32 and 64x64 blocks at QP 37).  D2 takes the levels
    D1's plain version gives."""
    cases = []
    for shape in (*DQ_PATH_SHAPES, (1, 8, 8), (33, 8, 8), (897, 8, 8),
                  (4096, 16, 16), (64, 32, 32), (3, 64, 64)):
        b, s, _ = shape
        # the plain version's chain takes about 1 s for 4096 positions on
        # the card: the largest blocks take one QP
        qps = (37,) if s >= 32 else (0, 37, 51)
        log2s = s.bit_length() - 1
        yy, xx = np.mgrid[0:s, 0:s]
        for kind in ("laplace", "zero", "saturating"):
            if kind == "laplace":
                c = (rng.laplace(0, 1, shape) * 400.0
                     / (1 + yy + xx) ** 1.3).round()
            elif kind == "zero":
                c = np.zeros(shape)
            else:
                c = rng.choice([-32768, 32767, -30000, 31000], shape)
            c = torch.from_numpy(c.astype(np.int32))
            for qp in qps:
                cd = c.to(dev)
                lev = depquant.quantize_dep_plain(cd, qp, log2s, log2s)
                label = f"{shape} {kind} QP {qp}"
                cases.append((
                    "quantize_dep", label,
                    lambda cd=cd, qp=qp, l=log2s:
                    depquant.quantize_dep(cd, qp, l, l),
                    lambda cd=cd, qp=qp, l=log2s:
                    depquant.quantize_dep_plain(cd, qp, l, l)))
                cases.append((
                    "dequantize_dep", label,
                    lambda lv=lev, qp=qp, l=log2s:
                    depquant.dequantize_dep(lv, qp, l, l),
                    lambda lv=lev, qp=qp, l=log2s:
                    depquant.dequantize_dep_plain(lv, qp, l, l)))
    return cases


def launch_counts() -> dict:
    """Kernel launches since the last reset_launches(), with K3-K5's and
    the sphere kernel's by shape under "by_shape", and the codec's calls of
    the sphere positions under "sphere_calls"."""
    return dict(all_launches(), by_shape={
        n: dict(d) for n, d in (*mc_kernel.LAUNCHES_BY_SHAPE.items(),
                                *sphere_kernel.LAUNCHES_BY_SHAPE.items())},
        sphere_calls=dict(frame_codec.POSITION_CALLS))


def device_events(prof) -> list[tuple[str, float]]:
    """(name, device seconds) of every device operation of a profile.
    Read from the profiler's raw records where it keeps them: building
    `prof.events()` costs about 0.1 ms an event, minutes for a traced
    sequence."""
    from torch.autograd import DeviceType
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None:
        return [(e.name(), e.duration_ns() * 1e-9) for e in raw.events()
                if e.device_type() == DeviceType.CUDA]
    return [(e.name, e.time_range.elapsed_us() * 1e-6)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def dq_device_s(prof) -> tuple[float, float]:
    """Device seconds of D1's and D2's kernels in a profile."""
    evs = device_events(prof)
    return (sum(t for n, t in evs if "quantize_dep_kernel" in n
                and "dequantize" not in n),
            sum(t for n, t in evs if "dequantize_dep_kernel" in n))


def device_work(prof) -> tuple[int, float]:
    """(device operations, their summed device seconds) of a profile.  The
    profiler misses the first few operations (about ten) after it starts,
    so a count is low by that much."""
    evs = device_events(prof)
    return len(evs), sum(t for _, t in evs)


def _profiler():
    """Device activity only: the host side of each operation is not read
    here, and tracing it slows the traced run."""
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


class MeasuredEncLib(EncLib):
    """EncLib that notes, for each picture encode_sequence codes, its
    launches, stage times and (mode "trace") its device operations.
    `mode`: "plain", "stages" (stage timers on, each stage synchronised) or
    "trace" (pictures under torch.profiler: every one, or with `sample`,
    a tuple of kind initials such as ("P", "B"), the first picture of
    each kind it names; the pictures of a kind had the same device
    operations within 1% in every traced run so far)."""

    def __init__(self, cfg: EncCfg, mode: str,
                 sample: tuple | None = None) -> None:
        super().__init__(cfg)
        self.mode = mode
        self.sample = sample
        self.rows: list[dict] = []

    def _measured(self, kind: str, method, poc: int, *args, **kw):
        before = all_launches()
        stages_before = profiling.totals()
        prof = None
        if self.mode == "trace" and (self.sample is None or (
                kind[0] in self.sample
                and all(r["kind"] != kind for r in self.rows))):
            prof = _profiler()
            prof.start()
        nal, res = method(poc, *args, **kw)
        if prof is not None:
            torch.cuda.synchronize()
            prof.stop()
        self.rows.append(dict(
            poc=poc, kind=kind, bits=res.bits,
            psnr=(res.psnr_y, res.psnr_u, res.psnr_v), seconds=res.seconds,
            stages={k: v - stages_before.get(k, 0.0)
                    for k, v in profiling.totals().items()},
            device_work=device_work(prof) if prof is not None else None,
            dq_device_s=dq_device_s(prof) if prof is not None else None,
            launches={k: v - before[k]
                      for k, v in all_launches().items()}))
        return nal, res

    def encode_intra_frame(self, poc, *args, **kw):
        return self._measured("I", super().encode_intra_frame, poc, *args,
                              **kw)

    def encode_p_frame(self, poc, *args, **kw):
        return self._measured("P", super().encode_p_frame, poc, *args, **kw)

    def encode_b_frame(self, poc, planes, ref0, ref0_poc, ref1, ref1_poc,
                       tid=0, qp=None):
        return self._measured(f"B{tid}", super().encode_b_frame, poc, planes,
                              ref0, ref0_poc, ref1, ref1_poc, tid, qp)


# bench.py:110-117, configurations 3 and 4 (and 4 with an off-pole
# epipole): MMConfig fields, the signalled (curPOC, refPOC, x, y, z) and
# the EncCfg fields beside the models
BENCH_CONFIGS = {
    "mpa": (dict(mpa=True), [], {}),
    "fullmm": (dict(mpa=True, ged=True, rot=True, mmmvp=True),
               [(1, 0, 0.0, 0.0, 1.0)], {}),
    "fullmm_ep": (dict(mpa=True, ged=True, rot=True, mmmvp=True),
                  [(4, 0, 0.3, -0.5, 0.8)], {}),
    # bench configuration 4 plus the last two models and projected DMVR
    "allmm_dmvr": (dict(mpa=True, t3d=True, tan=True, rot=True, ged=True,
                        mmmvp=True), [(1, 0, 0.0, 0.0, 1.0)],
                   dict(dmvr=True)),
}


def bench_cfg(name: str, w: int, h: int, qp: int, gop_size: int,
              search_range: int = 24) -> EncCfg:
    """Bench configurations 3 (`mpa`) and 4 (`fullmm`, `fullmm_ep`): ERP,
    RA with the QP cascade, the flat grid (qt_depth 0), merge,
    deblock+SAO+ALF."""
    mm, eps, tools = BENCH_CONFIGS[name]
    return EncCfg(width=w, height=h, qp=qp, gop="RA", gop_size=gop_size,
                  qt_depth=0, inter_block_size=16, search_range=search_range,
                  wrap_around=True, merge=True, mm=MMConfig(**mm),
                  epipoles=list(eps), **tools)


def headline_cfg(w: int, h: int, qp: int, gop_size: int,
                 search_range: int = 24) -> EncCfg:
    """The headline configuration: ERP, RA with the QP cascade, MPA+ROT,
    quadtree depth 1, merge, deblock+SAO+ALF."""
    return EncCfg(width=w, height=h, qp=qp, gop="RA", gop_size=gop_size,
                  qt_depth=1, inter_block_size=16, search_range=search_range,
                  wrap_around=True, merge=True,
                  mm=MMConfig(mpa=True, rot=True))


def encode_run(label: str, cfg: EncCfg, src: list, mode: str,
               sample: tuple | None = None) -> dict:
    """One EncLib(cfg).encode_sequence(src) on the card: the Annex-B
    bytes, the per-picture notes, the sequence's seconds (host clock,
    synchronised) and the launch counts of this run alone."""
    profiling.reset()
    profiling.enable(mode == "stages")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = MeasuredEncLib(cfg, mode, sample)
    data = enc.encode_sequence(src)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    profiling.enable(False)
    if len(enc.results) != len(src) or enc.summary()["frames"] != len(src):
        fail(f"{label}: {len(enc.results)} results for {len(src)} frames")
    return dict(label=label, data=data, rows=enc.rows, launches=launches,
                seconds=seconds, stages=profiling.totals(), frames=len(src),
                width=cfg.width, height=cfg.height, enc=enc)


def check_run(run: dict, need: tuple, record: dict | None = None,
              hold: bool = False) -> None:
    """Print a run's pictures beside the JAX encoder's record where there
    is one, and with `hold` keep them to it; require the kernels in `need`
    launched; decode the stream on the card and require every MD5 OK."""
    label, n = run["label"], run["frames"]
    for r in run["rows"]:
        ref = record.get(r["poc"]) if record else None
        rec_bits = f" (JAX encoder {ref['bits']})" if ref else ""
        rec_psnr = (f" (JAX encoder {ref['psnr_y']:.4f}/{ref['psnr_u']:.4f}/"
                    f"{ref['psnr_v']:.4f})") if ref else ""
        print(f"{label} POC {r['poc']} ({r['kind']}): {r['bits']} bits"
              f"{rec_bits}, PSNR Y/U/V {r['psnr'][0]:.4f}/{r['psnr'][1]:.4f}/"
              f"{r['psnr'][2]:.4f} dB{rec_psnr}, {r['seconds']:.2f} s (host "
              f"clock), launches {r['launches']}")
        if not all(np.isfinite(r["psnr"])) or r["psnr"][0] < MIN_PSNR_Y_DB:
            fail(f"{label} POC {r['poc']}: Y-PSNR {r['psnr'][0]}")
        if ref and hold:
            if r["psnr"][0] < ref["psnr_y"] - PSNR_TOL_DB:
                fail(f"POC {r['poc']}: Y-PSNR {r['psnr'][0]:.4f} more than "
                     f"{PSNR_TOL_DB} dB below {ref['psnr_y']:.4f}")
            if r["bits"] > BITS_TOL * ref["bits"]:
                fail(f"POC {r['poc']}: {r['bits']} bits more than 2% above "
                     f"{ref['bits']}")
    if sorted(r["poc"] for r in run["rows"]) != list(range(n)):
        fail(f"{label}: pictures {[r['poc'] for r in run['rows']]}")
    print(f"{label}: {n} pictures, {len(run['data'])} bytes (SHA-256 "
          f"{hashlib.sha256(run['data']).hexdigest()}) in "
          f"{run['seconds']:.2f} s (host clock), "
          f"{n / run['seconds']:.3f} frames per second, launches "
          f"{run['launches']}")
    for name in need:
        if run["launches"][name] == 0:
            fail(f"{label}: the encode did not launch {name}")
    for name, calls in run["launches"]["sphere_calls"].items():
        print(f"{label}: {name}: {calls} codec calls, "
              f"{run['launches'][name]} launches")
    dec = DecLib()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = dec.decode_bytes(run["data"])
    torch.cuda.synchronize()
    ok = sum(1 for v in dec.hash_status.values() if v == "OK")
    print(f"{label}: own stream decoded on the card in "
          f"{time.perf_counter() - t0:.2f} s (host clock), {ok} of {n} MD5 "
          f"OK, hash {dec.hash_status}")
    if sorted(dec.hash_status) != list(range(n)) or ok != n \
            or [f.poc for f in frames] != list(range(n)):
        fail(f"{label}: the port's decoder disagrees with its encoder on "
             "the card")
    for f in frames:
        if tuple(f.planes[0].shape) != (run["height"], run["width"]):
            fail(f"{label} POC {f.poc}: decoded shape "
                 f"{tuple(f.planes[0].shape)}")


def first_difference(a: bytes, b: bytes) -> int | None:
    """Index of the first differing byte (the shorter length if one is a
    prefix of the other), or None when equal."""
    if a == b:
        return None
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return min(len(a), len(b))


def hold_bytes(label: str, got: bytes, want: bytes, stream: str) -> None:
    """The card's stream must be the committed JAX stream byte for byte:
    both SHA-256s, and on a difference the first differing NAL and byte
    (compare_nals), then fail."""
    g, w = (hashlib.sha256(x).hexdigest() for x in (got, want))
    print(f"{label}: SHA-256 {g}, the committed {stream}'s {w}: "
          f"{'equal' if g == w else 'DIFFERENT'}")
    if g != w:
        compare_nals(label, got, want)
        fail(f"{label}: the card's stream differs from the JAX encoder's "
             f"{stream}")


def compare_nals(label: str, got: bytes, want: bytes, only=None) -> bool:
    """Print, NAL by NAL, whether the port's stream equals the committed
    (JAX-encoded) one; `only` limits the comparison to one NAL type."""
    g, w = bs.read_annexb(got), bs.read_annexb(want)
    same = len(g) == len(w)
    pics = -1
    for a, b in zip(g, w):
        if a.nal_type in (bs.NAL_IDR, bs.NAL_TRAIL):
            pics += 1
        if only is not None and a.nal_type != only:
            continue
        at = first_difference(a.payload, b.payload)
        if at is not None or a.nal_type != b.nal_type:
            same = False
            print(f"{label}: NAL type {a.nal_type} of coded picture {pics} "
                  f"differs from the committed stream's at byte {at} "
                  f"({len(a.payload)} against {len(b.payload)} bytes)")
    what = "whole stream" if only is None else f"NAL type {only}"
    print(f"{label}: {what} equal to the committed stream's byte for byte: "
          f"{same}")
    return same


def stage_shares(stages: dict) -> str:
    total = sum(stages.values())
    return ", ".join(f"{k} {100 * v / total:.1f}%" for k, v in
                     sorted(stages.items(), key=lambda kv: -kv[1]) if v > 0)


def print_stages(run: dict) -> None:
    """Stage shares of a "stages" run, per picture and over all."""
    for r in run["rows"]:
        print(f"{run['label']} POC {r['poc']} ({r['kind']}) stage shares "
              f"({sum(r['stages'].values()):.2f} s in stages of "
              f"{r['seconds']:.2f} s): {stage_shares(r['stages'])}")
    print(f"{run['label']} stage shares (timers on, each stage "
          f"synchronised; {sum(run['stages'].values()):.2f} s in stages of "
          f"{run['seconds']:.2f} s): {stage_shares(run['stages'])}")


def print_device_work(traced: dict, plain: dict) -> None:
    """Per picture: the device operations torch.profiler traced and their
    device time, against the untraced encode's seconds of that picture;
    then the sums by picture kind."""
    kinds: dict[str, list] = {}
    for r, p in zip(traced["rows"], plain["rows"]):
        if r["device_work"] and r["device_work"][0]:
            k = kinds.setdefault(r["kind"], [0, 0, 0.0, 0.0])
            k[0] += 1
            k[1] += r["device_work"][0]
            k[2] += r["device_work"][1]
            k[3] += p["seconds"]
    for kind, (n, ops, busy, secs) in sorted(kinds.items()):
        print(f"{traced['label']} {kind} pictures ({n}): {ops / n:.0f} "
              f"device operations and {busy / n:.4f} s of device time a "
              f"picture, {secs / n:.2f} s a picture untraced (host clock): "
              f"the card idle {100 * (1 - busy / secs):.1f}%")
    for r, p in zip(traced["rows"], plain["rows"]):
        if r["poc"] != p["poc"]:
            fail(f"{traced['label']}: picture order changed between runs")
        if r["device_work"] is None:        # not sampled
            continue
        n, busy = r["device_work"]
        if n == 0:
            print(f"{traced['label']} POC {r['poc']} ({r['kind']}): device "
                  "operations not measured (the profiler traced none)")
            continue
        print(f"{traced['label']} POC {r['poc']} ({r['kind']}): {n} device "
              f"operations (kernels and copies), {busy:.4f} s of device "
              f"time; the untraced encode took {p['seconds']:.2f} s (host "
              f"clock): the card is idle "
              f"{100 * (1 - busy / p['seconds']):.1f}% of it "
              f"({r['seconds']:.2f} s under the profiler)")


POSITION_FAULTS: list = []


def compare_positions(data: bytes, w: int, h: int):
    """Decode `data` on the card, computing every merged-positions tensor
    on the card and with the same code on the CPU (GED pictures with their
    epipoles): returns the card's tensors (projected DMVR's candidate
    positions among them, in call order), the (differing, total) subblock
    counts per merged-positions call (projected DMVR's candidates counted
    apart), the decoded frames and the decode's MD5 verdicts."""
    card_positions, mismatches, dmvr_mismatches = [], [], []
    dec = DecLib(positions_fn=lambda *a: compare(*a))
    cpu_reproj = None

    def compare(active, midx, stack, bsize, epipoles, row_step):
        nonlocal cpu_reproj
        if cpu_reproj is None:
            cpu_reproj = MVReprojection(ERP(w, h), w, h,
                                        dec.sps.mm.mm_offset_4x4,
                                        int(dec.sps.mm.ged_flavor),
                                        device="cpu")
        on_card = frame_codec.merged_positions(dec.reproj, active, midx,
                                               stack, bsize, epipoles,
                                               row_step)
        card_positions.append(on_card)
        on_cpu = frame_codec.merged_positions(cpu_reproj, active, midx,
                                              stack, bsize, epipoles,
                                              row_step)
        diff = (on_card.cpu() != on_cpu).any(-1)
        (dmvr_mismatches if row_step > 1 else mismatches).append(
            (int(diff.sum()), diff.numel()))
        return on_card

    frames = dec.decode_bytes(data)
    off = sum(n for n, _ in mismatches + dmvr_mismatches)
    if off:
        POSITION_FAULTS.append((f"{w}x{h}", off))
    for i, (n, tot) in enumerate(mismatches):
        print(f"{w}x{h} positions call {i}: {n} of {tot} subblocks differ "
              "card vs CPU")
    print(f"{w}x{h} position mismatches card vs CPU: "
          f"{sum(n for n, _ in mismatches)} of "
          f"{sum(t for _, t in mismatches)} subblocks")
    if dmvr_mismatches:
        print(f"{w}x{h} projected-DMVR candidate positions ("
              f"{len(dmvr_mismatches)} tensors, row step > 1), mismatches "
              f"card vs CPU: {sum(n for n, _ in dmvr_mismatches)} of "
              f"{sum(t for _, t in dmvr_mismatches)} subblocks")
    return card_positions, mismatches, frames, dec.hash_status


def captured_case(key: tuple) -> dict:
    """The tensors of the last launch with `key` = (kernel, positions
    shape, block width) that the encodes made."""
    if key not in mc_kernel.CAPTURED:
        fail(f"the encodes never launched {key}; captured "
             f"{sorted(mc_kernel.CAPTURED, key=str)}")
    return mc_kernel.CAPTURED[key]


class _Tee:
    """stdout, copied to smoke_out/chip_smoke.log, for a caller that keeps
    only the end of the output."""

    def __init__(self, stream, path: str) -> None:
        self.stream, self.file = stream, open(path, "w")

    def write(self, text: str) -> None:
        self.stream.write(text)
        self.file.write(text)

    def flush(self) -> None:
        self.stream.flush()
        self.file.flush()


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA device")
    out_dir = os.path.join(ROOT, "smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    sys.stdout = _Tee(sys.stdout, os.path.join(out_dir, "chip_smoke.log"))
    dev = torch.device("cuda")
    # ---- 1. build
    phase("1. build")
    t0 = time.perf_counter()
    reports = cuda_lib.build_all()
    print(f"build: {len(reports)} CUDA source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        entry = ""
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                print(f"  {name} {entry}: {line.split(':', 1)[-1].strip()}")
    # ---- 2. card
    card = card_line()
    print(card)
    # ---- 3. kernels vs plain versions
    phase("3. kernels against their plain versions")
    max_err = check_kernels(MC_MARGIN, dev)
    max_err["libm_f32"] = check_libm(dev)
    if max_err["libm_f32"]:
        fail("libm_f32 differs from its plain version")
    max_err.update(check_sphere(dev))

    # ---- 4. decode the 2048x1024 stream on the card
    phase("4. decode the committed streams on the card")
    w, h = 2048, 1024
    path_launches = {}
    side = json.load(open(os.path.join(DATA, BIG + ".json")))
    data = open(os.path.join(DATA, BIG + ".bin"), "rb").read()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = DecLib()
    frames = dec.decode_bytes(data)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = launch_counts()
    path_launches["decode 2048x1024"] = launches
    print(f"decode {BIG}: {len(frames)} pictures in {decode_s:.2f} s "
          f"(host clock, first call), launches {launches}")
    src = realistic_sequence(side["width"], side["height"],
                             side["frames"])
    hold_to_record(f"decode {BIG}", frames, dec.hash_status, side, src)
    for name in ("mc_luma_positions", "mc_chroma_positions"):
        if launches[name] == 0:
            fail(f"the decode did not launch {name}")

    # small stream on the card: every picture's MD5
    small = DecLib()
    small.decode_bytes(open(os.path.join(DATA, SMALL + ".bin"),
                            "rb").read())
    print(f"decode {SMALL}: hash {small.hash_status}")
    if not small.hash_status or \
            any(v != "OK" for v in small.hash_status.values()):
        fail(f"{SMALL}: MD5 mismatch on the card")
    for stream in SMALL_MM:
        sd = json.load(open(os.path.join(DATA, stream + ".json")))
        mm_dec = DecLib()
        mm_dec.decode_bytes(open(os.path.join(DATA, stream + ".bin"),
                                 "rb").read())
        md5_verdicts(f"decode {stream}", mm_dec.hash_status, sd)
    for stream in TENBIT:
        decode_tool_stream(f"decode {stream}", stream)

    # ---- 5. positions: card vs the same code on the CPU
    phase("5. positions, card against CPU")
    card_positions, mismatches, frames2, _ = compare_positions(data, w, h)
    same = [a.md5() == b.md5() for a, b in zip(frames, frames2)]
    print(f"second decode identical to the first: {same}")
    if not all(same):
        fail("the positions hook changed the decode")
    small_data = open(os.path.join(DATA, SMALL + ".bin"), "rb").read()
    _, small_mismatches, _, _ = compare_positions(small_data, 256, 128)
    if sum(n for n, _ in mismatches + small_mismatches):
        fail("positions differ between the card and the CPU")
    cpu_decode_from(f"decode {BIG}", data, frames2, card_positions)

    # ---- 6./7. sequences against the JAX encoder's record (GOP 4)
    phase("6./7. sequences against the JAX encoder's record")
    mc_kernel.CAPTURED = {}
    sequences_against_record(path_launches,
                             sum(n for n, _ in small_mismatches))

    # ---- 8. the headline sequence: 17 frames, GOP 16, 2048x1024
    phase("8. the headline sequence")
    clip = realistic_sequence(w, h, HEADLINE_FRAMES)
    reprojection.CAPTURED = {}
    headline_sequence("sequence 2048x1024 GOP 16",
                      headline_cfg(w, h, 37, HEADLINE_GOP), clip,
                      ("mc_luma_positions", "mc_chroma_positions",
                       "sad_block_positions", "mc_block_positions",
                       "sphere_positions", "sphere_centers"),
                      path_launches, sha256=HEADLINE_SHA256)
    sphere_captured, reprojection.CAPTURED = reprojection.CAPTURED, None

    # ---- 8b. bench configurations 3 and 4 (the flat MM P path, GED)
    phase("8b. bench configurations 3 and 4")
    mc_kernel.CAPTURED, kept = None, mc_kernel.CAPTURED
    bench_configurations(path_launches)
    mc_kernel.CAPTURED = kept

    # ---- 8c. bench configuration 2: the classic inter path, 832x480
    phase("8c. bench configuration 2 (classic, 832x480, GOP 16)")
    bench_configuration_2(path_launches)

    # ---- 8d. bench configuration 5: classic LDP at 6144x3072, two refs
    phase("8d. bench configuration 5 (classic LDP, 6144x3072)")
    bench_configuration_5(path_launches)

    # ---- 8e. all eight models and projected DMVR, 2048x1024
    phase("8e. configuration 4 + 3DT + TAN + projected DMVR (2048x1024)")
    dmvr_case = allmm_dmvr_path(path_launches, max_err)

    # ---- 8f. bench configuration 2 with BDOF and DMVR
    phase("8f. bench configuration 2 with BDOF and DMVR (832x480)")
    bench_configuration_2_tools(path_launches)

    # ---- 8g. bench configuration 1: AI at 416x240
    phase("8g. bench configuration 1 (AI, 416x240)")
    bench_configuration_1(path_launches)

    # ---- 8h-8j. configuration 2 with the classic random-access tools
    phase("8h. path C: the random-access tool set (832x480, GOP 16)")
    tools_path("path C 832x480 RA tools", PATH_C, path_launches)
    phase("8i. path D: affine (832x480, LDP)")
    affine_cases = affine_path(path_launches, max_err)
    phase("8j. path E: a fade with weighted prediction (832x480, GOP 16)")
    tools_path("path E 832x480 fade WP", PATH_E, path_launches)

    # ---- 8k-8m. the I picture's quantization and transform tools
    phase("8k. the CTC-like preset on the headline tools (2048x1024)")
    dq_captured = preset_path(path_launches)
    phase("8l. bench configuration 1 with the residual tools, and lossless")
    intra_tools_path(path_launches)
    phase("8m. configuration 2's clip, LDP, a scaling list (832x480)")
    scaling_path(path_launches)

    # ---- 8n. the I picture's prediction tools
    phase("8n. the I picture's prediction tools (416x240, 2048x1024)")
    intra_pred_path(path_launches)
    if POSITION_FAULTS:
        fail(f"positions differ between the card and the CPU: "
             f"{POSITION_FAULTS}")

    # ---- 8o-8q. block partitioning: quadtree, MTT, two-level intra
    phase("8o. the classic quadtree (832x480, RA, GOP 4)")
    partition_path("quadtree 832x480 GOP 4", PART_QT, path_launches)
    phase("8p. the multi-type tree (832x480, RA, GOP 4)")
    partition_path("MTT 832x480 GOP 4", PART_MTT, path_launches)
    phase("8q. two-level intra partitioning (416x240, 2048x1024)")
    partition_path("intra split 416x240 AI", PART_INTRA, path_launches)
    intra_split_picture(path_launches)

    # ---- 8r-8s. the sequence tools: WPP, LMCS, film grain, MCTS, loss
    phase("8r. WPP + LMCS + the film grain SEI (832x480, RA, GOP 4)")
    sequence_tools_path(path_launches)
    phase("8s. MCTS and a lost picture (832x480, LDP)")
    mcts_path(path_launches)

    # ---- 8t-8u. rate control, MCTF, the 360 metrics; Equisolid content
    phase("8t. MCTF + rate control + 360 metrics (2048x1024, RA, GOP 4)")
    rc_mctf_path(path_launches)
    phase("8u. Equisolid (fisheye) content (1088x1088, RA, GOP 4)")
    equisolid_path(path_launches)

    # ---- 8v-8w. the apps, and the sharded encodes in 2 ranks
    phase("8v. the apps on the card (2048x1024, 256x128)")
    apps_path(path_launches)
    phase("8w. sharded encodes in 2 ranks on the card (2048x1024)")
    sharded_path(path_launches)

    # ---- 9. decision SADs through K6 (and K5 beside it)
    phase("9. decision SADs")
    positions = card_positions[-1].to(torch.int32).contiguous()
    ref_pic = frames[0].planes
    full_grid = full_grid_case(ref_pic[0], clip[1][0], positions, dev)
    decision_sads(full_grid, path_launches)
    captured, mc_kernel.CAPTURED = mc_kernel.CAPTURED, None

    # ---- 10. time the kernels on the main paths' inputs
    phase("10. kernel times")
    out = time_kernels(captured, full_grid, ref_pic, positions, dmvr_case,
                       affine_cases, max_err, path_launches, card, w, h,
                       dq_captured, sphere_captured)
    phase("done")
    print(json.dumps({"kernels": list(out.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def sequences_against_record(path_launches: dict, small_positions_off: int
                             ) -> None:
    """Phases 6 and 7."""
    for label, stream, need in (
            ("sequence 2048x1024 GOP 4", BIG,
             ("mc_luma_positions", "mc_chroma_positions",
              "sad_block_positions", "mc_block_positions")),
            ("sequence 256x128 GOP 4", SMALL,
             ("mc_luma_positions", "mc_chroma_positions",
              "sad_luma_positions"))):
        sd = json.load(open(os.path.join(DATA, stream + ".json")))
        committed = open(os.path.join(DATA, stream + ".bin"), "rb").read()
        cfg = headline_cfg(sd["width"], sd["height"], sd["qp"],
                           sd["gop_size"], sd["search_range"])
        if (sd["gop"], sd["qt_depth"], sd["wrap_around"]) != \
                (cfg.gop, cfg.qt_depth, cfg.wrap_around):
            fail(f"{stream}: the sidecar names another configuration")
        clip = realistic_sequence(sd["width"], sd["height"], sd["frames"])
        run = encode_run(label, cfg, clip, "plain")
        path_launches[label] = run["launches"]
        big = stream == BIG
        # at 256x128 the byte comparison below is the stricter check
        check_run(run, need, {p["poc"]: p for p in sd["pocs"]}, hold=big)
        # the stage shares at both sizes (the only staged encode of the
        # 2048x1024 multi-model path), the trace at 256x128 (phase 8
        # traces the 2048x1024 headline)
        again = [encode_run(label, cfg, clip, "stages")]
        if not big:
            again.append(encode_run(label, cfg, clip, "trace"))
        for other in again:
            if other["data"] != run["data"]:
                fail(f"{label}: another encode gave other bytes")
        print_stages(again[0])
        if big:
            hold_bytes(label, run["data"], committed, stream)
        else:
            print_device_work(again[1], run)
            if not compare_nals(label, run["data"], committed) \
                    and small_positions_off == 0:
                fail(f"{label}: the card's positions equal the CPU's, yet "
                     "the stream differs from the JAX encoder's")


def headline_sequence(label: str, cfg: EncCfg, clip: list, need: tuple,
                      path_launches: dict, record: dict | None = None,
                      sha256: str | None = None,
                      sample: tuple = ("I", "P", "B")) -> dict:
    """Phase 8 (and 8c, held to `record`): returns the first run.  With
    `sha256`, the stream must have it; `sample`: the picture kinds whose
    first picture the traced encode measures."""
    n = len(clip)
    # one timed encode, no repeat: the smoke's time limit is shared
    first = encode_run(label, cfg, clip, "plain")
    path_launches[label] = first["launches"]
    check_run(first, need, record)
    one_launch_a_call(label, first["launches"])
    if sha256 is not None:
        got = hashlib.sha256(first["data"]).hexdigest()
        print(f"{label}: SHA-256 {got}, the JAX encoder's {sha256}: "
              f"{'equal' if got == sha256 else 'DIFFERENT'}")
        if got != sha256:
            fail(f"{label}: the stream differs from the JAX encoder's")
    l1 = ("libm_f32", "sphere_positions", "sphere_centers")
    for kind in sorted({r["kind"] for r in first["rows"]}):
        rows = [r for r in first["rows"] if r["kind"] == kind]
        per = {k: sum(r["launches"][k] for r in rows) / len(rows) for k in l1}
        each = ", ".join(f"{k} {v:.1f}" for k, v in per.items())
        print(f"{label}: {kind} pictures, L1 launches a picture: "
              f"{sum(per.values()):.1f} ({each})")
    counts = {k: first["launches"][k] for k in l1}
    print(f"{label}: L1 launches in the sequence: {sum(counts.values())} "
          f"({', '.join(f'{k} {v}' for k, v in counts.items())})")
    print(f"{label}: {first['seconds']:.2f} s (host clock) = "
          f"{n / first['seconds']:.3f} frames per second")
    for kind in sorted({r["kind"] for r in first["rows"]}):
        per = [r["seconds"] for r in first["rows"] if r["kind"] == kind]
        print(f"{label}: {kind} pictures {min(per):.2f}-{max(per):.2f} s, "
              f"median {statistics.median(per):.2f} s over {len(per)} "
              "pictures (host clock)")
    traced = encode_run(label + " (traced)", cfg, clip, "trace", sample)
    if traced["data"] != first["data"]:
        fail(f"{label}: the traced encode gave other bytes")
    print_device_work(traced, first)
    return first


def one_launch_a_call(label: str, launches: dict) -> None:
    """On a run whose models are all the sphere kernel's (MPA, ROT,
    CLASSIC): each codec call of the positions (frame_codec.POSITION_CALLS:
    a merged-positions call, a K-field search or decision step, a diamond
    step) is one launch, and the steps take their K fields in that one
    launch (launches by shape with K > 1)."""
    for name, calls in launches["sphere_calls"].items():
        if calls != launches[name]:
            fail(f"{label}: {calls} codec calls of {name}, "
                 f"{launches[name]} launches")
        multi = {k: n for k, n in launches["by_shape"][name].items()
                 if int(k.split(" K=")[1].split()[0]) > 1}
        print(f"{label}: {name}: one launch a codec call ({calls}); "
              f"{sum(multi.values())} of them take K > 1 fields: {multi}")
        if name == "sphere_centers" and calls and not multi:
            fail(f"{label}: no {name} launch took more than one field")


def bench_configurations(path_launches: dict) -> None:
    """Phase 8b."""
    need = ("mc_luma_positions", "mc_chroma_positions",
            "sad_block_positions", "mc_block_positions")
    for name in ("mpa", "fullmm"):
        stream = f"erp2048x1024_ra_{name}_qp37_5f"
        sd, committed, cfg, clip = bench_stream(name, stream)
        label = f"config {name} 2048x1024 GOP 4"
        run = encode_run(label, cfg, clip, "plain")
        path_launches[label] = run["launches"]
        check_run(run, need, {p["poc"]: p for p in sd["pocs"]}, hold=True)
        if name == "fullmm":    # configuration 3's path is a subset
            traced = encode_run(label + " (traced)", cfg, clip, "trace",
                                sample=("P", "B"))
            if traced["data"] != run["data"]:
                fail(f"{label}: another encode gave other bytes")
            print_device_work(traced, run)
        hold_bytes(label, run["data"], committed, stream)
        # the CPU decode from the card's positions runs on phase 5's
        # stream (MPA and ROT) and phase 8e's (every model), a superset
        decode_committed(label, stream, sd, committed, clip,
                         cpu_decode=False)
    for name in ("mpa", "fullmm", "fullmm_ep"):
        stream = f"erp256x128_ra_{name}_qp37_5f"
        sd, committed, cfg, clip = bench_stream(name, stream)
        label = f"config {name} 256x128 GOP 4"
        run = encode_run(label, cfg, clip, "plain")
        path_launches[label] = run["launches"]
        check_run(run, ("mc_luma_positions", "mc_chroma_positions",
                        "sad_luma_positions"),
                  {p["poc"]: p for p in sd["pocs"]})
        compare_positions(committed, sd["width"], sd["height"])
        # the port's CPU encode is held to the same committed stream by
        # tests/test_torch_sequence.py, so card == committed implies
        # card == CPU: no CPU encode here (the smoke's time limit)
        if not compare_nals(label, run["data"], committed):
            fail(f"{label}: the card's stream differs from the JAX "
                 "encoder's")


def bench_configuration_2(path_launches: dict) -> None:
    """Phase 8c: `ra832x480_qp37_encode_fps` (bench.py:106-108) against the
    JAX encoder's stream.  No sphere math runs here, so the card's stream
    must be the committed one byte for byte."""
    sd = json.load(open(os.path.join(DATA, CONFIG2 + ".json")))
    committed = open(os.path.join(DATA, CONFIG2 + ".bin"), "rb").read()
    cfg = EncCfg(width=832, height=480, qp=37, gop="RA", gop_size=16,
                 search_range=24)
    check_classic_sidecar(CONFIG2, sd, cfg)
    clip = realistic_sequence(cfg.width, cfg.height, sd["frames"])
    label = "config 2 832x480 GOP 16"
    first = headline_sequence(label, cfg, clip, (), path_launches,
                              {p["poc"]: p for p in sd["pocs"]},
                              sample=("P", "B"))
    if any(first["launches"][k] for k in SOURCES):
        fail(f"{label}: the classic path launched a kernel: "
             f"{first['launches']}")
    staged = encode_run(label, cfg, clip, "stages")
    if staged["data"] != first["data"]:
        fail(f"{label}: the staged encode gave other bytes")
    print_stages(staged)
    if not compare_nals(label, first["data"], committed):
        fail(f"{label}: the card's stream differs from the JAX encoder's")
    decode_all_ok(label, CONFIG2, committed, sd["frames"],
                  first["data"])


def check_classic_sidecar(stream: str, sd: dict, cfg: EncCfg,
                          fade: float | None = None) -> None:
    """A classic stream's sidecar must name `cfg` (and the clip's fade)."""
    if (sd["width"], sd["height"], sd["qp"], sd["gop"], sd["gop_size"],
            sd["search_range"], sd["wrap_around"], sd["merge"],
            sd["models"]) != (cfg.width, cfg.height, cfg.qp, cfg.gop,
                              cfg.gop_size, cfg.search_range,
                              cfg.wrap_around, cfg.merge, "CLASSIC") \
            or sidecar_tools(sd) != cfg_tools(cfg, fade):
        fail(f"{stream}: the sidecar names another configuration")


def decode_all_ok(label: str, stream: str, data: bytes, n: int,
                  own: bytes) -> None:
    """A committed stream decoded on the card: every MD5 OK.  Where it is
    the port's stream `own` byte for byte, check_run has decoded these
    very bytes already, and the second decode is not repeated."""
    if data == own:
        print(f"{label}: committed {stream} is the port's stream byte for "
              "byte: decoded on the card above with every MD5 OK")
        return
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = DecLib()
    frames = dec.decode_bytes(data)
    torch.cuda.synchronize()
    ok = sum(1 for v in dec.hash_status.values() if v == "OK")
    print(f"{label}: committed {stream} decoded on the card in "
          f"{time.perf_counter() - t0:.2f} s (host clock), {ok} of {n} MD5 "
          "OK")
    if ok != n or [f.poc for f in frames] != list(range(n)):
        fail(f"{label}: committed stream, hash {dec.hash_status}")


def allmm_dmvr_path(path_launches: dict, max_err: dict) -> dict:
    """Phase 8e: bench configuration 4 plus 3DT, TAN and projected DMVR at
    2048x1024 against the JAX encoder's record.  Returns the K1 inputs of
    one projected-DMVR bilateral cost, held here to the plain version."""
    sd, committed, cfg, clip = bench_stream("allmm_dmvr", ALLMM)
    label = "config allmm+DMVR 2048x1024 GOP 4"
    print(f"{label}: {len(cfg.mm.active_models())} active models "
          f"{cfg.mm.active_models()}, dmvr {cfg.dmvr}")
    kept, mc_kernel.CAPTURED = mc_kernel.CAPTURED, {}
    run = encode_run(label, cfg, clip, "plain")
    # projected DMVR launches K1 on one row of subblocks (its pair's bi
    # blocks); keep the largest such launch
    rows = [c for (name, shape, _), c in mc_kernel.CAPTURED.items()
            if name == "mc_luma_positions" and shape[0] == 1]
    case = max(rows, key=lambda c: c["positions"].shape[1], default=None)
    mc_kernel.CAPTURED = kept
    path_launches[label] = run["launches"]
    check_run(run, ("mc_luma_positions", "mc_chroma_positions",
                    "sad_block_positions", "mc_block_positions"),
              {p["poc"]: p for p in sd["pocs"]}, hold=True)
    k1 = run["launches"]["by_shape"]["mc_luma_positions"]
    print(f"{label}: K1 launches by subblock grid {k1}; projected DMVR's "
          f"bilateral costs (one row of a pair's bi blocks' subblocks, row "
          f"step 4): {k1.get('one row', 0)} over "
          f"{sum(1 for r in run['rows'] if r['kind'].startswith('B'))} B "
          "pictures")
    if not k1.get("one row") or case is None:
        fail(f"{label}: projected DMVR did not launch K1")
    args = (case["ref_padded"], case["positions"], case["margin"],
            case["bit_depth"])
    err = int((mc_kernel.mc_luma_positions(*args)
               - mc_kernel.mc_luma_positions_plain(*args)).abs().max())
    torch.cuda.synchronize()
    print(f"mc_luma_positions on a projected-DMVR bilateral cost's "
          f"positions {tuple(case['positions'].shape)}: max |kernel - "
          f"plain| = {err} (tolerance 0)")
    max_err["mc_luma_positions"] = max(max_err["mc_luma_positions"], err)
    if err:
        fail("mc_luma_positions differs from its plain version on the "
             "projected-DMVR positions")
    traced = encode_run(label + " (traced)", cfg, clip, "trace",
                        sample=("P", "B"))
    if traced["data"] != run["data"]:
        fail(f"{label}: another encode gave other bytes")
    print_device_work(traced, run)
    hold_bytes(label, run["data"], committed, ALLMM)
    decode_committed(label, ALLMM, sd, committed, clip)
    return case


def bench_configuration_2_tools(path_launches: dict) -> None:
    """Phase 8f: bench configuration 2 with BDOF and DMVR (the random-
    access common test conditions' setting) against the JAX encoder's
    stream: no float math, so byte for byte."""
    sd = json.load(open(os.path.join(DATA, CONFIG2_TOOLS + ".json")))
    committed = open(os.path.join(DATA, CONFIG2_TOOLS + ".bin"), "rb").read()
    cfg = EncCfg(width=832, height=480, qp=37, gop="RA", gop_size=16,
                 search_range=24, bdof=True, dmvr=True)
    check_classic_sidecar(CONFIG2_TOOLS, sd, cfg)
    clip = realistic_sequence(cfg.width, cfg.height, sd["frames"])
    label = "config 2+BDOF+DMVR 832x480 GOP 16"
    run = encode_run(label, cfg, clip, "plain")
    path_launches[label] = run["launches"]
    check_run(run, (), {p["poc"]: p for p in sd["pocs"]})
    if any(run["launches"][k] for k in SOURCES):
        fail(f"{label}: the classic path launched a kernel: "
             f"{run['launches']}")
    traced = encode_run(label + " (traced)", cfg, clip, "trace",
                        sample=("P", "B"))
    if traced["data"] != run["data"]:
        fail(f"{label}: the traced encode gave other bytes")
    print_device_work(traced, run)
    if not compare_nals(label, run["data"], committed):
        fail(f"{label}: the card's stream differs from the JAX encoder's")
    decode_all_ok(label, CONFIG2_TOOLS, committed, sd["frames"],
                  run["data"])


# path -> (EncCfg fields beside configuration 2's, fade step of the clip)
TOOLS_PATHS = {
    PATH_C: (dict(gop="RA", gop_size=16, tmvp=True, amvr=True, gpm=True,
                  ciip=True, bdof=True, dmvr=True), None),
    PATH_D: (dict(gop="LDP", gop_size=4, affine=True), None),
    PATH_E: (dict(gop="RA", gop_size=16, weighted_pred=True,
                  weighted_bipred=True, bdof=True, dmvr=True, gpm=True,
                  ciip=True), FADE_STEP),
}


def tools_stream(stream: str):
    """A tools path's sidecar, committed bytes, EncCfg (checked against the
    sidecar) and source clip (configuration 2's, faded where the path
    says)."""
    sd = json.load(open(os.path.join(DATA, stream + ".json")))
    committed = open(os.path.join(DATA, stream + ".bin"), "rb").read()
    fields, fade = TOOLS_PATHS[stream]
    cfg = EncCfg(width=832, height=480, qp=37, search_range=24, **fields)
    check_classic_sidecar(stream, sd, cfg, fade)
    clip = realistic_sequence(cfg.width, cfg.height, sd["frames"])
    if fade:
        clip = fade_sequence(clip, fade)
    return sd, committed, cfg, clip


def tools_runs(label: str, cfg: EncCfg, clip: list, path_launches: dict,
               record: dict, hold: bool) -> dict:
    """One plain encode (held to `record` with `hold`, its own stream
    decoded on the card), then one under the profiler (same bytes):
    seconds, frames per second and device operations per picture by kind
    (no stage-timer encode: the smoke's time limit is shared).  Returns the
    plain run."""
    run = encode_run(label, cfg, clip, "plain")
    path_launches[label] = run["launches"]
    check_run(run, (), record, hold=hold)
    traced = encode_run(label + " (traced)", cfg, clip, "trace",
                        sample=("P", "B"))
    if traced["data"] != run["data"]:
        fail(f"{label}: another encode gave other bytes")
    print_device_work(traced, run)
    return run


def weight_tables(data: bytes) -> list[tuple[int, str, bool, bool]]:
    """(POC, slice type, list-0 table, list-1 table) of every inter slice."""
    nals = bs.read_annexb(data)
    sps = SPS.read(bs.BitReader(nals[0].payload))
    out = []
    for n in nals:
        if n.nal_type == bs.NAL_TRAIL:
            h = SliceHeader.read(bs.BitReader(n.payload), sps)
            out.append((h.poc, h.slice_type.name, h.wp_params is not None,
                        h.wp_params_l1 is not None))
    return out


def tools_path(label: str, stream: str, path_launches: dict) -> None:
    """Phases 8h (path C) and 8j (path E): no float math on these paths,
    so the card's stream must be the committed JAX stream byte for byte,
    and both decode on the card with every MD5 OK."""
    sd, committed, cfg, clip = tools_stream(stream)
    run = tools_runs(label, cfg, clip, path_launches,
                     {p["poc"]: p for p in sd["pocs"]}, hold=False)
    if any(run["launches"][k] for k in SOURCES):
        fail(f"{label}: the classic path launched a kernel: "
             f"{run['launches']}")
    if cfg.weighted_pred or cfg.weighted_bipred:
        tables = weight_tables(run["data"])
        print(f"{label}: {sum(1 for t in tables if t[2] or t[3])} of "
              f"{len(tables)} inter slices carry weight tables (BDOF, DMVR, "
              f"GPM and CIIP off on those B slices): {tables}")
    if not compare_nals(label, run["data"], committed):
        fail(f"{label}: the card's stream differs from the JAX encoder's")
    decode_all_ok(label, stream, committed, sd["frames"],
                  run["data"])


def affine_parameters(data: bytes) -> list[tuple]:
    """(mvs, affine flags, dmv) of each affine P slice of a stream."""
    nals = bs.read_annexb(data)
    sps = SPS.read(bs.BitReader(nals[0].payload))
    s = sps.inter_block_size
    out = []
    for n in nals:
        if n.nal_type == bs.NAL_TRAIL:
            br = bs.BitReader(n.payload)
            SliceHeader.read(br, sps)
            out.append(decode_p_slice_affine(
                bytes(n.payload[br._pos // 8:]), sps.height // s,
                sps.width // s, s)[:3])
    return out


def affine_path(path_launches: dict, max_err: dict) -> dict:
    """Phase 8i, path D: configuration 2's clip, LDP, 9 frames, affine on.
    The search is float32 (einsum, batched solve), so the encode may
    differ from the JAX encoder's: byte for byte is the aim, else within
    0.1 dB and 2% of the sidecar with the IDR NAL equal; the blocks whose
    affine parameters differ are counted either way.  The decoder is
    integer only: the committed stream decodes with every MD5 OK.  K1 and
    K2 run on the affine grid (search: K1 three times a picture; final
    prediction: K1 once, K2 twice); their last launches there are held to
    the plain versions (tolerance 0).  Returns those launches' inputs."""
    sd, committed, cfg, clip = tools_stream(PATH_D)
    label = "path D 832x480 LDP affine"
    grid = (cfg.height // 4, cfg.width // 4, 2)
    kept, mc_kernel.CAPTURED = mc_kernel.CAPTURED, {}
    run = tools_runs(label, cfg, clip, path_launches,
                     {p["poc"]: p for p in sd["pocs"]}, hold=True)
    captured, mc_kernel.CAPTURED = mc_kernel.CAPTURED, kept
    shapes = run["launches"]["by_shape"]
    print(f"{label}: K1 launches by subblock grid "
          f"{shapes['mc_luma_positions']}, K2 "
          f"{shapes['mc_chroma_positions']} over "
          f"{sum(1 for r in run['rows'] if r['kind'] == 'P')} affine P "
          "pictures")
    key = f"{grid[0]}x{grid[1]}"
    if not shapes["mc_luma_positions"].get(key) or \
            not shapes["mc_chroma_positions"].get(key):
        fail(f"{label}: K1/K2 were not launched on the {key} affine grid")
    cases = {}
    for name in ("mc_luma_positions", "mc_chroma_positions"):
        c = captured.get((name, grid, None))
        if c is None:
            fail(f"{label}: no {name} launch on {grid} was captured")
        args = (c["ref_padded"], c["positions"], c["margin"],
                c["bit_depth"])
        err = int((getattr(mc_kernel, name)(*args)
                   - getattr(mc_kernel, name + "_plain")(*args)).abs().max())
        torch.cuda.synchronize()
        print(f"{name} on the affine grid {grid}: max |kernel - plain| = "
              f"{err} (tolerance 0)")
        max_err[name] = max(max_err[name], err)
        if err:
            fail(f"{name} differs from its plain version on the affine "
                 "grid")
        cases[name] = c
    same = compare_nals(label, run["data"], committed)
    ours, theirs = affine_parameters(run["data"]), \
        affine_parameters(committed)
    off = sum(int(((a[0] != b[0]).any(-1) | (a[1] != b[1])
                   | (a[2] != b[2]).any(-1)).sum())
              for a, b in zip(ours, theirs))
    print(f"{label}: affine blocks {[int(a[1].sum()) for a in ours]} by P "
          f"picture (JAX encoder {[int(b[1].sum()) for b in theirs]}); "
          f"blocks whose (mv, affine flag, dmv) differ from the JAX "
          f"encoder's: {off} of {sum(a[1].size for a in ours)}")
    if not same and not compare_nals(label, run["data"], committed,
                                     only=bs.NAL_IDR):
        fail(f"{label}: the IDR NAL differs from the JAX encoder's")
    decode_all_ok(label, PATH_D, committed, sd["frames"],
                  run["data"])
    return cases


def bench_configuration_1(path_launches: dict) -> None:
    """Phase 8g: `ai416x240_qp37_encode_fps` (bench.py:101-102), AI, 2
    frames, against the JAX encoder's stream byte for byte."""
    sd = json.load(open(os.path.join(DATA, CONFIG1 + ".json")))
    committed = open(os.path.join(DATA, CONFIG1 + ".bin"), "rb").read()
    cfg = EncCfg(width=416, height=240, qp=37, gop="AI")
    check_classic_sidecar(CONFIG1, sd, cfg)
    clip = realistic_sequence(cfg.width, cfg.height, sd["frames"])
    label = "config 1 416x240 AI"
    run = encode_run(label, cfg, clip, "plain")
    path_launches[label] = run["launches"]
    check_run(run, (), {p["poc"]: p for p in sd["pocs"]})
    if not compare_nals(label, run["data"], committed):
        fail(f"{label}: the card's stream differs from the JAX encoder's")


def preset_cfg(gop_size: int) -> EncCfg:
    """The headline configuration at 2048x1024 with the CTC-like preset."""
    cfg = headline_cfg(2048, 1024, 37, gop_size)
    for k, v in PRESET_TOOLS.items():
        setattr(cfg, k, v)
    return cfg


def preset_path(path_launches: dict) -> dict:
    """Phase 8k: the headline tools with make_bd_r05.py's CTC-like preset
    (TMVP, RDOQ, dependent quantization, MTS, LFNST) at 2048x1024.  TMVP
    is inert on multi-model pictures and dependent quantization shadows
    RDOQ, so the preset's new work is the I picture's: D1/D2 on every
    wavefront step.  5 frames at GOP 4 against the JAX encoder's sidecar
    (0.1 dB, 2%, the IDR NAL byte for byte: PRESET_I_DECISIONS_OFF), the
    port's stream decoded on the card (every MD5 OK), the committed stream
    decoded on the card (every MD5 OK: D2 in the decoder; every
    Y-PSNR within 0.1 dB); the 5-frame encode runs under the profiler.
    Then the headline's own 17 frames at GOP 16, untraced, with the I
    picture's seconds, device operations, D1/D2 launches and device time
    (its I picture is the 5-frame run's).  Returns D1/D2's captured
    launches."""
    sd = json.load(open(os.path.join(DATA, PRESET + ".json")))
    committed = open(os.path.join(DATA, PRESET + ".bin"), "rb").read()
    cfg = preset_cfg(4)
    if (sd["width"], sd["height"], sd["gop"], sd["gop_size"], sd["qt_depth"],
            sd["models"], sd["wrap_around"], sd["search_range"]) != \
            (cfg.width, cfg.height, cfg.gop, cfg.gop_size, cfg.qt_depth,
             "MPA+ROT", cfg.wrap_around, cfg.search_range) \
            or any(sd.get(k) is not True for k in PRESET_TOOLS):
        fail(f"{PRESET}: the sidecar names another configuration")
    clip = realistic_sequence(sd["width"], sd["height"], sd["frames"])
    label = "preset 2048x1024 GOP 4"
    need = ("mc_luma_positions", "mc_chroma_positions",
            "sad_block_positions", "mc_block_positions", "quantize_dep",
            "dequantize_dep")
    # traced: every picture's device operations and D1/D2's device time
    depquant_kernel.CAPTURED = {}
    run = encode_run(label, cfg, clip, "trace")
    dq_captured, depquant_kernel.CAPTURED = depquant_kernel.CAPTURED, None
    path_launches[label] = run["launches"]
    check_run(run, need, {p["poc"]: p for p in sd["pocs"]}, hold=True)
    same_idr = compare_nals(label, run["data"], committed, only=bs.NAL_IDR)
    print(f"{label}: I-picture decisions apart from the JAX encoder's "
          f"pinned at {PRESET_I_DECISIONS_OFF}; IDR NAL equal: {same_idr}")
    if not same_idr and PRESET_I_DECISIONS_OFF == 0:
        fail(f"{label}: the IDR NAL differs from the JAX encoder's")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = DecLib()
    frames = dec.decode_bytes(committed)
    torch.cuda.synchronize()
    print(f"{label}: committed {PRESET} decoded on the card in "
          f"{time.perf_counter() - t0:.2f} s (host clock), launches "
          f"{all_launches()}")
    if depquant_kernel.LAUNCHES["dequantize_dep"] == 0:
        fail(f"{label}: the decode did not launch dequantize_dep")
    hold_to_record(f"{label} committed", frames, dec.hash_status, sd, clip)
    # the headline's own sequence with the preset
    hlabel = "preset 2048x1024 GOP 16"
    hcfg = preset_cfg(HEADLINE_GOP)
    hclip = realistic_sequence(2048, 1024, HEADLINE_FRAMES)
    hrun = encode_run(hlabel, hcfg, hclip, "plain")
    path_launches[hlabel] = hrun["launches"]
    check_run(hrun, need)
    # both sequences open with the same I picture (POC 0, QP 34, the same
    # tools): its device work is the 5-frame traced run's
    i_plain = next(r for r in hrun["rows"] if r["kind"] == "I")
    i_traced = next(r for r in run["rows"] if r["kind"] == "I")
    if i_traced["bits"] != i_plain["bits"]:
        fail(f"{hlabel}: the I picture differs from the 5-frame run's")
    for r in run["rows"]:
        print(f"{label} POC {r['poc']} ({r['kind']}) traced: "
              f"{r['device_work'][0]} device operations, "
              f"{r['device_work'][1]:.4f} s of device time")
    print(f"{hlabel}: {hrun['seconds']:.2f} s for {HEADLINE_FRAMES} "
          "pictures (host clock)")
    intra_picture_work(hlabel, hrun, run)
    return dq_captured


def intra_tools_path(path_launches: dict) -> None:
    """Phase 8l: bench configuration 1 (AI, 416x240, 2 frames) with
    dependent quantization, MTS, LFNST, transform skip and BDPCM, and the
    same lossless; RDOQ (unshadowed) with transform skip and BDPCM at
    192x96: each byte for byte against its committed JAX stream, both
    streams decoded on the card with every MD5 OK; the lossless
    reconstructions and decodes equal their source."""
    for stream, size, fields in (
            (CONFIG1_TOOLS, (416, 240), dict(dep_quant=True, mts=True,
                                             lfnst=True, transform_skip=True,
                                             bdpcm=True)),
            (CONFIG1_LOSSLESS, (416, 240), dict(lossless=True)),
            (RDOQ_TS, (192, 96), dict(rdoq=True, transform_skip=True,
                                      bdpcm=True))):
        sd = json.load(open(os.path.join(DATA, stream + ".json")))
        committed = open(os.path.join(DATA, stream + ".bin"), "rb").read()
        cfg = EncCfg(width=size[0], height=size[1], qp=37, gop="AI",
                     **fields)
        check_classic_sidecar(stream, sd, cfg)
        clip = realistic_sequence(cfg.width, cfg.height, sd["frames"])
        label = f"AI {size[0]}x{size[1]} {'+'.join(fields)}"
        run = encode_run(label, cfg, clip, "plain")
        path_launches[label] = run["launches"]
        if cfg.lossless:
            lossless_run(run, clip)
        else:
            check_run(run, ("quantize_dep", "dequantize_dep")
                      if cfg.dep_quant else (),
                      {p["poc"]: p for p in sd["pocs"]})
        if not compare_nals(label, run["data"], committed):
            fail(f"{label}: the card's stream differs from the JAX "
                 "encoder's")
        decode_all_ok(label, stream, committed, sd["frames"],
                      run["data"])


def lossless_run(run: dict, clip: list) -> None:
    """A lossless run: every picture's reconstruction equals its source
    (the PSNR of equal planes, 999.99 dB), and the stream decodes on the
    card with every MD5 OK to the source itself."""
    label, n = run["label"], run["frames"]
    for r in run["rows"]:
        print(f"{label} POC {r['poc']} ({r['kind']}): {r['bits']} bits, "
              f"PSNR Y/U/V {r['psnr']}, {r['seconds']:.2f} s (host clock), "
              f"launches {r['launches']}")
        if min(r["psnr"]) < 999.99:    # utils.content.psnr of equal planes
            fail(f"{label} POC {r['poc']}: not lossless, PSNR {r['psnr']}")
    print(f"{label}: {n} pictures, {len(run['data'])} bytes in "
          f"{run['seconds']:.2f} s (host clock)")
    dec = DecLib()
    frames = dec.decode_bytes(run["data"])
    torch.cuda.synchronize()
    ok = sum(1 for v in dec.hash_status.values() if v == "OK")
    print(f"{label}: own stream decoded on the card, {ok} of {n} MD5 OK")
    if ok != n or [f.poc for f in frames] != list(range(n)):
        fail(f"{label}: hash {dec.hash_status}")
    for f in frames:
        if any(not np.array_equal(p, s) for p, s in
               zip(f.numpy(), clip[f.poc])):
            fail(f"{label} POC {f.poc}: the decode differs from the source")


def scaling_path(path_launches: dict) -> None:
    """Phase 8m: configuration 2's size and clip, LDP, 9 frames, the steep
    scaling list on the P pictures (one reference at POC 1, two after),
    byte for byte against the committed JAX stream; both decoded on the
    card with every MD5 OK.  The classic path launches no kernel."""
    sd = json.load(open(os.path.join(DATA, SCALING + ".json")))
    committed = open(os.path.join(DATA, SCALING + ".bin"), "rb").read()
    cfg = EncCfg(width=832, height=480, qp=37, gop="LDP", gop_size=4,
                 search_range=24, scaling_list=STEEP)
    check_classic_sidecar(SCALING, sd, cfg)
    if tuple(sd.get("scaling_list", ())) != STEEP:
        fail(f"{SCALING}: the sidecar names another scaling list")
    clip = realistic_sequence(cfg.width, cfg.height, sd["frames"])
    label = "config 2 clip 832x480 LDP scaling list"
    run = encode_run(label, cfg, clip, "plain")
    path_launches[label] = run["launches"]
    check_run(run, (), {p["poc"]: p for p in sd["pocs"]})
    if any(run["launches"][k] for k in SOURCES):
        fail(f"{label}: the classic path launched a kernel: "
             f"{run['launches']}")
    if not compare_nals(label, run["data"], committed):
        fail(f"{label}: the card's stream differs from the JAX encoder's")
    decode_all_ok(label, SCALING, committed, sd["frames"],
                  run["data"])


def intra_pred_path(path_launches: dict) -> None:
    """Phase 8n: the I picture's prediction tools.  Bench configuration 1
    with CCLM, MIP, MRL, IBC and dependent quantization, byte for byte
    against the committed JAX stream, both decoded on the card with every
    MD5 OK, D1/D2 launched; then one 2048x1024 I picture of the CTC-like
    preset with the four tools, its IDR NAL against the JAX sidecar's
    SHA-256.  At both sizes the I picture's seconds (untraced), device
    operations and idle share (a second encode under the profiler)."""
    sd = json.load(open(os.path.join(DATA, CONFIG1_PRED + ".json")))
    committed = open(os.path.join(DATA, CONFIG1_PRED + ".bin"), "rb").read()
    cfg = EncCfg(width=416, height=240, qp=37, gop="AI", dep_quant=True,
                 **PRED_TOOLS)
    check_classic_sidecar(CONFIG1_PRED, sd, cfg)
    clip = realistic_sequence(cfg.width, cfg.height, sd["frames"])
    label = "AI 416x240 CCLM+MIP+MRL+IBC+DQ"
    run = encode_run(label, cfg, clip, "plain")
    path_launches[label] = run["launches"]
    check_run(run, ("quantize_dep", "dequantize_dep"),
              {p["poc"]: p for p in sd["pocs"]})
    if not compare_nals(label, run["data"], committed):
        fail(f"{label}: the card's stream differs from the JAX encoder's")
    decode_all_ok(label, CONFIG1_PRED, committed, sd["frames"],
                  run["data"])
    print(f"{label}: blocks that chose each tool (the JAX stream's "
          f"sidecar) {sd['intra_tool_blocks']}")
    traced = encode_run(label + " (traced)", cfg, clip[:1], "trace")
    intra_picture_work(label, run, traced)
    side = json.load(open(os.path.join(DATA, PRESET_I_PRED + ".json")))
    pcfg = preset_cfg(4)
    for k, v in PRED_TOOLS.items():
        setattr(pcfg, k, v)
    if (side["width"], side["height"], side["frames"], side["models"]) != \
            (pcfg.width, pcfg.height, 1, "MPA+ROT") \
            or any(side.get(k) is not True for k in
                   list(PRESET_TOOLS) + list(PRED_TOOLS)):
        fail(f"{PRESET_I_PRED}: the sidecar names another configuration")
    plabel = "preset 2048x1024 I + CCLM+MIP+MRL+IBC"
    pclip = realistic_sequence(2048, 1024, 1)
    prun = encode_run(plabel, pcfg, pclip, "plain")
    path_launches[plabel] = prun["launches"]
    check_run(prun, ("quantize_dep", "dequantize_dep"),
              {p["poc"]: p for p in side["pocs"]}, hold=True)
    idr = [n for n in bs.read_annexb(prun["data"]) if n.nal_type == bs.NAL_IDR]
    sha = hashlib.sha256(idr[0].payload).hexdigest()
    same = sha == side["idr_sha256"]
    print(f"{plabel}: IDR NAL SHA-256 {sha}, the JAX encoder's "
          f"{side['idr_sha256']}: {'equal' if same else 'DIFFERENT'}")
    if not same:
        fail(f"{plabel}: the IDR NAL differs from the JAX encoder's")
    traced = encode_run(plabel + " (traced)", pcfg, pclip, "trace")
    if traced["data"] != prun["data"]:
        fail(f"{plabel}: the traced encode gave other bytes")
    intra_picture_work(plabel, prun, traced)


def partition_cfg(stream: str, sd: dict) -> EncCfg:
    """The EncCfg of a committed partitioning stream, from its sidecar
    (tests/make_torch_port_streams.py: every other field at its
    default)."""
    if sd["models"] != "CLASSIC" or sd["wrap_around"]:
        fail(f"{stream}: the sidecar names another configuration")
    if sd["gop"] == "AI":
        return EncCfg(width=sd["width"], height=sd["height"], qp=sd["qp"],
                      gop="AI", intra_split=sd["intra_split"])
    return EncCfg(width=sd["width"], height=sd["height"], qp=sd["qp"],
                  gop=sd["gop"], gop_size=sd["gop_size"],
                  search_range=sd["search_range"], merge=sd["merge"],
                  inter_block_size=sd["inter_block_size"],
                  qt_depth=sd["qt_depth"], mtt=sd["mtt"])


def no_kernel(label: str, launches: dict) -> None:
    """The partitioning paths run plain torch operations: no kernel."""
    n = {k: v for k, v in launches.items()
         if isinstance(v, int) and v}
    print(f"{label}: kernel launches {n or 0}")
    if n:
        fail(f"{label}: the partitioning path launched {n}")


def partition_path(label: str, stream: str, path_launches: dict) -> None:
    """Phases 8o-8q: a committed partitioning stream encoded on the card
    byte for byte, both streams decoded on the card with every MD5 OK,
    seconds per picture kind, a traced encode's device operations and
    idle share (the first picture of each kind) and the phase's wall
    seconds."""
    t0 = time.perf_counter()
    sd = json.load(open(os.path.join(DATA, stream + ".json")))
    committed = open(os.path.join(DATA, stream + ".bin"), "rb").read()
    cfg = partition_cfg(stream, sd)
    clip = realistic_sequence(cfg.width, cfg.height, sd["frames"])
    run = encode_run(label, cfg, clip, "plain")
    path_launches[label] = run["launches"]
    check_run(run, (), {p["poc"]: p for p in sd["pocs"]})
    no_kernel(label, run["launches"])
    hold_bytes(label, run["data"], committed, stream)
    decode_all_ok(label, stream, committed, sd["frames"],
                  run["data"])
    picture_seconds(label, run)
    # an AI sequence's first picture is its only sampled kind
    tclip = clip[:1] if cfg.gop == "AI" else clip
    traced = encode_run(label + " (traced)", cfg, tclip, "trace",
                        sample=("I", "P", "B"))
    expect = run["data"]
    if tclip is not clip:        # one picture: the stream's first pictures
        expect = expect[:len(traced["data"])]
    if traced["data"] != expect:
        fail(f"{label}: the traced encode gave other bytes")
    print_device_work(traced, run)
    print(f"{label}: phase {time.perf_counter() - t0:.1f} s (host clock)")


def intra_split_picture(path_launches: dict) -> None:
    """Phase 8q's second half: one 2048x1024 I picture of the headline
    configuration with the two-level intra partitioning, its IDR NAL
    against the JAX sidecar's SHA-256, its seconds."""
    t0 = time.perf_counter()
    side = json.load(open(os.path.join(DATA, PART_INTRA_BIG + ".json")))
    cfg = headline_cfg(2048, 1024, 37, 4)
    cfg.intra_split = True
    if (side["width"], side["height"], side["frames"], side["models"],
            side["qt_depth"], side.get("intra_split")) != (
                cfg.width, cfg.height, 1, "MPA+ROT", cfg.qt_depth, True):
        fail(f"{PART_INTRA_BIG}: the sidecar names another configuration")
    label = "intra split 2048x1024 I"
    clip = realistic_sequence(2048, 1024, 1)
    run = encode_run(label, cfg, clip, "plain")
    path_launches[label] = run["launches"]
    check_run(run, (), {p["poc"]: p for p in side["pocs"]}, hold=True)
    idr = [n for n in bs.read_annexb(run["data"]) if n.nal_type == bs.NAL_IDR]
    sha = hashlib.sha256(idr[0].payload).hexdigest()
    same = sha == side["idr_sha256"]
    print(f"{label}: IDR NAL SHA-256 {sha}, the JAX encoder's "
          f"{side['idr_sha256']}: {'equal' if same else 'DIFFERENT'}")
    if not same:
        fail(f"{label}: the IDR NAL differs from the JAX encoder's")
    # no traced encode here: 8q's 416x240 one traces the same path (the
    # smoke's time limit)
    print(f"{label}: I picture {run['rows'][0]['seconds']:.3f} s (host "
          f"clock); phase {time.perf_counter() - t0:.1f} s (host clock)")


def intra_picture_work(label: str, plain: dict, traced: dict) -> None:
    """An I picture: its seconds (host clock) in the untraced run, its
    device operations, device time and D1/D2 device time in the traced
    one, D1/D2 launches, and the card's idle share."""
    p = next(r for r in plain["rows"] if r["kind"] == "I")
    t = next(r for r in traced["rows"] if r["kind"] == "I")
    n_ops, busy = t["device_work"]
    # a kernel that ran but that the profile caught no event of is "not
    # measured", never 0 ms
    d1, d2 = ("not measured" if s <= 0 else f"{1e3 * s:.2f} ms"
              for s in t["dq_device_s"])
    print(f"{label}: I picture {p['seconds']:.3f} s (host clock), "
          f"{n_ops} device operations, {busy:.4f} s of device time, D1 "
          f"{p['launches']['quantize_dep']} launches ({d1} of device "
          f"time), D2 {p['launches']['dequantize_dep']} launches ({d2}); "
          f"the card idle {100 * (1 - busy / p['seconds']):.1f}% of the I "
          "picture")


def bench_configuration_5(path_launches: dict) -> None:
    """Phase 8d: `erp6144x3072_ldp_qp37_encode_fps` (bench.py:121-123), 3
    frames: POC 1 takes one reference, POC 2 two; held to the JAX
    encoder's sidecar (its stream's SHA-256; per picture the slice NAL's
    SHA-256, bits and Y-PSNR)."""
    cfg = EncCfg(width=6144, height=3072, qp=37, gop="LDP",
                 search_range=24, wrap_around=True)
    side = json.load(open(os.path.join(DATA, CONFIG5 + ".json")))
    if (side["width"], side["height"], side["qp"], side["gop"],
            side["search_range"], side["wrap_around"], side["frames"]) != (
                cfg.width, cfg.height, cfg.qp, cfg.gop, cfg.search_range,
                cfg.wrap_around, 3):
        fail(f"{CONFIG5}: the sidecar names another configuration")
    clip = realistic_sequence(cfg.width, cfg.height, 3)
    label = "config 5 6144x3072 LDP"
    torch.cuda.reset_peak_memory_stats()
    run = encode_run(label, cfg, clip, "plain")
    peak = torch.cuda.max_memory_allocated()
    path_launches[label] = run["launches"]
    check_run(run, ())
    rows = {r["poc"]: r for r in run["rows"]}
    slices = [n for n in bs.read_annexb(run["data"])
              if n.nal_type in (bs.NAL_IDR, bs.NAL_TRAIL)]
    for n, p in zip(slices, side["pocs"]):
        same = hashlib.sha256(n.payload).hexdigest() == p["slice_sha256"]
        r = rows[p["poc"]]
        print(f"{label} POC {p['poc']}: slice NAL "
              f"{'equal to' if same else 'DIFFERENT from'} the JAX "
              f"encoder's; {r['bits']} bits ({p['bits']}), Y-PSNR "
              f"{r['psnr'][0]:.4f} dB ({p['psnr_y']:.4f})")
    sha = hashlib.sha256(run["data"]).hexdigest()
    print(f"{label}: SHA-256 {sha}, the JAX encoder's {side['sha256']} "
          f"({side['bytes']} bytes): "
          f"{'equal' if sha == side['sha256'] else 'DIFFERENT'}")
    if sha != side["sha256"]:
        fail(f"{label}: the card's stream differs from the JAX encoder's")
    print(f"{label}: device memory peak of the encode "
          f"{peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated)")
    nals = bs.read_annexb(run["data"])
    sps = SPS.read(bs.BitReader(nals[0].payload))
    refs = {h.poc: h.ref_pocs_l0 for h in (
        SliceHeader.read(bs.BitReader(n.payload), sps) for n in nals
        if n.nal_type == bs.NAL_TRAIL)}
    print(f"{label}: reference lists {refs}")
    if refs != {1: [0], 2: [1, 0]}:
        fail(f"{label}: POC 2 is not a two-reference P picture")


def tool_sidecar(stream: str, cfg: EncCfg) -> dict:
    """The sidecar of a sequence-tool stream
    (tests/make_torch_port_streams.py TOOL_STREAMS), checked to name
    `cfg`."""
    sd = json.load(open(os.path.join(DATA, stream + ".json")))
    keys = ("width", "height", "qp", "gop", "gop_size", "search_range",
            "tmvp", "wpp", "num_substreams", "lmcs", "film_grain")
    if any(sd.get(k, getattr(EncCfg, k)) != getattr(cfg, k) for k in keys) \
            or tuple(sd["mcts_tiles"]) != tuple(cfg.mcts_tiles):
        fail(f"{stream}: the sidecar names another configuration")
    return sd


def md5_of(planes, bit_depth: int = 8) -> str:
    """The decoded-picture-hash MD5 of a picture's host planes."""
    m = hashlib.md5()
    for p in planes:
        m.update(np.asarray(p).astype("<u2" if bit_depth > 8
                                      else np.uint8).tobytes())
    return m.hexdigest()


def grain_record(params) -> dict | None:
    """FilmGrainParams as its sidecar records them."""
    return None if params is None else json.loads(json.dumps(
        dataclasses.asdict(params)))


def decode_tool_stream(label: str, stream: str, data: bytes | None = None):
    """A committed sequence-tool stream (or `data`, other bytes of it)
    decoded on the card: every MD5 verdict and every picture the JAX
    decoder's (its sidecar).  Returns the DecLib."""
    sd = json.load(open(os.path.join(DATA, stream + ".json")))
    bd = sd.get("bit_depth", 8)
    if data is None:
        data = open(os.path.join(DATA, stream + ".bin"), "rb").read()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = DecLib()
    frames = dec.decode_bytes(data)
    torch.cuda.synchronize()
    verdicts = {str(k): v for k, v in sorted(dec.hash_status.items())}
    same = [f.md5(bd) for f in frames] == sd["jax_decoder_frame_md5"]
    print(f"{label}: {len(frames)} pictures decoded on the card in "
          f"{time.perf_counter() - t0:.2f} s (host clock), hash {verdicts}, "
          f"pictures equal to the JAX decoder's: {same}")
    if verdicts != sd["jax_decoder_md5"] or not same \
            or any(v != "OK" for v in verdicts.values()):
        fail(f"{label}: the decode differs from the JAX decoder's")
    return dec


def picture_seconds(label: str, run: dict) -> None:
    """Seconds a picture by kind (host clock, untraced)."""
    for kind in sorted({r["kind"] for r in run["rows"]}):
        per = [r["seconds"] for r in run["rows"] if r["kind"] == kind]
        print(f"{label}: {kind} pictures {min(per):.3f}-{max(per):.3f} s, "
              f"median {statistics.median(per):.3f} s over {len(per)} "
              "(host clock)")


def kernel_launches(label: str, run: dict) -> None:
    """The run's kernel launches, printed whatever they are."""
    n = {k: v for k, v in run["launches"].items() if isinstance(v, int)
         and v}
    print(f"{label}: kernel launches {n or 0}")


def sequence_tools_path(path_launches: dict) -> None:
    """Phase 8r: WPP (the I, P and B substream writers, the P merge
    selection's HMVP resets under TMVP), LMCS and the film grain SEI on
    configuration 2's clip, against the JAX encoder's stream and its
    decoder's display-domain pictures and grain parameters."""
    t0 = time.perf_counter()
    cfg = EncCfg(width=832, height=480, qp=37, gop="RA", gop_size=4,
                 search_range=24, tmvp=True, wpp=True, num_substreams=4,
                 lmcs=True, film_grain=True)
    sd = tool_sidecar(TOOLS_8R, cfg)
    committed = open(os.path.join(DATA, TOOLS_8R + ".bin"), "rb").read()
    label = "WPP+LMCS+film grain 832x480 GOP 4"
    clip = realistic_sequence(cfg.width, cfg.height, sd["frames"])
    run = encode_run(label, cfg, clip, "plain")
    path_launches[label] = run["launches"]
    check_run(run, (), {p["poc"]: p for p in sd["pocs"]})
    hold_bytes(label, run["data"], committed, TOOLS_8R)
    enc = run["enc"]
    # the rows' Y-PSNRs above are the mapped domain's; the results' are
    # re-scored on the display domain against the true source
    shown_psnr = [(r.psnr_y, p["psnr_y"]) for r, p in zip(enc.results,
                                                          sd["pocs"])]
    print(f"{label}: display-domain Y-PSNR by POC " + ", ".join(
        f"{a:.4f} ({b:.4f})" for a, b in shown_psnr) + " dB (JAX encoder)")
    if any(abs(a - b) > 1e-3 for a, b in shown_psnr):
        fail(f"{label}: display-domain Y-PSNR differs from the JAX "
             "encoder's")
    outs = [md5_of(r.output) for r in enc.results]
    if outs != sd["encoder_output_md5"] or \
            grain_record(enc.film_grain_params) != sd["film_grain_params"]:
        fail(f"{label}: the encoder's display-domain pictures or grain "
             "parameters differ from the JAX encoder's")
    dec = decode_tool_stream(f"{label} committed {TOOLS_8R}", TOOLS_8R,
                             committed)
    shown = [f.md5() for f in dec.output_frames()]
    params = grain_record(dec.film_grain)
    t1 = time.perf_counter()
    grain = film_grain.apply_grain(dec.frames[0].planes, dec.film_grain, 0)
    grain_s = time.perf_counter() - t1
    print(f"{label}: LMCS codewords {list(dec.sps.lmcs_cw)}, display-domain "
          f"pictures equal to the JAX decoder's: {shown == sd['output_md5']}"
          f"; film grain {params}, equal: "
          f"{params == sd['film_grain_params']}; grain on POC 0 "
          f"({grain_s:.3f} s, host) equal: "
          f"{md5_of(grain) == sd['grain_poc0_md5']}")
    if list(dec.sps.lmcs_cw) != sd["lmcs_cw"] or shown != sd["output_md5"] \
            or params != sd["film_grain_params"] \
            or md5_of(grain) != sd["grain_poc0_md5"]:
        fail(f"{label}: LMCS output or film grain differ from the JAX "
             "decoder's")
    picture_seconds(label, run)
    kernel_launches(label, run)
    print(f"{label}: phase {time.perf_counter() - t0:.1f} s (host clock)")


def drop_first_trail(data: bytes) -> bytes:
    """The stream without its first TRAIL slice NAL (POC 1 of an LDP
    stream; tests/test_apps.py:98)."""
    nalus = bs.read_annexb(data)
    first = next(i for i, n in enumerate(nalus)
                 if n.nal_type == bs.NAL_TRAIL)
    return bs.write_annexb([n for i, n in enumerate(nalus) if i != first])


def mcts_path(path_launches: dict) -> None:
    """Phase 8s: MCTS on configuration 2's clip against the JAX encoder's
    stream, then the decode with POC 1's slice NAL lost against the JAX
    decoder's."""
    t0 = time.perf_counter()
    cfg = EncCfg(width=832, height=480, qp=37, gop="LDP", search_range=24,
                 mcts_tiles=(2, 2))
    sd = tool_sidecar(MCTS_8S, cfg)
    committed = open(os.path.join(DATA, MCTS_8S + ".bin"), "rb").read()
    label = "MCTS 832x480 LDP"
    clip = realistic_sequence(cfg.width, cfg.height, sd["frames"])
    run = encode_run(label, cfg, clip, "plain")
    path_launches[label] = run["launches"]
    check_run(run, (), {p["poc"]: p for p in sd["pocs"]})
    hold_bytes(label, run["data"], committed, MCTS_8S)
    dec = decode_tool_stream(f"{label} committed {MCTS_8S}", MCTS_8S,
                             committed)
    print(f"{label}: MCTS SEI tile grid {dec.mcts_tiles}")
    if dec.mcts_tiles != tuple(sd["jax_decoder_mcts_tiles"]):
        fail(f"{label}: the MCTS SEI reads {dec.mcts_tiles}")
    rec = sd["concealed"]
    lost = DecLib()
    t1 = time.perf_counter()
    frames = lost.decode_bytes(drop_first_trail(committed))
    torch.cuda.synchronize()
    got = dict(concealed=lost.concealed, pocs=[f.poc for f in frames],
               md5=[f.md5() for f in frames], hash_status={
                   str(k): v for k, v in sorted(lost.hash_status.items())})
    print(f"{label}: POC 1's slice NAL dropped: decoded in "
          f"{time.perf_counter() - t1:.2f} s (host clock), concealed "
          f"{got['concealed']}, POCs {got['pocs']}, hash "
          f"{got['hash_status']}; equal to the JAX decoder's: {got == rec}")
    if got != rec or got["concealed"] != [1]:
        fail(f"{label}: the concealed decode differs from the JAX "
             f"decoder's {rec}")
    picture_seconds(label, run)
    kernel_launches(label, run)
    print(f"{label}: phase {time.perf_counter() - t0:.1f} s (host clock)")


RC_MCTF_8T = "erp2048x1024_ra_mm_rc_mctf_5f"
FISHEYE_8U = "fish1088x1088_ra_mm_qp37_5f"
# the other models on a 128x128 Equisolid (3DT, TAN, GED, GEDA): decoded in
# phase 8u
FISHEYE_MODELS = "fish128x128_ra_t3d_tan_ged_qp37_5f"
METRICS_TOL_DB = 1e-3
# the main path's kernels on a multi-model sequence at 512 rows or more
MM_BLOCK_KERNELS = ("mc_luma_positions", "mc_chroma_positions",
                    "sad_block_positions", "mc_block_positions")


def lib360_stream(stream: str):
    """A committed stream of items 11f/11g: its sidecar, bytes, the
    port's EncCfg made from the sidecar's fields and the source clip."""
    sd = json.load(open(os.path.join(DATA, stream + ".json")))
    committed = open(os.path.join(DATA, stream + ".bin"), "rb").read()
    mm = dict(sd["mm"])
    mm["projection"] = ProjectionID[mm["projection"]]
    fields = {f.name: sd[f.name] for f in dataclasses.fields(EncCfg)
              if f.name in sd and f.name not in ("mm", "frames")}
    cfg = EncCfg(mm=MMConfig(**mm), **fields)
    clip = realistic_sequence(cfg.width, cfg.height, sd["frames"])
    return sd, committed, cfg, clip


def lib360_run(label: str, stream: str, need: tuple,
               path_launches: dict) -> tuple[dict, dict]:
    """The port's encode of a lib360 stream's source on the card, held to
    the committed JAX stream byte for byte and decoded on the card with
    every MD5 OK (check_run; the committed stream is the same bytes, so
    its decode is not repeated)."""
    sd, committed, cfg, clip = lib360_stream(stream)
    run = encode_run(label, cfg, clip, "plain")
    path_launches[label] = run["launches"]
    check_run(run, need, {p["poc"]: p for p in sd["pocs"]})
    hold_bytes(label, run["data"], committed, stream)
    md5_verdicts(f"{label} JAX decoder (sidecar)",
                 {int(k): v for k, v in sd["jax_decoder_md5"].items()}, sd)
    picture_seconds(label, run)
    print(f"{label}: {run['seconds'] / run['frames']:.3f} s a picture "
          "(host clock)")
    return run, sd


def slice_qps(data: bytes, sps: SPS) -> dict:
    """POC -> slice QP of an Annex-B stream."""
    out = {}
    for n in bs.read_annexb(data):
        if n.nal_type in (bs.NAL_IDR, bs.NAL_TRAIL):
            sh = SliceHeader.read(bs.BitReader(n.payload), sps)
            out[sh.poc] = sh.qp
    return out


def rc_mctf_path(path_launches: dict) -> None:
    """Phase 8t: MCTF, rate control and the 360 metrics on the headline
    tools at 2048x1024, then geo_convert on the card against the CPU.
    Besides the stream, the tools are held on their own: the filtered
    source pictures to the JAX prefilter's MD5s, the QPs to the rate
    control's picks from the JAX encoder's bits, the metrics to the JAX
    encoder's within 1e-3 dB."""
    t0 = time.perf_counter()
    label = "MCTF+RC+360 metrics 2048x1024 GOP 4"
    run, sd = lib360_run(label, RC_MCTF_8T, MM_BLOCK_KERNELS + (
        "sphere_positions", "sphere_centers"), path_launches)
    enc = run["enc"]
    _, _, cfg, clip = lib360_stream(RC_MCTF_8T)
    t1 = time.perf_counter()
    filtered = prefilter_sequence(clip, cfg.qp, cfg.bit_depth,
                                  period=cfg.gop_size)
    torch.cuda.synchronize()
    got = {str(p): md5_of(filtered[int(p)]) for p in sd["mctf_md5"]}
    print(f"{label}: MCTF on the card {time.perf_counter() - t1:.2f} s "
          f"(host clock), filtered pictures {sorted(got)} equal to the JAX "
          f"prefilter's: {got == sd['mctf_md5']}")
    if got != sd["mctf_md5"]:
        fail(f"{label}: the MCTF-filtered pictures differ from the JAX "
             "prefilter's")
    rc = RateControl(cfg.target_bitrate_kbps * 1000.0, cfg.frame_rate,
                     cfg.width, cfg.height)
    want_qp = {}
    for poc, tid, kind in [(0, 0, "I")] + [
            (p, t, "P" if b < 0 else "B")
            for p, _, b, t in EncLib.ra_coding_order(sd["frames"], 4)]:
        want_qp[poc] = rc.pick_qp(kind, tid)
        rc.update(next(q["bits"] for q in sd["pocs"] if q["poc"] == poc))
    qps = slice_qps(run["data"], enc.sps)
    print(f"{label}: slice QPs by POC {dict(sorted(qps.items()))}, the rate "
          f"control's picks from the JAX encoder's bits "
          f"{dict(sorted(want_qp.items()))}")
    if qps != want_qp:
        fail(f"{label}: a QP differs from the rate control's pick")
    res = sorted(enc.results, key=lambda r: r.poc)
    worst = max(abs(r.metrics_360[k] - p["metrics_360"][k])
                for r, p in zip(res, sd["pocs"]) for k in p["metrics_360"])
    for r in res:
        print(f"{label} POC {r.poc}: " + ", ".join(
            f"{k} {v:.6f}" for k, v in r.metrics_360.items()) + " dB")
    summ = enc.summary()
    print(f"{label}: 360 metrics within {worst:.2e} dB of the JAX "
          f"encoder's (limit {METRICS_TOL_DB}); averages WS-PSNR "
          f"{summ['ws_psnr']:.6f}, S-PSNR-NN {summ['s_psnr_nn']:.6f}, "
          f"CPP-PSNR {summ['cpp_psnr']:.6f} dB")
    if not worst <= METRICS_TOL_DB or any(
            abs(summ[k] - sd["summary"][k]) > METRICS_TOL_DB
            for k in ("ws_psnr", "s_psnr_nn", "cpp_psnr")):
        fail(f"{label}: a 360 metric differs from the JAX encoder's by "
             f"more than {METRICS_TOL_DB} dB")
    src = clip[0][0]
    for dst, size in (("cmp", (1024, 1536)), ("fisheye", (1024, 1024))):
        t1 = time.perf_counter()
        card = geometry.geo_convert(src, "erp", dst, size, "lanczos3",
                                    device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host = geometry.geo_convert(src, "erp", dst, size, "lanczos3",
                                    device="cpu")
        t3 = time.perf_counter()
        off = int((card != host).sum())
        print(f"{label}: geo_convert erp -> {dst} {size[1]}x{size[0]} "
              f"lanczos3: card {t2 - t1:.2f} s, CPU {t3 - t2:.2f} s (host "
              f"clock, first call), {off} samples differ")
        if off or card.shape != size:
            fail(f"{label}: geo_convert to {dst} differs between the card "
                 "and the CPU")
    kernel_launches(label, run)
    print(f"{label}: phase {time.perf_counter() - t0:.1f} s (host clock)")


def equisolid_path(path_launches: dict) -> None:
    """Phase 8u: multi-model coding of Equisolid content; every position
    through the float32 chain (L1's elementwise entry points)."""
    t0 = time.perf_counter()
    label = "Equisolid 1088x1088 GOP 4"
    run, _ = lib360_run(label, FISHEYE_8U, MM_BLOCK_KERNELS + ("libm_f32",),
                        path_launches)
    n = run["launches"]
    if n["sphere_positions"] or n["sphere_centers"]:
        fail(f"{label}: the sphere kernel launched on Equisolid content")
    kernel_launches(label, run)
    sd = json.load(open(os.path.join(DATA, FISHEYE_MODELS + ".json")))
    dec = DecLib()
    reset_launches()
    dec.decode_bytes(open(os.path.join(DATA, FISHEYE_MODELS + ".bin"),
                          "rb").read())
    md5_verdicts(f"decode {FISHEYE_MODELS}", dec.hash_status, sd)
    n = launch_counts()
    print(f"decode {FISHEYE_MODELS}: launches {all_launches()}")
    if not n["libm_f32"]:
        fail(f"decode {FISHEYE_MODELS}: L1's elementwise entries not "
             "launched")
    path_launches[f"decode {FISHEYE_MODELS}"] = n
    print(f"{label}: phase {time.perf_counter() - t0:.1f} s (host clock)")


def app_run(main, args: list[str]) -> list[str]:
    """An app's main(args) on the card: its standard output lines (also
    printed, at most 12), failing the run on a non-zero return."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    lines = buf.getvalue().splitlines()
    for line in lines[:12]:
        print(f"  | {line}")
    if rc != 0:
        fail(f"{main.__module__} returned {rc}")
    return lines


def write_yuv(path: str, frames: list) -> None:
    from vvc_mm_tpu_torch.common.typedefs import ChromaFormat
    from vvc_mm_tpu_torch.utils.yuv_io import VideoFormat, YuvWriter
    h, w = frames[0][0].shape
    with YuvWriter(path, VideoFormat(w, h, 8, ChromaFormat.C420)) as wr:
        for f in frames:
            wr.write_frame(f)


def apps_path(path_launches: dict) -> None:
    """Phase 8v: encoder_app, decoder_app (--CacheModel, --TraceFile,
    --BitStats) and parcat through their main() on the card."""
    from vvc_mm_tpu_torch.apps import decoder_app, encoder_app, parcat
    t0 = time.perf_counter()
    out = os.path.join(ROOT, "smoke_out", "apps")
    os.makedirs(out, exist_ok=True)
    f = {k: os.path.join(out, v) for k, v in dict(
        src="src2048x1024.yuv", bin="app2048x1024.bin",
        rec="rec2048x1024.yuv", dec="dec2048x1024.yuv",
        trace="trace2048x1024.txt").items()}
    sd = json.load(open(os.path.join(DATA, BIG + ".json")))
    write_yuv(f["src"], realistic_sequence(2048, 1024, sd["frames"]))
    label = "encoder app 2048x1024"
    reset_launches()
    t1 = time.perf_counter()
    app_run(encoder_app.main, [
        "-i", f["src"], "-b", f["bin"], "-o", f["rec"], "-wdt", "2048",
        "-hgt", "1024", "-f", str(sd["frames"]), "-q", "37", "--GOP=RA",
        "--GOPSize=4", "--QTDepth=1", "--MPA", "--ROT", "--WrapAround",
        "--SearchRange=24", "--IntraPeriod=32"])
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t1
    path_launches[label] = launch_counts()
    print(f"{label}: {enc_s:.2f} s (host clock), launches {all_launches()}")
    hold_bytes(label, open(f["bin"], "rb").read(),
               open(os.path.join(DATA, BIG + ".bin"), "rb").read(), BIG)
    for name in MM_BLOCK_KERNELS + ("sphere_positions", "sphere_centers"):
        if not path_launches[label][name]:
            fail(f"{label}: {name} not launched")
    label = "decoder app 2048x1024"
    reset_launches()
    t1 = time.perf_counter()
    lines = app_run(decoder_app.main, [
        "-b", f["bin"], "-o", f["dec"], "--CacheModel",
        f"--TraceFile={f['trace']}"])
    dec_s = time.perf_counter() - t1
    path_launches[label] = launch_counts()
    md5 = [ln for ln in lines if "[MD5:" in ln]
    if len(md5) != sd["frames"] or not all(ln.endswith("(OK)")
                                           for ln in md5):
        fail(f"{label}: MD5 lines {md5}")
    if not any(ln.startswith("CacheModel:") for ln in lines):
        fail(f"{label}: no cache model report")
    same = open(f["dec"], "rb").read() == open(f["rec"], "rb").read()
    print(f"{label}: {dec_s:.2f} s (host clock), {len(md5)} MD5 OK, output "
          f"YUV equal to the encoder app's reconstruction: {same}, "
          f"launches {all_launches()}")
    if not same:
        fail(f"{label}: its YUV differs from the encoder app's "
             "reconstruction")
    for name in ("mc_luma_positions", "mc_chroma_positions"):
        if not path_launches[label][name]:
            fail(f"{label}: {name} not launched")
    # --BitStats: the Python spec coder on the committed 256x128 stream
    record = json.load(open(os.path.join(DATA, "apps.json")))
    t1 = time.perf_counter()
    lines = app_run(decoder_app.main, [
        "-b", os.path.join(DATA, SMALL + ".bin"), "--BitStats"])
    got = [ln for ln in lines if not ln.startswith("decoded ")]
    want = [ln for ln in record["dec"]["bitstats"]["stdout"]
            if not ln.startswith("decoded ")]
    print(f"decoder app --BitStats {SMALL}: {time.perf_counter() - t1:.2f} "
          f"s (host clock), the JAX decoder app's report: {got == want}")
    if got != want:
        fail("decoder app --BitStats differs from the JAX decoder app's")
    # parcat: two chunks coded by the encoder app, spliced, decoded
    clip = realistic_sequence(256, 128, 5)
    chunks = []
    for i, part in enumerate((clip[:3], clip[3:])):
        yuv = os.path.join(out, f"chunk{i}.yuv")
        write_yuv(yuv, part)
        chunks.append(os.path.join(out, f"chunk{i}.bin"))
        app_run(encoder_app.main, [
            "-i", yuv, "-b", chunks[-1], "-wdt", "256", "-hgt", "128",
            "-q", "37", "--GOP=LDP", "--SearchRange=24", "--MPA", "--ROT",
            "--WrapAround"])
    spliced = os.path.join(out, "spliced.bin")
    app_run(parcat.main, [spliced] + chunks)
    dec = DecLib()
    frames = dec.decode_bytes(open(spliced, "rb").read())
    pocs = sorted(fr.poc for fr in frames)
    print(f"parcat of 2 chunks: POCs {pocs}, hash {dec.hash_status}")
    if pocs != list(range(5)) or len(dec.hash_status) != 5 or \
            any(v != "OK" for v in dec.hash_status.values()):
        fail("parcat: the spliced stream does not decode with every MD5 OK")
    print(f"8v: phase {time.perf_counter() - t0:.1f} s (host clock)")


SHARD_RANKS = 2
SHARD_MM = (2048, 1024)       # ERP, MPA+ROT, replicated reference
SHARD_INTRA = (1024, 512)     # frame-parallel intra, 2 pictures


def shard_inputs() -> dict:
    """8w's inputs: realistic_sequence pictures of each case."""
    w, h = SHARD_MM
    clip = realistic_sequence(w, h, 2)
    iw, ih = SHARD_INTRA
    return dict(ref=clip[0], cur=clip[1],
                intra=realistic_sequence(iw, ih, SHARD_RANKS))


def shard_rank(rank: int, init: str, out: str) -> None:
    """One rank of 8w, spawned: the three sharded encodes on the card over
    a gloo group; rank 0 writes the results, each rank its launches."""
    import pickle
    import torch.distributed as dist
    from vvc_mm_tpu_torch.parallel import sharding
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=SHARD_RANKS)
    try:
        torch.cuda.set_device(0)
        with open(os.path.join(out, "inputs.pkl"), "rb") as fh:
            inp = pickle.load(fh)
        mesh = sharding.make_mesh()
        h, w = np.asarray(inp["cur"][0]).shape
        res, secs = {}, {}
        reset_launches()
        t = time.perf_counter()
        res["intra"] = sharding.encode_frames_sharded(inp["intra"], 37,
                                                       mesh)
        secs["intra"] = time.perf_counter() - t
        intra_launches = launch_counts()
        reset_launches()
        t = time.perf_counter()
        mm = MMConfig(mpa=True, rot=True)
        reproj = MVReprojection(ERP(w, h), w, h, mm.mm_offset_4x4, 1)
        res["mm"] = sharding.encode_p_frame_mm_sharded(
            reproj, mm.active_models(), inp["cur"], inp["ref"], 37, mesh,
            search_range=24, wrap_around=True)
        torch.cuda.synchronize()
        secs["mm"] = time.perf_counter() - t
        mm_launches = launch_counts()
        reset_launches()
        t = time.perf_counter()
        res["halo"] = sharding.encode_p_frame_sharded_ref(
            inp["cur"], inp["ref"], 37, mesh, search_range=24,
            wrap_around=True)
        secs["halo"] = time.perf_counter() - t
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(dict(intra=intra_launches, mm=mm_launches,
                             halo=launch_counts(), secs=secs), fh)
        if rank == 0:
            with open(os.path.join(out, "results.pkl"), "wb") as fh:
                pickle.dump(res, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def sharded_path(path_launches: dict) -> None:
    """Phase 8w: 2 spawned ranks on the one card (gloo: NCCL refuses two
    ranks on a device), each sharded encode held bit for bit to the
    unsharded one of the same inputs on the card."""
    import pickle
    import torch.multiprocessing as mp
    from vvc_mm_tpu_torch.common import inter_frame, wavefront
    t0 = time.perf_counter()
    out = os.path.join(ROOT, "smoke_out", "sharding")
    os.makedirs(out, exist_ok=True)
    for name in os.listdir(out):
        os.remove(os.path.join(out, name))
    inp = shard_inputs()
    with open(os.path.join(out, "inputs.pkl"), "wb") as fh:
        pickle.dump(inp, fh)
    init = "file://" + os.path.join(out, "rendezvous")
    t1 = time.perf_counter()
    try:
        mp.spawn(shard_rank, args=(init, out), nprocs=SHARD_RANKS,
                 join=True)
    except Exception as e:        # a rank's failure fails the run
        fail(f"8w: a rank failed: {e}")
    spawn_s = time.perf_counter() - t1
    with open(os.path.join(out, "results.pkl"), "rb") as fh:
        res = pickle.load(fh)
    ranks = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            ranks.append(pickle.load(fh))
    print(f"8w: {SHARD_RANKS} ranks in {spawn_s:.1f} s (spawn to join, host "
          f"clock); rank seconds {[r['secs'] for r in ranks]}")
    dev = torch.device("cuda")

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    def same(label, got, want) -> None:
        ok = all(np.array_equal(np.asarray(g), w.cpu().numpy()
                                if torch.is_tensor(w) else np.asarray(w))
                 for g, w in zip(got, want))
        print(f"{label}: sharded = unsharded bit for bit: {ok}")
        if not ok:
            fail(f"{label}: the sharded encode differs from the unsharded")

    def launches(case: str) -> dict:
        """The ranks' launch_counts() of a case, summed."""
        tot = dict(by_shape={}, sphere_calls={})
        for r in ranks:
            for k, v in r[case].items():
                if isinstance(v, dict):
                    for kk, vv in v.items():
                        d = tot[k].setdefault(kk, {} if isinstance(
                            vv, dict) else 0)
                        if isinstance(vv, dict):
                            for shape, n in vv.items():
                                d[shape] = d.get(shape, 0) + n
                        else:
                            tot[k][kk] = d + vv
                else:
                    tot[k] = tot.get(k, 0) + v
        return tot

    outs, rec = res["intra"]
    for i, fr in enumerate(inp["intra"]):
        o, rc = wavefront.encode_intra_frame(*map(t, fr), 37, 8, 8)
        same(f"frame-parallel intra {SHARD_INTRA[0]}x{SHARD_INTRA[1]} "
             f"picture {i}", [*(x[i] for x in outs)] +
             [rec[c][i] for c in "yuv"], [*o] + [rc[c] for c in "yuv"])
    w, h = SHARD_MM
    mm = MMConfig(mpa=True, rot=True)
    active = mm.active_models()
    reproj = MVReprojection(ERP(w, h), w, h, mm.mm_offset_4x4, 1)
    cur, ref = [t(p) for p in inp["cur"]], [t(p) for p in inp["ref"]]
    t1 = time.perf_counter()
    midx, stack = frame_codec.search_p_mm(reproj, active, cur[0], ref[0], 37,
                                          16, 8, 24, None, True)
    pos = frame_codec.merged_positions(reproj, active, midx, stack, 16,
                                       None)
    ly, lu, lv, rc = frame_codec.enc_finish_p_mm(
        midx, stack, pos, *cur, *ref, 37, 16, 8, True, True)
    torch.cuda.synchronize()
    print(f"unsharded MM P {w}x{h}: {time.perf_counter() - t1:.2f} s "
          "(host clock)")
    g = res["mm"]
    same(f"row-sharded MM P {w}x{h}", [g[0], g[1], *g[2]] +
         [g[3][c] for c in "yuv"], [midx, stack, ly, lu, lv] +
         [rc[c] for c in "yuv"])
    want = inter_frame.encode_p_frame(*cur, *ref, 37, 16, 8, 24, True)
    g = res["halo"]
    same(f"row-sharded P {w}x{h}, halo exchange", [*g[:4]] +
         [g[4][c] for c in "yuv"], [*want[:4]] +
         [want[4][c] for c in "yuv"])
    for case, label, need in (
            ("intra", "sharded intra 2 ranks", ()),
            ("mm", "sharded MM P 2048x1024 2 ranks",      # K4: B only
             ("mc_luma_positions", "mc_chroma_positions",
              "sad_block_positions", "sphere_positions", "sphere_centers")),
            ("halo", "sharded P halo 2048x1024 2 ranks", ())):
        n = launches(case)
        path_launches[label] = n
        print(f"{label}: launches "
              f"{ {k: v for k, v in n.items() if not isinstance(v, dict)} }")
        for name in need:
            if not n[name]:
                fail(f"{label}: {name} not launched")
    print(f"8w: phase {time.perf_counter() - t0:.1f} s (host clock)")


def bench_stream(name: str, stream: str):
    """The committed stream of a bench configuration: its sidecar, bytes,
    EncCfg (checked against the sidecar) and source clip."""
    sd = json.load(open(os.path.join(DATA, stream + ".json")))
    committed = open(os.path.join(DATA, stream + ".bin"), "rb").read()
    cfg = bench_cfg(name, sd["width"], sd["height"], sd["qp"],
                    sd["gop_size"], sd["search_range"])
    if (sd["gop"], sd["qt_depth"], sd["wrap_around"], sd.get("config"),
            [tuple(e) for e in sd["epipoles"]]) != \
            (cfg.gop, cfg.qt_depth, cfg.wrap_around, name,
             [tuple(e) for e in cfg.epipoles]) \
            or sidecar_tools(sd) != cfg_tools(cfg):
        fail(f"{stream}: the sidecar names another configuration")
    return sd, committed, cfg, realistic_sequence(sd["width"], sd["height"],
                                                  sd["frames"])


# EncCfg tool fields a sidecar records beside the models
TOOL_FIELDS = ("dmvr", "bdof", "tmvp", "amvr", "gpm", "ciip", "affine",
               "weighted_pred", "weighted_bipred", "rdoq", "dep_quant",
               "mts", "lfnst", "transform_skip", "bdpcm", "lossless",
               "cclm", "mip", "mrl", "ibc")


def sidecar_tools(sd: dict) -> tuple:
    """(t3d, tan, the TOOL_FIELDS, fade step) a sidecar records; sidecars
    written before those fields existed name configurations with them off
    (and no fade)."""
    return tuple(bool(sd.get(k, False)) for k in ("t3d", "tan")
                 + TOOL_FIELDS) + (sd.get("fade"),)


def cfg_tools(cfg: EncCfg, fade: float | None = None) -> tuple:
    return (cfg.mm.t3d, cfg.mm.tan) + tuple(
        getattr(cfg, k) for k in TOOL_FIELDS) + (fade,)


def decode_committed(label: str, stream: str, sd: dict, data: bytes,
                     clip: list, cpu_decode: bool = True) -> None:
    """The JAX encoder's stream on the card, its positions against the
    CPU's (compare_positions), every MD5 OK and every Y-PSNR within 0.1
    dB of the sidecar; then, with `cpu_decode`, on the CPU fed the card's
    positions: bit-exact with the card."""
    card_positions, _, frames, verdicts = compare_positions(
        data, sd["width"], sd["height"])
    hold_to_record(f"{label} committed {stream}", frames, verdicts, sd,
                   clip)
    if cpu_decode:
        cpu_decode_from(label, data, frames, card_positions)


def hold_to_record(label: str, frames: list, hash_status: dict, sd: dict,
                   src: list) -> None:
    """A JAX-encoded stream decoded on the card, against its sidecar:
    every MD5 must match (md5_verdicts) and every picture's Y-PSNR
    against the source lie within 0.1 dB of the encoder's."""
    rec = {p["poc"]: p for p in sd["pocs"]}
    if [f.poc for f in frames] != sorted(rec):
        fail(f"{label}: decoded POCs {[f.poc for f in frames]}")
    for f in frames:
        planes = f.numpy()
        if any(p.shape != s.shape for p, s in zip(planes, src[f.poc])):
            fail(f"{label} POC {f.poc}: plane shapes")
        ps = [psnr(s, p) for s, p in zip(src[f.poc], planes)]
        ref_psnr = rec[f.poc]["psnr_y"]
        print(f"{label} POC {f.poc}: hash {hash_status.get(f.poc, 'NONE')}"
              f"  PSNR Y/U/V {ps[0]:.4f}/{ps[1]:.4f}/{ps[2]:.4f} dB  "
              f"encoder Y/U/V {rec[f.poc]['psnr_y']:.4f}/"
              f"{rec[f.poc]['psnr_u']:.4f}/{rec[f.poc]['psnr_v']:.4f} dB")
        if abs(ps[0] - ref_psnr) > PSNR_TOL_DB:
            fail(f"{label} POC {f.poc}: Y-PSNR {ps[0]:.4f} vs encoder "
                 f"{ref_psnr:.4f}")
    if hash_status.get(0) != "OK":
        fail(f"{label}: I picture (POC 0) MD5 mismatch")
    md5_verdicts(label, hash_status, sd)


def md5_verdicts(label: str, hash_status: dict, sd: dict) -> None:
    """A committed multi-model stream decoded on the card: every MD5 must
    be OK (the port copies the float32 form of the JAX codec's positions,
    ROADMAP queue 3 fault 1); the failing pictures are named."""
    n = len(sd["pocs"])
    failing = sorted(p for p in range(n) if hash_status.get(p) != "OK")
    print(f"{label}: {n - len(failing)} of {n} MD5 OK"
          + (f"; failing POCs {failing} (models {sd.get('models')})"
             if failing else ""))
    if failing:
        fail(f"{label}: MD5 mismatch at POCs {failing}")


def cpu_decode_from(label: str, data: bytes, frames: list,
                    card_positions: list) -> None:
    """Everything downstream of the positions (MC, bi-combine, dequant,
    inverse transform, deblock, SAO, ALF) is integer math: the plain
    versions on the CPU, fed the card's positions in the same order, must
    give the card's pictures bit for bit."""
    feed = iter([p.cpu() for p in card_positions])
    t0 = time.perf_counter()
    cpu_frames = DecLib(device="cpu",
                        positions_fn=lambda *_: next(feed)).decode_bytes(data)
    exact = {a.poc: all(torch.equal(p.cpu(), q)
                        for p, q in zip(a.planes, b.planes))
             for a, b in zip(frames, cpu_frames)}
    print(f"{label}: CPU decode from the card's positions "
          f"({time.perf_counter() - t0:.1f} s, host clock): bit-exact with "
          f"the card per POC {exact}")
    if [f.poc for f in cpu_frames] != [f.poc for f in frames] \
            or not all(exact.values()):
        fail(f"{label}: the card's reconstruction differs from the CPU's "
             "on the same positions")


def full_grid_case(ref_y, src_y: np.ndarray, positions, dev) -> dict:
    """One full-picture subblock grid for K5 and K6: not on a codec path
    (2048x1024 takes K3/K4); a decoded picture as the reference, the next
    source picture as the original, and the decode's merged positions
    shifted five ways."""
    shifts = torch.tensor([(0, 0), (0, -64), (-64, 0), (64, 0), (0, 64)],
                          dtype=torch.int32, device=dev)
    return dict(
        ref_padded=pad_ref(ref_y, MC_MARGIN, True),
        orig=torch.as_tensor(src_y.astype(np.int32), device=dev),
        margin=MC_MARGIN, s=None, bit_depth=8,
        positions=(positions[None] + shifts[:, None, None, :]).contiguous())


def decision_sads(full_grid: dict, path_launches: dict) -> None:
    """Phase 9."""
    # (captured K5 grid of the 256x128 diamonds, block size, row step,
    # column step), as _make_eval_subblock sets them
    decision_cases = [(captured_case(("sad_luma_positions", (5, 32, 64, 2),
                                      None)), 8, 1, 1),
                      (captured_case(("sad_luma_positions", (5, 8, 32, 2),
                                      None)), 16, 4, 2),
                      (full_grid, 16, 1, 1)]
    reset_launches()
    for c, s_blk, row_step, col_step in decision_cases:
        args = (c["ref_padded"], c["orig"], c["positions"])
        tail = (s_blk, row_step, col_step)
        bil = frame_codec._sad_fields_bilin(*args, *tail, exact=False)
        ex = frame_codec._sad_fields_bilin(*args, *tail, exact=True,
                                           bit_depth=8)
        torch.cuda.synchronize()
        plain = frame_codec._sad_fields_bilin(
            *(a.cpu() for a in args), *tail, exact=False)
        if bil.shape != ex.shape or not torch.equal(bil.cpu(), plain):
            fail(f"decision SAD {tuple(c['positions'].shape)}: the bilinear "
                 "arm differs from its plain version")
        agree = int((first_argmin(bil, 0) == first_argmin(ex, 0)).sum())
        print(f"decision SAD, positions {tuple(c['positions'].shape)}, "
              f"block {s_blk}, row/col step {row_step}/{col_step}: bilinear "
              f"equals its plain version on {bil.numel()} SADs; the best of "
              f"{bil.shape[0]} candidates is the same under both filters in "
              f"{agree} of {bil[0].numel()} blocks")
    path_launches["decision SAD"] = launch_counts()
    if path_launches["decision SAD"]["sad_bilinear_positions"] == 0:
        fail("the decision-SAD phase did not launch sad_bilinear_positions")


def by_shape(name: str, path_launches: dict) -> dict:
    """K3-K5: {"launches_by_shape": {"s=8 K=5": n, ...}} summed over the
    paths (K5's keys are field count and subblock grid, "K=5 8x32"); {}
    for the other kernels."""
    if name not in mc_kernel.LAUNCHES_BY_SHAPE and \
            name not in sphere_kernel.LAUNCHES_BY_SHAPE:
        return {}
    total: dict[str, int] = {}
    for p in path_launches.values():
        for shape, n in p["by_shape"][name].items():
            total[shape] = total.get(shape, 0) + n
    return {"launches_by_shape": total}


def launch_variants(cases: list, card: str) -> list:
    """K5's and K6's launch rule against its alternatives, on the same
    inputs: each (kernel, case) launched through the launcher's `_as` form
    as one thread an item with up to 8 fields of a subblock a CTA (the
    rule for K6, and for K5 above 16,384 items), with one field a CTA, and,
    for K5, split over 4 lanes an item (its rule at most 16,384 items).
    Every variant is held
    to the plain version (tolerance 0); device ms of each, in records."""
    lib = cuda_lib.load("sad_positions")
    variants = {"sad_luma_positions": (("fields side by side", 0, 8),
                                       ("one field a CTA", 0, 1),
                                       ("4 lanes an item", 1, 1)),
                "sad_bilinear_positions": (("fields side by side", 0, 8),
                                           ("one field a CTA", 0, 1))}
    records = []
    for name, c in cases:
        fn = getattr(lib, name + "_as")
        fn.restype = ctypes.c_int
        ref, pos = c["ref_padded"], c["positions"]
        orig = c["orig"].contiguous().clone()     # 16-byte aligned
        k, ny, nx, _ = pos.shape
        out = torch.empty((k, ny, nx), dtype=torch.int32, device=ref.device)
        head = [ctypes.c_void_p(ref.data_ptr()), ref.shape[0], ref.shape[1],
                ctypes.c_void_p(orig.data_ptr()),
                ctypes.c_void_p(pos.data_ptr()), k, ny, nx, c["margin"]]
        if c["bit_depth"] is not None:
            head.append(c["bit_depth"])
        plain_args = [ref, c["orig"], pos, c["margin"]] + \
            ([c["bit_depth"]] if c["bit_depth"] is not None else [])
        want = getattr(mc_kernel, name + "_plain")(*plain_args)
        for label, split, kc in variants[name]:
            tail = ([split] if name == "sad_luma_positions" else []) + \
                [kc, ctypes.c_void_p(out.data_ptr()),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)]

            def launch(a=head + tail):
                err = fn(*a)
                if err:
                    fail(f"{name}_as: CUDA launch failed with error {err}")
            launch()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                fail(f"{name} {label} on {tuple(pos.shape)} differs from "
                     "its plain version")
            dev_ms = device_ms(launch)
            records.append(dict(kernel=name, shape=list(pos.shape),
                                variant=label, device_ms=dev_ms))
            alone = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
            print(f"launch variant {name} {tuple(pos.shape)} {label}: "
                  f"device {alone}, equal to plain, {card}")
    return records


def dq_bound(name: str, b: int, n: int, max_level: int
             ) -> tuple[float, str]:
    """D1/D2: every input and output word once (the blocks in, the levels
    or coefficients out, the coding order, and for D1 the rate entries up to
    the largest candidate level this input needs) against their operations:
    D1 per coefficient 66 float32 operations (the two lattices' levels 8,
    the five distinct levels' errors and squares 10, four rate products,
    and per destination three candidates of an add, a rounding and an add
    and two minima, 44), over the float32 rate; D2 12 integer operations a
    coefficient over the int32 rate."""
    words = 2 * b * n + n
    if name == "quantize_dep":
        words += max_level + 2
        t_ops = b * n * 66 / F32_OPS_PER_S * 1e3
    else:
        t_ops = b * n * 12 / I32_OPS_PER_S * 1e3
    t_bytes = 4 * words / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def libm_timed_cases(dev) -> tuple[list, dict]:
    """L1 on a 2048x1024 picture's merged-position batch (LIBM_BATCH
    subblocks) of angles, each function once: (timed cases, {label:
    (library call, its name)}).  The bound: the float32 words read and
    written over the memory rate, against LIBM_F64_OPS float64 operations
    an element over the FP64 rate."""
    rng = np.random.default_rng(17)
    x = torch.as_tensor(rng.uniform(-4, 4, LIBM_BATCH).astype(np.float32),
                        device=dev)
    y = torch.as_tensor(rng.uniform(-4, 4, LIBM_BATCH).astype(np.float32),
                        device=dev)
    cases, library = [], {}
    for name, fn, plain, lib, lib_name, args in (
            ("sinf", libm_kernel.sin, libm_f32.sinf, torch.sin, "torch.sin",
             (x,)),
            ("cosf", libm_kernel.cos, libm_f32.cosf, torch.cos, "torch.cos",
             (x,)),
            ("tanf", libm_kernel.tan, libm_f32.tanf, torch.tan, "torch.tan",
             (x,)),
            ("atan2f", libm_kernel.atan2, libm_f32.atan2f, torch.atan2,
             "torch.atan2", (y, x))):
        words = (len(args) + 1) * LIBM_BATCH
        t_bytes = 4 * words / HBM_BYTES_PER_S * 1e3
        t_ops = LIBM_F64_OPS[name] * LIBM_BATCH / F64_OPS_PER_S * 1e3
        bound = (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")
        label = f"{name}, {LIBM_BATCH} elements (2048x1024 positions)"
        cases.append(("libm_f32", label, lambda f=fn, a=args: f(*a),
                      lambda f=plain, a=args: f(*a), bound))
        library[label] = (lambda f=lib, a=args: f(*a), lib_name)
    return cases, library


def depquant_timed_cases(dq_captured: dict) -> list:
    """D1/D2 on the inputs of their last launches at the I picture's luma
    and chroma shapes in phase 8k."""
    cases = []
    for name in ("quantize_dep", "dequantize_dep"):
        for shape, what in zip(DQ_PATH_SHAPES, ("luma", "U and V")):
            key = (name, shape)
            if key not in dq_captured:
                fail(f"phase 8k never launched {key}; captured "
                     f"{sorted(dq_captured, key=str)}")
            t, *args = dq_captured[key]
            fn = getattr(depquant, name)
            plain = getattr(depquant, name + "_plain")
            b, h, w_ = t.shape
            top = (int(t.abs().max()) if name == "dequantize_dep" else
                   int(depquant.quantize_dep_plain(t, *args).abs().max()))
            cases.append((name, f"{shape} (I picture {what}, 2048x1024)",
                          lambda fn=fn, t=t, a=args: fn(t, *a),
                          lambda fn=plain, t=t, a=args: fn(t, *a),
                          dq_bound(name, b, h * w_, top)))
    return cases


def sphere_bound(name: str, c: dict) -> tuple[float, str]:
    """The sphere kernel's least time for one captured call: the largest
    of the bytes of each block's MV (and model index), each kept
    position's grid constant (MPA's perspective cache 9 bytes, ROT's
    folded point 12 in the merged form), the rsqrt table where a fused
    form reads it and 8 bytes of output a position, over the memory rate;
    the float32 operations of this call's positions (SPHERE_OPS) over the
    FP32 rate; and the float64 operations of their glibc sinf / cosf /
    tanf calls over the FP64 rate.  The two kinds of
    operation run on separate units, so the larger of them bounds."""
    mvs, idx, models = c["mvs"], c["model_idx"], c["models"]
    k, _, nby, nbx = mvs.shape[:4]
    slots = torch.zeros((k, nby, nbx), dtype=torch.int64) if idx is None \
        else idx.cpu().to(torch.int64)
    if name == "sphere_positions":
        rep = c["block_size"] // 4
        slots = slots.repeat_interleave(rep, 1).repeat_interleave(rep, 2)[
            :, ::c["row_step"], ::c["col_step"]]
    counts = torch.bincount(slots.reshape(-1), minlength=len(models))
    n_bytes = k * nby * nbx * (8 + (4 if idx is not None else 0)) \
        + 8 * slots.numel()
    f64 = f32 = 0
    for m, n in zip(models, counts.tolist()):
        fam = "mpa" if m in (1, 2, 3) else "rot" if m == 6 else None
        if fam is None:
            continue
        own, atan2s, tans, sincos = SPHERE_OPS[(name, fam)][c["form"]]
        f64 += n * (sincos * LIBM_F64_OPS["sinf"]
                    + tans * LIBM_F64_OPS["tanf"])
        f32 += n * (own + atan2s * ATAN2F_F32 + tans * TANF_F32)
        if name == "sphere_positions":
            n_bytes += n * (9 if fam == "mpa" else
                            12 if c["form"] == "merged" else 0)
    if c["form"] is not None:
        n_bytes += 2048 * 8
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(f64 / F64_OPS_PER_S, f32 / F32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sphere_timed_cases(sphere_captured: dict, by_shape: dict) -> list:
    """The sphere kernel on the headline's own calls (phase 8's last call
    of each kernel, form, model count and shape; by kernel, the most
    launched first, from `by_shape`, the headline's launches by shape),
    each held to its plain version on the same inputs first: bit for
    bit."""
    def launched(key):
        name, form, n, shape = key
        label = (f"{'op' if form is None else form} " if name ==
                 "sphere_positions" else "") + \
            f"m={n} K={shape[0]} {shape[1]}x{shape[2]}"
        return -by_shape[name].get(label, 0)
    cases = []
    keys = sorted(sphere_captured, key=lambda key: (
        key[0] != "sphere_positions", launched(key), str(key)))
    for key in keys:
        name = key[0]
        c = sphere_captured[key]
        entry = "positions" if name == "sphere_positions" else "centers"
        fn = getattr(c["reproj"], entry)
        plain = getattr(c["reproj"], entry + "_plain")
        args = (c["models"], c["model_idx"], c["mvs"], c["block_size"])
        args += ((c["row_step"], c["col_step"], c["form"])
                 if name == "sphere_positions" else (None, c["form"]))
        before = dict(sphere_kernel.LAUNCHES)
        got, want = fn(*args), plain(*args)
        sphere_kernel.LAUNCHES.update(before)
        bad = int((got != want).any(-1).sum())
        form = f"{'op by op' if c['form'] is None else c['form']}, "
        n = len(c["models"])
        label = (f"{form}{n} model{'s' if n > 1 else ''}, block size "
                 f"{c['block_size']}, out {tuple(got.shape)} (headline)")
        print(f"{name} [{label}]: {bad} of {got[..., 0].numel()} positions "
              "differ from the plain version (tolerance 0)")
        if bad:
            fail(f"{name} differs from its plain version on the headline's "
                 "inputs")
        cases.append((name, label, lambda f=fn, a=args: f(*a),
                      lambda f=plain, a=args: f(*a), sphere_bound(name, c)))
    if {c[0] for c in cases} != {"sphere_positions", "sphere_centers"}:
        fail(f"the headline captured {sorted(sphere_captured, key=str)}")
    return cases


def time_kernels(captured: dict, full_grid: dict, ref_pic, positions,
                 dmvr_case: dict, affine_cases: dict, max_err: dict,
                 path_launches: dict, card: str, w: int, h: int,
                 dq_captured: dict, sphere_captured: dict) -> dict:
    """Phase 10: the `kernels` records, by kernel name."""
    timed_cases = []       # (kernel, label, kernel call, plain, bound)
    for name, plane, s, taps, m in (
            ("mc_luma_positions", ref_pic[0], 4, 8, MC_MARGIN),
            ("mc_chroma_positions", ref_pic[1], 2, 4, MC_MARGIN // 2)):
        refp = pad_ref(plane, m, True)
        fn = getattr(mc_kernel, name)
        plain = getattr(mc_kernel, name + "_plain")
        timed_cases.append((
            name, "256x512 subblocks (decode)",
            lambda fn=fn, r=refp, m=m: fn(r, positions, m, 8),
            lambda fn=plain, r=refp, m=m: fn(r, positions, m, 8),
            mc_bound(refp, positions, m, s, taps)))
    dmvr_args = (dmvr_case["ref_padded"], dmvr_case["positions"],
                 dmvr_case["margin"], dmvr_case["bit_depth"])
    timed_cases.append((
        "mc_luma_positions", f"{dmvr_args[1].shape[1]} subblocks in one row "
        "(projected DMVR, 2048x1024)",
        lambda: mc_kernel.mc_luma_positions(*dmvr_args),
        lambda: mc_kernel.mc_luma_positions_plain(*dmvr_args),
        mc_bound(dmvr_args[0], dmvr_args[1], dmvr_args[2], 4, 8)))
    # K1/K2 on path D's affine grid (the last final prediction's inputs)
    for name, (s_sub, taps) in (("mc_luma_positions", (4, 8)),
                                ("mc_chroma_positions", (2, 4))):
        c = affine_cases[name]
        args = (c["ref_padded"], c["positions"], c["margin"],
                c["bit_depth"])
        timed_cases.append((
            name, f"{c['positions'].shape[0]}x{c['positions'].shape[1]} "
            "subblocks (affine, 832x480)",
            lambda fn=getattr(mc_kernel, name), a=args: fn(*a),
            lambda fn=getattr(mc_kernel, name + "_plain"), a=args: fn(*a),
            mc_bound(args[0], args[1], args[2], s_sub, taps)))
    # K3: its most launched shapes on the headline sequence first (s=16, K
    # = 4 and 5), then s=8 K=5 and s=16 K=6
    wanted = (("sad_block_positions", (4, h // 16, w // 16, 2), 16),
              ("sad_block_positions", (5, h // 16, w // 16, 2), 16),
              ("sad_block_positions", (5, h // 8, w // 8, 2), 8),
              ("sad_block_positions", (6, h // 16, w // 16, 2), 16),
              ("mc_block_positions", (4, h // 16, w // 16, 2), 16),
              ("sad_luma_positions", (5, 32, 64, 2), None),
              ("sad_luma_positions", (5, 8, 32, 2), None))
    for key in wanted:
        if key not in captured:
            fail(f"the encodes never launched {key}; captured "
                 f"{sorted(captured, key=str)}")
    cases = [(k[0], captured[k]) for k in wanted]
    # K5 and K6 at the full 2048x1024 grid, then K6 on the 256x128 grids
    cases.append(("sad_luma_positions", full_grid))
    cases.append(("sad_bilinear_positions", dict(full_grid, bit_depth=None)))
    for shape in ((5, 32, 64, 2), (5, 8, 32, 2)):
        key = ("sad_bilinear_positions", shape, None)
        if key not in captured:
            fail(f"the decision-SAD phase never launched {key}")
        cases.append((key[0], captured[key]))
    for name, c in cases:
        args = [c["ref_padded"]] + \
            ([c["orig"]] if c["orig"] is not None else []) + \
            [c["positions"], c["margin"]] + \
            ([c["s"]] if c["s"] is not None else []) + \
            ([c["bit_depth"]] if c["bit_depth"] is not None else [])
        fn = getattr(mc_kernel, name)
        plain = getattr(mc_kernel, name + "_plain")
        label = f"positions {tuple(c['positions'].shape)}" + \
            (f" s={c['s']}" if c["s"] is not None else "")
        timed_cases.append((name, label,
                            lambda fn=fn, a=args: fn(*a),
                            lambda fn=plain, a=args: fn(*a),
                            search_bound(name, c)))
    variant_cases = [(n, c) for n, c in cases
                     if n in ("sad_luma_positions", "sad_bilinear_positions")]
    floor = launch_floor_ms(ref_pic[0].device)
    print("launch floor (device time of a one-element fill, "
          f"torch.zeros(1) on the card): "
          f"{'not measured' if floor is None else f'{floor:.4f} ms'}, "
          f"{card}")
    timed_cases += depquant_timed_cases(dq_captured)
    libm_cases, library = libm_timed_cases(ref_pic[0].device)
    timed_cases += libm_cases
    timed_cases += sphere_timed_cases(
        sphere_captured, path_launches["sequence 2048x1024 GOP 16"][
            "by_shape"])
    out = {}
    for name, label, fn, plain, (b_ms, b_by) in timed_cases:
        tag = "dep_kernel" if name in depquant_kernel.LAUNCHES \
            else "libm_kernel" if name == "libm_f32" \
            else name + "_kernel" if name in sphere_kernel.LAUNCHES \
            else "positions_kernel"
        before = (dict(mc_kernel.LAUNCHES), dict(depquant_kernel.LAUNCHES),
                  dict(libm_kernel.LAUNCHES), dict(sphere_kernel.LAUNCHES))
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(plain, iters=5)
        dev_ms = device_ms(fn, tag=tag)
        mc_kernel.LAUNCHES.update(before[0])    # timing is not a main path
        depquant_kernel.LAUNCHES.update(before[1])
        libm_kernel.LAUNCHES.update(before[2])
        sphere_kernel.LAUNCHES.update(before[3])
        alone = "not measured by the profiler" if dev_ms is None \
            else f"{dev_ms:.4f} ms"
        print(f"{name} [{label}]: {ms:.4f} ms kernel (device time alone "
              f"{alone}), {plain_ms:.4f} ms plain, bound "
              f"{b_ms:.4f} ms ({b_by}), {card}")
        case = dict(shape=label, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, device_ms=dev_ms)
        if name not in out:      # the first case is the main path's
            out[name] = dict(
                name=name, route="cuda",
                source="vvc_mm_tpu_torch/csrc/" + SOURCES[name],
                replaces=REPLACES[name],
                launches=sum(p[name] for p in path_launches.values()),
                launches_by_path={k: p[name]
                                  for k, p in path_launches.items()},
                **by_shape(name, path_launches),
                max_abs_err=max_err[name], ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                device_ms=dev_ms, cases=[])
            if name in sphere_kernel.LAUNCHES:
                out[name]["codec_calls"] = sum(
                    p["sphere_calls"][name] for p in path_launches.values())
        if name == "libm_f32":
            lib_fn, lib_name = library[label]
            case.update(library_ms=cuda_ms(lib_fn), library_fn=lib_name)
            print(f"  library call {lib_name} on the same inputs: "
                  f"{case['library_ms']:.4f} ms (a different function: "
                  "it rounds otherwise), {card}")
            if out[name]["library_ms"] is None:
                out[name]["library_ms"] = case["library_ms"]
                out[name]["library_fn"] = lib_name + " (rounds otherwise)"
        out[name]["cases"].append(case)
    if sorted(out) != sorted(SOURCES):
        fail(f"kernels timed: {sorted(out)}")
    for r in launch_variants(variant_cases, card):
        out[r.pop("kernel")].setdefault("launch_variants", []).append(r)
    for name, k in out.items():
        if k["launches"] == 0:
            fail(f"no main path launched {name}")
    return out


if __name__ == "__main__":
    main()
