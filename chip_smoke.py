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
     levels and reconstructions equal;
  4. decode the committed 2048x1024 ERP multi-model RA stream with
     DecLib() on CUDA, counting kernel launches: the I picture's MD5 must
     match, and every picture's Y-PSNR against the regenerated source must
     lie within 0.1 dB of the encoder's recorded value; the small 256x128
     stream is decoded on the card too: all its MD5s must match;
  5. count, per multi-model picture, the subblock positions the card
     computes differently from the same code on the CPU (both streams);
     then decode the 2048x1024 stream on the CPU from the card's
     positions: every picture must equal the card's bit for bit (all that
     follows the positions is integer math);
  6. sequence, against the JAX encoder's record: EncLib(cfg)
     .encode_sequence(frames) on CUDA for 5 frames at GOP 4, 2048x1024,
     the configuration of the committed stream (parameter sets, I picture,
     POC 4 (P), 2, 1, 3 (B), hash SEIs), counting launches (K1-K4 must be
     launched); DecLib() on the card decodes the port's stream: every MD5
     must match; per picture the Y-PSNR may lie at most 0.1 dB below and
     the bits at most 2% above the recorded JAX encoder's; the IDR NAL is
     compared with the committed stream's.  A second encode with the stage
     timers on must give the same bytes and prints the stage shares per
     picture;
  7. the same at 256x128 on the card: the path that launches K5 (and K1 in
     the B decision); every MD5 must match; a third encode under
     torch.profiler counts, per picture, every device operation (kernel,
     copy) and their summed device time.  The whole stream is compared
     with the committed one byte for byte: where the card's positions
     equal the CPU's at this size, a difference fails the run;
  8. sequence, full width: the headline configuration (2048x1024, RA,
     GOP 16, 17 frames, MPA+ROT, quadtree depth 1, QP 37 with the cascade)
     through encode_sequence on the card, then DecLib() on the card: 17 of
     17 MD5s must match and K1-K4 must be launched; per-picture bits,
     Y-PSNR and seconds, the frames per second and the stream's SHA-256
     are printed.  Two more
     encodes give the median and the spread of the sequence's seconds and
     must give the same bytes; one more under torch.profiler gives every
     picture's device operations, device time and idle share, and the I
     picture's decode is traced the same way;
  8b. bench configurations 3 (MPA, flat grid) and 4 (MPA+GED+ROT+MMMVP
     with the signalled epipole (1, 0, 0, 0, 1), flat grid) of bench.py,
     5 frames at GOP 4: at 2048x1024 through encode_sequence on the card,
     held to the committed JAX stream's sidecar (per picture Y-PSNR at most
     0.1 dB below, bits at most 2% above) and its IDR NAL byte for byte,
     K1-K4 launched; the port's stream decoded on the card (every MD5 OK);
     seconds, frames per second, stage shares and device operations per
     picture printed; the committed stream decoded on the card (I picture
     MD5 OK, every Y-PSNR within 0.1 dB of the sidecar) and on the CPU fed
     the card's positions (epipoles through the positions hook): bit-exact
     with the card.  At 256x128 (configurations 3, 4 and 4 with the
     off-pole epipole (4, 0, 0.3, -0.5, 0.8)), where the card's positions
     equal the CPU's, the card's stream must equal the port's CPU encode
     byte for byte; each is compared with the committed stream NAL by NAL;
  8c. bench configuration 2 (`ra832x480_qp37_encode_fps`: 832x480, RA,
     GOP 16, 17 frames, the classic single-model inter path, no 360 tool):
     encode_sequence on the card, held to the committed JAX stream
     `ra832x480_qp37_17f` byte for byte; the port's stream and the
     committed one decoded on the card with 17 of 17 MD5 OK; two more
     encodes give the median seconds and frames per second (same bytes),
     one with the stage timers on the stage shares, one under
     torch.profiler every picture's device operations and idle share.
     The classic path launches none of K1-K6;
  8d. bench configuration 5 (`erp6144x3072_ldp_qp37_encode_fps`:
     6144x3072 ERP, LDP, wrap-around, classic tools), 3 frames: POC 2 is
     the first two-reference P picture; encode_sequence on the card, the
     stream decoded on the card with 3 of 3 MD5 OK; seconds per picture
     and the device memory peak printed;
  8e. bench configuration 4 plus the last two motion models and projected
     DMVR (`erp2048x1024_ra_qp37_allmm_dmvr`: MPA+3DT+TAN+ROT+GED+MMMVP,
     8 active models, epipole (1, 0, 0, 0, 1), dmvr on), 5 frames at GOP
     4, 2048x1024: held to the committed JAX stream's sidecar and IDR NAL
     as in 8b, the port's stream decoded on the card (every MD5 OK), K1
     launched by projected DMVR's bilateral costs (one row of the
     subblocks of a model pair's bi blocks) and held to its plain version
     on the largest of them (tolerance 0);
     stage shares and device operations per picture; the committed stream
     decoded on the card (I picture MD5 OK, every Y-PSNR within 0.1 dB)
     and on the CPU fed the card's positions, projected DMVR's candidate
     positions among them: bit-exact with the card;
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
     encode with the stage timers on and one under torch.profiler give the
     stage shares and every picture's device operations and idle share;
  8i. path D, affine (configuration 2's clip, LDP, 9 frames;
     `ldp832x480_affine_qp37_9f`): the encode byte for byte with the JAX
     stream, or within 0.1 dB and 2% of its sidecar with the IDR NAL
     equal; the blocks whose affine parameters differ are counted; the
     port's and the committed stream decode on the card with 9 of 9 MD5
     OK; K1/K2 launches by shape printed, their last launches on the
     (120, 208, 2) affine grid held to the plain versions (tolerance 0);
     stage shares and device operations as in 8h;
  8j. path E, the fade (frame i at gain 1 - 0.04 i) with weighted
     prediction on P and B slices, BDOF, DMVR, GPM and CIIP
     (`ra832x480_fade_wp_qp37_17f`): as 8h, and the count of slices that
     carry weight tables;
  8k. the headline tools with make_bd_r05.py's CTC-like preset (TMVP,
     RDOQ, dependent quantization, MTS, LFNST) at 2048x1024, 5 frames at
     GOP 4: held to the committed JAX stream's sidecar (0.1 dB, 2%) and its
     IDR NAL byte for byte, D1/D2 launched on every wavefront step, the
     port's stream decoded on the card (every MD5 OK), the committed
     stream decoded on the card (the I picture's MD5 OK, every Y-PSNR
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
  9. decision SADs (K6's path): frame_codec._sad_fields_bilin with
     exact=False and exact=True on the tensors captured from the 256x128
     encodes' diamond steps and on one full 2048x1024 grid: the bilinear
     result must equal the plain version's, sad_bilinear_positions must be
     launched, and the blocks whose best candidate is the same under both
     filters are counted;
 10. time each kernel and its plain version on inputs captured from those
     runs (K1 also on projected DMVR's row, K1/K2 also on path D's affine
     grid, D1/D2 on phase 8k's I-picture luma batch), after a launch floor
     (the
     device time of a one-element fill), print the `kernels` line (K1-K5
     launches also by shape), then the
     result line.  Before it, K5's and K6's launch rule is timed against
     its alternatives on the same inputs (each held to the plain version).
"""
from __future__ import annotations

import ctypes
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
from vvc_mm_tpu_torch.common.inter_frame import (MC_MARGIN, first_argmin,
                                                 pad_ref)
from vvc_mm_tpu_torch.common.mm import frame_codec
from vvc_mm_tpu_torch.common.mm.reprojection import MVReprojection
from vvc_mm_tpu_torch.common.slice_ps import SPS, MMConfig, SliceHeader
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder.enclib import EncCfg, EncLib
from vvc_mm_tpu_torch.lib360.projection import ERP
from vvc_mm_tpu_torch.common import depquant
from vvc_mm_tpu_torch.ops import cuda_lib, depquant_kernel, mc_kernel
from vvc_mm_tpu_torch.utils import profiling
from vvc_mm_tpu_torch.decoder.inter_parser import decode_p_slice_affine
from vvc_mm_tpu_torch.utils.content import (fade_sequence, psnr,
                                            realistic_sequence)

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
           "dequantize_dep": "depquant.cu"}
REPLACES = {"mc_luma_positions": "vvc_mm_tpu/ops/mc_kernel.py:191",
            "mc_chroma_positions": "vvc_mm_tpu/ops/mc_kernel.py:817",
            "sad_block_positions": "vvc_mm_tpu/ops/mc_kernel.py:565",
            "mc_block_positions": "vvc_mm_tpu/ops/mc_kernel.py:505",
            "sad_luma_positions": "vvc_mm_tpu/ops/mc_kernel.py:291",
            "sad_bilinear_positions": "vvc_mm_tpu/ops/mc_kernel.py:688",
            "quantize_dep": "vvc_mm_tpu/common/depquant.py:70 (lax.scan, "
                            "no Pallas)",
            "dequantize_dep": "vvc_mm_tpu/common/depquant.py:165 (lax.scan, "
                              "no Pallas)"}
# D1/D2: the block batch shapes of the I picture's launches at 2048x1024
# with MTS and LFNST, timed in phase 10: luma (128 blocks x 7 candidates),
# then U and V (2 x 128 blocks)
DQ_PATH_SHAPES = ((896, 8, 8), (256, 4, 4))


_T0 = time.perf_counter()


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
    it caught.  Where it traces none, or more than one for a call, twice in
    a row, the time is not measured (None) and the CUDA-event time of
    cuda_ms stands alone."""
    for _ in range(2):          # now and then a trace is unusable
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
    max_err = {name: 0 for name in SOURCES}
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


def all_launches() -> dict:
    """Every kernel's launch count: K1-K6 and D1/D2."""
    return dict(mc_kernel.LAUNCHES, **depquant_kernel.LAUNCHES)


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
    """Kernel launches since the last reset_launches(), with K3-K5's by
    shape under "by_shape"."""
    return dict(all_launches(), by_shape={
        n: dict(d) for n, d in mc_kernel.LAUNCHES_BY_SHAPE.items()})


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
    "trace" (each picture under torch.profiler)."""

    def __init__(self, cfg: EncCfg, mode: str) -> None:
        super().__init__(cfg)
        self.mode = mode
        self.rows: list[dict] = []

    def _measured(self, kind: str, method, poc: int, *args, **kw):
        before = all_launches()
        stages_before = profiling.totals()
        prof = None
        if self.mode == "trace":
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


def encode_run(label: str, cfg: EncCfg, src: list, mode: str) -> dict:
    """One EncLib(cfg).encode_sequence(src) on the card: the Annex-B
    bytes, the per-picture notes, the sequence's seconds (host clock,
    synchronised) and the launch counts of this run alone."""
    profiling.reset()
    profiling.enable(mode == "stages")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = MeasuredEncLib(cfg, mode)
    data = enc.encode_sequence(src)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    profiling.enable(False)
    if len(enc.results) != len(src) or enc.summary()["frames"] != len(src):
        fail(f"{label}: {len(enc.results)} results for {len(src)} frames")
    return dict(label=label, data=data, rows=enc.rows, launches=launches,
                seconds=seconds, stages=profiling.totals(), frames=len(src),
                width=cfg.width, height=cfg.height)


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
        if r["device_work"][0]:
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


def compare_positions(data: bytes, w: int, h: int):
    """Decode `data` on the card, computing every merged-positions tensor
    on the card and with the same code on the CPU (GED pictures with their
    epipoles): returns the card's tensors (projected DMVR's candidate
    positions among them, in call order), the (differing, total) subblock
    counts per merged-positions call (projected DMVR's candidates counted
    apart), and the decoded frames."""
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
    return card_positions, mismatches, frames


def captured_case(key: tuple) -> dict:
    """The tensors of the last launch with `key` = (kernel, positions
    shape, block width) that the encodes made."""
    if key not in mc_kernel.CAPTURED:
        fail(f"the encodes never launched {key}; captured "
             f"{sorted(mc_kernel.CAPTURED, key=str)}")
    return mc_kernel.CAPTURED[key]


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA device")
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
    t0 = time.perf_counter()
    DecLib().decode_bytes(data)
    torch.cuda.synchronize()
    print(f"decode {BIG} again (warm): "
          f"{time.perf_counter() - t0:.2f} s (host clock)")
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

    # ---- 5. positions: card vs the same code on the CPU
    phase("5. positions, card against CPU")
    card_positions, mismatches, frames2 = compare_positions(data, w, h)
    same = [a.md5() == b.md5() for a, b in zip(frames, frames2)]
    print(f"second decode identical to the first: {same}")
    if not all(same):
        fail("the positions hook changed the decode")
    small_data = open(os.path.join(DATA, SMALL + ".bin"), "rb").read()
    _, small_mismatches, _ = compare_positions(small_data, 256, 128)
    cpu_decode_from(f"decode {BIG}", data, frames2, card_positions)

    # ---- 6./7. sequences against the JAX encoder's record (GOP 4)
    phase("6./7. sequences against the JAX encoder's record")
    mc_kernel.CAPTURED = {}
    sequences_against_record(path_launches,
                             sum(n for n, _ in small_mismatches))

    # ---- 8. the headline sequence: 17 frames, GOP 16, 2048x1024
    phase("8. the headline sequence")
    clip = realistic_sequence(w, h, HEADLINE_FRAMES)
    headline_sequence("sequence 2048x1024 GOP 16",
                      headline_cfg(w, h, 37, HEADLINE_GOP), clip,
                      ("mc_luma_positions", "mc_chroma_positions",
                       "sad_block_positions", "mc_block_positions"),
                      path_launches)

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
                       dq_captured)
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
        again = [encode_run(label, cfg, clip, "stages")]
        if not big:
            again.append(encode_run(label, cfg, clip, "trace"))
        for other in again:
            if other["data"] != run["data"]:
                fail(f"{label}: another encode gave other bytes")
        print_stages(again[0])
        if big:
            compare_nals(label, run["data"], committed, only=bs.NAL_IDR)
        else:
            print_device_work(again[1], run)
            if not compare_nals(label, run["data"], committed) \
                    and small_positions_off == 0:
                fail(f"{label}: the card's positions equal the CPU's, yet "
                     "the stream differs from the JAX encoder's")


def headline_sequence(label: str, cfg: EncCfg, clip: list, need: tuple,
                      path_launches: dict, record: dict | None = None
                      ) -> dict:
    """Phase 8 (and 8c, held to `record`): returns the first run."""
    n = len(clip)
    first = encode_run(label + " (first call)", cfg, clip, "plain")
    path_launches[label] = first["launches"]
    check_run(first, need, record)
    # two timed encodes after the first (three before the preset's phase
    # 8k joined the run: the smoke's time limit is shared)
    runs = [encode_run(label, cfg, clip, "plain") for _ in range(2)]
    for r in runs:
        if r["data"] != first["data"]:
            fail(f"{label}: another encode gave other bytes")
    secs = sorted(r["seconds"] for r in runs)
    med = statistics.median(secs)
    print(f"{label}: first call {first['seconds']:.2f} s; two more: "
          f"{', '.join(f'{x:.2f}' for x in secs)} s (host clock), median "
          f"{med:.2f} s = {n / med:.3f} frames per second, spread "
          f"(max - min) {secs[-1] - secs[0]:.2f} s = "
          f"{100 * (secs[-1] - secs[0]) / med:.1f}% of the median")
    for kind in sorted({r["kind"] for r in runs[0]["rows"]}):
        per = [r["seconds"] for run in runs for r in run["rows"]
               if r["kind"] == kind]
        print(f"{label}: {kind} pictures {min(per):.2f}-{max(per):.2f} s, "
              f"median {statistics.median(per):.2f} s over {len(per)} "
              "encodes (host clock)")
    traced = encode_run(label + " (traced)", cfg, clip, "trace")
    if traced["data"] != first["data"]:
        fail(f"{label}: the traced encode gave other bytes")
    print_device_work(traced, runs[0])
    # the I picture's decode alone, untraced then traced
    head = bs.write_annexb(bs.read_annexb(first["data"])[:4])
    for trace in (False, True):
        prof = _profiler() if trace else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if prof is not None:
            prof.start()
        idec = DecLib()
        idec.decode_bytes(head)
        torch.cuda.synchronize()
        if prof is not None:
            prof.stop()
        took = time.perf_counter() - t0
        if idec.hash_status != {0: "OK"}:
            fail(f"{label}: I picture decode, hash {idec.hash_status}")
        if not trace:
            i_decode_s = took
            print(f"{label}: I picture decoded alone in {took:.2f} s (host "
                  "clock)")
            continue
        n_ops, busy = device_work(prof)
        if n_ops == 0:
            print(f"{label}: I picture decode: device operations not "
                  "measured (the profiler traced none)")
        else:
            print(f"{label}: I picture decode: {n_ops} device operations, "
                  f"{busy:.4f} s of device time; untraced it took "
                  f"{i_decode_s:.2f} s: the card is idle "
                  f"{100 * (1 - busy / i_decode_s):.1f}% of it "
                  f"({took:.2f} s under the profiler)")
    return first


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
        staged = encode_run(label, cfg, clip, "stages")
        traced = encode_run(label + " (traced)", cfg, clip, "trace")
        for other in (staged, traced):
            if other["data"] != run["data"]:
                fail(f"{label}: another encode gave other bytes")
        print_stages(staged)
        print_device_work(traced, run)
        if not compare_nals(label, run["data"], committed, only=bs.NAL_IDR):
            fail(f"{label}: the IDR NAL differs from the JAX encoder's")
        decode_committed(label, stream, sd, committed, clip)
    for name in ("mpa", "fullmm", "fullmm_ep"):
        stream = f"erp256x128_ra_{name}_qp37_5f"
        sd, committed, cfg, clip = bench_stream(name, stream)
        label = f"config {name} 256x128 GOP 4"
        run = encode_run(label, cfg, clip, "plain")
        path_launches[label] = run["launches"]
        check_run(run, ("mc_luma_positions", "mc_chroma_positions",
                        "sad_luma_positions"),
                  {p["poc"]: p for p in sd["pocs"]})
        _, off, _ = compare_positions(committed, sd["width"], sd["height"])
        n_off = sum(n for n, _ in off)
        cpu = EncLib(cfg, device="cpu").encode_sequence(clip)
        same = run["data"] == cpu
        print(f"{label}: the card's stream equals the port's CPU encode "
              f"byte for byte: {same}")
        compare_nals(label, run["data"], committed)
        if not same and n_off == 0:
            fail(f"{label}: the card's positions equal the CPU's, yet the "
                 "card's stream differs from the CPU's")


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
                              {p["poc"]: p for p in sd["pocs"]})
    if any(first["launches"][k] for k in SOURCES):
        fail(f"{label}: the classic path launched a kernel: "
             f"{first['launches']}")
    staged = encode_run(label, cfg, clip, "stages")
    if staged["data"] != first["data"]:
        fail(f"{label}: the staged encode gave other bytes")
    print_stages(staged)
    if not compare_nals(label, first["data"], committed):
        fail(f"{label}: the card's stream differs from the JAX encoder's")
    decode_all_ok(label, CONFIG2, committed, sd["frames"])


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


def decode_all_ok(label: str, stream: str, data: bytes, n: int) -> None:
    """A committed stream decoded on the card: every MD5 OK."""
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
    staged = encode_run(label, cfg, clip, "stages")
    traced = encode_run(label + " (traced)", cfg, clip, "trace")
    for other in (staged, traced):
        if other["data"] != run["data"]:
            fail(f"{label}: another encode gave other bytes")
    print_stages(staged)
    print_device_work(traced, run)
    if not compare_nals(label, run["data"], committed, only=bs.NAL_IDR):
        fail(f"{label}: the IDR NAL differs from the JAX encoder's")
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
    traced = encode_run(label + " (traced)", cfg, clip, "trace")
    if traced["data"] != run["data"]:
        fail(f"{label}: the traced encode gave other bytes")
    print_device_work(traced, run)
    if not compare_nals(label, run["data"], committed):
        fail(f"{label}: the card's stream differs from the JAX encoder's")
    decode_all_ok(label, CONFIG2_TOOLS, committed, sd["frames"])


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
    decoded on the card), then one with the stage timers and one under the
    profiler (same bytes): seconds, frames per second, stage shares and
    device operations per picture by kind.  Returns the plain run."""
    run = encode_run(label, cfg, clip, "plain")
    path_launches[label] = run["launches"]
    check_run(run, (), record, hold=hold)
    staged = encode_run(label, cfg, clip, "stages")
    traced = encode_run(label + " (traced)", cfg, clip, "trace")
    for other in (staged, traced):
        if other["data"] != run["data"]:
            fail(f"{label}: another encode gave other bytes")
    print_stages(staged)
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
    decode_all_ok(label, stream, committed, sd["frames"])


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
    decode_all_ok(label, PATH_D, committed, sd["frames"])
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
    decoded on the card (the I picture's MD5 OK: D2 in the decoder; every
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
    n_ops, busy = i_traced["device_work"]
    # a kernel that ran but that the profile caught no event of is "not
    # measured", never 0 ms
    d1, d2 = ("not measured" if t <= 0 else f"{1e3 * t:.2f} ms"
              for t in i_traced["dq_device_s"])
    print(f"{hlabel}: {hrun['seconds']:.2f} s for {HEADLINE_FRAMES} "
          f"pictures; I picture {i_plain['seconds']:.2f} s (host clock), "
          f"{n_ops} device operations, {busy:.4f} s of device time, D1 "
          f"{i_plain['launches']['quantize_dep']} launches "
          f"({d1} of device time), D2 "
          f"{i_plain['launches']['dequantize_dep']} launches "
          f"({d2}); the card idle "
          f"{100 * (1 - busy / i_plain['seconds']):.1f}% of the I picture")
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
        decode_all_ok(label, stream, committed, sd["frames"])


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
    decode_all_ok(label, SCALING, committed, sd["frames"])


def bench_configuration_5(path_launches: dict) -> None:
    """Phase 8d: `erp6144x3072_ldp_qp37_encode_fps` (bench.py:121-123), 3
    frames: POC 1 takes one reference, POC 2 two.  No JAX record exists
    at this size; the CPU tests hold the two-reference path to JAX."""
    cfg = EncCfg(width=6144, height=3072, qp=37, gop="LDP",
                 search_range=24, wrap_around=True)
    clip = realistic_sequence(cfg.width, cfg.height, 3)
    label = "config 5 6144x3072 LDP"
    torch.cuda.reset_peak_memory_stats()
    run = encode_run(label, cfg, clip, "plain")
    peak = torch.cuda.max_memory_allocated()
    path_launches[label] = run["launches"]
    check_run(run, ())
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
               "mts", "lfnst", "transform_skip", "bdpcm", "lossless")


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
                     clip: list) -> None:
    """The JAX encoder's stream on the card (I picture MD5 OK, every
    Y-PSNR within 0.1 dB of the sidecar), then on the CPU fed the card's
    positions: bit-exact with the card."""
    card_positions, _, frames = compare_positions(data, sd["width"],
                                                  sd["height"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = DecLib()
    again = dec.decode_bytes(data)
    torch.cuda.synchronize()
    print(f"{label}: committed {stream} decoded on the card in "
          f"{time.perf_counter() - t0:.2f} s (host clock)")
    if [a.md5() for a in frames] != [b.md5() for b in again]:
        fail(f"{label}: the positions hook changed the decode")
    hold_to_record(f"{label} committed", frames, dec.hash_status, sd, clip)
    cpu_decode_from(label, data, frames, card_positions)


def hold_to_record(label: str, frames: list, hash_status: dict, sd: dict,
                   src: list) -> None:
    """A JAX-encoded stream decoded on the card, against its sidecar: the
    I picture's MD5 must match and every picture's Y-PSNR against the
    source lie within 0.1 dB of the encoder's."""
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
    if name not in mc_kernel.LAUNCHES_BY_SHAPE:
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


def time_kernels(captured: dict, full_grid: dict, ref_pic, positions,
                 dmvr_case: dict, affine_cases: dict, max_err: dict,
                 path_launches: dict, card: str, w: int, h: int,
                 dq_captured: dict) -> dict:
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
    out = {}
    for name, label, fn, plain, (b_ms, b_by) in timed_cases:
        tag = "dep_kernel" if name in depquant_kernel.LAUNCHES \
            else "positions_kernel"
        before = dict(mc_kernel.LAUNCHES), dict(depquant_kernel.LAUNCHES)
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(plain, iters=5)
        dev_ms = device_ms(fn, tag=tag)
        mc_kernel.LAUNCHES.update(before[0])    # timing is not a main path
        depquant_kernel.LAUNCHES.update(before[1])
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
