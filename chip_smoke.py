"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build every CUDA kernel of the port (one nvcc per source, in parallel);
  2. print the card's name and power limit (nvidia-smi);
  3. hold kernels K1 (luma MC), K2 (chroma MC), K3 (block-band SAD), K4
     (block-band MC) and K5 (per-subblock SAD) against their plain PyTorch
     versions on the card, on random and on extreme (clamped) positions at
     the main paths' shapes: bit-exact (tolerance 0);
  4. decode the committed 2048x1024 ERP multi-model RA stream with
     DecLib() on CUDA, counting kernel launches: the I picture's MD5 must
     match, and every picture's Y-PSNR against the regenerated source must
     lie within 0.1 dB of the encoder's recorded value; the small 256x128
     stream is decoded on the card too: all its MD5s must match;
  5. count, per multi-model picture, the subblock positions the card
     computes differently from the same code on the CPU; then decode the
     stream on the CPU from the card's positions: every picture must equal
     the card's bit for bit (all that follows the positions is integer
     math);
  6. encode POC 4 (P), 2, 1, 3 (B) of the 2048x1024 source with EncLib() on
     CUDA at the random-access cascade's QPs, from the card's own decode of
     the committed I picture, counting launches (K1-K4 must be launched);
     decode the assembled stream (committed headers + I picture, the
     port's P/B pictures + hash SEIs) with DecLib() on the card: every MD5
     must match; Y-PSNR may lie at most 0.1 dB below and the bits at most
     2% above the recorded JAX encoder's.  A second encode with the stage
     timers on must give the same bytes and prints the stage shares per
     picture; a third under torch.profiler counts, per picture, every
     device operation (kernel, copy) and their summed device time, which
     against the first encode's seconds gives the card's idle share;
  7. the same at 256x128 on the card: the path that launches K5 (and K1 in
     the B decision); every MD5 must match;
  8. time each kernel and its plain version on inputs captured from those
     runs, print the `kernels` line, then the result line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from vvc_mm_tpu_torch.common import bitstream as bs
from vvc_mm_tpu_torch.common.inter_frame import MC_MARGIN, pad_ref
from vvc_mm_tpu_torch.common.mm import frame_codec
from vvc_mm_tpu_torch.common.mm.reprojection import MVReprojection
from vvc_mm_tpu_torch.common.slice_ps import MMConfig
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder.enclib import EncCfg, EncLib, ctc_qp
from vvc_mm_tpu_torch.lib360.projection import ERP
from vvc_mm_tpu_torch.ops import cuda_lib, mc_kernel
from vvc_mm_tpu_torch.utils import profiling
from vvc_mm_tpu_torch.utils.content import psnr, realistic_sequence

DATA = os.path.join(ROOT, "tests", "data", "torch_port")
BIG = "erp2048x1024_ra_mm_qp37_5f"
SMALL = "erp256x128_ra_mm_qp37_5f"
PSNR_TOL_DB = 0.1
BITS_TOL = 1.02
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # H100 SXM non-tensor float32 rate (the
                               # table's nearest entry for int32 MACs)
SOURCES = {"mc_luma_positions": "mc_positions.cu",
           "mc_chroma_positions": "mc_positions.cu",
           "sad_block_positions": "sad_positions.cu",
           "mc_block_positions": "sad_positions.cu",
           "sad_luma_positions": "sad_positions.cu"}
REPLACES = {"mc_luma_positions": "vvc_mm_tpu/ops/mc_kernel.py:191",
            "mc_chroma_positions": "vvc_mm_tpu/ops/mc_kernel.py:817",
            "sad_block_positions": "vvc_mm_tpu/ops/mc_kernel.py:565",
            "mc_block_positions": "vvc_mm_tpu/ops/mc_kernel.py:505",
            "sad_luma_positions": "vvc_mm_tpu/ops/mc_kernel.py:291"}


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


def device_ms(fn, iters: int = 20) -> float | None:
    """Mean device time of the one kernel a wrapper call fn() launches, from
    torch.profiler's device events: the gaps between launches, which the
    CUDA-event loop of cuda_ms includes, are left out.  The profiler
    misses the first few operations after it starts, so the mean is taken
    over the kernels it caught.  Where it traces no device event at all, or
    more than one for a call, the time is not measured (None) and the
    CUDA-event time of cuda_ms stands alone."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    n, busy = device_work(prof)
    return busy / n * 1e3 if 0 < n <= iters else None


def bound_ms(n_words: int, macs: int) -> tuple[float, str]:
    """Least time on the card for one call: its bytes (every input and
    output int32 word once) over the memory rate, against its MACs (2
    operations each) over the non-tensor rate."""
    t_bytes = 4 * n_words / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mc_bound(ref, positions, s: int, taps: int) -> tuple[float, str]:
    """K1/K2: reference, positions and output once each; the separable
    filter's MACs per subblock."""
    nsy, nsx, _ = positions.shape
    return bound_ms(ref.numel() + positions.numel() + nsy * nsx * s * s,
                    nsy * nsx * ((s + taps - 1) * s * taps + s * s * taps))


def search_bound(name: str, case: dict) -> tuple[float, str]:
    """K3/K4/K5: padded reference + positions + original band or plane +
    output; MACs per (k, block) = 11*s*8 + 4*s*8 (K3, K4), 480 per
    subblock (K5)."""
    pos = case["positions"]
    k, ny, nx, _ = pos.shape
    words = case["ref_padded"].numel() + pos.numel()
    if case["orig"] is not None:
        words += case["orig"].numel()
    if name == "sad_luma_positions":
        return bound_ms(words + k * ny * nx, 480 * k * ny * nx)
    s = case["s"]
    out = k * ny * nx if name == "sad_block_positions" else k * ny * 4 * nx * s
    return bound_ms(words + out, k * ny * nx * (11 * s * 8 + 4 * s * 8))


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
    cases = []      # (kernel, label, kernel call, plain call) per positions
    for pos in positions_pair(rng, (h // 4, w // 4), 4):
        p = t(pos)
        cases.append(("mc_luma_positions", "256x512 subblocks",
                      lambda p=p: mc_kernel.mc_luma_positions(
                          ref_y, p, margin, 8),
                      lambda p=p: mc_kernel.mc_luma_positions_plain(
                          ref_y, p, margin, 8)))
        cases.append(("mc_chroma_positions", "256x512 subblocks",
                      lambda p=p: mc_kernel.mc_chroma_positions(
                          ref_c, p, margin // 2, 8),
                      lambda p=p: mc_kernel.mc_chroma_positions_plain(
                          ref_c, p, margin // 2, 8)))
    for s, k in ((8, 5), (16, 6)):
        bands = t(rng.integers(0, 256, (h // s * 4, w), dtype=np.int32))
        for pos in positions_pair(rng, (k, h // s, w // s), s):
            p = t(pos)
            cases.append(("sad_block_positions", f"s={s} K={k}",
                          lambda p=p, b=bands, s=s:
                          mc_kernel.sad_block_positions(ref_y, b, p, margin,
                                                        s, 8),
                          lambda p=p, b=bands, s=s:
                          mc_kernel.sad_block_positions_plain(
                              ref_y, b, p, margin, s, 8)))
    for pos in positions_pair(rng, (4, h // 16, w // 16), 16):
        p = t(pos)
        cases.append(("mc_block_positions", "s=16 K=4",
                      lambda p=p: mc_kernel.mc_block_positions(
                          ref_y, p, margin, 16, 8),
                      lambda p=p: mc_kernel.mc_block_positions_plain(
                          ref_y, p, margin, 16, 8)))
    # K5: the 256x128 search's grids (s=8 unsubsampled; s=16 keeps 1 of 4
    # subblock rows and 1 of 2 columns) and one full 2048x1024 grid
    for (ny, nx), ref in (((32, 64), ref_small), ((8, 32), ref_small),
                          ((h // 4, w // 4), ref_y)):
        orig = t(rng.integers(0, 256, (ny * 4, nx * 4), dtype=np.int32))
        for pos in positions_pair(rng, (5, ny, nx), 4):
            p = t(pos)
            cases.append(("sad_luma_positions", f"(5, {ny}, {nx}, 2)",
                          lambda p=p, o=orig, r=ref:
                          mc_kernel.sad_luma_positions(r, o, p, margin, 8),
                          lambda p=p, o=orig, r=ref:
                          mc_kernel.sad_luma_positions_plain(r, o, p, margin,
                                                             8)))
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
        print(f"{name}: max |kernel - plain| = {err} over {n} cases "
              "(tolerance 0)")
        if err != 0:
            fail(f"{name} differs from its plain version")
    return max_err


def device_work(prof) -> tuple[int, float]:
    """(device operations, their summed device seconds) of a profile.  The
    profiler misses the first few operations (about ten) after it starts,
    so a count is low by that much."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(evs), sum(e.time_range.elapsed_us() for e in evs) * 1e-6


def encode_path(label: str, stream: str, mode: str) -> dict:
    """Phases 6/7: encode POC 4, 2, 1, 3 with EncLib() on the card from the
    card's decode of the committed I picture; returns the NAL units, the
    per-picture results and the launch counts of the encode.  `mode`:
    "plain", "stages" (stage timers on, each stage synchronised) or "trace"
    (each picture under torch.profiler)."""
    side = json.load(open(os.path.join(DATA, stream + ".json")))
    data = open(os.path.join(DATA, stream + ".bin"), "rb").read()
    head = []
    for nal in bs.read_annexb(data):
        head.append(nal)
        if nal.nal_type == bs.NAL_SEI:
            break
    if [n.nal_type for n in head] != [bs.NAL_SPS, bs.NAL_PPS, bs.NAL_IDR,
                                      bs.NAL_SEI]:
        fail(f"{stream}: unexpected head {[n.nal_type for n in head]}")
    dec = DecLib()
    dec.decode_bytes(bs.write_annexb(head))
    if dec.hash_status.get(0) != "OK":
        fail(f"{stream}: I picture MD5 on the card")
    w, h, n = side["width"], side["height"], side["frames"]
    src = realistic_sequence(w, h, n)
    cfg = EncCfg(
        width=w, height=h, qp=side["qp"], gop="RA",
        gop_size=side["gop_size"], qt_depth=side["qt_depth"],
        inter_block_size=16, search_range=side["search_range"],
        wrap_around=side["wrap_around"], merge=True,
        mm=MMConfig(mpa=True, rot=True))
    profiling.reset()
    profiling.enable(mode == "stages")
    enc = EncLib(cfg)
    dpb = {0: dec.frames[0].numpy()}
    nals, rows = [], []
    mc_kernel.reset_launches()
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for poc, r0, r1, tid in EncLib.ra_coding_order(n, side["gop_size"]):
        before = dict(mc_kernel.LAUNCHES)
        stages_before = profiling.totals()
        prof = None
        if mode == "trace":
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        if r1 < 0:
            nal, res = enc.encode_p_frame(
                poc, src[poc], dpb[r0], r0,
                qp=ctc_qp(side["qp"], "P"))
        else:
            nal, res = enc.encode_b_frame(
                poc, src[poc], dpb[r0], r0, dpb[r1], r1, tid,
                qp=ctc_qp(side["qp"], "B", tid))
        if prof is not None:
            torch.cuda.synchronize()
            prof.stop()
        dpb[poc] = res.recon
        nals += [nal, enc._hash_sei(poc, res.recon, tid)]
        rows.append(dict(
            poc=poc, kind="P" if r1 < 0 else "B", bits=res.bits,
            psnr=(res.psnr_y, res.psnr_u, res.psnr_v),
            seconds=res.seconds,
            stages={k: v - stages_before.get(k, 0.0)
                    for k, v in profiling.totals().items()},
            device_work=device_work(prof) if prof is not None else None,
            launches={k: v - before[k]
                      for k, v in mc_kernel.LAUNCHES.items()}))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_all
    launches = dict(mc_kernel.LAUNCHES)
    profiling.enable(False)
    return dict(label=label, side=side, head=head, nals=nals, rows=rows,
                launches=launches, seconds=seconds,
                stages=profiling.totals())


def check_encode(run: dict, need: tuple, hold_to_sidecar: bool) -> None:
    side = run["side"]
    rec = {p["poc"]: p for p in side["pocs"]}
    for r in run["rows"]:
        ref = rec[r["poc"]]
        print(f"{run['label']} POC {r['poc']} ({r['kind']}): {r['bits']} bits "
              f"(JAX encoder {ref['bits']}), PSNR Y/U/V "
              f"{r['psnr'][0]:.4f}/{r['psnr'][1]:.4f}/{r['psnr'][2]:.4f} dB "
              f"(JAX encoder {ref['psnr_y']:.4f}/{ref['psnr_u']:.4f}/"
              f"{ref['psnr_v']:.4f}), {r['seconds']:.2f} s (host clock), "
              f"launches {r['launches']}")
        if hold_to_sidecar:
            if r["psnr"][0] < ref["psnr_y"] - PSNR_TOL_DB:
                fail(f"POC {r['poc']}: Y-PSNR {r['psnr'][0]:.4f} more than "
                     f"{PSNR_TOL_DB} dB below {ref['psnr_y']:.4f}")
            if r["bits"] > BITS_TOL * ref["bits"]:
                fail(f"POC {r['poc']}: {r['bits']} bits more than 2% above "
                     f"{ref['bits']}")
    print(f"{run['label']}: 4 pictures in {run['seconds']:.2f} s (host "
          f"clock), launches {run['launches']}")
    for name in need:
        if run["launches"][name] == 0:
            fail(f"{run['label']}: the encode did not launch {name}")
    dec = DecLib()
    t0 = time.perf_counter()
    dec.decode_bytes(bs.write_annexb(run["head"] + run["nals"]))
    torch.cuda.synchronize()
    print(f"{run['label']}: own stream decoded on the card in "
          f"{time.perf_counter() - t0:.2f} s, hash {dec.hash_status}")
    if sorted(dec.hash_status) != list(range(side["frames"])) or \
            any(v != "OK" for v in dec.hash_status.values()):
        fail(f"{run['label']}: the port's decoder disagrees with its "
             "encoder on the card")


def stage_shares(stages: dict) -> str:
    total = sum(stages.values())
    return ", ".join(f"{k} {100 * v / total:.1f}%" for k, v in
                     sorted(stages.items(), key=lambda kv: -kv[1]) if v > 0)


def print_stages(run: dict) -> None:
    """Stage shares of a "stages" run, per picture and over the four."""
    for r in run["rows"]:
        print(f"{run['label']} POC {r['poc']} ({r['kind']}) stage shares "
              f"({sum(r['stages'].values()):.2f} s in stages of "
              f"{r['seconds']:.2f} s): {stage_shares(r['stages'])}")
    print(f"{run['label']} stage shares (timers on, each stage "
          f"synchronised; {sum(run['stages'].values()):.2f} s in stages of "
          f"{run['seconds']:.2f} s): {stage_shares(run['stages'])}")


def print_device_work(traced: dict, plain: dict) -> None:
    """Per picture: the device operations torch.profiler traced and their
    device time, against the untraced encode's seconds of that picture."""
    for r, p in zip(traced["rows"], plain["rows"]):
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA device")
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    # ---- 1. build
    t0 = time.perf_counter()
    reports = cuda_lib.build_all()
    print(f"build: {len(reports)} CUDA source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    # ---- 2. card
    card = card_line()
    print(card)

    # ---- 3. kernels vs plain versions
    max_err = check_kernels(MC_MARGIN, dev)

    # ---- 4. decode the 2048x1024 stream on the card
    w, h = 2048, 1024
    path_launches = {}
    side = json.load(open(os.path.join(DATA, BIG + ".json")))
    data = open(os.path.join(DATA, BIG + ".bin"), "rb").read()
    mc_kernel.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = DecLib()
    frames = dec.decode_bytes(data)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = dict(mc_kernel.LAUNCHES)
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
    rec = {p["poc"]: p for p in side["pocs"]}
    if [f.poc for f in frames] != sorted(rec):
        fail(f"decoded POCs {[f.poc for f in frames]}")
    for f in frames:
        planes = f.numpy()
        if any(p.shape != s.shape for p, s in zip(planes, src[f.poc])):
            fail(f"POC {f.poc}: plane shapes")
        ps = [psnr(s, p) for s, p in zip(src[f.poc], planes)]
        ref_psnr = rec[f.poc]["psnr_y"]
        status = dec.hash_status.get(f.poc, "NONE")
        print(f"POC {f.poc}: hash {status}  PSNR Y/U/V "
              f"{ps[0]:.4f}/{ps[1]:.4f}/{ps[2]:.4f} dB  encoder Y/U/V "
              f"{rec[f.poc]['psnr_y']:.4f}/{rec[f.poc]['psnr_u']:.4f}/"
              f"{rec[f.poc]['psnr_v']:.4f} dB")
        if abs(ps[0] - ref_psnr) > PSNR_TOL_DB:
            fail(f"POC {f.poc}: Y-PSNR {ps[0]:.4f} vs encoder "
                 f"{ref_psnr:.4f}")
    if dec.hash_status.get(0) != "OK":
        fail("I picture (POC 0) MD5 mismatch")
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
    card_positions = []
    cpu_reproj = MVReprojection(ERP(w, h), w, h,
                                dec.sps.mm.mm_offset_4x4, device="cpu")
    mismatches = []

    def compare(active, midx, stack, bs):
        on_card = frame_codec.merged_positions(dec2.reproj, active, midx,
                                               stack, bs)
        on_cpu = frame_codec.merged_positions(cpu_reproj, active, midx,
                                              stack, bs)
        diff = (on_card.cpu() != on_cpu).any(-1)
        mismatches.append((int(diff.sum()), diff.numel()))
        card_positions.append(on_card)
        return on_card

    dec2 = DecLib(positions_fn=compare)
    frames2 = dec2.decode_bytes(data)
    for i, (n, tot) in enumerate(mismatches):
        print(f"positions call {i}: {n} of {tot} subblocks differ "
              "card vs CPU")
    print(f"position mismatches card vs CPU: "
          f"{sum(n for n, _ in mismatches)} of "
          f"{sum(t for _, t in mismatches)} subblocks")
    same = [a.md5() == b.md5() for a, b in zip(frames, frames2)]
    print(f"second decode identical to the first: {same}")
    if not all(same):
        fail("the positions hook changed the decode")

    # everything downstream of the positions (MC, bi-combine, dequant,
    # inverse transform, deblock, SAO, ALF) is integer math: the plain
    # versions on the CPU, fed the card's positions in the same order,
    # must give the card's pictures bit for bit
    feed = iter([p.cpu() for p in card_positions])
    t0 = time.perf_counter()
    cpu_frames = DecLib(
        device="cpu",
        positions_fn=lambda *_: next(feed)).decode_bytes(data)
    exact = {a.poc: all(torch.equal(p.cpu(), q)
                        for p, q in zip(a.planes, b.planes))
             for a, b in zip(frames2, cpu_frames)}
    print(f"CPU decode from the card's positions "
          f"({time.perf_counter() - t0:.1f} s, host clock): bit-exact "
          f"with the card per POC {exact}")
    if [f.poc for f in cpu_frames] != [f.poc for f in frames2] \
            or not all(exact.values()):
        fail("the card's reconstruction differs from the CPU's on the "
             "same positions")

    # ---- 6./7. encode on the card, decode the own stream on the card
    mc_kernel.CAPTURED = {}
    for label, stream, need, hold in (
            ("encode 2048x1024", BIG,
             ("mc_luma_positions", "mc_chroma_positions",
              "sad_block_positions", "mc_block_positions"), True),
            ("encode 256x128", SMALL,
             ("mc_luma_positions", "mc_chroma_positions",
              "sad_luma_positions"), False)):
        run = encode_path(label, stream, "plain")
        path_launches[label] = run["launches"]
        check_encode(run, need, hold)
        timed = encode_path(label, stream, "stages")
        traced = encode_path(label, stream, "trace")
        for again in (timed, traced):
            if [n.payload for n in again["nals"]] != \
                    [n.payload for n in run["nals"]]:
                fail(f"{label}: another encode gave other bytes")
        print_stages(timed)
        print_device_work(traced, run)
    captured, mc_kernel.CAPTURED = mc_kernel.CAPTURED, None

    # ---- 8. time the kernels on the main paths' inputs
    positions = card_positions[-1].to(torch.int32).contiguous()
    ref_pic = frames[0].planes
    refp_y = pad_ref(ref_pic[0], MC_MARGIN, True)
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
            mc_bound(refp, positions, s, taps)))
    wanted = (("sad_block_positions", (5, 128, 256, 2), 8),
              ("sad_block_positions", (6, 64, 128, 2), 16),
              ("mc_block_positions", (4, 64, 128, 2), 16),
              ("sad_luma_positions", (5, 32, 64, 2), None),
              ("sad_luma_positions", (5, 8, 32, 2), None))
    for key in wanted:
        if key not in captured:
            fail(f"the encodes never launched {key}; captured "
                 f"{sorted(captured, key=str)}")
    cases = [(k[0], captured[k]) for k in wanted]
    # K5 at the full 2048x1024 grid: not on a main path (that size
    # takes K3/K4), timed on the decode's positions shifted 5 ways
    src_y = torch.as_tensor(
        realistic_sequence(w, h, 2)[1][0].astype(np.int32), device=dev)
    shifts = torch.tensor([(0, 0), (0, -64), (-64, 0), (64, 0), (0, 64)],
                          dtype=torch.int32, device=dev)
    cases.append(("sad_luma_positions", dict(
        ref_padded=refp_y, orig=src_y, margin=MC_MARGIN, s=None,
        bit_depth=8,
        positions=(positions[None] + shifts[:, None, None, :])
        .contiguous())))
    for name, c in cases:
        args = [c["ref_padded"]] + \
            ([c["orig"]] if c["orig"] is not None else []) + \
            [c["positions"], c["margin"]] + \
            ([c["s"]] if c["s"] is not None else []) + [c["bit_depth"]]
        fn = getattr(mc_kernel, name)
        plain = getattr(mc_kernel, name + "_plain")
        label = f"positions {tuple(c['positions'].shape)}" + \
            (f" s={c['s']}" if c["s"] is not None else "")
        timed_cases.append((name, label,
                            lambda fn=fn, a=args: fn(*a),
                            lambda fn=plain, a=args: fn(*a),
                            search_bound(name, c)))
    out = {}
    for name, label, fn, plain, (b_ms, b_by) in timed_cases:
        before = dict(mc_kernel.LAUNCHES)
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(plain, iters=5)
        dev_ms = device_ms(fn)
        mc_kernel.LAUNCHES.update(before)    # timing is not a main path
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
                max_abs_err=max_err[name], ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                cases=[])
        out[name]["cases"].append(case)
    for name, k in out.items():
        if k["launches"] == 0:
            fail(f"no main path launched {name}")
    print(f"smoke run: {time.perf_counter() - t_start:.0f} s in all")
    print(json.dumps({"kernels": list(out.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
