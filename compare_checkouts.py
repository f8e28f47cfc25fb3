"""Run the port of one or more checkouts of this repository on one GPU and
compare them: the headline stream's SHA-256, the host time of a kernel
wrapper call and the device time of the MC kernels K1 and K2 and of the
subblock SAD kernels K5 and K6.

    python3 compare_checkouts.py [CHECKOUT ...]

For each checkout (default: this one), in the order given and each in a
process of its own, the checkout's own code builds its CUDA kernels, runs
`EncLib(cfg).encode_sequence` on the card for the headline configuration
of its `chip_smoke.py` (2048x1024 ERP, RA GOP 16, 17 frames, MPA+ROT, QP
37), and times 300 back-to-back calls of the K5 wrapper
`sad_luma_positions` on the 256x128 search's smallest grid (5, 8, 32, 2),
whose kernel takes a few microseconds: the mean is the wrapper's host
time.  Then it times K1 (`mc_luma_positions`) and K2
(`mc_chroma_positions`) through the checkout's own wrappers and its
`chip_smoke.device_ms` on one 2048x1024 picture of the headline clip and
coherent 256x512 subblock positions, made from a fixed seed and the same
for every checkout, and K5 (`sad_luma_positions`) and K6
(`sad_bilinear_positions`) the same way on two grids of five fields (those
positions shifted by 0 or 1 pel along x or y; 4 pel on the full grid): a
search grid of the 256x128 configuration, (5, 32, 64, 2) on one picture of
its clip, and the full (5, 256, 512, 2) grid on the 2048x1024 picture,
with the next picture as the original.  One JSON line per checkout gives
the stream's SHA-256 and length, the sequence's seconds (host clock,
synchronised), the launches of each kernel (those the checkout's
`chip_smoke.all_launches` counts), the wrapper's microseconds and
K1's, K2's, K5's and K6's device milliseconds.  The last line is
`{"same": true|false, ...}`: whether every encode gave the same bytes.
Give the parent first and last to interleave (parent, change, change,
parent); a changed kernel whose decisions are the same leaves the hash as
it was.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time


def encode_one(checkout: str) -> dict:
    """Import `checkout`'s chip_smoke.py (which puts the checkout first on
    sys.path) and encode its headline configuration on the card."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(checkout, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    import vvc_mm_tpu_torch
    if not os.path.abspath(vvc_mm_tpu_torch.__file__).startswith(checkout):
        raise RuntimeError(f"imported {vvc_mm_tpu_torch.__file__}, not the "
                           f"package of {checkout}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    smoke.cuda_lib.build_all()
    w, h = 2048, 1024
    cfg = smoke.headline_cfg(w, h, 37, smoke.HEADLINE_GOP)
    clip = smoke.realistic_sequence(w, h, smoke.HEADLINE_FRAMES)
    smoke.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = smoke.EncLib(cfg).encode_sequence(clip)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(smoke.all_launches())
    return dict(checkout=checkout, sha256=hashlib.sha256(data).hexdigest(),
                bytes=len(data), seconds=seconds, launches=launches,
                wrapper_us=wrapper_us(smoke.mc_kernel, torch),
                mc_device_ms=mc_device_ms(smoke, torch, clip[0]),
                sad_device_ms=sad_device_ms(smoke, torch, clip),
                device=torch.cuda.get_device_name(0))


def coherent_positions(nsy: int, nsx: int, seed: int = 5):
    """(nsy, nsx, 2) int32 1/16-pel subblock positions as merged MM
    positions come: each subblock at its own place plus a motion that
    varies smoothly over the picture (up to 12 pel), neighbours within
    1.5 pel of it."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(nsy), np.arange(nsx), indexing="ij")
    motion = np.stack([np.sin(ys / 17.0) * 96 + np.cos(xs / 23.0) * 96,
                       np.cos(ys / 13.0) * 96 + np.sin(xs / 29.0) * 96], -1)
    pos = np.stack([xs * 64, ys * 64], -1) + motion.astype(np.int64) + \
        rng.integers(-24, 24, (nsy, nsx, 2))
    return pos.astype(np.int32)


def mc_device_ms(smoke, torch, frame) -> dict:
    """K1's and K2's device ms (the checkout's `chip_smoke.device_ms`) on
    `frame`'s luma and first chroma plane, padded as the codec pads them,
    at coherent positions."""
    dev = torch.device("cuda")
    pos = torch.as_tensor(coherent_positions(frame[0].shape[0] // 4,
                                             frame[0].shape[1] // 4),
                          device=dev)
    out = {}
    for name, plane, m in (("mc_luma_positions", frame[0], smoke.MC_MARGIN),
                           ("mc_chroma_positions", frame[1],
                            smoke.MC_MARGIN // 2)):
        ref = smoke.pad_ref(torch.as_tensor(plane.astype("int32"),
                                            device=dev), m, True)
        fn = getattr(smoke.mc_kernel, name)
        out[name] = smoke.device_ms(lambda: fn(ref, pos, m, 8))
    return out


def sad_device_ms(smoke, torch, clip) -> dict:
    """K5's and K6's device ms (the checkout's `chip_smoke.device_ms`) on a
    (5, 32, 64, 2) grid of the 256x128 clip and on the full (5, 256, 512,
    2) grid of `clip`: the first picture's padded luma as the reference,
    the second's as the original, five fields of coherent positions."""
    dev = torch.device("cuda")
    out = {}
    for label, frames, step in (
            ("(5, 32, 64, 2)", smoke.realistic_sequence(256, 128, 2), 16),
            ("(5, 256, 512, 2)", clip, 64)):
        h, w = frames[0][0].shape
        ref = smoke.pad_ref(torch.as_tensor(frames[0][0].astype("int32"),
                                            device=dev), smoke.MC_MARGIN,
                            True)
        orig = torch.as_tensor(frames[1][0].astype("int32"), device=dev)
        shifts = torch.tensor([(0, 0), (0, -step), (-step, 0), (step, 0),
                               (0, step)], dtype=torch.int32, device=dev)
        pos = torch.as_tensor(coherent_positions(h // 4, w // 4), device=dev)
        pos = (pos[None] + shifts[:, None, None, :]).contiguous()
        m = smoke.MC_MARGIN
        luma, bilin = (smoke.mc_kernel.sad_luma_positions,
                       smoke.mc_kernel.sad_bilinear_positions)
        out[label] = dict(
            sad_luma_positions=smoke.device_ms(
                lambda: luma(ref, orig, pos, m, 8)),
            sad_bilinear_positions=smoke.device_ms(
                lambda: bilin(ref, orig, pos, m)))
    return out


def wrapper_us(mc_kernel, torch) -> float:
    """Mean microseconds of one K5 wrapper call on a (5, 8, 32, 2) grid,
    300 calls back to back between CUDA events."""
    dev = torch.device("cuda")
    ref = torch.zeros(128 + 160, 256 + 160, dtype=torch.int32, device=dev)
    orig = torch.zeros(32, 128, dtype=torch.int32, device=dev)
    pos = torch.zeros(5, 8, 32, 2, dtype=torch.int32, device=dev)
    for _ in range(10):
        mc_kernel.sad_luma_positions(ref, orig, pos, 80, 8)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(300):
        mc_kernel.sad_luma_positions(ref, orig, pos, 80, 8)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 300 * 1e3


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(encode_one(os.path.abspath(sys.argv[2]))))
        return
    here = os.path.dirname(os.path.abspath(__file__))
    results = []
    for checkout in sys.argv[1:] or [here]:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             os.path.abspath(checkout)], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            sys.exit(f"the encode of {checkout} failed")
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    hashes = sorted({r["sha256"] for r in results})
    print(json.dumps({"same": len(hashes) == 1, "sha256": hashes}))
    if len(hashes) != 1:
        sys.exit(1)


if __name__ == "__main__":
    main()
