"""Where kernel D1's time goes on the card (dependent quantization's
trellis, vvc_mm_tpu_torch/csrc/depquant.cu), and its chain floor.

    python3 measure_depquant.py [--out DIR]    (DIR: vvc_mm_tpu_torch/_build)

Needs a CUDA card and the CUDA toolkit (nvcc, cuobjdump).

Phases: each variant below is a copy of depquant.cu built with
-DDQ_CLOCK_MARKS, so that thread 0 of CTAs 0-63 keeps clock64() at D1's
phase boundaries (the loads of the blocks, the order and the rate's first
entries; the terms of every position; the chain; the backtrack; the
epilogue), into vvc_mm_tpu_torch/_build/, one nvcc each, all started
together.  Each runs on Laplacian blocks at the I picture's two shapes at
2048x1024, (896, 8, 8) and (256, 4, 4), QP 34, is held to the plain
version (tolerance 0), and prints the median cycles of each phase over
the CTAs and its device time (chip_smoke.device_ms).

Chain floor: a kernel appended to the copy as it ships runs one warp
through 2^18 steps of the chain's own step (two shuffles of the cost
front, then dest_step) on terms held in registers, so that a step waits
only on the one before.  Its cycles a step are the dependent latency of
one step, n times that a block's floor; its cycles over its CUDA-event
time give the SM clock.  The SASS of that loop and of the n = 64 chain as
it ships go to DIR/depquant.sass, one step of each is printed, and so are
the registers, shared memory and spills that ptxas reports for each kernel
of depquant.cu.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from chip_smoke import card_line, device_ms  # noqa: E402
from vvc_mm_tpu_torch.common import depquant  # noqa: E402
from vvc_mm_tpu_torch.ops import cuda_lib  # noqa: E402

# One thread a block, the 4 destinations in its registers: edits of
# depquant.cu as (text, replacement), or (first text, last text,
# replacement) for the span from one to the other.
ONE_LANE = (
    ("    const int cb = tid >> 2, d = tid & 3;\n"
     "    const bool chains = tid < 32;\n",
     "    const int cb = tid, d = 0;\n"
     "    const bool chains = tid < DQ_BPC;\n"),
    ("    float cost = d == 0 ? 0.0f : DQ_INF;        // the cost of state d",
     "    float cost4[4] = {0.0f, DQ_INF, DQ_INF, DQ_INF};"),
    ("        if (chains) {\n            const int lat = d & 1",
     "    DQ_MARK(3);\n",
     """        if (chains) {
            auto terms = [&](int p, int lat) -> Terms {
                const double* e = sh.e2[p][cb][lat];
                const float* l = sh.lr[p][cb][lat];
                return Terms{e[0], e[1], e[2], l[0], l[1], l[2]};
            };
            Terms cur_t[2] = {terms(0, 0), terms(0, 1)};
#pragma unroll(N ? N : 4)
            for (int p = 0; p < ch; ++p) {
                const int q = min(p + 1, ch - 1);
                const Terms next_t[2] = {terms(q, 0), terms(q, 1)};
                float prev[4];
#pragma unroll
                for (int s = 0; s < 4; ++s) prev[s] = cost4[s];
                uint32_t word = 0;
#pragma unroll
                for (int dd = 0; dd < 4; ++dd) {
                    const int lat = dd & 1, kind = dd >> 1;
                    uint32_t dec;
                    cost4[dd] = dest_step(dd, prev[2 * lat + kind],
                                          prev[2 * lat + 1 - kind],
                                          cur_t[lat], dec);
                    word |= dec << (8 * dd);
                }
                if (cb < nblk) *dec_at(c0 + p, cb) = word;
                cur_t[0] = next_t[0];
                cur_t[1] = next_t[1];
            }
        }
    }
    DQ_MARK(3);
"""),
    ("    float fin = __shfl_sync(0xffffffffu, cost, tid & ~3);",
     "    float fin = cost4[0];"),
    ("        const float c = __shfl_sync(0xffffffffu, cost, "
     "(tid & ~3) + s);", "        const float c = cost4[s];"),
)
# each source cost converted by its bits, not F2F: exact for a zero or a
# normal float
F2D_BITS = (
    ("    const double dmaj = (double)maj, dmn = (double)mn;",
     "    auto f2d = [](float f) {\n"
     "        const uint32_t u = __float_as_uint(f);\n"
     "        return __hiloint2double(\n"
     "            u ? (int)((u >> 3) + 0x38000000u) : 0, (int)(u << 29));\n"
     "    };\n"
     "    const double dmaj = f2d(maj), dmn = f2d(mn);"),)
# (label, edits, nvcc defines)
VARIANTS = (
    ("as shipped: 512 threads, 4 lanes a block", (), ()),
    ("1 lane a block", ONE_LANE, ()),
    ("128 threads", (), ("-DDQ_THREADS=128",)),
    ("256 threads", (), ("-DDQ_THREADS=256",)),
    ("float->double by integer bits", F2D_BITS, ()),
)
SHAPES = ((896, 8, 8), (256, 4, 4))
QP = 34
PHASES = ("loads", "terms", "chain", "backtrack", "epilogue")
LATENCY_STEPS = 1 << 18

# The chain floor's kernel: D1's chain step, one warp, terms in registers
CHAIN_LATENCY = r"""
__global__ void dq_chain_latency(const double* e2, const float* lr,
                                 int steps, long long* cycles, float* sink) {
    const int tid = threadIdx.x, d = tid & 3;
    const int lat = d & 1, kind = d >> 1;
    const int maj_lane = (tid & ~3) + 2 * lat + kind;
    const int mn_lane = (tid & ~3) + 2 * lat + 1 - kind;
    const Terms t{e2[3 * lat], e2[3 * lat + 1], e2[3 * lat + 2],
                  lr[3 * lat], lr[3 * lat + 1], lr[3 * lat + 2]};
    float cost = d == 0 ? 0.0f : DQ_INF;
    uint32_t acc = 0;
    const long long t0 = clock64();
#pragma unroll 16
    for (int i = 0; i < steps; ++i) {
        const float maj = __shfl_sync(0xffffffffu, cost, maj_lane);
        const float mn = __shfl_sync(0xffffffffu, cost, mn_lane);
        uint32_t dec;
        cost = dest_step(d, maj, mn, t, dec);
        acc += dec;
    }
    const long long t1 = clock64();
    if (tid == 0) *cycles = t1 - t0;
    sink[tid] = cost + (float)acc;
}

extern "C" int dq_chain_latency_run(const void* e2, const void* lr,
                                    int steps, void* cycles, void* sink) {
    dq_chain_latency<<<1, 32>>>((const double*)e2, (const float*)lr, steps,
                                (long long*)cycles, (float*)sink);
    return (int)cudaGetLastError();
}
"""


def variant_source(edits, chain_latency: bool) -> str:
    s = open(os.path.join(cuda_lib.CSRC, "depquant.cu")).read()
    for e in edits:
        first, new = e[0], e[-1]
        if s.count(first) != 1:
            raise RuntimeError(f"depquant.cu: no unique {first!r}")
        a = s.index(first)
        b = a + len(first)
        if len(e) == 3:
            b = s.index(e[1], a) + len(e[1])
        s = s[:a] + new + s[b:]
    return s + (CHAIN_LATENCY if chain_latency else "")


def build() -> list[ctypes.CDLL]:
    """One nvcc per variant, all started together."""
    os.makedirs(cuda_lib.BUILD, exist_ok=True)
    jobs = []
    for i, (_, edits, defines) in enumerate(VARIANTS):
        src = os.path.join(cuda_lib.BUILD, f"depquant_marks{i}.cu")
        open(src, "w").write(variant_source(edits, i == 0))
        so = os.path.join(cuda_lib.BUILD, f"libdepquant_marks{i}.so")
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-DDQ_CLOCK_MARKS",
               *defines, "-o", so, src]
        jobs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True),
                     so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = []
    for proc, so in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out}")
        lib = ctypes.CDLL(so)
        lib.quantize_dep.argtypes = [P, I, I, P, P, F, F, I, P, P, P]
        lib.dq_clk_marks_read.argtypes = [P]
        libs.append(lib)
    libs[0].dq_chain_latency_run.argtypes = [P, P, I, P, P]
    return libs


def chain_latency(lib) -> tuple[float, float]:
    """(cycles a chain step, SM clock in GHz): medians of 5 runs."""
    dev = torch.device("cuda")
    e2 = torch.tensor([0.25, 0.0625, 0.5625, 1.0, 0.01, 2.25],
                      dtype=torch.float64, device=dev)
    lr = torch.tensor([0.7, 2.5, 3.1, 0.7, 2.9, 3.3], device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.empty(32, device=dev)
    runs = []
    for _ in range(6):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        if lib.dq_chain_latency_run(e2.data_ptr(), lr.data_ptr(),
                                    LATENCY_STEPS, cycles.data_ptr(),
                                    sink.data_ptr()):
            raise RuntimeError("dq_chain_latency failed to launch")
        t1.record()
        torch.cuda.synchronize()
        cyc = int(cycles.item())
        runs.append((cyc / LATENCY_STEPS, cyc / (t0.elapsed_time(t1) * 1e6)))
    step, ghz = np.median(np.array(runs[1:]), axis=0)   # the first warms up
    return float(step), float(ghz)


def one_step(sass: str, function: str) -> str:
    """One step of `function`'s unrolled chain: from a shuffle of one
    source lane to the next."""
    body = sass[sass.index(function):]
    end = body.find("Function :", len(function))
    body = body if end < 0 else body[:end]
    ops = [re.sub(r"^\s*/\*[0-9a-f]+\*/\s*", "", ln).split(";")[0].strip()
           for ln in body.splitlines() if ";" in ln and "/*" in ln]
    shfl = [i for i, o in enumerate(ops) if "SHFL.IDX" in o]
    if not shfl:
        return "(no shuffle)"
    lane = ops[shfl[0]].split(",")[3].strip()
    steps = [i for i in shfl if ops[i].split(",")[3].strip() == lane]
    if len(steps) < 3:
        return f"(no unrolled chain: {len(steps)} steps)"
    mid = len(steps) // 2
    return "\n".join(ops[steps[mid - 1]:steps[mid] + 1])


def ptxas_lines(report: str) -> list[str]:
    """Registers, shared memory and spills of each kernel in a ptxas -v
    report: one line a kernel."""
    lines, entry, spill = [], "", ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            lines.append(f"{entry}: {line.split(':', 1)[-1].strip()}; "
                         f"{spill}")
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=cuda_lib.BUILD)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("measure_depquant.py needs a CUDA card")
    card = card_line()
    print(card)
    print("ptxas -v, depquant.cu as it ships:")
    for line in ptxas_lines(cuda_lib.build_all()["depquant"]):
        print("  " + line)
    libs = build()
    step, ghz = chain_latency(libs[0])
    print(f"chain step: {step:.2f} cycles of dependent latency, SM clock "
          f"{ghz:.3f} GHz; {card}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    for b, s, _ in SHAPES:
        n, l2 = s * s, s.bit_length() - 1
        print(f"chain floor at n = {n}: {n * step:.0f} cycles, "
              f"{n * step / ghz * 1e-6:.5f} ms at {ghz:.3f} GHz")
        yy, xx = np.mgrid[0:s, 0:s]
        c = torch.from_numpy((rng.laplace(0, 1, (b, s, s)) * 400.0
                              / (1 + yy + xx) ** 1.3).round()
                             .astype(np.int32)).to(dev)
        p = depquant.dq_params(QP, l2, l2, 8)
        order = depquant._order(l2, l2, dev)
        rate = depquant._rate_table(dev)
        want = depquant.quantize_dep_plain(c, QP, l2, l2)
        for (label, _, _), lib in zip(VARIANTS, libs):
            out = torch.empty_like(c)

            def launch(lib=lib, out=out):
                err = lib.quantize_dep(
                    c.data_ptr(), b, n, order.data_ptr(), rate.data_ptr(),
                    p["xscale"], p["lam_h"], 0, None, out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed with error {err}")
            launch()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                sys.exit(f"{label} at {(b, s, s)} differs from the plain "
                         "version")
            ms = device_ms(launch, iters=50, tag="quantize_dep_kernel")
            launch()
            torch.cuda.synchronize()
            clk = np.zeros(512, np.int64)
            if lib.dq_clk_marks_read(clk.ctypes.data):
                raise RuntimeError("reading the clock marks failed")
            marks = clk.reshape(64, 8)[:min(64, (b + 7) // 8), :6]
            cyc = np.median(np.diff(marks, axis=1), axis=0)
            total = np.median(marks[:, 5] - marks[:, 0])
            alone = "not measured" if ms is None else f"{ms:.4f} ms"
            print(f"D1 {(b, s, s)} {label}: device {alone}; cycles "
                  + ", ".join(f"{k} {v:.0f}" for k, v in zip(PHASES, cyc))
                  + f", in all {total:.0f} ({total / (n * step):.2f}x the "
                  f"chain floor); chain {cyc[2] / n:.1f} a position; "
                  f"{card}")
    cuobjdump = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass",
         os.path.join(cuda_lib.BUILD, "libdepquant_marks0.so")],
        capture_output=True, text=True, check=True).stdout
    os.makedirs(args.out, exist_ok=True)
    open(os.path.join(args.out, "depquant.sass"), "w").write(sass)
    print("one step of the chain floor's loop:")
    print(one_step(sass, "Function : _Z16dq_chain_latency"))
    print("one step of the chain as it ships (n = 64):")
    print(one_step(sass, "Function : _Z19quantize_dep_kernelILi64ELb0EEv"))


if __name__ == "__main__":
    main()
