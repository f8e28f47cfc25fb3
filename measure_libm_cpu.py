"""Host time of the plain float32 sinf/cosf (vvc_mm_tpu_torch/common/
libm_f32.py) in its two forms, on one CPU thread.

    python3 measure_libm_cpu.py [--n N] [--repeat R]

The shipped sinf/cosf run a first pass with each double operation rounded
on its own and hand only the elements near a float32 rounding boundary
(and |x| >= 120, tiny and special values) to glibc's exact arithmetic
(_sincos_exact); the other form runs _sincos_exact on every element.  Both
run on the same N seeded angles in [-4, 4) (the range of the sphere
positions' angles), must give the same bits, and their median time over R
calls is printed.  No card is needed.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from vvc_mm_tpu_torch.common import libm_f32 as plain


def median_ms(fn, x: torch.Tensor, repeat: int) -> float:
    fn(x)
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn(x)
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--repeat", type=int, default=10)
    args = ap.parse_args()
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(args.n, generator=g, dtype=torch.float64) * 8 - 4
         ).to(torch.float32)
    for want_cos, name in ((False, "sinf"), (True, "cosf")):
        two_pass = plain._sincos_core(x, want_cos)
        exact = plain._sincos_exact(x, want_cos)
        if not torch.equal(two_pass.view(torch.int32),
                           exact.view(torch.int32)):
            raise SystemExit(f"{name}: the two forms disagree")
        t_two = median_ms(lambda v: plain._sincos_core(v, want_cos), x,
                          args.repeat)
        t_exact = median_ms(lambda v: plain._sincos_exact(v, want_cos), x,
                            args.repeat)
        print(f"{name} on {args.n} angles, one thread: two passes "
              f"{t_two:.1f} ms, exact arithmetic alone {t_exact:.1f} ms "
              f"(median of {args.repeat}); the same bits")


if __name__ == "__main__":
    main()
