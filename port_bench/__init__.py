"""The benchmark of `vvc_mm_tpu_torch`, the PyTorch and CUDA port, on one
NVIDIA GPU.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

`BENCHMARK.json` at the root of the checkout names the cells; each cell's
configuration, traffic mix and per-layer metrics are files of their own
under `configs/`, `traffic/` and `metrics/`, found by name (`spec.py`).
The yardstick lives here and nowhere in the program: the clip generator
(`clip.py`), the profiler reader (`devtrace.py`), the kernels' operation
and byte counts (`counts.py`), and the plain reference decoder that
decides `correct` (`refcodec/`, a frozen copy; `check.py`).  Nothing here
imports JAX or the JAX package `vvc_mm_tpu`; only `program.py` imports
the port.
"""
