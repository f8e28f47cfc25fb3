"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 -m port_bench.run --workload erp2k-mm-ra16.encode \
        --seed 1234567890123 --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed` (pictures), `metrics` (with `--trace 0` the cell's
end-to-end metrics, with `--trace 1` its per-layer ones), `device`, with
`--trace 1` a `breakdown`, and last `check`: each number compared beside
its limit, which also ends standard error.  Exits non-zero and prints no
result when there is no CUDA device (or fewer than the cell asks for),
when the program is missing, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from port_bench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vvc_mm_tpu")
# The program's host threads, the same on any host.  The bounds' sets ran
# with 4; a probe read an eager operation at 9.5-13.6 us with 1 thread and
# 11-13.8 us with 4, no difference beside the host's own modes.
THREADS = 4


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: `vvc_mm_tpu_torch` is not `vvc_mm_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not read"


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"port_bench: {msg}", file=sys.stderr)
    return 1


def result_line(bench: dict, cell: dict, traffic: dict, res: dict, j,
                trace: bool, kind: str, card: str) -> dict:
    """The result's JSON object: with `trace` the cell's per-layer
    metrics, else its end-to-end ones; the check's numbers last."""
    metrics = {}
    if trace:
        rec = res["record"]
        for m in spec.per_layer(bench, cell["name"]):
            value = spec.load_metric(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rate = res["pictures"] / res["window_s"]
        for m in spec.end_to_end(bench, cell["name"]):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": res["setup_s"], "unit": "s"}
            elif m["name"] == f"{traffic['mode']}_fps":
                metrics[m["name"]] = {"value": rate, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if trace:
        device.update(busy_s=res["busy_s"], window_s=res["traced_window_s"])
    line = {"correct": j.correct, "attempted": res["pictures"],
            "failed": len(j.bad), "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = res["breakdown"]
    line["card"] = card
    line["unit_s"] = res["unit_s"]
    line["window_s"] = res["window_s"]
    line["check"] = j.as_dict()
    return line


def main(argv=None) -> int:
    args = parse(argv)
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the port on a "
                    "GPU and has no CPU fallback")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{cell['name']} asks for {cell['chips']} devices, "
                    f"{torch.cuda.device_count()} found")
    try:
        import vvc_mm_tpu_torch  # noqa: F401
    except ImportError as exc:
        return fail(f"the program is not in this checkout: {exc}")
    from port_bench import check, harness
    torch.set_num_threads(THREADS)
    config = spec.load_config(bench, cell["config"])
    traffic = spec.load_traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    expect = spec.load_expect(cell["name"])
    limits = spec.limits_of(config, expect)
    res = harness.run_cell(config, traffic, args.seed, args.seconds,
                           bool(args.trace), device, T_START)
    workers = check.use_threads()
    t_check = time.perf_counter()
    j = harness.judge(res, traffic, args.seed, limits, workers=workers,
                      expect=expect)
    print(f"port_bench: the reference's check took "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    found = forbidden_modules()
    if found:
        return fail(f"modules of JAX or the JAX package were loaded: "
                    f"{', '.join(found)}")
    line = result_line(bench, cell, traffic, res, j, bool(args.trace),
                       torch.cuda.get_device_name(0), card_line())
    print(json.dumps(line), flush=True)
    for text in j.lines():
        print(text, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
