"""Read the check's numbers of sound runs, of the control and of the
planted faults, at a cell's own size, on several seeds in one process.

    python3 -m port_bench.control --workload erp2k-mm-ra16.encode \
        --seeds 11 12 13 --seconds 1 [--faults stale lsb search] \
        [--fault-seeds 3] [--no-warmup] [--trace-first] [--out FILE]

For each seed: the cell's set-up and a window of `--seconds` (it closes
after the first whole unit at or after it), then the check of the
window's outputs as they came (sound), and of the same outputs with each
of faults.KINDS planted (`lsb` is the control); for the first
`--fault-seeds` seeds, a window with each of faults.PROGRAM_KINDS
planted in the program.  One JSON line a seed, on standard output and
appended to `--out`, with the numbers compared and the first unit's bits
(`info`, which `expect/<cell>.json` is set from).  The
reference decodes each window's streams in processes of their own while
the next seed runs.  The limits are set from these readings (PERF.md).
Needs a CUDA device, as `run.py` does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from port_bench import check, faults, harness, spec

REFERENCE_JOBS = 4        # seeds whose reference decodes run at once


def _streams_to_check(res: dict, traffic: dict, seed: int) -> list[bytes]:
    """The streams the check of `res` decodes (the faults planted
    afterwards may ask for more, which it decodes itself)."""
    if res["mode"] == "decode":
        return list(res["streams_of_unit"])
    outputs = res["outputs"]
    return [outputs[u].data for u in check.sample_units(
        len(outputs), traffic.get("check_units", 1), seed)]


def _judge_seed(row: dict, runs: dict, after: list, traffic: dict,
                limits: dict, expect: dict | None) -> str:
    seed = row["seed"]
    for name, res in runs.items():
        cache: dict = {}
        check.reference_decode_many(_streams_to_check(res, traffic, seed),
                                    cache, own_process=True)
        for fault in ([None, *after] if name == "sound" else [None]):
            t = time.perf_counter()
            j = harness.judge(res, traffic, seed, limits, fault, cache,
                              expect=expect)
            row["checks"][fault or name] = dict(
                correct=j.correct, numbers=j.numbers, info=j.info,
                errors=j.errors, seconds=time.perf_counter() - t)
    return json.dumps(row)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--faults", nargs="*",
                   default=[*faults.KINDS, *faults.PROGRAM_KINDS])
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--trace-first", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA device", file=sys.stderr)
        return 1
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    config = spec.load_config(bench, cell["config"])
    traffic = spec.load_traffic(cell["traffic"])
    if args.no_warmup:
        traffic = dict(traffic, warmup=None)
    expect = spec.load_expect(args.workload)
    limits = spec.limits_of(config, expect)
    after = [k for k in args.faults if k in faults.KINDS]
    planted = [k for k in args.faults if k in faults.PROGRAM_KINDS]
    device = torch.device("cuda", 0)
    torch.set_num_threads(4)
    pending = []
    with ThreadPoolExecutor(REFERENCE_JOBS) as pool:
        for i, seed in enumerate(args.seeds):
            trace = args.trace_first and i == 0
            res = harness.run_cell(config, traffic, seed, args.seconds, trace,
                                   device, time.perf_counter())
            row = dict(workload=args.workload, seed=seed,
                       setup_s=res["setup_s"], window_s=res["window_s"],
                       units=res["units"], pictures=res["pictures"],
                       rate=res["pictures"] / res["window_s"], checks={})
            if trace:
                row["per_layer"] = {
                    m["name"]: spec.load_metric(m["name"]).read(res["record"])
                    for m in spec.per_layer(bench, args.workload)}
                row["kernels"] = res["record"]["kernels"]
            runs = {"sound": res}
            for kind in planted if i < args.fault_seeds else []:
                runs[kind] = harness.run_cell(
                    config, traffic, seed, args.seconds, False, device,
                    time.perf_counter(), fault=kind)
            pending.append(pool.submit(_judge_seed, row, runs, after,
                                       traffic, limits, expect))
            del res, runs
            while pending and pending[0].done():
                _emit(pending.pop(0).result(), args.out)
        for job in pending:
            _emit(job.result(), args.out)
    return 0


def _emit(text: str, out: str | None) -> None:
    print(text, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    sys.exit(main())
