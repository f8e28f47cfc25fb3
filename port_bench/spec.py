"""Find a cell's parts by the names in BENCHMARK.json.

A configuration is `configs/<name>.json` (the `file` its entry names), a
traffic mix `traffic/<name>.json`, a per-layer metric `metrics/<name>.py`
(a reader: `read(record) -> float | None`), what an encode cell's sound
first unit gives `expect/<cell>.json`.  Adding a cell, a
configuration, a mix or a metric adds files and entries; no file here
names one of them.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")


def load_benchmark(path: str = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def load_config(bench: dict, name: str, root: str = ROOT) -> dict:
    entry = _by_name(bench["configs"], name, "configuration")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def load_traffic(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        return json.load(f)


def load_expect(cell: str, root: str = HERE) -> dict | None:
    """`expect/<cell>.json`, what a sound encoder gives for the cell's
    first unit and the limits of the excess over it (`check.py`), or
    None where the cell has none."""
    path = os.path.join(root, "expect", f"{cell}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def limits_of(config: dict, expect: dict | None) -> dict:
    """The limits of a cell's check: its configuration's, with its
    expect file's."""
    return {**config["check"], **(expect or {}).get("limits", {})}


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"] if _applies(m, cell)]


def per_layer(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric it reports."""
    mine = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in mine)]


def load_metric(name: str, root: str = HERE):
    """The reader module of a per-layer metric."""
    path = os.path.join(root, "metrics", f"{name}.py")
    mod_name = "port_bench.metrics." + name.replace(".", "__")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
