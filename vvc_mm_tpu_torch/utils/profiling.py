"""Per-stage encoder timers (INTERPRED_PROFILING analog).

PyTorch counterpart of `vvc_mm_tpu/utils/profiling.py` (reference: the MM
extension's profiling build, InterPrediction.h:194-215, TypeDef.h:140
INTERPRED_PROFILING).  Times the frame pipeline's STAGES: search, select,
finish, entropy, filters.

Off by default (zero overhead beyond a flag test); enable with
VVC_PROFILE=1 or `enable()`.  CUDA work is asynchronous, so a stage that
names a device with `set_sync` waits for that device on exit
(`torch.cuda.synchronize`) and is charged its device work — profiling
serializes the pipeline, so the speed WITH profiling is not the production
speed.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict

import torch

ENABLED = os.environ.get("VVC_PROFILE", "") not in ("", "0")

_acc: dict[str, float] = defaultdict(float)
_cnt: dict[str, int] = defaultdict(int)


def enable(on: bool = True) -> None:
    global ENABLED
    ENABLED = on


class stage:
    """Context manager: `with profiling.stage("mm_search") as ps: ...;
    ps.set_sync(device)`."""

    def __init__(self, name: str, sync=None) -> None:
        self.name = name
        self.sync = sync
        self._t0 = 0.0

    def __enter__(self):
        if ENABLED:
            self._t0 = time.perf_counter()
        return self

    def set_sync(self, sync) -> None:
        """`sync`: a device, or a tensor whose device is waited for."""
        self.sync = sync

    def __exit__(self, *exc):
        if not ENABLED:
            return False
        dev = getattr(self.sync, "device", self.sync)
        if dev is not None and torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)
        _acc[self.name] += time.perf_counter() - self._t0
        _cnt[self.name] += 1
        return False


def totals() -> dict[str, float]:
    """Seconds per stage so far."""
    return dict(_acc)


def report() -> str:
    if not _acc:
        return "profiling: no stages recorded (set VVC_PROFILE=1)"
    total = sum(_acc.values())
    lines = [f"{'stage':<18}{'total s':>10}{'calls':>8}{'ms/call':>10}"
             f"{'share':>8}"]
    for k in sorted(_acc, key=lambda k: -_acc[k]):
        lines.append(f"{k:<18}{_acc[k]:>10.2f}{_cnt[k]:>8d}"
                     f"{1000.0 * _acc[k] / max(_cnt[k], 1):>10.1f}"
                     f"{100.0 * _acc[k] / total:>7.1f}%")
    lines.append(f"{'TOTAL':<18}{total:>10.2f}")
    return "\n".join(lines)


def reset() -> None:
    _acc.clear()
    _cnt.clear()
