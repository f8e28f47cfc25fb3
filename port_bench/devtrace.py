"""Read a `torch.profiler` trace of the device: its operations, the time
the device was busy, and where it stood idle.

Frozen from `chip_smoke.py` (`device_events`, `_profiler`): the raw
records of the profiler are read (`prof.profiler.kineto_results`), not
`prof.events()`, which costs about 0.1 ms an event.  Busy time is the
union of the operations' intervals, not their sum.  Device and host
clocks are tied by marker kernels (`torch.cuda._sleep`, traced as
`spin_kernel`) launched right after a synchronise at a known host time.
"""
from __future__ import annotations

import re
import time

MARKER = "spin_kernel"
MARKER_CYCLES = 2000


def profiler():
    """Device activity only: tracing the host side of each operation
    slows the traced run several times over."""
    import torch
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def mark() -> int:
    """Launch a marker kernel once the device is idle; the host's
    perf_counter_ns at the launch."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    torch.cuda._sleep(MARKER_CYCLES)
    return t


def device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every device operation of a profile,
    in the profiler's clock."""
    from torch.autograd import DeviceType
    raw = prof.profiler.kineto_results
    out = []
    for e in raw.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns()))
    out.sort(key=lambda r: r[1])
    return out


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The union of (start, end) intervals, as disjoint sorted ones."""
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_ns(intervals: list[tuple[int, int]], lo: int, hi: int) -> int:
    """Nanoseconds in [lo, hi] covered by at least one interval."""
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in union(intervals))


def idle_gaps(intervals: list[tuple[int, int]], lo: int, hi: int
              ) -> list[tuple[int, int]]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, at = [], lo
    for s, e in union(intervals):
        if e <= lo or s >= hi:
            continue
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    return gaps


def family_pattern(tag: str) -> re.Pattern:
    """Finds a kernel family's name in a device operation's name as a
    word's start (`quantize_dep_kernel` is not `dequantize_dep_kernel`),
    with or without a return type or template arguments around it."""
    return re.compile(r"(?<![A-Za-z0-9_])" + re.escape(tag))


class Spans:
    """The benchmark's host spans, (label, start ns, end ns) on
    perf_counter_ns."""

    def __init__(self) -> None:
        self.spans: list[tuple[str, int, int]] = []
        self._open: list[tuple[str, int]] = []

    def begin(self, label: str) -> None:
        self._open.append((label, time.perf_counter_ns()))

    def end(self) -> None:
        label, t0 = self._open.pop()
        self.spans.append((label, t0, time.perf_counter_ns()))

    def label_points(self, points: list[int]) -> list[str]:
        """For each host ns in `points`, the labels of the spans open
        there, outermost first and "/"-joined, or "outside"."""
        edges = sorted([(s, 0, i) for i, (_, s, _) in enumerate(self.spans)]
                       + [(e, 1, i) for i, (_, _, e) in enumerate(self.spans)])
        order = sorted(range(len(points)), key=points.__getitem__)
        labels = [""] * len(points)
        active: list[int] = []
        k = 0
        for q in order:
            t = points[q]
            while k < len(edges) and edges[k][0] <= t:
                _, is_end, i = edges[k]
                if is_end:
                    active.remove(i)
                else:
                    active.append(i)
                k += 1
            labels[q] = "/".join(self.spans[i][0] for i in active) \
                or "outside"
        return labels


def breakdown(events, gaps, offset_ns: int, spans: Spans, top: int = 10
              ) -> dict:
    """The device operations that took most time (by name, seconds
    summed) and the idle time by what the host was doing (the label of
    the host span at each gap's midpoint, seconds summed), longest first,
    `top` of each."""
    by_op: dict[str, float] = {}
    for name, s, e in events:
        key = name if len(name) <= 96 else name[:93] + "..."
        by_op[key] = by_op.get(key, 0.0) + (e - s) * 1e-9
    by_gap: dict[str, float] = {}
    labels = spans.label_points([(s + e) // 2 - offset_ns for s, e in gaps])
    for (s, e), key in zip(gaps, labels):
        by_gap[key] = by_gap.get(key, 0.0) + (e - s) * 1e-9

    def order(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": order(by_op), "idle_gaps": order(by_gap)}
