"""The program's own spans (`vvc_mm_tpu_torch/utils/profiling.py`): what
the span metrics read, and a table keyed by span path with each device
operation of a traced unit put down to the innermost span open when the
host launched it (`table`, for `harness._traced` to call once a
`benchmark` change wires it in; until then no run writes it).

A launch's host time is the start of the CUDA runtime record (the
`cudaLaunchKernel` / `cudaMemcpyAsync` call) that shares the operation's
correlation id in the profiler's raw records (`launch_times`), moved onto
the host's perf_counter_ns by the marker kernel's own runtime record (or,
without one, by the device offset).  An operation without such a record
is put down by its device start instead; `attribution` counts which way
each went.

The metric readers: in a traced run the benchmark's stage timers
(`profiling.enable`) turn the program's tracer on for the traced unit
alone, so the spans it recorded, and the `host_waits` counted into them,
are the unit's; they are read without being taken out.  A program
without a tracer, or a run without a traced unit, gives them nothing to
read.
"""
from __future__ import annotations

from . import devtrace

DTOH, HTOD = "Memcpy DtoH", "Memcpy HtoD"


def launch_times(prof) -> dict[tuple[str, int], int]:
    """(name, device start ns) of each device operation -> the profiler-
    clock start of its runtime record; empty where the profile has no
    raw records or none are linked."""
    try:
        from torch.autograd import DeviceType
        events = prof.profiler.kineto_results.events()
    except (AttributeError, ImportError, RuntimeError):
        return {}
    runtime: dict[int, int] = {}
    device: list[tuple[str, int, int]] = []
    for e in events:
        corr = e.correlation_id()
        if not corr:
            continue
        if e.device_type() == DeviceType.CUDA:
            device.append((e.name(), e.start_ns(), corr))
        else:
            runtime.setdefault(corr, e.start_ns())
    return {(name, start): runtime[corr] for name, start, corr in device
            if corr in runtime}


def _kind(sp) -> str:
    attrs = sp.attrs or {}
    if sp.name == "gc" and "generation" in attrs:
        return "gc"
    if "poc" in attrs:
        return "picture"
    if "seq" in attrs:
        return "sequence"
    return "root" if sp.parent is None else "stage"


def _key(sp) -> str:
    """A span's table key: its path, a gc span's with its generation
    (`gc.2`: a full collection)."""
    path = sp.path()
    return f"{path}.{sp.attrs['generation']}" if _kind(sp) == "gc" else path


def _staged(sp) -> bool:
    """Whether the span is a stage or lies inside one."""
    while sp is not None:
        if _kind(sp) == "stage":
            return True
        sp = sp.parent
    return False


def innermost(spans: list, points: list[int]) -> list:
    """For each host ns in `points`, the innermost span open there, or
    None."""
    inf = float("inf")
    edges = sorted([(s.t0, 0, i) for i, s in enumerate(spans)]
                   + [(inf if s.t1 is None else s.t1, 1, i)
                      for i, s in enumerate(spans)])
    order = sorted(range(len(points)), key=points.__getitem__)
    out: list = [None] * len(points)
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
        out[q] = spans[active[-1]] if active else None
    return out


def table(spans: list, ops: list[tuple[str, int, int]], gaps, lo: int,
          hi: int, offset_ns: int, launches: dict, launch_offset_ns: int
          ) -> tuple[dict, dict]:
    """The span table and its check.

    `spans`: the program's spans (take_spans()); `ops`: the traced
    window's device operations (name, start, end; device clock); `gaps`:
    its idle gaps; [lo, hi]: the window; `offset_ns`: device - host ns;
    `launches`: launch_times(); `launch_offset_ns`: runtime-record clock -
    host ns.  Each entry: calls, seconds, self_s (less its children's),
    device_ops, device_busy_s (the union of their intervals in the
    window), launches (hand-written kernels), host_waits, idle_s (idle
    gaps whose midpoint fell in the span, innermost), and every other
    counter charged to the span (`nvcc_compiles` of a set-up's builds).
    "outside" holds the operations and idle time in no span."""
    entries: dict[str, dict] = {}
    paths = {id(sp): _key(sp) for sp in spans}

    def entry(path: str) -> dict:
        return entries.setdefault(path, dict(
            calls=0, seconds=0.0, self_s=0.0, device_ops=0,
            device_busy_s=0.0, launches=0, host_waits=0, idle_s=0.0))
    child_s: dict[int, float] = {}
    for sp in spans:
        if sp.t1 is not None and sp.parent is not None:
            child_s[id(sp.parent)] = (child_s.get(id(sp.parent), 0.0)
                                      + (sp.t1 - sp.t0) * 1e-9)
    for sp in spans:
        e = entry(paths[id(sp)])
        e["calls"] += 1
        if sp.t1 is not None:
            dur = (sp.t1 - sp.t0) * 1e-9
            e["seconds"] += dur
            e["self_s"] += dur - child_s.get(id(sp), 0.0)
        for key, n in (sp.counts or {}).items():
            e[key] = e.get(key, 0) + n
    by_runtime = 0
    points = []
    for name, start, _ in ops:
        rt = launches.get((name, start))
        if rt is not None:
            by_runtime += 1
            points.append(rt - launch_offset_ns)
        else:
            points.append(start - offset_ns)
    intervals: dict[str, list] = {}
    for (_, start, end), sp in zip(ops, innermost(spans, points)):
        path = "outside" if sp is None else paths[id(sp)]
        entry(path)["device_ops"] += 1
        intervals.setdefault(path, []).append((start, end))
    for path, iv in intervals.items():
        entries[path]["device_busy_s"] = devtrace.busy_ns(iv, lo, hi) * 1e-9
    mids = [(s + e) // 2 - offset_ns for s, e in gaps]
    idle = staged_idle = 0.0
    for (s, e), sp in zip(gaps, innermost(spans, mids)):
        path = "outside" if sp is None else paths[id(sp)]
        entry(path)["idle_s"] += (e - s) * 1e-9
        idle += (e - s) * 1e-9
        if sp is not None and _staged(sp):
            staged_idle += (e - s) * 1e-9
    unit = [sp for sp in spans if paths[id(sp)].startswith("unit/")
            and sp.t1 is not None]
    pic_s = sum((sp.t1 - sp.t0) * 1e-9 for sp in unit
                if _kind(sp) == "picture")
    staged_s = sum((c.t1 - c.t0) * 1e-9 for c in unit
                   if _kind(c) == "stage" and _kind(c.parent) == "picture")
    check = dict(
        attribution={"runtime_record": by_runtime,
                     "device_start": len(ops) - by_runtime},
        device_ops=len(ops),
        outside_ops=entries.get("outside", {}).get("device_ops", 0),
        memcpy_dtoh=sum(1 for name, _, _ in ops if DTOH in name),
        memcpy_htod=sum(1 for name, _, _ in ops if HTOD in name),
        picture_s=pic_s,
        stage_cover_pct=100.0 * staged_s / pic_s if pic_s > 0 else None,
        idle_staged_pct=100.0 * staged_idle / idle if idle > 0 else None)
    return entries, check


def picture_means(spans: list, root: str = "unit") -> dict[str, float]:
    """Mean seconds of the picture spans under the root span `root`, by
    kind."""
    xs: dict[str, list[float]] = {}
    for sp in spans:
        if _kind(sp) == "picture" and sp.t1 is not None \
                and sp.path().startswith(root + "/"):
            xs.setdefault(sp.name, []).append((sp.t1 - sp.t0) * 1e-9)
    return {k: sum(v) / len(v) for k, v in sorted(xs.items())}


def decode_stage_pct(rec: dict, name: str) -> float | None:
    """Percent of the decoder's staged seconds (`parse`, `recon`,
    `filters`, `hash`: the record's `stages` in decode mode) in stage
    `name`."""
    stages = rec["stages"] if rec["mode"] == "decode" else {}
    total = sum(stages.values())
    if total <= 0 or name not in stages:
        return None
    return 100.0 * stages[name] / total


def host_waits_per_frame(rec: dict, mode: str) -> float | None:
    """The traced unit's host waits on the device a picture: the counter
    `host_waits` of the spans the program's tracer recorded (read, not
    taken out).  Waits outside any span, such as the harness's own pulls
    after a sequence, are not the program's and are left out."""
    if rec["mode"] != mode or not rec["pictures"]:
        return None
    from vvc_mm_tpu_torch.utils import profiling
    if not hasattr(profiling, "recorded"):
        return None
    spans, _ = profiling.recorded()
    if not spans:
        return None
    return sum((sp.counts or {}).get("host_waits", 0)
               for sp in spans) / rec["pictures"]
