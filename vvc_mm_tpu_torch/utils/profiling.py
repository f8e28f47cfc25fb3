"""The port's tracer: per-stage timers (INTERPRED_PROFILING analog), spans
and counters.

PyTorch counterpart of `vvc_mm_tpu/utils/profiling.py` (reference: the MM
extension's profiling build, InterPrediction.h:194-215, TypeDef.h:140
INTERPRED_PROFILING).

Stage timers time the frame pipeline's STAGES (the encoder's search,
select, finish, entropy, filters; the decoder's parse, recon, filters,
hash).  Off by default (zero overhead beyond a flag test); enable with
VVC_PROFILE=1 or `enable()`, which also turns the tracer on (`trace`; the
variable alone does not).  CUDA work is asynchronous, so a stage that
names a device with `set_sync` waits for that device on exit
(`torch.cuda.synchronize`) and is charged its device work — profiling
serializes the pipeline, so the speed WITH profiling is not the production
speed.

Spans, on while `trace(True)` (or `enable(True)`), record what the
program did and when, on `time.perf_counter_ns()`: every stage; the
`sequence` of an EncLib or DecLib call and its pictures (`picture`: kind,
POC and the instance's sequence id, which none of `totals()` sees); the
set-up's builds; and, as a child of whatever span is open, a `gc` span
for each collection of Python's garbage collector.  `count(name)` charges a counter to the
innermost open span; while tracing, every hand-written kernel launch
counts `launches` and every time the host waits on a CUDA device
(PyTorch's sync debug mode, each warning counted and swallowed) counts
`host_waits`: a copy to or from pageable host memory, `.item()`,
`.tolist()`, `nonzero`, a boolean mask, a stream's synchronise.  The mode
does not see `torch.cuda.synchronize`, the stages' explicit wait.  Spans
stay in memory until `take_spans()`.  Tracing off, a span costs one flag
test and no synchronise; no hook is installed.  Spans are recorded on the
thread that turned tracing on; other threads' waits count outside any span.

The counter registry (`counters`) holds the kernel modules' launch
counters and the codec's position-call counts, as plain dicts that the
modules keep under their old names; `report()` lists those not 0.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import os
import threading
import time
import warnings
from collections import defaultdict

import torch

ENABLED = os.environ.get("VVC_PROFILE", "") not in ("", "0")
TRACING = False

_acc: dict[str, float] = defaultdict(float)
_cnt: dict[str, int] = defaultdict(int)

SYNC_WARNING = "called a synchronizing CUDA operation"


def enable(on: bool = True) -> None:
    """Stage timers on or off, and the tracer with them."""
    global ENABLED
    ENABLED = on
    trace(on)


class Span:
    """One recorded span: `name`, `parent` (a Span or None), `t0`/`t1`
    (perf_counter_ns; `t1` None while open), `attrs` (kind, poc, seq,
    generation) and `counts` (counter -> n)."""

    __slots__ = ("name", "parent", "t0", "t1", "attrs", "counts")

    def __init__(self, name: str, parent: "Span | None", t0: int,
                 attrs: dict | None) -> None:
        self.name = name
        self.parent = parent
        self.t0 = t0
        self.t1: int | None = None
        self.attrs = attrs
        self.counts: dict[str, int] | None = None

    def path(self) -> str:
        """Names from the outermost span down to this one, "/"-joined."""
        names, s = [], self
        while s is not None:
            names.append(s.name)
            s = s.parent
        return "/".join(reversed(names))


_spans: list[Span] = []
_stack: list[Span] = []
_outside: dict[str, int] = defaultdict(int)
_owner: int | None = None
_saved: dict = {}
_seq_ids = itertools.count()


def _open(name: str, attrs: dict | None = None,
          t0: int | None = None) -> Span | None:
    if threading.get_ident() != _owner:
        return None
    sp = Span(name, _stack[-1] if _stack else None,
              time.perf_counter_ns() if t0 is None else t0, attrs)
    _spans.append(sp)
    _stack.append(sp)
    return sp


def _close(sp: Span, t1: int | None = None) -> None:
    sp.t1 = time.perf_counter_ns() if t1 is None else t1
    if sp in _stack:             # inner spans left open by an exception
        while _stack.pop() is not sp:
            pass


def count(name: str, n: int = 1) -> None:
    """Charge `n` to counter `name` of the innermost open span (while
    tracing; outside any span, to `take_spans()`'s outside counts)."""
    if not TRACING:
        return
    if _stack and threading.get_ident() == _owner:
        sp = _stack[-1]
        if sp.counts is None:
            sp.counts = {}
        sp.counts[name] = sp.counts.get(name, 0) + n
    else:
        _outside[name] += n


def sequence_id() -> int:
    """A new sequence identifier: one EncLib's or DecLib's pictures share
    one."""
    return next(_seq_ids)


_NULL = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("name", "attrs", "_span")

    def __init__(self, name: str, attrs: dict | None) -> None:
        self.name = name
        self.attrs = attrs
        self._span = None

    def __enter__(self):
        self._span = _open(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            _close(self._span)
        return False


def span(name: str, seq: int | None = None):
    """Context manager: a span `name` (a sequence's, a build's) while
    tracing, else nothing."""
    if not TRACING:
        return _NULL
    return _OpenSpan(name, None if seq is None else {"seq": seq})


class picture:
    """Context manager: `with profiling.picture("B", poc, seq) as pic:`.
    Always times the picture (`pic.seconds`, perf_counter); while tracing
    also records a span named by its kind.  Not a stage: `totals()` does
    not see it."""

    __slots__ = ("kind", "poc", "seq", "seconds", "_t0", "_span")

    def __init__(self, kind: str, poc: int, seq: int) -> None:
        self.kind, self.poc, self.seq = kind, poc, seq
        self.seconds = 0.0
        self._span = None

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        if TRACING:
            self._span = _open(self.kind, {"kind": self.kind,
                                           "poc": self.poc, "seq": self.seq},
                               self._t0)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.seconds = (t1 - self._t0) * 1e-9
        if self._span is not None:
            _close(self._span, t1)
        return False


class stage:
    """Context manager: `with profiling.stage("mm_search") as ps: ...;
    ps.set_sync(device)`."""

    def __init__(self, name: str, sync=None) -> None:
        self.name = name
        self.sync = sync
        self._t0 = 0.0
        self._span = None

    def __enter__(self):
        if ENABLED:
            self._t0 = time.perf_counter()
        if TRACING:
            self._span = _open(self.name)
        return self

    def set_sync(self, sync) -> None:
        """`sync`: a device, or a tensor whose device is waited for."""
        self.sync = sync

    def __exit__(self, *exc):
        if ENABLED:
            dev = getattr(self.sync, "device", self.sync)
            if dev is not None and torch.device(dev).type == "cuda":
                torch.cuda.synchronize(dev)
            _acc[self.name] += time.perf_counter() - self._t0
            _cnt[self.name] += 1
        if self._span is not None:
            _close(self._span)
        return False


def launch(launches: dict, name: str) -> None:
    """Count a hand-written kernel launch in its module's counters and,
    while tracing, as `launches` of the open span."""
    launches[name] += 1
    if TRACING:
        count("launches")


_registry: dict[str, dict] = {}


def counters(group: str, names=()) -> dict:
    """The registry's counter group `group`: a dict, created holding each
    of `names` at 0, that its module keeps under its own name."""
    d = _registry.setdefault(group, {})
    for n in names:
        d.setdefault(n, 0)
    return d


def _show_warning(message, category, filename, lineno, file=None,
                  line=None):
    if SYNC_WARNING in str(message):
        count("host_waits")
        return
    _saved["showwarning"](message, category, filename, lineno, file, line)


def _gc_hook(phase: str, info: dict) -> None:
    if phase == "start":
        _saved["gc"] = _open("gc", {"generation": info["generation"]})
    else:
        sp = _saved.pop("gc", None)
        if sp is not None:
            _close(sp)


def trace(on: bool = True) -> None:
    """Turn span recording on or off.  On: gc spans and, with a CUDA
    device, the host-wait counter (sync debug mode "warn", every such
    warning counted and swallowed); off: both removed and the sync debug
    mode restored."""
    global TRACING, _owner
    if on == TRACING:
        return
    if on:
        _owner = threading.get_ident()
        gc.callbacks.append(_gc_hook)
        _saved["showwarning"] = warnings.showwarning
        warnings.showwarning = _show_warning
        warnings.filterwarnings("always", message=SYNC_WARNING)
        _saved["filter"] = warnings.filters[0]
        if torch.cuda.is_available():
            _saved["sync_mode"] = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        TRACING = True
        return
    TRACING = False
    if "sync_mode" in _saved:
        torch.cuda.set_sync_debug_mode(_saved.pop("sync_mode"))
    if _saved.get("filter") in warnings.filters:
        warnings.filters.remove(_saved["filter"])
        warnings._filters_mutated()
    _saved.pop("filter", None)
    if warnings.showwarning is _show_warning:
        warnings.showwarning = _saved["showwarning"]
    _saved.pop("showwarning", None)
    if _gc_hook in gc.callbacks:
        gc.callbacks.remove(_gc_hook)
    _saved.pop("gc", None)
    _stack.clear()
    _owner = None


def recorded() -> tuple[list[Span], dict[str, int]]:
    """The spans recorded so far, in the order they opened (those still
    open have `t1` None), and the counts charged outside any span; both
    stay recorded."""
    return list(_spans), dict(_outside)


def take_spans() -> tuple[list[Span], dict[str, int]]:
    """`recorded()`, and both cleared."""
    out = recorded()
    _spans.clear()
    _outside.clear()
    return out


def totals() -> dict[str, float]:
    """Seconds per stage so far."""
    return dict(_acc)


def _by_picture_kind(spans: list[Span]) -> dict[str, list[float]]:
    out: dict[str, list[float]] = {}
    for sp in spans:
        if sp.attrs and "poc" in sp.attrs and sp.t1 is not None:
            out.setdefault(sp.name, []).append((sp.t1 - sp.t0) * 1e-9)
    return out


def _counts_by_span(spans: list[Span]) -> dict[str, dict[str, int]]:
    """Counter -> span name -> the counts charged to spans of that name."""
    out: dict[str, dict[str, int]] = {}
    for sp in spans:
        for k, n in (sp.counts or {}).items():
            by = out.setdefault(k, {})
            by[sp.name] = by.get(sp.name, 0) + n
    return out


def report(spans: list[Span] | None = None) -> str:
    """The stage table; with `spans` (take_spans()'s) also seconds by
    picture kind and each counter by span name (`host_waits` always,
    `launches`, `nvcc_compiles` where counted); then the registry's
    counters that are not 0."""
    if not _acc and not spans:
        return "profiling: no stages recorded (set VVC_PROFILE=1)"
    total = sum(_acc.values())
    lines = [f"{'stage':<18}{'total s':>10}{'calls':>8}{'ms/call':>10}"
             f"{'share':>8}"]
    for k in sorted(_acc, key=lambda k: -_acc[k]):
        lines.append(f"{k:<18}{_acc[k]:>10.2f}{_cnt[k]:>8d}"
                     f"{1000.0 * _acc[k] / max(_cnt[k], 1):>10.1f}"
                     f"{100.0 * _acc[k] / max(total, 1e-12):>7.1f}%")
    lines.append(f"{'TOTAL':<18}{total:>10.2f}")
    if spans:
        lines.append(f"{'picture':<18}{'total s':>10}{'count':>8}"
                     f"{'ms/pic':>10}")
        for kind, xs in sorted(_by_picture_kind(spans).items()):
            lines.append(f"{kind:<18}{sum(xs):>10.2f}{len(xs):>8d}"
                         f"{1000.0 * sum(xs) / len(xs):>10.1f}")
        counts = {"host_waits": {}, **_counts_by_span(spans)}
        for name, by in counts.items():
            lines.append(f"{name.replace('_', ' '):<18}"
                         f"{sum(by.values()):>10d}")
            for k in sorted(by, key=lambda k: -by[k]):
                lines.append(f"  {k:<16}{by[k]:>10d}")
    registered = [(f"{group}.{name}", n)
                for group, d in sorted(_registry.items())
                for name, n in d.items() if isinstance(n, int) and n]
    registered += [(f"{group}.{name} {shape}", n)
                 for group, d in sorted(_registry.items())
                 for name, by in d.items() if isinstance(by, dict)
                 for shape, n in by.items() if n]
    if registered:
        lines.append("counters")
        lines += [f"  {k:<40}{n:>10d}" for k, n in registered]
    return "\n".join(lines)


def reset() -> None:
    _acc.clear()
    _cnt.clear()
