"""CPU tests of the span metrics and of `spantable.py`'s table:
`python3 -m pytest port_bench -q`."""
from __future__ import annotations

import time

import pytest
import torch

from port_bench import devtrace, harness, spantable, spec
from port_bench.tests.test_port_bench import BENCH, DEC, RA, SEED, _tiny
from vvc_mm_tpu_torch.utils import profiling

NEW = ("parse_pct.decode", "recon_pct.decode", "filters_pct.decode",
       "host_waits_per_frame.encode", "host_waits_per_frame.decode")


@pytest.mark.parametrize("name,stages,want", [
    ("parse_pct.decode", {"parse": 6.0, "recon": 3.0, "filters": 0.5,
                          "hash": 0.5}, 60.0),
    ("recon_pct.decode", {"parse": 6.0, "recon": 3.0, "filters": 0.5,
                          "hash": 0.5}, 30.0),
    ("filters_pct.decode", {"parse": 6.0, "recon": 3.0, "filters": 0.5,
                            "hash": 0.5}, 5.0),
    ("parse_pct.decode", {}, None),       # a program without the stages
])
def test_decode_stage_shares(name, stages, want):
    got = spec.load_metric(name).read(dict(mode="decode", stages=stages))
    assert got == (None if want is None else pytest.approx(want))
    assert spec.load_metric(name).read(dict(mode="encode",
                                            stages={"filters": 1.0})) is None


@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_host_waits_read_from_the_program(mode):
    """The stage timers turn the tracer on; the reader counts the waits
    in the unit's spans, not those outside any span, and leaves the spans
    recorded; with none recorded it reads nothing."""
    reader = spec.load_metric(f"host_waits_per_frame.{mode}")
    other = "decode" if mode == "encode" else "encode"
    profiling.take_spans()
    assert reader.read(dict(mode=mode, pictures=17)) is None
    profiling.enable(True)
    try:
        with profiling.span("sequence"):
            with profiling.stage("parse"):
                profiling.count("host_waits", 30)
            profiling.count("host_waits", 4)
        profiling.count("host_waits", 17)
    finally:
        profiling.enable(False)
        profiling.reset()
    assert reader.read(dict(mode=other, pictures=17)) is None
    assert reader.read(dict(mode=mode, pictures=17)) == pytest.approx(2.0)
    assert reader.read(dict(mode=mode, pictures=17)) == pytest.approx(2.0)
    spans, outside = profiling.take_spans()
    assert len(spans) == 2 and outside == {"host_waits": 17}
    assert reader.read(dict(mode=mode, pictures=17)) is None


class _Span:
    def __init__(self, name, parent, t0, t1, attrs=None, counts=None):
        self.name, self.parent, self.t0, self.t1 = name, parent, t0, t1
        self.attrs, self.counts = attrs, counts

    def path(self):
        return self.name if self.parent is None else \
            f"{self.parent.path()}/{self.name}"


def test_device_operations_put_down_to_the_launching_span():
    """A synthetic trace: unit > sequence > B picture > parse, recon; a
    gc span inside parse; the device clock 1000 ns ahead of the host's,
    the runtime records' 500 ns.  An operation goes to the span open at
    its launch (its runtime record), else at its device start."""
    unit = _Span("unit", None, 0, 1000)
    seq = _Span("sequence", unit, 10, 990, {"seq": 3})
    pic = _Span("B", seq, 20, 900, {"kind": "B", "poc": 1, "seq": 3})
    parse = _Span("parse", pic, 20, 500, counts={"host_waits": 2})
    gcs = _Span("gc", parse, 100, 150, {"generation": 2})
    recon = _Span("recon", pic, 500, 880, counts={"launches": 3,
                                                  "host_waits": 1})
    build = _Span("load", unit, 991, 994, counts={"nvcc_compiles": 1})
    spans = [unit, seq, pic, parse, gcs, recon, build]
    dev, rt = 1000, 500
    ops = [("k_a", 1600, 1650),            # launched at 510: recon
           ("Memcpy DtoH (Device -> Pageable)", 1700, 1720),   # 520
           ("k_b", 1300, 1310),            # no record, starts at 300: parse
           ("k_c", 1995, 2005)]            # no record, 995: unit
    launches = {("k_a", 1600): 510 + rt,
                ("Memcpy DtoH (Device -> Pageable)", 1700): 520 + rt}
    gaps = [(1000 + 110, 1000 + 140), (1000 + 600, 1000 + 700)]
    table, chk = spantable.table(spans, ops, gaps, 1000, 2000, dev,
                                 launches, rt)
    assert chk["attribution"] == {"runtime_record": 2, "device_start": 2}
    assert table["unit/sequence/B/recon"]["device_ops"] == 2
    assert table["unit/sequence/B/recon"]["device_busy_s"] == \
        pytest.approx(70e-9)
    assert table["unit/sequence/B/parse"]["device_ops"] == 1
    assert table["unit"]["device_ops"] == 1
    assert chk["outside_ops"] == 0 and chk["memcpy_dtoh"] == 1
    assert sum(e["device_ops"] for e in table.values()) == len(ops)
    b = table["unit/sequence/B"]
    assert (b["calls"], b["seconds"]) == (1, pytest.approx(880e-9))
    assert b["self_s"] == pytest.approx((880 - 480 - 380) * 1e-9)
    assert table["unit/sequence/B/parse"]["self_s"] == pytest.approx(430e-9)
    assert table["unit/sequence/B/parse/gc.2"]["idle_s"] == \
        pytest.approx(30e-9)
    assert table["unit/sequence/B/recon"]["idle_s"] == pytest.approx(100e-9)
    assert (table["unit/sequence/B/recon"]["launches"],
            table["unit/sequence/B/recon"]["host_waits"]) == (3, 1)
    assert table["unit/load"]["nvcc_compiles"] == 1
    assert "nvcc_compiles" not in table["unit/sequence/B/recon"]
    assert chk["stage_cover_pct"] == pytest.approx(100.0 * 860 / 880)
    assert chk["idle_staged_pct"] == pytest.approx(100.0)
    assert spantable.picture_means(spans) == {"B": pytest.approx(880e-9)}
    ops_out = [("k_d", 1000 + 2000, 1000 + 2010)]     # after every span
    table, chk = spantable.table(spans, ops_out, [], 1000, 4000, dev, {},
                                 rt)
    assert table["outside"]["device_ops"] == 1 and chk["outside_ops"] == 1


@pytest.mark.parametrize("cell", [RA, DEC])
def test_span_metrics_in_a_traced_run_on_the_cpu(monkeypatch, cell):
    """The harness as it is, the profiler faked: the decode cell's stage
    shares and either cell's host waits (none on the CPU) read."""
    class FakeProfiler:
        def start(self):
            pass

        def stop(self):
            pass
    marks: list[int] = []

    def mark():
        marks.append(time.perf_counter_ns())
        return marks[-1]
    monkeypatch.setattr(devtrace, "profiler", FakeProfiler)
    monkeypatch.setattr(devtrace, "mark", mark)
    monkeypatch.setattr(devtrace, "device_events", lambda prof: [
        (devtrace.MARKER, t, t + 100) for t in marks])
    torch.set_num_threads(1)
    config, traffic = _tiny(cell)
    res = harness.run_cell(config, traffic, SEED, 1e9, True,
                           torch.device("cpu"), time.perf_counter(),
                           max_units=1)
    rec = res["record"]
    got = {m["name"]: spec.load_metric(m["name"]).read(rec)
           for m in spec.per_layer(BENCH, cell) if m["name"] in NEW}
    if cell == DEC:
        assert set(rec["stages"]) == {"parse", "recon", "filters", "hash"}
        shares = [got[f"{s}_pct.decode"] for s in ("parse", "recon",
                                                    "filters")]
        assert all(0 < v < 100 for v in shares) and sum(shares) < 100
        assert got["host_waits_per_frame.decode"] == 0.0
    else:
        assert got == {"host_waits_per_frame.encode": 0.0}
    assert not profiling.TRACING
