"""The port's tracer (utils/profiling.py): spans, counters, the host-wait
counter's hooks, and the picture, sequence and stage spans of EncLib and
DecLib on the CPU.  Each test turns tracing off again."""
import gc
import os
import warnings

import pytest
import torch

from vvc_mm_tpu_torch.apps import decoder_app
from vvc_mm_tpu_torch.common.mm import frame_codec
from vvc_mm_tpu_torch.common.slice_ps import MMConfig
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder.enclib import EncCfg, EncLib
from vvc_mm_tpu_torch.ops import (depquant_kernel, libm_kernel, mc_kernel,
                                  sphere_kernel)
from vvc_mm_tpu_torch.utils import profiling
from vvc_mm_tpu_torch.utils.content import realistic_sequence

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
# a tiny encode of the benchmark's RA configuration: its stage names
RA_STAGES = {"intra_search", "entropy", "filters", "recon_pull",
             "mm_search", "mm_select+pull", "mm_finish", "mm_search_b",
             "mm_select_b+pull", "mm_finish_b"}


@pytest.fixture
def tracing():
    """Tracing on with the stage timers off; both as they were after."""
    was = profiling.ENABLED
    profiling.enable(False)
    profiling.take_spans()
    profiling.trace(True)
    try:
        yield
    finally:
        profiling.trace(False)
        profiling.take_spans()
        profiling.enable(was)


def test_spans_nest_with_parents_counts_and_ids(tracing):
    seq = profiling.sequence_id()
    assert profiling.sequence_id() == seq + 1
    with profiling.span("sequence", seq):
        with profiling.picture("B", 6, seq) as pic:
            with profiling.stage("parse"):
                profiling.count("host_waits", 2)
                profiling.count("host_waits")
            with profiling.stage("recon"):
                profiling.launch({"k": 0}, "k")
        profiling.count("outside_any_picture")
    profiling.count("nowhere", 4)
    spans, outside = profiling.take_spans()
    assert [s.path() for s in spans] == [
        "sequence", "sequence/B", "sequence/B/parse", "sequence/B/recon"]
    sq, b, parse, recon = spans
    assert parse.parent is b and recon.parent is b and b.parent is sq
    assert b.attrs == {"kind": "B", "poc": 6, "seq": seq}
    assert sq.attrs == {"seq": seq}
    assert parse.counts == {"host_waits": 3}
    assert recon.counts == {"launches": 1}
    assert sq.counts == {"outside_any_picture": 1}
    assert outside == {"nowhere": 4}
    for child in (parse, recon):
        assert b.t0 <= child.t0 <= child.t1 <= b.t1
    assert parse.t1 <= recon.t0
    self_ns = (b.t1 - b.t0) - (parse.t1 - parse.t0) - (recon.t1 - recon.t0)
    assert 0 <= self_ns < b.t1 - b.t0
    assert pic.seconds == pytest.approx((b.t1 - b.t0) * 1e-9)
    assert "parse" not in profiling.totals()        # the timers were off
    assert profiling.take_spans() == ([], {})


def test_tracing_off_records_and_waits_for_nothing(monkeypatch):
    """Off: no span, no synchronise, no hook; on and off again: the sync
    debug mode, the warning hook and gc's callbacks as they were."""
    modes = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 7)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)

    def no_sync(*a):
        raise AssertionError("synchronised")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    was = profiling.ENABLED
    profiling.enable(False)
    try:
        assert not profiling.TRACING
        with profiling.span("sequence", 1):
            with profiling.picture("I", 0, 1) as pic:
                with profiling.stage("parse", torch.device("cuda", 0)):
                    profiling.count("host_waits")
        assert pic.seconds > 0
        assert profiling.take_spans() == ([], {}) and modes == []
        callbacks, show = list(gc.callbacks), warnings.showwarning
        filters = list(warnings.filters)
        profiling.trace(True)
        assert modes == ["warn"] and len(gc.callbacks) == len(callbacks) + 1
        with profiling.stage("parse", torch.device("cuda", 0)):
            pass                  # tracing alone does not synchronise
        profiling.trace(False)
        assert modes == ["warn", 7]
        assert gc.callbacks == callbacks and warnings.showwarning is show
        assert warnings.filters == filters
    finally:
        profiling.trace(False)
        profiling.take_spans()
        profiling.enable(was)


def test_sync_warnings_counted_each_time_and_swallowed(monkeypatch):
    shown = []
    monkeypatch.setattr(warnings, "showwarning",
                        lambda msg, *a, **kw: shown.append(str(msg)))
    profiling.trace(True)
    try:
        with profiling.stage("pull"):
            for _ in range(3):      # one call site: not deduplicated
                warnings.warn(profiling.SYNC_WARNING
                              + "\n(Triggered internally)", UserWarning)
            warnings.warn("another warning", UserWarning)
        spans, _ = profiling.take_spans()
    finally:
        profiling.trace(False)
    assert [s.counts for s in spans if s.name == "pull"] == [
        {"host_waits": 3}]
    assert shown == ["another warning"]


def test_gc_span_under_the_open_span(tracing):
    with profiling.stage("entropy"):
        gc.collect()
    spans, _ = profiling.take_spans()
    gcs = [s for s in spans if s.name == "gc"]
    assert gcs and all(s.parent.name == "entropy" for s in gcs)
    assert {"generation": 2} in [s.attrs for s in gcs]


def test_launch_counters_live_in_the_registry(tracing):
    assert profiling.counters("mc_kernel") is mc_kernel.LAUNCHES
    assert profiling.counters("mc_kernel.by_shape") is \
        mc_kernel.LAUNCHES_BY_SHAPE
    for mod in (sphere_kernel, depquant_kernel, libm_kernel):
        assert profiling.counters(mod.__name__.rsplit(".", 1)[1]) is \
            mod.LAUNCHES
    assert profiling.counters("frame_codec.position_calls") is \
        frame_codec.POSITION_CALLS
    assert profiling.counters("mc_kernel", ["mc_luma_positions"]) == \
        dict(mc_kernel.LAUNCHES)            # names already there stay
    with profiling.stage("recon"):
        pass
    spans, _ = profiling.take_spans()
    was = mc_kernel.LAUNCHES["mc_luma_positions"]
    shapes = mc_kernel.LAUNCHES_BY_SHAPE["mc_luma_positions"]
    shapes_was = dict(shapes)
    mc_kernel.LAUNCHES["mc_luma_positions"] = was + 3
    shapes["256x512"] = shapes.get("256x512", 0) + 3
    try:
        shown = profiling.report(spans).splitlines()
    finally:
        mc_kernel.LAUNCHES["mc_luma_positions"] = was
        shapes.clear()
        shapes.update(shapes_was)
    rows = {ln.rsplit(None, 1)[0].strip(): ln.split()[-1]
            for ln in shown[shown.index("counters") + 1:]}
    assert rows["mc_kernel.mc_luma_positions"] == str(was + 3)
    assert rows["mc_kernel.by_shape.mc_luma_positions 256x512"] == \
        str(shapes_was.get("256x512", 0) + 3)


@pytest.mark.parametrize("counter,where", [
    ("host_waits", "parse"), ("launches", "recon"),
    ("nvcc_compiles", "load")])
def test_report_counts_each_counter_by_span(tracing, counter, where):
    """The apps' report lists every counter charged to a span (the
    set-up's `nvcc_compiles` too) by span name."""
    with profiling.span("sequence", 0):
        with profiling.picture("B", 2, 0):
            with profiling.stage(where):
                profiling.count(counter, 2)
            with profiling.stage(where):
                profiling.count(counter)
    spans, _ = profiling.take_spans()
    lines = profiling.report(spans).splitlines()
    at = lines.index(next(ln for ln in lines
                          if ln.startswith(counter.replace("_", " "))))
    assert lines[at].split()[-1] == "3"
    assert lines[at + 1].split() == [where, "3"]
    if counter != "host_waits":        # listed even when nothing waited
        assert any(ln.split() == ["host", "waits", "0"] for ln in lines)


@pytest.fixture(scope="module")
def ra_encode():
    """A tiny encode of the benchmark's RA configuration (I, P, B), stage
    timers and tracing on."""
    was = profiling.ENABLED
    profiling.reset()
    profiling.enable(True)
    profiling.take_spans()
    profiling.trace(True)
    try:
        enc = EncLib(EncCfg(width=64, height=32, qp=37, gop="RA",
                            gop_size=2, intra_period=32, ctc_qp_offsets=True,
                            qt_depth=1, inter_block_size=16, search_range=24,
                            wrap_around=True, merge=True,
                            mm=MMConfig(mpa=True, rot=True)), device="cpu")
        data = enc.encode_sequence(realistic_sequence(64, 32, 3))
        spans, _ = profiling.take_spans()
        totals = profiling.totals()
    finally:
        profiling.trace(False)
        profiling.enable(was)
        profiling.reset()
    return enc, data, spans, totals


def test_encoder_stage_names_unchanged(ra_encode):
    _, _, _, totals = ra_encode
    assert set(totals) == RA_STAGES


def test_encoder_picture_spans_match_results(ra_encode):
    enc, _, spans, _ = ra_encode
    seqs = [s for s in spans if s.path() == "sequence"]
    assert len(seqs) == 1 and seqs[0].attrs == {"seq": enc.seq_id}
    pics = [s for s in spans if s.attrs and "poc" in s.attrs]
    assert [(s.name, s.attrs["poc"]) for s in pics] == [
        ("I", 0), ("P", 2), ("B", 1)]
    assert all(s.parent is seqs[0] and s.attrs["seq"] == enc.seq_id
               for s in pics)
    assert sorted(s.attrs["poc"] for s in pics) == \
        [r.poc for r in enc.results]
    by_poc = {s.attrs["poc"]: (s.t1 - s.t0) * 1e-9 for s in pics}
    for r in enc.results:
        assert r.seconds == pytest.approx(by_poc[r.poc], abs=1e-6)
    stages = {s.name for s in spans if s.parent in pics}
    assert RA_STAGES <= stages


def _spy(monkeypatch, name):
    calls = []
    method = getattr(DecLib, name)

    def call(self, *args, **kw):
        calls.append(name)
        return method(self, *args, **kw)
    monkeypatch.setattr(DecLib, name, call)
    return calls


@pytest.mark.parametrize("stream,path", [
    ("ai64x32_10bit_qp32_3f", "_decode_i"),
    ("ai64x32_intra_split_qp37_2f", "_decode_i_part"),
    ("erp256x128_ra_fullmm_qp37_5f", "_decode_p_flat"),
    ("erp256x128_ra_mm_qp37_5f", "_decode_p_mm"),
    ("erp256x128_ra_mm_qp37_5f", "_decode_b_mm"),
    ("ldp192x96_qp37_4f", "_decode_classic"),
    ("ra96x64_qt_qp37_5f", "_decode_tree"),
])
def test_every_decoder_path_opens_its_stages(tracing, monkeypatch, stream,
                                             path):
    calls = _spy(monkeypatch, path)
    with open(os.path.join(DATA, stream + ".bin"), "rb") as f:
        data = f.read()
    dec = DecLib(device="cpu")
    frames = dec.decode_bytes(data)
    assert calls and set(dec.hash_status.values()) == {"OK"}
    spans, _ = profiling.take_spans()
    pics = [s for s in spans if s.attrs and "poc" in s.attrs]
    assert sorted(s.attrs["poc"] for s in pics) == [f.poc for f in frames]
    for p in pics:
        assert p.path() == f"sequence/{p.name}"
        assert p.attrs["seq"] == dec.seq_id
        assert [s.name for s in spans if s.parent is p
                and s.name != "gc"] == ["parse", "recon", "filters"]
    hashes = [s for s in spans if s.name == "hash"]
    assert len(hashes) == len(dec.hash_status)
    assert all(s.path() == "sequence/hash" for s in hashes)


def test_decoder_app_profile_report(monkeypatch, capsys):
    was = profiling.ENABLED
    profiling.reset()
    try:
        assert decoder_app.main([
            "-b", os.path.join(DATA, "ldp192x96_qp37_4f.bin"),
            "--Device=cpu", "--Profile"]) == 0
    finally:
        profiling.enable(was)
        profiling.reset()
    out = capsys.readouterr().out
    assert not profiling.TRACING
    for word in ("parse", "recon", "filters", "hash", "host waits"):
        assert word in out
    kinds = [ln.split()[0] for ln in out.splitlines()
             if ln.split() and ln.split()[0] in ("I", "P")]
    assert kinds == ["I", "P"]
