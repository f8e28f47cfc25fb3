"""CPU tests of the port's benchmark: `python3 -m pytest port_bench -q`.

They drive the harness at tiny sizes on the CPU (the CLI itself refuses
to run without a CUDA device), hold the check to the control and to each
planted fault, and check the data-driven parts, the arithmetic of the
metrics and the import rule.  The `cuda` test runs one cell on a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from port_bench import (check, counts, devtrace, faults, harness, readers,
                        run, spec)

ROOT = spec.ROOT
BENCH = spec.load_benchmark()
RA, AI, DEC = ("erp2k-mm-ra16.encode", "erp2k-ai-ctc.encode",
               "erp2k-mm-ra16.decode")
SEED = 2 ** 31 + 12345          # past 32 signed bits, as large seeds are


# -------------------------------------------------------------- by name
def test_benchmark_parts_found_by_name():
    names = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["config"] in names
        config = spec.load_config(BENCH, w["config"])
        assert {"source", "assumed", "reduced", "check"} <= set(config)
        traffic = spec.load_traffic(w["traffic"])
        assert traffic["mode"] in ("encode", "decode")
        if traffic["mode"] == "encode":
            expect = spec.load_expect(w["name"])
            assert expect["unit_bits"] > 0
            assert set(expect["limits"]) == {"bits_over_pct"}
        reported = {m["name"] for m in spec.end_to_end(BENCH, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.per_layer(BENCH, w["name"])
    for m in BENCH["per_layer"]:
        reader = spec.load_metric(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (
            m["unit"], m["layer"], m["moves"])
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in
                                  spec.end_to_end(BENCH, cell)}


def test_a_cell_added_as_files_only(tmp_path):
    """A new configuration, traffic mix and metric: files and entries,
    no code."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(
        {"width": 64, "height": 32, "gop": "AI", "check": {}}))
    (tmp_path / "traffic" / "one-picture.json").write_text(json.dumps(
        {"mode": "encode", "unit": "picture", "frames": 1}))
    (tmp_path / "metrics" / "pictures_seen.encode.py").write_text(
        'UNIT = "frames"\nLAYER = "sequence"\nMOVES = "encode_fps"\n\n\n'
        'def read(rec):\n    return rec["pictures"] or None\n')
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [
        {"name": "tiny", "file": "configs/tiny.json"}]
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "tiny.encode", "config": "tiny",
         "traffic": "one-picture", "chips": 1}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "pictures_seen.encode", "unit": "frames",
         "moves": "encode_fps", "workloads": ["tiny.encode"]}]
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + ["tiny.encode"])
                           if m["name"] == "encode_fps" else m
                           for m in BENCH["end_to_end"]]
    assert spec.load_config(bench, "tiny", str(tmp_path))["width"] == 64
    assert spec.load_traffic("one-picture", str(tmp_path))["unit"] == \
        "picture"
    assert [m["name"] for m in spec.per_layer(bench, "tiny.encode")] == \
        ["pictures_seen.encode"]
    reader = spec.load_metric("pictures_seen.encode", str(tmp_path))
    assert reader.read({"pictures": 3}) == 3
    assert {m["name"] for m in spec.end_to_end(bench, "tiny.encode")} == \
        {"encode_fps", "setup_s"}


# -------------------------------------------------------------- the rate
class _FakeEncoded:
    def __init__(self, frames):
        self.data = b"x"
        self.recon = {p: f for p, f in enumerate(frames)}


def _fake_program(unit_s: float):
    class Encoder:
        def __init__(self, config, device, instruments=None, **kw):
            pass

        def run(self, frames):
            time.sleep(unit_s)
            return _FakeEncoded(frames)
    return types.SimpleNamespace(build=lambda device: None, Encoder=Encoder)


def test_rate_over_whole_units(monkeypatch):
    """The window closes at the first unit boundary at or after
    `seconds`; every unit's pictures count."""
    import port_bench
    fake = _fake_program(0.04)
    monkeypatch.setitem(sys.modules, "port_bench.program", fake)
    monkeypatch.setattr(port_bench, "program", fake, raising=False)
    config = {"width": 32, "height": 16}
    traffic = {"mode": "encode", "unit": "sequence", "frames": 3,
               "variants": 2}
    res = harness.run_cell(config, traffic, SEED, 0.1, False,
                           torch.device("cpu"), time.perf_counter())
    assert res["units"] == len(res["unit_s"]) >= 3
    assert res["pictures"] == 3 * res["units"]
    assert res["window_s"] >= 0.1
    assert res["window_s"] - res["unit_s"][-1] < 0.1
    assert abs(sum(res["unit_s"]) - res["window_s"]) < 1e-9


def test_units_differ_and_seed_repeats():
    traffic = {"mode": "encode", "unit": "sequence", "frames": 2,
               "variants": 3}
    a = harness.make_units({"width": 64, "height": 32}, traffic, SEED)
    b = harness.make_units({"width": 64, "height": 32}, traffic, SEED)
    assert len(a) == 3
    assert all(np.array_equal(x[0][0], y[0][0])
               for x, y in zip(a.frames, b.frames))
    assert not np.array_equal(a.frames[0][0][0], a.frames[1][0][0])
    pics = harness.make_units({"width": 64, "height": 32},
                              {"mode": "encode", "unit": "picture",
                               "frames": 4}, SEED)
    assert len(pics) == 4 and all(len(f) == 1 for f in pics.frames)


def test_first_pictures_warm_a_decode():
    config, _ = _tiny(RA)
    from port_bench import program
    frames = harness.make_units(config, {"unit": "sequence", "frames": 5},
                                SEED).frames[0]
    data = program.Encoder(config, torch.device("cpu")).run(frames).data
    prefix = harness.first_pictures(data, 3)
    assert len(prefix) < len(data)
    assert sorted(program.Decoder(torch.device("cpu")).run(prefix)) == \
        [0, 2, 4]


def test_reference_in_worker_processes_agrees():
    """Two streams decoded by two worker processes give what one process
    gives."""
    config, traffic = _tiny(DEC)
    from port_bench import program
    units = harness.make_units(config, traffic, SEED)
    enc = program.Encoder(config, torch.device("cpu"))
    streams = [enc.run(f).data for f in units.frames]
    one, two = {}, {}
    check.reference_decode_many(streams, one, workers=1)
    check.reference_decode_many(streams, two, workers=2)
    for d in streams:
        assert one[d][1] == two[d][1] and one[d][2] is None is two[d][2]
        assert sorted(one[d][0]) == sorted(two[d][0])
        for poc, planes in one[d][0].items():
            assert all(np.array_equal(a, b)
                       for a, b in zip(planes, two[d][0][poc]))


# -------------------------------------------------------------- the trace
def test_idle_share_is_a_union_of_intervals():
    iv = [(0, 40), (10, 30), (35, 50), (70, 80)]   # overlapping
    assert devtrace.busy_ns(iv, 0, 100) == 60       # not the sum, 75
    assert devtrace.idle_gaps(iv, 0, 100) == [(50, 70), (80, 100)]
    assert devtrace.busy_ns(iv, 20, 75) == 35
    rec = {"mode": "encode", "window_s": 100e-9,
           "busy_s": devtrace.busy_ns(iv, 0, 100) * 1e-9}
    assert readers.idle_pct(rec, "encode") == pytest.approx(40.0)
    assert readers.idle_pct(rec, "decode") is None


def test_gaps_labelled_by_host_span():
    spans = devtrace.Spans()
    spans.spans = [("unit", 0, 100), ("B", 10, 60), ("entropy", 40, 55)]
    labels = spans.label_points([5, 20, 50, 80, 150])
    assert labels == ["unit", "unit/B", "unit/B/entropy", "unit",
                      "outside"]
    out = devtrace.breakdown([("k1", 0, 10), ("k2", 10, 15), ("k1", 20, 30)],
                             [(45, 52), (70, 90)], 0, spans)
    assert out["device_ops"][0] == ["k1", pytest.approx(20e-9)]
    assert [g[0] for g in out["idle_gaps"]] == ["unit", "unit/B/entropy"]


def test_traced_run_on_the_cpu(monkeypatch):
    """The traced path end to end, with the profiler faked: the first
    unit is traced, the rest of the window runs untraced, and the record
    and breakdown come from the fake device events."""
    clock = {"t": 0}

    def mark():
        clock["t"] = time.perf_counter_ns()
        marks.append(clock["t"])
        return clock["t"]

    class FakeProfiler:
        def start(self):
            pass

        def stop(self):
            pass
    marks: list[int] = []
    offset = 10 ** 6
    monkeypatch.setattr(devtrace, "profiler", FakeProfiler)
    monkeypatch.setattr(devtrace, "mark", mark)

    def events(prof):
        evs = [(devtrace.MARKER, t + offset, t + offset + 100) for t in marks]
        lo, hi = marks[3] + offset, marks[4] + offset
        step = (hi - lo) // 10
        evs += [("void band_positions_kernel<16>(int)", lo + k * step,
                 lo + k * step + step // 2) for k in range(10)]
        return sorted(evs, key=lambda e: e[1])
    monkeypatch.setattr(devtrace, "device_events", events)
    config, traffic = _tiny(RA)
    res = harness.run_cell(config, traffic, SEED, 1e9, True,
                           torch.device("cpu"), time.perf_counter(),
                           max_units=2)
    rec = res["record"]
    assert res["units"] == 2 and rec["pictures"] == 5
    assert rec["device_ops"] == 10
    assert 40.0 < readers.idle_pct(rec, "encode") < 60.0
    assert [k for k, _ in rec["picture_seconds"]].count("I") == 1
    assert rec["stages"]
    assert res["breakdown"]["idle_gaps"][0][0].startswith("unit")
    j = harness.judge(res, traffic, SEED, config["check"])
    assert j.correct


def test_kernel_family_names():
    dq = devtrace.family_pattern(counts.FAMILY_OF["quantize_dep"])
    assert dq.search("void quantize_dep_kernel<4>(int const*, int)")
    assert not dq.search("void dequantize_dep_kernel(int const*)")
    assert not devtrace.family_pattern("mc_positions_kernel").search(
        "void at::native::elementwise_kernel")


# -------------------------------------------------------------- rooflines
def test_roofline_counts_on_hand_worked_shapes():
    # K3, s = 16, K = 4, 2x3 blocks: MACs 4*2*3*(11*16*8 + 4*16*8) = 46080;
    # words: plane 100 + positions 48 + band plane 0 + output 24
    words, macs = counts.search_words_macs("sad_block_positions", 100,
                                           (4, 2, 3, 2), 0, 16)
    assert (words, macs) == (172, 46080)
    words, macs = counts.search_words_macs("mc_block_positions", 100,
                                           (4, 2, 3, 2), 0, 16)
    assert words == 100 + 48 + 4 * 2 * 4 * 3 * 16
    # K1 on 2x2 subblocks: window 11x11, 4 taps wide... 8 taps: each
    # subblock 11*4*8 + 4*4*8 = 480 MACs
    words, macs = counts.mc_words_macs(121, 2, 2, 4)
    assert (words, macs) == (121 + 8 + 64, 4 * 480)
    # D2 on 3 blocks of 16: 2*48 + 16 words; 12 * 48 integer operations
    assert counts.dq_least_s("dequantize_dep", 3, 16) == pytest.approx(
        max(4 * 112 / counts.HBM_BYTES_PER_S, 576 / counts.I32_OPS_PER_S))
    assert counts.dq_least_s("quantize_dep", 3, 16) == pytest.approx(
        max(4 * 112 / counts.HBM_BYTES_PER_S, 66 * 48 / counts.F32_OPS_PER_S))


def test_l1_counts_on_hand_worked_shapes():
    # atan2f over 1000 elements: two inputs and the output, no float64
    assert counts.libm_least_s("atan2f", 1000) == pytest.approx(
        4 * 3000 / counts.HBM_BYTES_PER_S)
    # sinf: 8 bytes an element outweigh its 13 float64 operations
    assert counts.libm_least_s("sinf", 1000) == pytest.approx(
        4 * 2000 / counts.HBM_BYTES_PER_S)
    assert 13000 / counts.F64_OPS_PER_S < 4 * 2000 / counts.HBM_BYTES_PER_S
    # merged positions of an MPA slot (code 1, 10 positions) and a ROT
    # slot (code 6, 6 positions), CLASSIC (code 0, 4) and a chain model
    # (-1, 2): MPA 54 + 4*25 float32 and 4*13 float64 a position, ROT
    # 111 + 4*25 and 12*13; bytes: 3 blocks' MVs and indices, 8 bytes a
    # position, MPA's cache 9 and ROT's points 12 a position, the table
    n_bytes, f32, f64 = counts.sphere_work(
        "sphere_positions", [1, 6, 0, -1], "merged", [10, 6, 4, 2], 3, True)
    assert f32 == 10 * (54 + 100) + 6 * (111 + 100)
    assert f64 == 10 * 4 * 13 + 6 * 12 * 13
    assert n_bytes == 3 * 12 + 8 * 22 + 10 * 9 + 6 * 12 + 2048 * 8
    # the same slots from a model index: 2x2 blocks of 8 samples (2x2
    # subblocks each), every position kept
    idx = torch.tensor([[[0, 1], [1, 1]]])
    t = counts.sphere_least_s("sphere_positions", [1, 6], None, idx, 1, 2,
                              2, 8)
    n_bytes, f32, f64 = counts.sphere_work("sphere_positions", [1, 6], None,
                                           [4, 12], 4, True)
    assert t == pytest.approx(max(n_bytes / counts.HBM_BYTES_PER_S,
                                  f32 / counts.F32_OPS_PER_S,
                                  f64 / counts.F64_OPS_PER_S))
    assert devtrace.family_pattern(counts.FAMILY_OF["cosf"]).search(
        "void libm_kernel<1>(float const*, float const*, float*, long)")


def test_l1_launches_recorded_from_their_arguments(monkeypatch):
    """The traced run's wrappers read each L1 launch's models and form
    from its template and count it (the launches themselves are the
    card's; here they do nothing)."""
    from vvc_mm_tpu_torch.common.mm.reprojection import MVReprojection
    from vvc_mm_tpu_torch.common.typedefs import MotionModelID as M
    from vvc_mm_tpu_torch.lib360.projection import ERP
    from vvc_mm_tpu_torch.ops import libm_kernel, sphere_kernel

    from port_bench import program
    monkeypatch.setattr(sphere_kernel, "launch", lambda *a: None)
    monkeypatch.setattr(libm_kernel, "_launch", lambda *a: None)
    inst = program.Instruments(devtrace.Spans(), torch.device("cpu"))
    inst.start()
    rp = MVReprojection(ERP(256, 128), 256, 128, device="cpu")
    models = [M.CLASSIC, M.MPA_FRONT_BACK, M.ROTATIONAL]
    idx = torch.tensor([[[0, 1], [2, 2]]], dtype=torch.int32)
    mvs = torch.zeros((1, 3, 2, 2, 2), dtype=torch.int32)
    sphere_kernel.launch("sphere_positions",
                         rp._template("sphere_positions", models, "merged",
                                      16), idx, mvs,
                         torch.empty((1, 8, 8, 2), dtype=torch.int32), 1, 1)
    libm_kernel._launch("cosf", torch.empty(100), torch.empty(100))
    inst.stop()
    n_bytes, f32, f64 = counts.sphere_work(
        "sphere_positions", [0, 1, 6], "merged", [16, 16, 32], 4, True)
    assert inst.least_by_kernel() == {
        "sphere_positions": (1, pytest.approx(max(
            n_bytes / counts.HBM_BYTES_PER_S, f32 / counts.F32_OPS_PER_S,
            f64 / counts.F64_OPS_PER_S))),
        "cosf": (1, counts.libm_least_s("cosf", 100))}


def test_mc_union_counts_each_word_once():
    ref = torch.zeros((40, 40), dtype=torch.int32)
    # two subblocks at the same position and one 2 samples right: the
    # windows (11x11 luma) overlap; union 11 x 13
    pos = torch.tensor([[[0, 0], [0, 0], [32, 0]]], dtype=torch.int32)
    t = counts.mc_least_s(ref, pos, margin=8, s=4)
    words, macs = counts.mc_words_macs(11 * 13, 1, 3, 4)
    assert t == pytest.approx(counts.least_s(words, 2 * macs))


def test_roofline_reader_scales_to_caught_launches():
    rec = {"mode": "decode", "kernels": {
        "mc_positions_kernel": dict(launches=10, least_s=1.0, events=8,
                                    device_s=2.0),
        "band_positions_kernel": dict(launches=0, least_s=0.0, events=3,
                                      device_s=5.0)}}
    assert readers.roofline_pct(rec, "decode") == pytest.approx(40.0)
    assert readers.roofline_pct(rec, "encode") is None


# -------------------------------------------------------------- result line
def test_last_line_keys():
    j = check.Judgement({"missing_pictures": 0, "worst_mse_y": 100.0})
    j.numbers.update(missing_pictures=0, worst_mse_y=12.5)
    traffic = spec.load_traffic("sequences-17")
    cell = spec.workload(BENCH, RA)
    res = dict(pictures=34, window_s=40.0, setup_s=20.0, unit_s=[20.0, 20.0],
               memory_peak_bytes=123, busy_s=3.0, traced_window_s=40.0,
               breakdown={"device_ops": [], "idle_gaps": []},
               record=dict(mode="encode", pictures=34, window_s=40.0,
                           busy_s=3.0, device_ops=340, picture_seconds=[],
                           stages={}, kernels={}))
    line = run.result_line(BENCH, cell, traffic, res, j, False, "GPU", "c")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "check"
    assert line["metrics"]["encode_fps"] == {"value": 34 / 40.0,
                                             "unit": "frames/s"}
    assert set(line["metrics"]) == {"encode_fps", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    traced = run.result_line(BENCH, cell, traffic, res, j, True, "GPU", "c")
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert "breakdown" in traced and list(traced)[-1] == "check"
    assert traced["metrics"]["device_ops_per_frame.encode"]["value"] == 10.0
    assert traced["check"]["worst_mse_y"] == {"value": 12.5, "limit": 100.0}
    json.dumps(traced)


# -------------------------------------------------------------- imports
def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "vvc_mm_tpu_torch_fake", types.ModuleType("x"))
    assert "vvc_mm_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vvc_mm_tpu.common.fake",
                        types.ModuleType("y"))
    assert run.forbidden_modules() == ["vvc_mm_tpu"]


def _modules_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_reference_and_harness_imports():
    """The reference loads neither JAX, nor the JAX package, nor the
    program; the harness loads the program and neither of the others."""
    ref = _modules_after(
        "import torch; torch.set_num_threads(1)\n"
        "from port_bench import check, clip, refworker\n"
        "check.reference_decode(b'')")
    assert not ref & {"jax", "jaxlib", "flax", "vvc_mm_tpu",
                      "vvc_mm_tpu_torch"}
    whole = _modules_after(
        "import torch; torch.set_num_threads(1)\n"
        "from port_bench import harness, program, run, control")
    assert "vvc_mm_tpu_torch" in whole
    assert not whole & {"jax", "jaxlib", "flax", "vvc_mm_tpu"}


def test_no_card_no_result():
    """Without a CUDA device the harness fails and prints no result; it
    does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "port_bench.run",
                          "--workload", AI, "--seed", str(SEED), "--seconds",
                          "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


# -------------------------------------------------------------- the check
def _tiny(cell: str):
    w = spec.workload(BENCH, cell)
    config = spec.load_config(BENCH, w["config"])
    traffic = dict(spec.load_traffic(w["traffic"]), warmup=None)
    if config["gop"] == "RA":
        config = dict(config, width=128, height=64, gop_size=4)
        traffic = dict(traffic, frames=5, variants=2)
    else:
        config = dict(config, width=64, height=32)
        traffic = dict(traffic, frames=3)
    return config, traffic


@pytest.mark.parametrize("cell", [RA, AI, DEC])
@pytest.mark.parametrize("fault", [None, *faults.KINDS])
def test_check_catches_each_fault(cell, fault):
    """A whole run with the timed path as it is comes out correct; with
    the control (`lsb`) or any planted fault in the timed path, not."""
    torch.set_num_threads(1)
    config, traffic = _tiny(cell)
    res = harness.run_cell(config, traffic, SEED, 1e9, False,
                           torch.device("cpu"), time.perf_counter(),
                           fault=fault, max_units=3)
    assert res["units"] == 3
    j = harness.judge(res, traffic, SEED, config["check"])
    assert j.correct == (fault is None), j.lines()
    if fault is not None:
        assert j.bad


@pytest.mark.parametrize("cell", [RA, AI])
def test_search_fault_fails_the_check(cell):
    """The search fault (planted in the program) still writes a stream
    that decodes as the encoder says; the check catches it by the first
    unit's bits against what the sound encoder gave for the same input,
    at the cell's own limits.  All intra at 128x64, where the fault costs
    about what it costs at the cell's size (20-25% more bits here, 24-34%
    at 2048x1024 on the card; at 64x32 13-22%)."""
    torch.set_num_threads(1)
    config, traffic = _tiny(cell)
    if config["gop"] == "AI":
        config = dict(config, width=128, height=64)
    limits = spec.limits_of(config, spec.load_expect(cell))
    runs = {fault: harness.run_cell(config, traffic, SEED, 1e9, False,
                                    torch.device("cpu"), time.perf_counter(),
                                    fault=fault, max_units=2)
            for fault in (None, "search")}
    sound = harness.judge(runs[None], traffic, SEED, limits)
    expect = dict(unit_bits=sound.info["unit_bits"])
    j = harness.judge(runs[None], traffic, SEED, limits, expect=expect)
    assert j.correct and j.numbers["bits_over_pct"] == 0, j.lines()
    j = harness.judge(runs["search"], traffic, SEED, limits, expect=expect)
    assert j.numbers["recon_mismatch"] == 0 == j.numbers["md5_mismatch"]
    assert j.numbers["bits_over_pct"] > limits["bits_over_pct"], j.lines()
    assert not j.correct and j.bad


# -------------------------------------------------------------- on a card
@pytest.mark.cuda
def test_one_run_on_the_card(cuda_device):
    out = subprocess.run([sys.executable, "-m", "port_bench.run",
                          "--workload", AI, "--seed", str(SEED), "--seconds",
                          "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
