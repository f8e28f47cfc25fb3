"""PyTorch port, the encoder and decoder apps (ROADMAP queue 1 item 12)
against the JAX package's apps, through their main() on the CPU.

The JAX apps' outputs are committed records (tests/data/torch_port/
apps.json and app_ra128x64_mm_qp37_5f.bin, written by `python
tests/make_torch_port_streams.py apps`), so no JAX encoder runs here.

  encoder app   a cfg file, short aliases and --Name=value options (MPA+ROT,
                the MM quadtree, RA GOP 4, an epipole, 128x64, 5 frames):
                the JAX app's stream byte for byte, its reconstruction
                (MD5 of the YUV) and its log lines (without the clock);
  decoder app   on that stream with --CacheModel and --TraceFile: the JAX
                app's lines (MD5s, the cache model's report), trace file
                and output YUV, which is the encoder app's reconstruction;
                --BitStats on the committed 256x128 stream (the Python
                spec coder); the HRD CPB check of a rate-controlled
                stream; --FilmGrain; the flat MM P trace; a classic
                stream's cache model: each the JAX app's output;
  refusals      4:4:4 input, missing options, and no --Device without a
                card (it raises instead of running on the CPU);
  processes     `python -m vvc_mm_tpu_torch.apps.encoder_app --Device=cpu`,
                then decoder_app, in subprocesses: neither imports JAX
                (python -X importtime lists every module they import).

Cost on one core: about 30 s (the encoder app's encode 8 s, the two
subprocesses 9 s, --BitStats 1.3 s)."""
import json
import os
import subprocess
import sys

import pytest
import torch

from vvc_mm_tpu_torch.apps import decoder_app, encoder_app

from tests.make_torch_port_streams import (APP_CFG, APP_DEC_RUNS,
                                           APP_ENC_ARGS, OUT_DIR, app_args,
                                           app_source, file_md5, run_app)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--Device=cpu"]


@pytest.fixture(scope="module")
def record():
    with open(os.path.join(OUT_DIR, "apps.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("apps")
    f = {k: str(d / v) for k, v in dict(
        IN="in.yuv", BIN="app.bin", REC="rec.yuv", OUT="out.yuv",
        CFG="enc.cfg", TRACE="trace.txt").items()}
    app_source(f["IN"])
    with open(f["CFG"], "w") as fh:
        fh.write(APP_CFG)
    return f


@pytest.fixture(scope="module")
def encoded(files):
    """The port's encoder app on the CPU: its output lines."""
    return run_app(encoder_app.main, app_args(APP_ENC_ARGS, files) + CPU)


def test_encoder_app_matches_jax(record, files, encoded):
    assert encoded == record["enc_stdout"]
    with open(files["BIN"], "rb") as f:
        data = f.read()
    with open(os.path.join(OUT_DIR, "app_ra128x64_mm_qp37_5f.bin"),
              "rb") as f:
        assert data == f.read()
    assert file_md5(files["REC"]) == record["recon_md5"]


@pytest.mark.parametrize("run", list(APP_DEC_RUNS))
def test_decoder_app_matches_jax(record, files, encoded, run):
    for k in ("OUT", "TRACE"):
        if os.path.exists(files[k]):
            os.remove(files[k])
    want = record["dec"][run]
    got = run_app(decoder_app.main, app_args(APP_DEC_RUNS[run], files) + CPU)
    assert got == want["stdout"]
    assert all(ln.endswith("(OK)") for ln in got if "[MD5:" in ln)
    if "yuv_md5" in want:
        assert file_md5(files["OUT"]) == want["yuv_md5"]
    if "trace" in want:
        with open(files["TRACE"]) as f:
            assert f.read().splitlines() == want["trace"]
    if run == "cache_trace":       # the decoder's output is the encoder's
        assert file_md5(files["OUT"]) == file_md5(files["REC"])
    if run == "hrd":
        assert any(ln.startswith("HRD: CPB") for ln in got)
    if run == "bitstats":
        assert any(ln.startswith("TOTAL") for ln in got)


def test_app_refusals(files, tmp_path):
    yuv = tmp_path / "in444.yuv"
    yuv.write_bytes(bytes(64 * 32 * 3))
    with pytest.raises(SystemExit, match="4:2:0"):
        encoder_app.main(["-i", str(yuv), "-b", str(tmp_path / "o.bin"),
                          "-wdt", "64", "-hgt", "32",
                          "--InputChromaFormat=444"] + CPU)
    for main, argv in ((encoder_app.main, []),
                       (encoder_app.main, ["-i", "x", "-b", "y"]),
                       (decoder_app.main, []),
                       (encoder_app.main, ["--NoSuchOption=1"])):
        with pytest.raises(SystemExit):
            main(argv)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is it")
    with pytest.raises(RuntimeError, match="CUDA"):
        encoder_app.main(app_args(APP_ENC_ARGS, files))
    with pytest.raises(RuntimeError, match="CUDA"):
        decoder_app.main(["-b", os.path.join(
            OUT_DIR, "app_ra128x64_mm_qp37_5f.bin")])


def _imports(stderr: str) -> set[str]:
    """The modules `python -X importtime` reports."""
    mods = set()
    for line in stderr.splitlines():
        if line.startswith("import time:") and "|" in line:
            mods.add(line.rsplit("|", 1)[1].strip())
    return mods


def test_apps_in_processes_import_no_jax(tmp_path):
    from vvc_mm_tpu_torch.common.typedefs import ChromaFormat
    from vvc_mm_tpu_torch.utils.content import realistic_sequence
    from vvc_mm_tpu_torch.utils.yuv_io import VideoFormat, YuvWriter

    src = tmp_path / "in.yuv"
    with YuvWriter(str(src), VideoFormat(64, 32, 8, ChromaFormat.C420)) as w:
        for f in realistic_sequence(64, 32, 2):
            w.write_frame(f)
    env = dict(os.environ, PYTHONPATH=ROOT)
    runs = (["encoder_app", "-i", str(src), "-b", str(tmp_path / "o.bin"),
             "-o", str(tmp_path / "rec.yuv"), "-wdt", "64", "-hgt", "32",
             "--GOP=LDP", "--MPA", "--ROT", "--WrapAround", "--Device=cpu"],
            ["decoder_app", "-b", str(tmp_path / "o.bin"), "-o",
             str(tmp_path / "dec.yuv"), "--Device=cpu"])
    for app, *argv in runs:
        out = subprocess.run(
            [sys.executable, "-X", "importtime", "-m",
             f"vvc_mm_tpu_torch.apps.{app}", *argv],
            capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-2000:]
        mods = _imports(out.stderr)
        assert "vvc_mm_tpu_torch.apps" in mods
        assert not {m for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "vvc_mm_tpu")}
    assert "(OK)" in out.stdout
    assert (tmp_path / "dec.yuv").read_bytes() == \
        (tmp_path / "rec.yuv").read_bytes()
