"""PyTorch port, the utility apps (ROADMAP queue 1 item 12) against the
JAX package's, at tolerance 0.

  host apps     parcat.splice, bitstream_extractor.extract (layers and
                temporal sub-streams), sei_removal.remove_sei (with and
                without the picture hashes), stream_merge.merge and
                subpic_merge.merge / parse_layout: the JAX functions' bytes
                on the same streams (committed JAX streams, and chunks the
                port's encoder codes here), and every result the port's
                DecLib decodes has every MD5 OK (parcat's after its one
                repair: the JAX app leaves the hash SEIs of later chunks
                at their old POCs, so its spliced stream differs from the
                port's in those SEIs' POC alone, and its MD5s fail);
  subpictures   subpic_merge.decode_merged through the port's DecLib: each
                subpicture the decode of its own stream;
  film grain    film_grain_app on the committed film grain stream: the JAX
                decoder app's --FilmGrain output (tests/data/torch_port/
                apps.json);
  360           convert_360 (ERP to EAC and a viewport, bilinear) through
                the port's lib360/geometry.py: the JAX app's output files;
  targeting     fit_qp_for_target on seeded trial encodes, bd_rate and
                bd_psnr on seeded curves: the JAX functions' values;
                bitrate_targeting.main and bd_rate.main on the CPU: the JAX
                apps' lines (apps.json).

Cost on one core: about 8 s."""
import json
import math
import os

import numpy as np
import pytest
import torch

from vvc_mm_tpu.apps import bd_rate as jax_bd
from vvc_mm_tpu.apps import bitrate_targeting as jax_target
from vvc_mm_tpu.apps import bitstream_extractor as jax_extractor
from vvc_mm_tpu.apps import convert_360 as jax_convert
from vvc_mm_tpu.apps import parcat as jax_parcat
from vvc_mm_tpu.apps import sei_removal as jax_sei
from vvc_mm_tpu.apps import stream_merge as jax_merge
from vvc_mm_tpu.apps import subpic_merge as jax_subpic
from vvc_mm_tpu_torch.apps import (bd_rate, bitrate_targeting,
                                   bitstream_extractor, convert_360,
                                   film_grain_app, parcat, sei_removal,
                                   stream_merge, subpic_merge)
from vvc_mm_tpu_torch.common.bitstream import NAL_SEI, read_annexb
from vvc_mm_tpu_torch.common.typedefs import ChromaFormat
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder.enclib import EncCfg, EncLib
from vvc_mm_tpu_torch.utils.content import realistic_sequence
from vvc_mm_tpu_torch.utils.yuv_io import VideoFormat, YuvWriter

from tests.make_torch_port_streams import (APP_BD_ARGS, APP_TARGET_ARGS,
                                           OUT_DIR, app_args, app_source,
                                           file_md5, run_app)

torch.set_num_threads(1)

CPU = ["--Device=cpu"]


def _committed(name: str) -> bytes:
    with open(os.path.join(OUT_DIR, name + ".bin"), "rb") as f:
        return f.read()


def _decode_ok(data: bytes):
    dec = DecLib(device="cpu")
    frames = dec.decode_bytes(data)
    assert dec.hash_status and all(v == "OK"
                                   for v in dec.hash_status.values())
    return frames


@pytest.fixture(scope="module")
def record():
    with open(os.path.join(OUT_DIR, "apps.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def chunks():
    """Two chunks of one clip (POCs 0-2 and 3-4), each coded by the
    port's encoder as its own LDP stream, and a third stream at QP 30."""
    clip = realistic_sequence(64, 32, 5)
    out = []
    for part, qp in ((clip[:3], 37), (clip[3:], 37), (clip[:2], 30)):
        enc = EncLib(EncCfg(width=64, height=32, qp=qp, gop="LDP"),
                     device="cpu")
        out.append((enc.encode_sequence(part), enc))
    return out


def test_parcat_matches_jax(chunks, tmp_path):
    parts = [c[0] for c in chunks[:2]]
    spliced = parcat.splice(parts)
    jax_spliced = jax_parcat.splice(parts)
    assert sorted(f.poc for f in _decode_ok(spliced)) == [0, 1, 2, 3, 4]
    # the same NALs but the second chunk's hash SEIs, which name POC + 3
    a, b = read_annexb(spliced), read_annexb(jax_spliced)
    moved = [(x, y) for x, y in zip(a, b) if x.payload != y.payload]
    assert len(a) == len(b) and len(moved) == 2
    for x, y in moved:
        assert x.nal_type == y.nal_type == NAL_SEI
        assert x.payload[1:] != y.payload[1:]
    dec = DecLib(device="cpu")
    dec.decode_bytes(jax_spliced)
    assert "MISMATCH" in dec.hash_status.values()
    no_hash = [sei_removal.remove_sei(p) for p in parts]
    assert parcat.splice(no_hash) == jax_parcat.splice(no_hash)
    paths = []
    for i, p in enumerate(parts):
        paths.append(str(tmp_path / f"c{i}.bin"))
        with open(paths[-1], "wb") as f:
            f.write(p)
    run_app(parcat.main, [str(tmp_path / "out.bin")] + paths)
    assert (tmp_path / "out.bin").read_bytes() == spliced


@pytest.mark.parametrize("keep_hash", [False, True])
def test_sei_removal_matches_jax(keep_hash):
    data = _committed("ra192x96_qp37_9f")
    out = sei_removal.remove_sei(data, keep_hash=keep_hash)
    assert out == jax_sei.remove_sei(data, keep_hash=keep_hash)
    seis = [n for n in read_annexb(out) if n.nal_type == NAL_SEI]
    assert bool(seis) == keep_hash
    dec = DecLib(device="cpu")
    assert len(dec.decode_bytes(out)) == 9
    assert all(v == "OK" for v in dec.hash_status.values())
    assert bool(dec.hash_status) == keep_hash


def test_merge_and_extract_match_jax(chunks):
    streams = [chunks[0][0], chunks[2][0]]
    merged = stream_merge.merge(streams)
    assert merged == jax_merge.merge(streams)
    assert {n.layer_id for n in read_annexb(merged)} == {0, 1}
    for layer, s in enumerate(streams):
        assert bitstream_extractor.extract(merged, layer=layer) == s
        assert jax_extractor.extract(merged, layer=layer) == s


@pytest.mark.parametrize("max_tid", [0, 1, 2])
def test_temporal_extraction_matches_jax(max_tid):
    data = _committed("ra192x96_qp37_9f")
    sub = bitstream_extractor.extract(data, layer=0, max_tid=max_tid)
    assert sub == jax_extractor.extract(data, layer=0, max_tid=max_tid)
    n = len(_decode_ok(sub))
    assert (n == 9) if max_tid == 2 else (0 < n < 9)


def test_subpic_merge_matches_jax(chunks):
    streams = [chunks[0][0], chunks[2][0]]
    merged = subpic_merge.merge(streams, cols=2)
    assert merged == jax_subpic.merge(streams, cols=2)
    assert subpic_merge.parse_layout(merged) == \
        jax_subpic.parse_layout(merged) == (2, 2, [(64, 32), (64, 32)])
    frames, (w, h) = subpic_merge.decode_merged(merged, device="cpu")
    assert (w, h) == (128, 32) and len(frames) == 2
    for i, s in enumerate(streams):
        own = [f.numpy() for f in _decode_ok(s)]
        for t in range(2):
            np.testing.assert_array_equal(frames[t][0][:, 64 * i:64 * i + 64],
                                          own[t][0])
            np.testing.assert_array_equal(frames[t][1][:, 32 * i:32 * i + 32],
                                          own[t][1])
    assert subpic_merge.parse_layout(streams[0]) is None


def test_film_grain_app_matches_jax(record, tmp_path):
    out = tmp_path / "grained.yuv"
    bs = os.path.join(OUT_DIR, "ai96x64_film_grain_qp37_2f.bin")
    lines = run_app(film_grain_app.main, ["-b", bs, "-o", str(out)] + CPU)
    assert lines == ["wrote 2 frames (with grain)"]
    assert file_md5(str(out)) == record["dec"]["film_grain"]["yuv_md5"]


def _random_yuv(path: str, w: int, h: int) -> None:
    rng = np.random.default_rng(21)
    with YuvWriter(path, VideoFormat(w, h, 8, ChromaFormat.C420)) as wr:
        for _ in range(2):
            wr.write_frame([rng.integers(0, 255, (h, w)),
                            rng.integers(0, 255, (h // 2, w // 2)),
                            rng.integers(0, 255, (h // 2, w // 2))])


@pytest.mark.parametrize("extra", [
    ["--src", "erp", "--dst", "eac", "-ow", "96", "-oh", "64"],
    ["-ow", "32", "-oh", "32", "--viewport", "90,30,10"]],
    ids=["eac", "viewport"])
def test_convert_360_matches_jax(tmp_path, extra):
    src = str(tmp_path / "in.yuv")
    _random_yuv(src, 96, 48)
    outs = []
    for mod, dev in ((convert_360, ["--Device", "cpu"]), (jax_convert, [])):
        outs.append(str(tmp_path / f"{mod.__name__}.yuv"))
        run_app(mod.main, ["-i", src, "-o", outs[-1], "-wdt", "96", "-hgt",
                           "48", "--method", "bilinear"] + extra + dev)
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        assert a.read() == b.read()


def test_fit_qp_for_target_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(50):
        slope = rng.uniform(-0.2, 0.02)
        trial = [(q, int(math.exp(12 + slope * q + rng.normal(0, 0.05))))
                 for q in (27, 32, 37)]
        target = math.exp(rng.uniform(5, 14))
        assert bitrate_targeting.fit_qp_for_target(trial, target) == \
            jax_target.fit_qp_for_target(trial, target)
    assert bitrate_targeting.PROBE_QPS == jax_target.PROBE_QPS


def test_bd_rate_bd_psnr_match_jax():
    rng = np.random.default_rng(6)
    for n in (3, 4):
        for _ in range(20):
            r1 = np.sort(rng.uniform(1e3, 1e5, n))
            p1 = np.sort(rng.uniform(28, 40, n))
            r2 = r1 * rng.uniform(0.7, 1.2)
            p2 = p1 + rng.uniform(-0.5, 0.5)
            for f, g in ((bd_rate.bd_rate, jax_bd.bd_rate),
                         (bd_rate.bd_psnr, jax_bd.bd_psnr)):
                np.testing.assert_array_equal(f(r1, p1, r2, p2),
                                              g(r1, p1, r2, p2))
    assert math.isnan(bd_rate.bd_rate([1, 2], [30, 31], [1, 2], [40, 41]))


def test_targeting_apps_match_jax(record, tmp_path):
    files = {"IN": str(tmp_path / "in.yuv")}
    app_source(files["IN"])
    assert run_app(bitrate_targeting.main,
                   app_args(APP_TARGET_ARGS, files) + CPU) == \
        record["target_stdout"]
    assert run_app(bd_rate.main, APP_BD_ARGS + CPU) == record["bd_stdout"]
