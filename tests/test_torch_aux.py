"""PyTorch port, the host modules of the analyser tools and the options
(ROADMAP queue 1 item 12), against the JAX package on the same seeded
inputs, at tolerance 0.

  options       utils/options.py: the same values from a cfg file, short
                aliases, --Name=value, bare flags and a repeatable option,
                the same help text and errors, parse_epipole;
  trace         utils/trace.py: Trace channels with conditions, BitStats
                accounting and report, StatsBinDecoder over the Python
                spec coder (the same bits and report as JAX's on a
                committed stream's slice);
  cache model   utils/cache_model.py: simulate_mc and the block /
                subblock estimates on seeded MV fields, the report;
  picture       common/picture.py: pad_plane (edge and wrap-around),
                Picture.md5, the DPB's bookkeeping and psnr (the one the
                port's utils/content.py re-exports);
  hooks         DecLib(stats=None, cache_model=None) keeps its native
                path, picture_bits holds each slice NAL's size, and the
                encoder's trace events of a flat MM P picture equal the
                decoder's.

Cost on one core: about 4 s."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import picture as jax_picture
from vvc_mm_tpu.utils import cache_model as jax_cm
from vvc_mm_tpu.utils import options as jax_options
from vvc_mm_tpu.utils import trace as jax_trace
from vvc_mm_tpu_torch.common import picture
from vvc_mm_tpu_torch.common.bitstream import NAL_IDR, NAL_TRAIL, read_annexb
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.utils import cache_model, content, options, trace

from tests.make_torch_port_streams import OUT_DIR

torch.set_num_threads(1)


def _parser(mod):
    p = mod.OptionParser()
    p.add("InputFile", "", "input YUV file")
    p.add("SourceWidth", 0, "frame width")
    p.add("SourceHeight", 0, "frame height")
    p.add("QP", 32, "base QP")
    p.add("FrameRate", 30.0, "fps")
    p.add("WrapAround", False, "ERP wrap-around")
    p.add("GOP", "RA", "AI | LDP | RA")
    p.add("Epipole", [], "curPOC,refPOC,x,y,z", parse=mod.parse_epipole)
    return p


@pytest.mark.parametrize("argv", [
    ["-i", "in.yuv", "-wdt", "0x40", "-hgt", "32", "-q", "37"],
    ["--QP=30", "--WrapAround", "--GOP=LDP", "--FrameRate=29.97",
     "--Epipole=1,0,0.5,0.5,0.7071", "--Epipole=2,0,0,0,1"],
    ["-c", "{CFG}", "--QP=22"],
    ["--qp=40", "--wraparound=0", "--sourcewidth", "-q", "12"],
], ids=["short", "long", "cfg", "case"])
def test_options_match_jax(argv, tmp_path):
    cfg = tmp_path / "enc.cfg"
    cfg.write_text("QP : 35   # the CTC QP\n\nGOP : AI\n"
                   "Epipole : 3,1,0.0,1.0,0.0\nWrapAround : yes\n")
    argv = [a.replace("{CFG}", str(cfg)) for a in argv]
    assert _parser(options).parse(argv) == _parser(jax_options).parse(argv)
    assert _parser(options).help_text() == _parser(jax_options).help_text()


def test_options_errors_match_jax(tmp_path):
    bad = tmp_path / "bad.cfg"
    bad.write_text("QP 35\n")
    for argv in (["--NoSuchOption=1"], ["stray"], ["-h"]):
        with pytest.raises(SystemExit) as a:
            _parser(options).parse(argv)
        with pytest.raises(SystemExit) as b:
            _parser(jax_options).parse(argv)
        assert str(a.value) == str(b.value)
    for mod in (options, jax_options):
        with pytest.raises(ValueError, match="bad cfg line"):
            _parser(mod).parse(["-c", str(bad)])
        with pytest.raises(ValueError, match="5 comma values"):
            mod.parse_epipole("1,2,3")
    assert options.parse_epipole("4,0,0.3,-0.5,0.8") == \
        jax_options.parse_epipole("4,0,0.3,-0.5,0.8")


def _trace_events(mod, rules):
    tr = mod.Trace(rules)
    rng = np.random.default_rng(5)
    for poc in range(3):
        tr.set_ctx(poc=poc)
        for by in range(3):
            tr.set_ctx(by=by)
            tr.log("motion_model", by=by, bx=1, model=int(rng.integers(9)))
            tr.log("mvd", by=by, bx=1, x=int(rng.integers(-9, 9)),
                   y=int(rng.integers(-9, 9)))
            tr.log("other", by=by)
    return tr.events


@pytest.mark.parametrize("rules", [
    ["motion_model", "mvd"], ["mvd:poc==1"], ["motion_model:by>0 and poc<2",
                                              "mvd:nope"], []])
def test_trace_rules_match_jax(rules):
    assert _trace_events(trace, rules) == _trace_events(jax_trace, rules)


def test_trace_file_and_global(tmp_path):
    paths = [tmp_path / "p.txt", tmp_path / "j.txt"]
    for mod, path in zip((trace, jax_trace), paths):
        tr = mod.enable_trace(["mvd:x!=0"], str(path))
        assert mod.TRACE is tr
        for x in (0, 3, -2):
            tr.set_ctx(x=x)
            tr.log("mvd", by=0, bx=0, x=x, y=1)
        mod.disable_trace()
        assert mod.TRACE is None
    assert paths[0].read_text() == paths[1].read_text() != ""


def test_bitstats_match_jax():
    reports = []
    for mod in (trace, jax_trace):
        st = mod.BitStats()
        rng = np.random.default_rng(2)
        for name in ("cbf", "mvd", "residual_y", "cbf", "skip_flag"):
            st.label(name)
            for _ in range(5):
                st.add(float(rng.uniform(0.01, 3.0)),
                       int(rng.integers(1, 4)))
        reports.append(st.report())
    assert reports[0] == reports[1]


def test_stats_bin_decoder_matches_jax():
    """The Python spec coder with accounting over an I slice's CABAC
    payload (the committed 256x128 stream): the same bins and bits."""
    from vvc_mm_tpu.decoder.intra_parser import \
        decode_intra_slice as jax_intra
    from vvc_mm_tpu_torch.common.slice_ps import SPS, SliceHeader
    from vvc_mm_tpu_torch.common.bitstream import (NAL_IDR, NAL_SPS,
                                                   BitReader)
    from vvc_mm_tpu_torch.decoder.intra_parser import decode_intra_slice

    with open(os.path.join(OUT_DIR, "erp256x128_ra_mm_qp37_5f.bin"),
              "rb") as f:
        nals = read_annexb(f.read())
    sps = SPS.read(BitReader(next(n for n in nals
                                  if n.nal_type == NAL_SPS).payload))
    idr = next(n for n in nals if n.nal_type == NAL_IDR).payload
    br = BitReader(idr)
    SliceHeader.read(br, sps)
    cabac = bytes(idr[br._pos // 8:])
    s = sps.intra_block_size
    grids, reps = [], []
    for fn, mod in ((decode_intra_slice, trace), (jax_intra, jax_trace)):
        st = mod.BitStats()
        grids.append(fn(cabac, sps.height // s, sps.width // s, s,
                        stats=st))
        reps.append(st.report())
    assert reps[0] == reps[1]
    for a, b in zip(grids[0], grids[1]):
        np.testing.assert_array_equal(a, np.asarray(b))
    native = decode_intra_slice(cabac, sps.height // s, sps.width // s, s)
    for a, b in zip(grids[0], native):
        np.testing.assert_array_equal(a, b)


def test_cache_model_matches_jax():
    rng = np.random.default_rng(11)
    out = []
    for mod in (cache_model, jax_cm):
        cm = mod.CacheModel()
        assert cm.report() == "CacheModel: no inter traffic recorded"
        for poc, s in ((1, 16), (2, 8), (3, 32)):
            cm.start_frame(poc)
            mvs = rng.integers(-300, 300, (64 // s, 128 // s, 2))
            cm.simulate_mc(mvs, s, 128)
            cm.report_block_mc(7, s)
            cm.report_subblock_mc(96, chroma=poc != 2)
        out.append((cm.report(25.0), [vars(f) for f in cm.frames]))
        rng = np.random.default_rng(11)
    assert out[0] == out[1]
    cm = cache_model.CacheModel()
    cm.simulate_mc(np.zeros((2, 2, 2), np.int64), 16, 64)   # no frame: no-op
    assert cm.frames == []


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("margin", [3, 16])
def test_pad_plane_matches_jax(wrap, margin):
    rng = np.random.default_rng(margin)
    plane = rng.integers(0, 1024, (24, 40)).astype(np.int32)
    got = picture.pad_plane(torch.from_numpy(plane), margin, wrap)
    want = np.asarray(jax_picture.pad_plane(jnp.asarray(plane), margin,
                                            wrap))
    np.testing.assert_array_equal(got.numpy(), want)


def test_picture_and_dpb_match_jax():
    rng = np.random.default_rng(4)
    planes = [rng.integers(0, 1024, (16, 32)).astype(np.int32),
              rng.integers(0, 1024, (8, 16)).astype(np.int32),
              rng.integers(0, 1024, (8, 16)).astype(np.int32)]
    for bd in (8, 10):
        kw = dict(poc=3, width=32, height=16, bit_depth=bd, wrap_around=True)
        p = picture.Picture(recon=[torch.from_numpy(x) for x in planes],
                            **kw)
        j = jax_picture.Picture(recon=[jnp.asarray(x) for x in planes], **kw)
        assert p.md5() == j.md5()
        p.finalize_recon()
        j.finalize_recon()
        for a, b in zip(p.recon_padded, j.recon_padded):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dpbs = (picture.DecodedPictureBuffer(3),
            jax_picture.DecodedPictureBuffer(3))
    for poc in (0, 4, 2, 1, 3, 8):
        for dpb, mod in zip(dpbs, (picture, jax_picture)):
            dpb.add(mod.Picture(poc=poc, width=8, height=8,
                                is_output=poc % 2 == 0))
    for dpb in dpbs:
        assert [(q.poc, q.is_reference) for q in dpb.pics] == \
            [(q.poc, q.is_reference) for q in dpbs[1].pics]
        assert [q.poc for q in dpb.ref_list(8, [3, 8, 4])] == [3, 4]
        with pytest.raises(KeyError, match="POC 99"):
            dpb.get(99)


def test_psnr_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.integers(0, 1024, (32, 48))
    b = np.clip(a + rng.integers(-5, 6, a.shape), 0, 1023)
    for bd in (8, 10):
        assert picture.psnr(a, b, bd) == jax_picture.psnr(a, b, bd)
        assert picture.psnr(a, a, bd) == 999.99
    assert content.psnr is picture.psnr


def test_declib_hooks_off_and_picture_bits():
    """Without hooks the decoder parses natively; picture_bits holds each
    slice NAL's bits."""
    with open(os.path.join(OUT_DIR, "ldp192x96_qp37_4f.bin"), "rb") as f:
        data = f.read()
    dec = DecLib(device="cpu")
    assert dec.stats is None and dec.cache_model is None
    dec.decode_bytes(data)
    assert all(v == "OK" for v in dec.hash_status.values())
    slices = [n for n in read_annexb(data)
              if n.nal_type in (NAL_IDR, NAL_TRAIL)]
    assert sorted(dec.picture_bits.values()) == \
        sorted(len(n.payload) * 8 for n in slices)
    assert sorted(dec.picture_bits) == sorted(dec.hash_status)


def test_encoder_trace_matches_decoder():
    """The flat MM P picture's motion_model / mvd events: the encoder's
    (when it writes the slice) equal the decoder's (when it parses it)."""
    from vvc_mm_tpu_torch.encoder.enclib import EncCfg, EncLib
    from vvc_mm_tpu_torch.common.slice_ps import MMConfig

    frames = content.realistic_sequence(64, 32, 2)
    enc = EncLib(EncCfg(width=64, height=32, qp=37, gop="LDP",
                        wrap_around=True, merge=False,
                        mm=MMConfig(mpa=True, rot=True)), device="cpu")
    tr = trace.enable_trace(["motion_model", "mvd"])
    try:
        data = enc.encode_sequence(frames)
        enc_events = list(tr.events)
        tr.events.clear()
        DecLib(device="cpu").decode_bytes(data)
    finally:
        trace.disable_trace()
    assert enc_events and enc_events == tr.events
    assert {c for c, _ in enc_events} == {"motion_model", "mvd"}
