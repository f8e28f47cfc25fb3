"""PyTorch port, rate control, the MCTF pre-filter and the per-picture 360
metrics in EncLib (ROADMAP queue 1 items 11f and 11g), against the JAX
package.

  rate       RateControl (a copy of the JAX package's host float64 code):
             its QP picks and model state over a seeded sequence of picture
             kinds and bit counts equal the JAX class's, exactly;
  mctf       filter_frame and prefilter_sequence (the hierarchical search,
             the fractional refinement, MC and the float32 bilateral
             combine of the JAX package's jit) at 128x64: every filtered
             plane equal (0 differing samples, pinned);
  stream     the port's CPU encode of erp256x128_ra_mm_rc_mctf_5f (the
             headline tools with mctf=True, target_bitrate_kbps=30 and
             metrics_360=True, RA GOP 4, 5 frames) equals the committed JAX
             stream byte for byte, with the JAX encoder's MD5s and bits,
             the port decodes it with every MD5 OK, its filtered source
             pictures equal the JAX prefilter's (the sidecar's MD5s), and
             every per-POC 360 metric and summary average is within 1e-3
             dB of the JAX encoder's (largest seen: 4e-6 dB).

Cost on one core: about 25 s (the stream 13 s)."""
import numpy as np
import pytest
import torch

from vvc_mm_tpu.encoder import mctf as jax_mctf
from vvc_mm_tpu.encoder import rate_ctrl as jax_rc
from vvc_mm_tpu_torch.encoder import mctf
from vvc_mm_tpu_torch.encoder import rate_ctrl
from vvc_mm_tpu_torch.utils.content import realistic_sequence

from tests.make_torch_port_streams import (assert_lib360_run, lib360_frames,
                                           metrics_360_diff, plane_md5,
                                           port_lib360_run)

torch.set_num_threads(1)


@pytest.mark.parametrize("kbps,size", [(30, (256, 128)), (500, (416, 240)),
                                       (1920, (2048, 1024))])
def test_rate_control_matches_jax(kbps, size):
    rng = np.random.default_rng(kbps)
    a = jax_rc.RateControl(kbps * 1000.0, 30.0, *size)
    b = rate_ctrl.RateControl(kbps * 1000.0, 30.0, *size)
    kinds = ["I"] + [("P", 0), ("B", 1), ("B", 2), ("B", 3), ("B", 4)] * 8
    for k in kinds:
        kind, tid = (k, 0) if k == "I" else k
        assert b.pick_qp(kind, tid) == a.pick_qp(kind, tid)
        bits = int(rng.integers(100, 200000))
        a.update(bits)
        b.update(bits)
        assert (b.alpha, b.beta, b.budget, b.last_lambda) == \
            (a.alpha, a.beta, a.budget, a.last_lambda)


@pytest.mark.parametrize("gop,n,kbps", [("RA", 1, 0), ("LDP", 3, 0),
                                        ("LDP", 3, 40), ("AI", 2, 40)])
def test_rate_control_qp_arms(gop, n, kbps):
    """The QP each loop of encode_sequence gives a picture, as in the JAX
    package: RA's CTC cascade only from two frames (a one-frame RA
    sequence codes at the configuration's QP), LDP and AI at the
    configuration's QP, and under rate control the RateControl pick from
    the bits coded so far."""
    from vvc_mm_tpu_torch.common import bitstream as bs
    from vvc_mm_tpu_torch.common.slice_ps import SliceHeader
    from vvc_mm_tpu_torch.encoder.enclib import EncCfg, EncLib

    cfg = EncCfg(width=64, height=64, qp=33, gop=gop, gop_size=4,
                 target_bitrate_kbps=kbps)
    enc = EncLib(cfg, device="cpu")
    data = enc.encode_sequence(realistic_sequence(64, 64, n))
    qps = [SliceHeader.read(bs.BitReader(x.payload), enc.sps).qp
           for x in bs.read_annexb(data)
           if x.nal_type in (bs.NAL_IDR, bs.NAL_TRAIL)]
    want = [33] * n
    if kbps:
        ref = rate_ctrl.RateControl(kbps * 1000.0, 30.0, 64, 64)
        want = []
        for r in sorted(enc.results, key=lambda r: r.poc):
            kind = "I" if gop == "AI" or r.poc == 0 else "P"
            want.append(ref.pick_qp(kind, 0))
            ref.update(r.bits)
    assert qps == want


@pytest.fixture(scope="module")
def clip():
    return realistic_sequence(128, 64, 9)


@pytest.mark.parametrize("poc,qp,strength", [(0, 22, 1.5), (4, 37, 0.95),
                                             (8, 37, 1.5)])
def test_filter_frame_matches_jax(clip, poc, qp, strength):
    want = jax_mctf.filter_frame(clip, poc, qp, 8, strength=strength)
    got = mctf.filter_frame(clip, poc, qp, 8, strength=strength,
                            device="cpu")
    for g, w, src in zip(got, want, clip[poc]):
        w = np.asarray(w)
        assert g.dtype == np.int32 and g.shape == w.shape
        assert int((g != w).sum()) == 0
        assert (g != src).any()          # the filter did move samples


def test_prefilter_sequence_matches_jax(clip):
    want = jax_mctf.prefilter_sequence(clip[:5], 32, 8, period=4)
    got = mctf.prefilter_sequence(clip[:5], 32, 8, period=4, device="cpu")
    for poc in range(5):
        for g, w in zip(got[poc], want[poc]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got[1] is clip[1]             # not an anchor: passed through
    # dimensions that do not divide by 64: the frame passes through
    odd = realistic_sequence(96, 64, 3)
    assert mctf.filter_frame(odd, 0, 37, device="cpu") is odd[0]


def test_rc_mctf_metrics_stream_byte_exact():
    name = "erp256x128_ra_mm_rc_mctf_5f"
    run = port_lib360_run(name)
    assert_lib360_run(run)
    sd = run["sd"]
    filtered = mctf.prefilter_sequence(lib360_frames(name), sd["qp"], 8,
                                       period=sd["gop_size"], device="cpu")
    assert {p: plane_md5(filtered[int(p)]) for p in sd["mctf_md5"]} == \
        sd["mctf_md5"]
    assert sd["mctf"] and sd["metrics_360"] and sd["target_bitrate_kbps"]
    assert metrics_360_diff(run["enc"].results, sd) <= 1e-4
    assert set(run["enc"].results[0].metrics_360) == {
        "ws_psnr", "s_psnr_nn", "s_psnr_i", "cpp_psnr"}
