"""PyTorch port, the encoder's in-loop filter decisions against the JAX
package on the same pictures.

SAO: types, offsets and band positions are integer decisions taken from
correctly rounded float32 divisions and float32 sums of integer-valued
gains: exact (tolerance 0).  ALF: classification, filtering and the region
decisions are integer: exact.  The Wiener statistics are float32 sums of up
to 255^2 * H * W in the JAX package, whose last bits depend on the order of
reduction, and exact float64 sums in the port: compared with rtol = 1e-5
(measured: 2.7e-7), and the rounded coefficients that differ are counted
(measured: none on these pictures)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import alf as jax_alf
from vvc_mm_tpu.common import sao as jax_sao
from vvc_mm_tpu.common.quant import lambda_from_qp
from vvc_mm_tpu.encoder import filter_stage as jax_fs
from vvc_mm_tpu_torch.common import alf, sao
from vvc_mm_tpu_torch.common.bitstream import NAL_SEI, read_annexb, \
    write_annexb
from vvc_mm_tpu_torch.common.slice_ps import MMConfig
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder import filter_stage
from vvc_mm_tpu_torch.encoder.enclib import EncCfg, EncLib
from vvc_mm_tpu_torch.utils.content import realistic_sequence

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
STREAM = os.path.join(DATA, "erp256x128_ra_mm_qp37_5f.bin")
QP = 38
LAM = lambda_from_qp(QP, intra=False)
STATS_RTOL = 1e-5
# rounded ALF coefficients (25 x 12 luma, 6 + 6 chroma, 7 + 7 CC-ALF) that
# differ from the JAX package's on the test picture: measured
MAX_COEFF_MISMATCHES = 0


@pytest.fixture(scope="module")
def pictures():
    """(source planes, deblocked pre-filter reconstruction) of POC 4 of the
    256x128 clip, encoded by the port from the committed I picture."""
    head = []
    for nal in read_annexb(open(STREAM, "rb").read()):
        head.append(nal)
        if nal.nal_type == NAL_SEI:
            break
    dec = DecLib(device="cpu")
    dec.decode_bytes(write_annexb(head))
    src = realistic_sequence(256, 128, 5)
    enc = EncLib(EncCfg(width=256, height=128, qp=37, gop="RA", qt_depth=1,
                        wrap_around=True, mm=MMConfig(mpa=True, rot=True)),
                 device="cpu")
    enc.encode_p_frame(4, src[4], dec.frames[0].numpy(), 0, qp=QP)
    orig = [p.astype(np.int32) for p in src[4]]
    rec = {k: v.numpy() for k, v in enc.prefilter_recon.items()}
    return orig, rec


def _both(orig, rec):
    jdev = tuple(jnp.asarray(p) for p in orig)
    jrec = {k: jnp.asarray(v) for k, v in rec.items()}
    tdev = tuple(torch.from_numpy(p) for p in orig)
    trec = {k: torch.from_numpy(v) for k, v in rec.items()}
    return jdev, jrec, tdev, trec


def _params_equal(got, want):
    if want is None or got is None:
        return want is None and got is None
    return all((g is None and w is None) or
               (g is not None and w is not None and
                all(np.array_equal(np.asarray(a), np.asarray(b))
                    for a, b in zip(g, w)))
               for g, w in zip(got, want))


@pytest.fixture(scope="module")
def sao_out(pictures):
    jdev, jrec, tdev, trec = _both(*pictures)
    return (jax_fs.run_sao(jrec, jdev, LAM, 8),
            filter_stage.run_sao(trec, tdev, LAM, 8), jdev, tdev)


def test_sao_stage_parameters_exact(sao_out):
    (jrec2, jparams), (trec2, tparams), _, _ = sao_out
    assert jparams is not None and jparams[0] is not None   # SAO is on
    assert _params_equal(tparams, jparams)
    for k in "yuv":
        np.testing.assert_array_equal(trec2[k].numpy(),
                                      np.asarray(jrec2[k]))


@pytest.mark.parametrize("shape", [(128, 192), (72, 40)],
                         ids=["aligned", "ragged"])
def test_estimate_sao_exact_on_noisy_planes(rng, shape):
    """Strong banding and edge noise so that every SAO type is chosen
    somewhere; (72, 40) takes the edge-padding path."""
    h, w = shape
    orig = rng.integers(0, 256, shape).astype(np.int32)
    orig[:, : w // 2] = (np.arange(h)[:, None] * 2) % 256
    rec = np.clip(orig + rng.integers(-6, 7, shape)
                  + 3 * ((orig >> 3) % 5 == 1), 0, 255).astype(np.int32)
    for lam in (LAM, 1.0):
        want = jax_sao.estimate_sao(jnp.asarray(orig), jnp.asarray(rec),
                                    lam, 8)
        got = sao.estimate_sao(torch.from_numpy(orig), torch.from_numpy(rec),
                               lam, 8)
        for g, w_ in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert len(np.unique(np.asarray(want[0]))) >= 2


def test_alf_statistics_within_float32_of_jax(sao_out):
    (jrec2, _), (trec2, _), jdev, tdev = sao_out
    jcls, jstats = jax_fs._alf_stats_stage(
        jdev[0], jrec2["y"], jdev[1], jrec2["u"], jdev[2], jrec2["v"], 8)
    tcls, tstats = filter_stage._alf_stats_stage(
        tdev[0], trec2["y"], tdev[1], trec2["u"], tdev[2], trec2["v"], 8)
    np.testing.assert_array_equal(tcls.numpy(), np.asarray(jcls))
    want = np.asarray(jstats).astype(np.float64)
    got = tstats.numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=STATS_RTOL, atol=0)
    # the port's sums are exact: they are whole numbers
    np.testing.assert_array_equal(got, np.round(got))
    n = alf.NUM_CLASSES * alf.NUM_COEFF
    a = got[:n * alf.NUM_COEFF].reshape(alf.NUM_CLASSES, alf.NUM_COEFF, -1)
    b = got[n * alf.NUM_COEFF:n * alf.NUM_COEFF + n].reshape(
        alf.NUM_CLASSES, -1)
    ja = want[:n * alf.NUM_COEFF].reshape(a.shape)
    jb = want[n * alf.NUM_COEFF:n * alf.NUM_COEFF + n].reshape(b.shape)
    diff = int((alf.solve_coeffs(a, b) != jax_alf.solve_coeffs(ja, jb)).sum())
    assert diff <= MAX_COEFF_MISMATCHES


def test_run_alf_decisions_and_pictures(sao_out):
    """The whole ALF family: coefficient mismatches counted, enable maps
    and (the coefficients being equal here) the filtered planes equal."""
    (jrec2, _), (trec2, _), jdev, tdev = sao_out
    jout = jax_fs.run_alf(jrec2, jdev, LAM, 8)
    tout = filter_stage.run_alf(trec2, tdev, LAM, 8)
    mismatches = 0
    for jp, tp in zip(jout[1:], tout[1:]):
        assert (jp is None) == (tp is None)
        if jp is None:
            continue
        pairs = [(jp, tp)] if isinstance(jp[0], np.ndarray) else zip(jp, tp)
        for a, b in pairs:
            assert (a is None) == (b is None)
            if a is not None:
                mismatches += int((np.asarray(a[0]) != np.asarray(b[0]))
                                  .sum())
                np.testing.assert_array_equal(a[1], b[1])
    assert mismatches <= MAX_COEFF_MISMATCHES
    assert jout[2] is not None and jout[3] is not None   # chroma, CC-ALF on
    if mismatches == 0:
        for k in "yuv":
            np.testing.assert_array_equal(tout[0][k].numpy(),
                                          np.asarray(jout[0][k]))


def test_alf_integer_functions_exact(rng):
    """filter_frame, filter_chroma, the CC-ALF correction and
    region_decide on random coefficients."""
    h, w = 64, 128
    rec = rng.integers(0, 256, (h, w)).astype(np.int32)
    orig = np.clip(rec + rng.integers(-9, 10, (h, w)), 0, 255) \
        .astype(np.int32)
    jr, tr = jnp.asarray(rec), torch.from_numpy(rec)
    jcls = jax_alf.classify(jr, 8)
    tcls = alf.classify(tr, 8)
    np.testing.assert_array_equal(tcls.numpy(), np.asarray(jcls))
    cl = rng.integers(-40, 41, (alf.NUM_CLASSES, alf.NUM_COEFF)) \
        .astype(np.int32)
    jf = jax_alf.filter_frame(jr, jcls, jnp.asarray(cl), 8)
    tf = alf.filter_frame(tr, tcls, cl, 8)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    for lam in (LAM, 0.0, 5000.0):
        np.testing.assert_array_equal(
            alf.region_decide(torch.from_numpy(orig), tr, tf, lam,
                              8).numpy(),
            np.asarray(jax_alf.region_decide(jnp.asarray(orig), jr, jf, lam,
                                             8)))
    cc = rng.integers(-40, 41, alf.NUM_COEFF_C).astype(np.int32)
    np.testing.assert_array_equal(
        alf.filter_chroma(tr, cc, 8).numpy(),
        np.asarray(jax_alf.filter_chroma(jr, jnp.asarray(cc), 8)))
    luma = rng.integers(0, 256, (2 * h, 2 * w)).astype(np.int32)
    np.testing.assert_array_equal(
        alf._ccalf_features(torch.from_numpy(luma), h, w).numpy(),
        np.asarray(jax_alf._ccalf_features(jnp.asarray(luma), h, w)))
    ccc = np.array([4, -8, 16, 0, -2, 1, 32], np.int32)
    en = np.ones((1, 2), bool)
    np.testing.assert_array_equal(
        alf.filter_ccalf(tr, torch.from_numpy(luma), ccc, 8).numpy(),
        np.asarray(jax_alf.apply_ccalf(jr, jnp.asarray(luma),
                                       jnp.asarray(ccc), jnp.asarray(en),
                                       8)))
    for fn, jfn in ((alf._stats_c, jax_alf._stats_c),):
        ta, tb = fn(tr, torch.from_numpy(orig))
        ja, jb = jfn(jr, jnp.asarray(orig))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja),
                                   rtol=STATS_RTOL)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb),
                                   rtol=STATS_RTOL, atol=1.0)
