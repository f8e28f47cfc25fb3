"""PyTorch port, multi-model coding of Equisolid (fisheye) content and the
rest of lib360/projection.py (ROADMAP queue 1 item 11g), against the JAX
package.

  projection  Equisolid's to_sphere / from_sphere op by op, LookupTable
              (jnp.interp's float32 form) and Calibrated, on seeded points:
              equal to the JAX package's; tests/test_mm_models.py:150's
              round trip; make_projection's defaults;
  lut         ReprojectionLUT (a host float64 copy) equals the JAX one on
              tests/test_mm_models.py:176's case;
  positions   the merged positions (the JAX decoder's jit of
              merged_positions) of MPA x3, ROT, 3DT, TAN, GED and GEDA on
              a 128x128 Equisolid, random MV fields: every model copies
              the compiled form, 0 differing subblocks; at 1088x1088 (the
              default focal's sensor) TAN, GED and GEDA equal the JAX
              positions' SHA-256 (tests/make_torch_port_streams.py
              equisolid_sha256 wrote them; a JAX run there takes 18 s);
  stream      the port's CPU encode of fish128x128_ra_mm_qp37_5f
              (Equisolid, MPA+ROT, the MM quadtree, RA GOP 4, 5 frames)
              and of fish128x128_ra_t3d_tan_ged_qp37_5f (3DT, TAN, GED
              with a signalled epipole and GEDA) equal the committed JAX
              streams byte for byte, and the port decodes them with every
              MD5 OK (0 differing decisions);
  refusals    CALIBRATED with a motion model is refused when EncLib is
              built (the JAX package's Calibrated has no `focal`, so its
              encoder fails at the first P picture); PERSPECTIVE raises in
              both packages.

Cost on one core: about 55 s (the streams 12 s and 28 s, the JAX
positions' compiles)."""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common.mm import frame_codec as jax_fc
from vvc_mm_tpu.common.mm import reprojection as jax_rp
from vvc_mm_tpu.common.typedefs import ProjectionID
from vvc_mm_tpu.lib360 import projection as jax_proj
from vvc_mm_tpu_torch.common.mm import frame_codec
from vvc_mm_tpu_torch.common.mm import reprojection as rp
from vvc_mm_tpu_torch.common.slice_ps import MMConfig
from vvc_mm_tpu_torch.encoder.enclib import EncCfg, EncLib
from vvc_mm_tpu_torch.lib360 import projection as proj

from tests.make_torch_port_streams import assert_lib360_run, port_lib360_run

torch.set_num_threads(1)

T = torch.from_numpy
BLOCK = 16
EPIPOLE = (0.3, -0.5, 0.8)
# model id -> subblocks of the 128x128 Equisolid merged positions that
# differ from the JAX package's (seed 100 + model, MVs uniform in +-24
# pel); measured on the development machine's CPU, no slack
MEASURED = {1: 0, 2: 0, 3: 0, 6: 0, 4: 0, 5: 0, 7: 0, 8: 0}
# model id -> SHA-256 of the JAX package's merged positions (little-endian
# int32) on a 1088x1088 Equisolid, the same fields at that size
# (tests/make_torch_port_streams.py equisolid_sha256)
SHA256_1088 = {
    5: "40960327c8d15e623c2f82590d5f7330ada14fbe37c36a3076a02b3cd07f8936",
    7: "734e9543e77fd0dfff1a402570d9b34beec4b1923baf60069d6e9e469ec41bb1",
    8: "a5d00c2fa96330a58ac48f60783de015db8ae01b67e5dbdce8e4c47eb31b43ff"}


def _points(n=4096, seed=3, lo=-80.0, hi=1200.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, n).astype(np.float32),
            rng.uniform(lo, hi, n).astype(np.float32))


def test_equisolid_matches_jax():
    w = h = 1088
    pj = jax_proj.make_projection(ProjectionID.EQUISOLID, w, h)
    pp = proj.make_projection(ProjectionID.EQUISOLID, w, h)
    assert (pp.focal, pp.cx, pp.cy) == (pj.focal, pj.cx, pj.cy)
    x, y = _points()
    want = [np.asarray(v) for v in pj.to_sphere(jnp.asarray(x),
                                                jnp.asarray(y))]
    got = [v.numpy() for v in pp.to_sphere(T(x), T(y))]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    back_j = [np.asarray(v) for v in pj.from_sphere(*map(jnp.asarray,
                                                         want))]
    back_p = [v.numpy() for v in pp.from_sphere(*map(T, want))]
    for a, b in zip(back_p, back_j):
        np.testing.assert_array_equal(a, b)
    # the grid's folded sphere points are to_sphere's, on any device
    for a, b in zip(pp.to_sphere_folded(T(x), T(y)), got):
        assert torch.equal(a, T(b))


def test_lookup_table_and_calibrated_match_jax():
    fn = (lambda t: 2.0 * t + 0.5 * t * t)
    lj = jax_proj.LookupTable(fn, (0.0, 2.0), 512)
    lp = proj.LookupTable(fn, (0.0, 2.0), 512)
    np.testing.assert_array_equal(lp.xs, lj.xs)
    np.testing.assert_array_equal(lp.ys, lj.ys)
    rng = np.random.default_rng(9)
    # inside, on the samples and outside both ends
    xs = np.concatenate([rng.uniform(-0.5, 2.5, 2000), lj.xs[::7]]
                        ).astype(np.float32)
    np.testing.assert_array_equal(lp.lookup(T(xs)).numpy(),
                                  np.asarray(lj.lookup(xs)))
    ys = rng.uniform(-1.0, 7.0, 2000).astype(np.float32)
    np.testing.assert_array_equal(lp.inverse_lookup(T(ys)).numpy(),
                                  np.asarray(lj.inverse_lookup(ys)))
    with pytest.raises(ValueError, match="monotone"):
        proj.LookupTable(lambda t: -t, (0.0, 1.0), 16)
    # tests/test_mm_models.py:150: the calibrated round trip
    cj = jax_proj.Calibrated((0.0, 300.0, 20.0), cx=200.0, cy=150.0)
    cp = proj.Calibrated((0.0, 300.0, 20.0), cx=200.0, cy=150.0)
    px = np.array([200.0, 260.0, 120.0, 300.0], np.float32)
    py = np.array([150.0, 190.0, 100.0, 60.0], np.float32)
    sj = [np.asarray(v) for v in cj.to_sphere(jnp.asarray(px),
                                              jnp.asarray(py))]
    sp = [v.numpy() for v in cp.to_sphere(T(px), T(py))]
    for a, b in zip(sp, sj):
        np.testing.assert_array_equal(a, b)
    bj = [np.asarray(v) for v in cj.from_sphere(*map(jnp.asarray, sj))]
    bp = [v.numpy() for v in cp.from_sphere(*map(T, sj))]
    for a, b in zip(bp, bj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(bp[0], px, atol=0.1)
    np.testing.assert_allclose(bp[1], py, atol=0.1)
    # make_projection's default calibration: r = f * theta
    dj = jax_proj.make_projection(ProjectionID.CALIBRATED, 64, 48)
    dp = proj.make_projection(ProjectionID.CALIBRATED, 64, 48)
    assert dp.coeffs == dj.coeffs and (dp.cx, dp.cy) == (dj.cx, dj.cy)


def test_reprojection_lut_matches_jax():
    def fn(x, y):
        return x * 0.5 + y * 0.25, y * 2.0 - x * 0.125

    lj = jax_rp.ReprojectionLUT(fn, (-16, 16), (-8, 8), step=1.0)
    lp = rp.ReprojectionLUT(fn, (-16, 16), (-8, 8), step=1.0)
    xs = np.array([-15.0, -3.5, 0.0, 2.25, 15.5, 40.0])
    ys = np.array([-7.0, 1.5, 0.0, -2.75, 7.5, -30.0])
    for a, b in zip(lp(xs, ys), lj(xs, ys)):
        np.testing.assert_array_equal(a, b)
    eu, ev = fn(xs[:5], ys[:5])
    np.testing.assert_allclose(lp(xs[:5], ys[:5])[0], eu, atol=1e-9)
    np.testing.assert_allclose(lp(xs[:5], ys[:5])[1], ev, atol=1e-9)


@pytest.fixture(scope="module")
def reprojections():
    w = h = 128
    jr = jax_rp.MVReprojection(
        jax_proj.make_projection(ProjectionID.EQUISOLID, w, h), w, h, 1)
    pr = rp.MVReprojection(proj.make_projection(ProjectionID.EQUISOLID, w,
                                                h), w, h, 1, device="cpu")
    return jr, pr


@pytest.mark.parametrize("model", list(MEASURED),
                         ids=[f"m{m}" for m in MEASURED])
def test_equisolid_positions_match_jax(reprojections, model):
    jr, pr = reprojections
    w, h = jr.width, jr.height
    rng = np.random.default_rng(100 + model)
    mv = rng.integers(-384, 385, (h // BLOCK, w // BLOCK, 2)).astype(
        np.int32)
    idx = np.zeros((h // BLOCK, w // BLOCK), np.int32)
    eps = {7: EPIPOLE} if model == 7 else None
    want = np.asarray(jax_fc.merged_positions(
        jr, [model], jnp.asarray(idx), jnp.asarray(mv[None]), BLOCK, eps))
    got = frame_codec.merged_positions(pr, [model], T(idx), T(mv[None]),
                                       BLOCK, eps).numpy()
    d = got - want
    assert np.abs(d).max() <= 1
    assert int((d != 0).any(-1).sum()) == MEASURED[model]


def equisolid_fields(w: int, model: int):
    """The seeded (model_idx, MV field, epipoles) of the positions tests
    on a w x w Equisolid."""
    rng = np.random.default_rng(100 + model)
    mv = rng.integers(-384, 385, (w // BLOCK, w // BLOCK, 2)).astype(
        np.int32)
    idx = np.zeros((w // BLOCK, w // BLOCK), np.int32)
    return idx, mv, ({7: EPIPOLE} if model == 7 else None)


@pytest.mark.parametrize("model", list(SHA256_1088),
                         ids=[f"m{m}" for m in SHA256_1088])
def test_equisolid_positions_1088_match_jax(model):
    w = 1088
    pr = rp.MVReprojection(proj.make_projection(ProjectionID.EQUISOLID, w,
                                                w), w, w, 1, device="cpu")
    idx, mv, eps = equisolid_fields(w, model)
    got = frame_codec.merged_positions(pr, [model], T(idx), T(mv[None]),
                                       BLOCK, eps).numpy()
    assert hashlib.sha256(np.ascontiguousarray(got, "<i4").tobytes()
                          ).hexdigest() == SHA256_1088[model]


def test_equisolid_stream_byte_exact():
    run = port_lib360_run("fish128x128_ra_mm_qp37_5f")
    assert_lib360_run(run)
    assert run["sd"]["mm"]["projection"] == "EQUISOLID"


def test_equisolid_other_models_stream_byte_exact():
    run = port_lib360_run("fish128x128_ra_t3d_tan_ged_qp37_5f")
    assert_lib360_run(run)
    assert run["sd"]["mm"] == dict(t3d=True, tan=True, ged=True, geda=True,
                                   projection="EQUISOLID")


def test_calibrated_motion_refused():
    jc = jax_proj.make_projection(ProjectionID.CALIBRATED, 64, 64)
    assert not hasattr(jc, "focal")
    cfg = EncCfg(width=64, height=64, qp=37, gop="LDP",
                 mm=MMConfig(mpa=True, rot=True,
                             projection=ProjectionID.CALIBRATED))
    with pytest.raises(NotImplementedError, match="no focal length"):
        EncLib(cfg, device="cpu")
    # without a motion model the projection is not used: accepted
    EncLib(EncCfg(width=64, height=64, qp=37, gop="LDP",
                  mm=MMConfig(projection=ProjectionID.CALIBRATED)),
           device="cpu")
    for make in (jax_proj.make_projection, proj.make_projection):
        with pytest.raises(NotImplementedError, match="perspective"):
            make(ProjectionID.PERSPECTIVE, 64, 64)
