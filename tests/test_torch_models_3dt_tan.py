"""PyTorch port, the last two motion models (3-D translational and
tangential) and the inverses (`*_mv_for_shift`, `mv_in_desired_model`)
against the JAX package, on seeded numpy inputs.

The models are float32 sphere math with the JAX package's operation order
and glibc's float32 functions copied (common/libm_f32.py), so op by op
they equal the JAX package's outside a jit.  The elementwise functions
are held to a stated relative tolerance (|port - JAX| / max(1, |JAX|)),
and their NaN pattern must be JAX's exactly.  The integer 1/16-pel
positions are held as the MPA, ROT and GED ones are
(tests/test_torch_reprojection.py, tests/test_torch_ged.py): the number
of subblocks (or candidates) whose value differs from the JAX package's,
and the largest difference, are asserted exactly as measured.  Against
the decoder's jit-compiled merged_positions, 3DT and TAN take XLA's
compiled float32 form (models.t3d_motion(form="merged"),
models._tan_motion_fused) and are equal too (ROADMAP queue 3, fault
1)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common.mm import frame_codec as jax_fc
from vvc_mm_tpu.common.mm import models as jax_models
from vvc_mm_tpu.common.mm.reprojection import MVReprojection as JaxReproj
from vvc_mm_tpu.lib360.projection import ERP as JaxERP
from vvc_mm_tpu_torch.common.bitstream import BitReader, read_annexb
from vvc_mm_tpu_torch.common.mm import frame_codec, models
from vvc_mm_tpu_torch.common.mm.reprojection import MVReprojection
from vvc_mm_tpu_torch.common.slice_ps import SPS, MMConfig
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder.enclib import EncCfg, EncLib
from vvc_mm_tpu_torch.common.typedefs import ChromaFormat
from vvc_mm_tpu_torch.lib360.projection import ERP
from vvc_mm_tpu_torch.utils.yuv_io import VideoFormat, synthetic_sequence

torch.set_num_threads(1)

BLOCK = 16
T3D, TAN = 4, 5
GED_EPIPOLE = (0.3, -0.5, 0.8)
# relative tolerance of the elementwise float32 functions; the MPA
# inverses divide by the motion plane's depth, which is near zero at the
# plane's horizon, and take a looser one
RTOL = 1e-4
RTOL_MPA_INVERSE = 4e-3


def _inputs(w, h, n=4096, seed=21):
    """Points, MVs in pixels (one in 16 zero), block centres within 8
    pixels of the points (one in 7 the point itself), float32."""
    rng = np.random.default_rng(seed)
    px = rng.uniform(0, w, n).astype(np.float32)
    py = rng.uniform(0, h, n).astype(np.float32)
    mvx = rng.uniform(-24, 24, n).astype(np.float32)
    mvy = rng.uniform(-24, 24, n).astype(np.float32)
    mvx[::16] = 0
    mvy[::16] = 0
    cx = (px + rng.uniform(-8, 8, n)).astype(np.float32)
    cy = (py + rng.uniform(-8, 8, n)).astype(np.float32)
    cx[::7], cy[::7] = px[::7], py[::7]
    return px, py, mvx, mvy, cx, cy


def _close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok]) / np.maximum(1.0, np.abs(want[ok]))
    assert err.max(initial=0.0) <= rtol, (what, float(err.max()))


def _both(fn_jax, fn_port, *arrays):
    """fn on the JAX package's and on the port's version of `arrays`."""
    return (fn_jax(*(jnp.asarray(a) for a in arrays)),
            fn_port(*(torch.from_numpy(a) for a in arrays)))


@pytest.mark.parametrize("size", [(256, 128), (2048, 1024)])
@pytest.mark.parametrize("model", ["t3d", "tan"])
def test_motion_matches_jax(model, size):
    w, h = size
    jp, tp = JaxERP(w, h), ERP(w, h)
    res = math.pi / h
    if model == "t3d":
        want, got = _both(lambda *a: jax_models.t3d_motion(jp, *a),
                          lambda *a: models.t3d_motion(tp, *a),
                          *_inputs(w, h))
    else:
        want, got = _both(lambda *a: jax_models.tan_motion(jp, res, *a),
                          lambda *a: models.tan_motion(tp, res, *a),
                          *_inputs(w, h))
    for g, j, axis in zip(got, want, "xy"):
        _close(g, j, RTOL, f"{model} {axis}")
    # a zero MV keeps the grid point exactly
    px, py = _inputs(w, h)[:2]
    np.testing.assert_array_equal(got[0].numpy()[::16], px[::16])
    np.testing.assert_array_equal(got[1].numpy()[::16], py[::16])


# (width, height) -> pole samples (of 50,000) off by more than 1/32 pel
# in x, in y
POLE_MEASURED = {(256, 128): (0, 0), (2048, 1024): (0, 0)}


def test_tan_nan_rules_match_jax():
    """rho = 0 with a non-zero MV (a zero angular resolution at the block
    centre itself) divides 0 by 0: NaN in both packages, not the zero-MV
    identity.  Dense samples 0-3 rows from both poles, where the arcsin
    argument sits next to 1, give the same NaN pattern as JAX's.  There
    the azimuth is ill-conditioned, so the samples whose moved position
    differs from JAX's by more than 1/32 pel are counted, per axis, and
    pinned as measured (POLE_MEASURED)."""
    w, h = 256, 128
    c = np.array([10.5, 100.25, 3.0], np.float32)
    mv = np.array([1.0, -2.0, 0.5], np.float32)
    want, got = _both(
        lambda *a: jax_models.tan_motion(JaxERP(w, h), 0.0, *a),
        lambda *a: models.tan_motion(ERP(w, h), 0.0, *a),
        c, c[::-1].copy(), mv, mv, c, c[::-1].copy())
    for g, j in zip(got, want):
        assert np.isnan(np.asarray(j)).all() and torch.isnan(g).all()
    rng = np.random.default_rng(5)
    n = 50000
    for w, h in ((256, 128), (2048, 1024)):
        cx = rng.uniform(0, w, n).astype(np.float32)
        top = rng.uniform(size=n) < 0.5
        cy = np.where(top, rng.uniform(0, 3, n),
                      h - rng.uniform(0, 3, n)).astype(np.float32)
        px = (cx + rng.integers(-2, 3, n) * 4).astype(np.float32)
        py = (cy + rng.integers(-2, 3, n) * 4).astype(np.float32)
        mvx = (rng.integers(-64, 65, n) / 16).astype(np.float32)
        mvy = (rng.integers(-64, 65, n) / 16).astype(np.float32)
        res = math.pi / h
        want, got = _both(
            lambda *a: jax_models.tan_motion(JaxERP(w, h), res, *a),
            lambda *a: models.tan_motion(ERP(w, h), res, *a),
            px, py, mvx, mvy, cx, cy)
        far = []
        for g, j in zip(got, want):
            j, g = np.asarray(j), g.numpy()
            np.testing.assert_array_equal(np.isnan(g), np.isnan(j))
            far.append(int((np.abs(g - j) > 1 / 32).sum()))
        assert tuple(far) == POLE_MEASURED[(w, h)]


INVERSES = ["translational", "mpa_front_back", "mpa_left_right",
            "mpa_top_bottom", "t3d", "tan", "rot", "ged_original",
            "ged_modulated"]


@pytest.mark.parametrize("name", INVERSES)
def test_mv_for_shift_matches_jax(name):
    w, h = 256, 128
    jp, tp = JaxERP(w, h), ERP(w, h)
    res = math.pi / h
    px, py, mvx, mvy, cx, cy = _inputs(w, h, seed=22)
    sx, sy = px + mvx, py + mvy
    rot = models.ged_rotation_matrix(GED_EPIPOLE)
    fns = {
        "translational": (jax_models.translational_mv_for_shift,
                          models.translational_mv_for_shift),
        "t3d": (lambda *a: jax_models.t3d_mv_for_shift(jp, *a),
                lambda *a: models.t3d_mv_for_shift(tp, *a)),
        "tan": (lambda *a: jax_models.tan_mv_for_shift(jp, res, *a),
                lambda *a: models.tan_mv_for_shift(tp, res, *a)),
        "rot": (lambda *a: jax_models.rot_mv_for_shift(jp, res, *a),
                lambda *a: models.rot_mv_for_shift(tp, res, *a)),
    }
    for plane, key in enumerate(INVERSES[1:4], start=1):
        fns[key] = (lambda *a, p=plane: jax_models.mpa_mv_for_shift(
            jp, p, *a[:4]), lambda *a, p=plane: models.mpa_mv_for_shift(
            tp, p, *a[:4]))
    for flavor, key in enumerate(("ged_original", "ged_modulated")):
        fns[key] = (lambda *a, f=flavor: jax_models.ged_mv_for_shift(
            jp, res, rot, f, *a), lambda *a, f=flavor:
            models.ged_mv_for_shift(tp, res, rot, f, *a))
    fj, ft = fns[name]
    want, got = _both(fj, ft, px, py, sx, sy, cx, cy)
    rtol = RTOL_MPA_INVERSE if name.startswith("mpa") else RTOL
    for g, j, axis in zip(got, want, "xy"):
        _close(g, j, rtol, f"{name} {axis}")
    a = np.random.default_rng(23).uniform(-20, 20, 512).astype(np.float32)
    np.testing.assert_array_equal(
        models._wrap_angle(torch.from_numpy(a)).numpy(),
        np.asarray(jax_models._wrap_angle(jnp.asarray(a))))


# --------------------------------------------------------------- positions

# (width, height) -> model -> what -> (subblocks or blocks that differ,
# largest difference in 1/16 pel); seed 200 + model, MVs uniform in
# +-24 pel, every other block of every third block row MV 0.  "frame":
# against the JAX decoder's jit-compiled merged_positions; "rows": the
# search's row-subsampled grid (row step 4) and "centres": the >=512-row
# arm's block-centre positions, each against JAX op by op.
MEASURED = {
    (256, 128): {T3D: dict(frame=(0, 0), rows=(0, 0), centres=(0, 0)),
                 TAN: dict(frame=(0, 0), rows=(0, 0), centres=(0, 0))},
    (2048, 1024): {T3D: dict(frame=(0, 0), rows=(0, 0), centres=(0, 0)),
                   TAN: dict(frame=(0, 0), rows=(0, 0), centres=(0, 0))},
}
CASES = [(wh, m) for wh in MEASURED for m in MEASURED[wh]]


def _count(got, want):
    d = np.asarray(got).astype(np.int64) - np.asarray(want)
    return int((d != 0).any(-1).sum()), int(np.abs(d).max(initial=0))


@pytest.mark.parametrize("size,model", CASES,
                         ids=[f"{w}x{h}-m{m}" for (w, h), m in CASES])
def test_positions_match_jax(size, model):
    w, h = size
    rng = np.random.default_rng(200 + model)
    mv = rng.integers(-384, 385, (h // BLOCK, w // BLOCK, 2)).astype(np.int32)
    mv[::3, ::2] = 0
    idx = np.zeros((h // BLOCK, w // BLOCK), np.int32)
    jr = JaxReproj(JaxERP(w, h), w, h, 1, 1)
    tr = MVReprojection(ERP(w, h), w, h, 1, 1, device="cpu")
    tmv = torch.from_numpy(mv)
    got = {
        "frame": frame_codec.merged_positions(
            tr, [model], torch.from_numpy(idx), tmv[None], BLOCK).numpy(),
        "rows": tr.reproject_frame(model, tmv, BLOCK, None, 4).numpy(),
        "centres": tr.reproject_block_centers(model, tmv, BLOCK).numpy()}
    want = {
        "frame": np.asarray(jax_fc.merged_positions(
            jr, [model], jnp.asarray(idx), jnp.asarray(mv[None]), BLOCK)),
        "rows": np.asarray(jr.reproject_frame(model, jnp.asarray(mv),
                                              BLOCK, None, 4)),
        "centres": np.asarray(jr.reproject_block_centers(
            model, jnp.asarray(mv), BLOCK))}
    for what in got:
        assert got[what].dtype == np.int32
        assert got[what].shape == want[what].shape, what
        assert _count(got[what], want[what]) == MEASURED[size][model][what], \
            what
    # MV 0 everywhere: every position is the grid's, in both packages
    z = np.zeros_like(mv)
    got0 = frame_codec.merged_positions(
        tr, [model], torch.from_numpy(idx), torch.from_numpy(z[None]),
        BLOCK).numpy()
    want0 = np.asarray(jax_fc.merged_positions(
        jr, [model], jnp.asarray(idx), jnp.asarray(z[None]), BLOCK))
    np.testing.assert_array_equal(got0, want0)
    np.testing.assert_array_equal(got0, frame_codec.merged_positions(
        tr, [0], torch.from_numpy(idx), torch.from_numpy(z[None]),
        BLOCK).numpy())


# (from model, to model) -> candidates whose converted MV differs from the
# JAX package's (all others: 0 of 512), seed 31 at 256x128, random
# positions, centres one block apart, one MV in 8 zero and one in 8 with
# mvx = 0, GED epipoles (0.3, -0.5, 0.8) -> (0, 0, 1).  Near a motion
# plane's horizon the MPA inverse divides by a depth near zero, and near a
# rotated pole GED's arccos is ill-conditioned, so one ulp there moves the
# converted MV by many units.
MVD_MEASURED: dict = {}


def test_mv_in_desired_model_every_pair_matches_jax():
    w, h = 256, 128
    jr = JaxReproj(JaxERP(w, h), w, h, 1, 1)
    tr = MVReprojection(ERP(w, h), w, h, 1, 1, device="cpu")
    rng = np.random.default_rng(31)
    n = 512
    pos = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)],
                   -1).astype(np.float32)
    mv = rng.integers(-384, 385, (n, 2)).astype(np.int32)
    mv[::8] = 0
    mv[1::8, 0] = 0
    cc = (pos + rng.integers(-1, 2, (n, 2)) * 16 + 7.5).astype(np.float32)
    kc = (pos + 7.5).astype(np.float32)
    e0, e1 = GED_EPIPOLE, (0.0, 0.0, 1.0)
    counts = {}
    for a in range(11):
        for b in range(11):
            want = np.asarray(jr.mv_in_desired_model(
                jnp.asarray(pos), jnp.asarray(mv), a, b, jnp.asarray(cc),
                jnp.asarray(kc), e0, e1))
            got = tr.mv_in_desired_model(pos, mv, a, b, cc, kc, e0,
                                         e1).numpy()
            assert got.dtype == np.int32 and got.shape == want.shape
            # a zero candidate MV converts to zero
            assert not got[::8].any()
            k = _count(got, want)[0]
            if k:
                counts[(a, b)] = k
    assert counts == MVD_MEASURED


# ------------------------------------------------------- the 11-model SPS

def test_eleven_model_sequence_round_trips():
    """MPA + ROT + GED + 3DT + TAN + GEDA (11 active models) at 64x32, LDP,
    3 frames, as tests/test_mm_codec.py codes it in the JAX package: the
    SPS carries the model list, the port decodes its own stream with every
    MD5 OK and bit-exact with the encoder, and the JAX DecLib decodes it
    bit-exactly too."""
    from vvc_mm_tpu.decoder.declib import DecLib as JaxDecLib
    w, h = 64, 32
    mm = MMConfig(mpa=True, rot=True, ged=True, t3d=True, tan=True,
                  geda=True, global_epipole=(0.0, 0.0, 1.0))
    cfg = EncCfg(width=w, height=h, qp=32, gop="LDP", intra_period=0,
                 search_range=8, wrap_around=True, mm=mm,
                 epipoles=[(-1, -1, 1.0, 0.0, 0.0)])
    frames = synthetic_sequence(VideoFormat(w, h, 8, ChromaFormat.C420), 3,
                                motion=(2.0, 1.0))
    enc = EncLib(cfg, device="cpu")
    data = enc.encode_sequence(frames)
    sps = SPS.read(BitReader(read_annexb(data)[0].payload))
    assert sps.mm.active_models() == mm.active_models()
    assert len(sps.mm.active_models()) == 11
    dec = DecLib(device="cpu")
    out = dec.decode_bytes(data)
    assert dec.hash_status == {p: "OK" for p in range(3)}
    assert dec.sps.mm.active_models() == mm.active_models()
    for f, r in zip(out, sorted(enc.results, key=lambda r: r.poc)):
        for a, b in zip(f.numpy(), r.recon):
            np.testing.assert_array_equal(a, b)
    jdec = JaxDecLib()
    jdec.decode_bytes(data)
    assert jdec.hash_status == {p: "OK" for p in range(3)}
    jax.clear_caches()
