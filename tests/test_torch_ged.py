"""PyTorch port, geodesic motion: the epipole list, the MM-MVP converter and
the GED/GEDA positions against the JAX package.

`EpipoleList`, `to_fixed`/`from_fixed`, `ged_rotation_matrix` and
`MMVPConverter` are host numpy/float64 code copied from the JAX package:
on seeded inputs their outputs must be identical (floats compared bit for
bit, NaN where the reference gives NaN).

The GED and GEDA positions are float32 sphere math rounded to 1/16 pel, as
for MPA and ROT (tests/test_torch_reprojection.py).  The port computes
them op by op with glibc's float32 functions copied
(common/libm_f32.py), so they equal the JAX package's outside a jit (the
block centres and the row-subsampled grid below); inside the decoder's
jit-compiled merged_positions XLA rewrites the float32 arithmetic (FMAs,
its rsqrt, the grid's sphere points folded in double), which the port
copies (models.ged_motion(form="merged"), the modulated flavour), so those
equal JAX's too.  The original flavour keeps the op-by-op form.  Near the
rotated frame's poles the arccos of the ERP back-projection turns one ulp
into several 1/16-pel units, so any difference would show; the number of
subblocks whose position differs from the jit's, and the largest
difference, are asserted exactly as measured (seed 3, MVs uniform in
+-24 pel, block 16)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common.mm import epipole as jax_epipole
from vvc_mm_tpu.common.mm import frame_codec as jax_fc
from vvc_mm_tpu.common.mm import models as jax_models
from vvc_mm_tpu.common.mm import mvp_convert as jax_mvp
from vvc_mm_tpu.common.mm.reprojection import MVReprojection as JaxReproj
from vvc_mm_tpu.lib360.projection import ERP as JaxERP
from vvc_mm_tpu_torch.common.mm import epipole, frame_codec, models
from vvc_mm_tpu_torch.common.mm import mvp_convert
from vvc_mm_tpu_torch.common.mm.reprojection import MVReprojection
from vvc_mm_tpu_torch.lib360.projection import ERP

torch.set_num_threads(1)

BLOCK = 16
GED, GEDA_X, GEDA_Y, GEDA_Z = 7, 8, 9, 10
EPIPOLES = {"pole": (0.0, 0.0, 1.0), "x": (1.0, 0.0, 0.0),
            "off": (0.3, -0.5, 0.8)}
# (width, height) -> (model, epipole key or None) -> (subblocks that
# differ, largest difference in 1/16 pel)
MEASURED = {
    (256, 128): {(GED, "pole"): (0, 0), (GED, "x"): (0, 0),
                 (GED, "off"): (0, 0), (GEDA_X, None): (0, 0),
                 (GEDA_Y, None): (0, 0), (GEDA_Z, None): (0, 0)},
    (2048, 1024): {(GED, "pole"): (0, 0), (GED, "x"): (0, 0),
                   (GED, "off"): (0, 0), (GEDA_X, None): (0, 0),
                   (GEDA_Y, None): (0, 0), (GEDA_Z, None): (0, 0)},
}
CASES = [(wh, m, e) for wh in MEASURED for (m, e) in MEASURED[wh]]


def _same_float(a, b) -> bool:
    a, b = float(a), float(b)
    return (math.isnan(a) and math.isnan(b)) or a == b


# ------------------------------------------------------------ host copies

def test_fixed_point_epipoles_match_jax():
    rng = np.random.default_rng(11)
    for e in rng.normal(size=(64, 3)):
        assert epipole.to_fixed(e) == jax_epipole.to_fixed(e)
        f = jax_epipole.to_fixed(e)
        np.testing.assert_array_equal(epipole.from_fixed(f),
                                      jax_epipole.from_fixed(f))
    assert epipole.FIXED_ONE == jax_epipole.FIXED_ONE == 1 << 24


def test_epipole_list_matches_jax():
    """A seeded sequence of set/make_available/find/derive calls on both
    lists gives identical epipoles at every step."""
    rng = np.random.default_rng(12)
    ours = epipole.EpipoleList((0.1, 0.2, 0.97))
    ref = jax_epipole.EpipoleList((0.1, 0.2, 0.97))
    for _ in range(300):
        op = rng.integers(0, 4)
        c, r = (int(v) for v in rng.integers(0, 9, 2))
        if op == 0:
            e = rng.normal(size=3)
            avail = bool(rng.integers(0, 2))
            ours.set_epipole(c, r, e, available=avail)
            ref.set_epipole(c, r, e, available=avail)
        elif op == 1:
            ours.make_available(c, r)
            ref.make_available(c, r)
        else:
            name = "find_epipole" if op == 2 else "derive_predictor"
            got, want = (_outcome(getattr(x, name), c, r)
                         for x in (ours, ref))
            assert type(got) is type(want)
            np.testing.assert_array_equal(got, want)


def _outcome(fn, *args):
    """fn(*args), or the name of the exception it raises (a gated key
    that was never set raises KeyError in the reference)."""
    try:
        return fn(*args)
    except KeyError as err:
        return type(err).__name__


@pytest.mark.parametrize("ep", [(0.0, 0.0, 1.0), (0.0, 0.0, -1.0),
                                (1.0, 0.0, 0.0), (0.3, -0.5, 0.8),
                                (0.0, 2.0, 0.0), (-0.2, 0.1, -0.9)])
def test_ged_rotation_matrix_matches_jax(ep):
    got = models.ged_rotation_matrix(ep)
    want = jax_models.ged_rotation_matrix(ep)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for m in (GEDA_X, GEDA_Y, GEDA_Z):
        np.testing.assert_array_equal(models.GEDA_EPIPOLES[m],
                                      jax_models.GEDA_EPIPOLES[m])


@pytest.mark.parametrize("size,flavor", [((256, 128), 1), ((2048, 1024), 1),
                                         ((256, 128), 0)])
def test_mmvp_converter_matches_jax(size, flavor):
    """model_point, mv_for_shift and convert for every (from, to) pair of
    the eleven models, on seeded positions, MVs, centres and epipoles:
    identical floats (or the same exception) and identical integers."""
    w, h = size
    ours = mvp_convert.MMVPConverter(w, h, flavor)
    ref = jax_mvp.MMVPConverter(w, h, flavor)
    rng = np.random.default_rng(13 + w + flavor)
    for _ in range(160):
        mf, mt = (int(v) for v in rng.integers(0, 11, 2))
        pos = (float(rng.integers(0, w // BLOCK)) * BLOCK,
               float(rng.integers(0, h // BLOCK)) * BLOCK)
        mv = rng.integers(-400, 401, 2)
        if rng.integers(0, 6) == 0:
            mv[0] = 0                   # the GED mvx == 0 branch
        cc = (pos[0] + rng.integers(-1, 2) * BLOCK + 7.5,
              pos[1] + rng.integers(-1, 1) * BLOCK + 7.5)
        kc = (pos[0] + 7.5, pos[1] + 7.5)
        e0, e1 = rng.normal(size=3), rng.normal(size=3)
        outs = []
        for conv in (ours, ref):
            try:
                pt = conv.model_point(mf, pos[0], pos[1], mv[0] / 16.0,
                                      mv[1] / 16.0, cc[0], cc[1], e0)
                sh = conv.mv_for_shift(mt, pos[0], pos[1], pt[0], pt[1],
                                       kc[0], kc[1], e1)
            except (ValueError, ZeroDivisionError) as err:
                pt = sh = type(err).__name__
            outs.append((pt, sh, conv.convert(pos, mv, mf, mt, cc, kc, e0,
                                              e1)))
        (p0, s0, c0), (p1, s1, c1) = outs
        if isinstance(p1, str):
            assert p0 == p1
        else:
            assert all(_same_float(a, b) for a, b in zip(p0, p1)), (mf, mt)
            assert all(_same_float(a, b) for a, b in zip(s0, s1)), (mf, mt)
        assert c0.dtype == c1.dtype == np.int64
        np.testing.assert_array_equal(c0, c1)


# --------------------------------------------------------------- positions

def _fields(w, h, seed=3):
    rng = np.random.default_rng(seed)
    mv = rng.integers(-384, 385, (h // BLOCK, w // BLOCK, 2)).astype(np.int32)
    return np.zeros((h // BLOCK, w // BLOCK), np.int32), mv


@pytest.mark.parametrize("size,model,ep", CASES,
                         ids=[f"{w}x{h}-m{m}-{e}" for (w, h), m, e in CASES])
def test_ged_positions_match_jax(size, model, ep):
    w, h = size
    idx, mv = _fields(w, h)
    eps = {GED: EPIPOLES[ep]} if ep else None
    want = np.asarray(jax_fc.merged_positions(
        JaxReproj(JaxERP(w, h), w, h, 1, 1), [model], jnp.asarray(idx),
        jnp.asarray(mv[None]), BLOCK, eps))
    got = frame_codec.merged_positions(
        MVReprojection(ERP(w, h), w, h, 1, 1, device="cpu"), [model],
        torch.from_numpy(idx), torch.from_numpy(mv[None]), BLOCK,
        eps).numpy()
    assert got.shape == want.shape == (h // 4, w // 4, 2)
    assert got.dtype == np.int32
    d = got - want
    n_sub = int((d != 0).any(-1).sum())
    assert (n_sub, int(np.abs(d).max())) == MEASURED[size][(model, ep)]


# flavour -> epipole key -> (subblocks that differ, largest difference),
# measured as MEASURED is, on the field of test_ged_flavours_and_zero_mvx
FLAVOUR_MEASURED = {0: {"pole": (0, 0), "x": (1, 1), "off": (1, 1)},
                    1: {"pole": (0, 0), "x": (0, 0), "off": (0, 0)}}
FLAVOUR_CASES = [(f, e) for f in FLAVOUR_MEASURED for e in EPIPOLES]


@pytest.mark.parametrize("flavor,ep", FLAVOUR_CASES,
                         ids=[f"flavour{f}-{e}" for f, e in FLAVOUR_CASES])
def test_ged_flavours_and_zero_mvx_match_jax(flavor, ep):
    """Both flavours (VISHWANATH_ORIGINAL and _MODULATED) at 256x128 on a
    field whose MVs have mvx == 0 with mvy != 0 on every other block row
    (an infinite k or a NaN, then the NaN -> no-motion rule) and zero MVs
    on every fourth: the counted mismatches only."""
    w, h = 256, 128
    idx, mv = _fields(w, h, seed=4)
    mv[::2, :, 0] = 0
    mv[1::4, :, :] = 0
    want = np.asarray(jax_fc.merged_positions(
        JaxReproj(JaxERP(w, h), w, h, 1, flavor), [GED], jnp.asarray(idx),
        jnp.asarray(mv[None]), BLOCK, {GED: EPIPOLES[ep]}))
    got = frame_codec.merged_positions(
        MVReprojection(ERP(w, h), w, h, 1, flavor, device="cpu"), [GED],
        torch.from_numpy(idx), torch.from_numpy(mv[None]), BLOCK,
        {GED: EPIPOLES[ep]}).numpy()
    d = got - want
    n_sub = int((d != 0).any(-1).sum())
    assert (n_sub, int(np.abs(d).max())) == FLAVOUR_MEASURED[flavor][ep]


def test_ged_block_centres_and_row_step_match_jax():
    """The search's GED positions at 256x128: block centres (the >=512-row
    arm's decision positions) and the row-subsampled subblock grid."""
    w, h = 256, 128
    idx, mv = _fields(w, h, seed=5)
    jr = JaxReproj(JaxERP(w, h), w, h, 1, 1)
    tr = MVReprojection(ERP(w, h), w, h, 1, 1, device="cpu")
    for model, ep in ((GED, EPIPOLES["pole"]), (GED, EPIPOLES["x"]),
                      (GEDA_Y, None)):
        want = np.asarray(jr.reproject_block_centers(
            model, jnp.asarray(mv), BLOCK, ep))
        got = tr.reproject_block_centers(model, torch.from_numpy(mv),
                                         BLOCK, ep).numpy()
        np.testing.assert_array_equal(got, want)
        want = np.asarray(jr.reproject_frame(model, jnp.asarray(mv), BLOCK,
                                             ep, 4))
        got = tr.reproject_frame(model, torch.from_numpy(mv), BLOCK, ep,
                                 4).numpy()
        np.testing.assert_array_equal(got, want)


def test_ged_rotation_cache_is_keyed_by_the_epipole():
    tr = MVReprojection(ERP(64, 32), 64, 32, 1, 1, device="cpu")
    a = tr.ged_rot((0.3, -0.5, 0.8))
    assert tr.ged_rot((0.3, -0.5, 0.8 + 1e-12)) is a
    assert tr.ged_rot((0.0, 0.0, 1.0)) is not a
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    with pytest.raises(ValueError):
        tr.reproject_frame(GED, torch.zeros((2, 4, 2), dtype=torch.int32),
                           BLOCK)
