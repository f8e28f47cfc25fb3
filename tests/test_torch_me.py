"""PyTorch port, the search's building blocks against the JAX package on the
same numpy inputs: classic motion estimation, forward transform, quantizer,
residual pass, the coefficient-bit estimate, the block-center positions and
the first-minimum tie rule.  Integer results are exact (tolerance 0); the
float32 block-center positions may differ by one 1/16-pel unit in a counted
number of blocks (they only rank search candidates)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import inter_frame as jax_if
from vvc_mm_tpu.common import qtree as jax_qtree
from vvc_mm_tpu.common import quant as jax_quant
from vvc_mm_tpu.common import transforms as jax_tr
from vvc_mm_tpu.common.mm.reprojection import MVReprojection as JaxReproj
from vvc_mm_tpu.encoder import me as jax_me
from vvc_mm_tpu.lib360.projection import ERP as JaxERP
from vvc_mm_tpu_torch.common import inter_frame, qtree, quant, transforms
from vvc_mm_tpu_torch.common.inter_frame import first_argmin
from vvc_mm_tpu_torch.common.mm.reprojection import MVReprojection
from vvc_mm_tpu_torch.encoder import me
from vvc_mm_tpu_torch.lib360.projection import ERP
from vvc_mm_tpu_torch.utils.content import realistic_sequence

torch.set_num_threads(1)

MARGIN = 80


@pytest.fixture(scope="module")
def luma_pair():
    """(original, reference) luma of two pictures of the 256x128 clip."""
    fr = realistic_sequence(256, 128, 3)
    return fr[2][0].astype(np.int32), fr[0][0].astype(np.int32)


@pytest.mark.parametrize("s", [8, 16])
def test_classic_search_matches_jax(luma_pair, s):
    """hierarchical_search then fractional_refine: MVs and SADs equal."""
    orig, ref = luma_pair
    jref = jax_if.pad_ref(jnp.asarray(ref), MARGIN, True)
    tref = inter_frame.pad_ref(torch.from_numpy(ref), MARGIN, True)
    jmv, jsad = jax_me.hierarchical_search(jnp.asarray(orig), jref, s, 24,
                                           MARGIN, 37)
    tmv, tsad = me.hierarchical_search(torch.from_numpy(orig), tref, s, 24,
                                       MARGIN, 37)
    np.testing.assert_array_equal(tmv.numpy(), np.asarray(jmv))
    np.testing.assert_array_equal(tsad.numpy(), np.asarray(jsad))
    assert np.abs(np.asarray(jmv)).max() > 0       # the clip does move
    jf, jc = jax_me.fractional_refine(jnp.asarray(orig), jref, jmv, s,
                                      MARGIN, 8)
    tf, tc = me.fractional_refine(torch.from_numpy(orig), tref, tmv, s,
                                  MARGIN, 8)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tf.dtype == torch.int32


def test_integer_search_matches_jax_without_mv_cost(rng):
    orig = rng.integers(0, 256, (32, 64), dtype=np.int32)
    ref = rng.integers(0, 256, (32 + 16, 64 + 16), dtype=np.int32)
    jmv, jsad = jax_me.integer_search(jnp.asarray(orig), jnp.asarray(ref),
                                      8, 4, 8, 0)
    tmv, tsad = me.integer_search(torch.from_numpy(orig),
                                  torch.from_numpy(ref), 8, 4, 8, 0)
    np.testing.assert_array_equal(tmv.numpy(), np.asarray(jmv))
    np.testing.assert_array_equal(tsad.numpy(), np.asarray(jsad))


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("s", [4, 8, 16])
def test_forward_transform_and_quantize_match_jax(rng, s, bit_depth):
    top = (1 << bit_depth) - 1
    resid = rng.integers(-top, top + 1, (50, s, s), dtype=np.int32)
    resid[0] = top
    resid[1] = -top
    jc = jax_tr.forward_transform(jnp.asarray(resid), bit_depth=bit_depth)
    tc = transforms.forward_transform(torch.from_numpy(resid),
                                      bit_depth=bit_depth)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    log2s = s.bit_length() - 1
    for qp in (22, 38, 43):
        jl = jax_quant.quantize(jc, qp, log2s, log2s, bit_depth, intra=False)
        tl = quant.quantize(tc, qp, log2s, log2s, bit_depth, intra=False)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tl.dtype == torch.int32
    assert quant.lambda_from_qp(38, intra=False) == \
        jax_quant.lambda_from_qp(38, intra=False)


@pytest.mark.parametrize("s", [4, 8, 16])
def test_residual_pass_matches_jax(rng, s):
    orig = rng.integers(0, 256, (32, 64), dtype=np.int32)
    pred = np.clip(orig + rng.integers(-30, 31, orig.shape), 0, 255) \
        .astype(np.int32)
    jl, jr = jax_if._residual_pass(jnp.asarray(orig), jnp.asarray(pred), s,
                                   38, 8)
    tl, trc = inter_frame._residual_pass(torch.from_numpy(orig),
                                         torch.from_numpy(pred), s, 38, 8)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(trc.numpy(), np.asarray(jr))
    ys, xs = inter_frame._block_coords(3, 5, s)
    jys, jxs = jax_if._block_coords(3, 5, s)
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))


def test_coeff_bits_estimate_every_magnitude():
    """ceil(log2(a + 1)) in float32: at a + 1 = 2^k one ulp of log2 decides
    between k and k + 1.  Every magnitude 0..32767, one per block, and
    both signs: measured 0 of 32768 differ from the JAX function."""
    mag = np.arange(32768, dtype=np.int32).reshape(32768, 1, 1, 1)
    for sign in (1, -1):
        want = np.asarray(jax_qtree._coeff_bits_est(jnp.asarray(sign * mag)))
        got = qtree._coeff_bits_est(torch.from_numpy(sign * mag)).numpy()
        assert got.dtype == np.float32
        assert int((got != want).sum()) == 0
    blocks = np.arange(32768, dtype=np.int32).reshape(8, 16, 16, 16)
    np.testing.assert_array_equal(
        qtree._coeff_bits_est(torch.from_numpy(blocks)).numpy(),
        np.asarray(jax_qtree._coeff_bits_est(jnp.asarray(blocks))))
    np.testing.assert_array_equal(
        qtree._up2(torch.arange(6).reshape(2, 3), 2).numpy(),
        np.asarray(jax_qtree._up2(jnp.arange(6).reshape(2, 3), 2)))


# block size -> model id -> blocks whose center position differs from the
# JAX package's (op by op) at 2048x1024; measured with seed 200 + model +
# block size, MVs uniform in +-24 pel, with glibc's float32 functions
# copied (common/libm_f32.py; before, with torch's: 34/29/13/6 at s=8 and
# 9/10/5/2 at s=16 for MPA x3 and ROT)
CENTER_MISMATCHES = {
    8: {0: 0, 1: 0, 2: 0, 3: 0, 6: 0},
    16: {0: 0, 1: 0, 2: 0, 3: 0, 6: 0},
}
CENTER_CASES = [(s, m) for s in CENTER_MISMATCHES
                for m in CENTER_MISMATCHES[s]]


@pytest.mark.parametrize("s,model", CENTER_CASES,
                         ids=[f"s{s}-m{m}" for s, m in CENTER_CASES])
def test_block_center_positions_match_jax(s, model):
    w, h = 2048, 1024
    rng = np.random.default_rng(200 + model + s)
    mv = rng.integers(-384, 385, (h // s, w // s, 2)).astype(np.int32)
    want = np.asarray(JaxReproj(JaxERP(w, h), w, h, 1)
                      .reproject_block_centers(model, jnp.asarray(mv), s))
    got = MVReprojection(ERP(w, h), w, h, 1, device="cpu") \
        .reproject_block_centers(model, torch.from_numpy(mv), s).numpy()
    assert got.shape == want.shape == (h // s, w // s, 2)
    assert got.dtype == np.int32
    d = got - want
    assert np.abs(d).max() <= 1, "a mismatch larger than one 1/16 pel"
    assert int((d != 0).any(-1).sum()) <= CENTER_MISMATCHES[s][model]


def test_reproject_frame_row_step_matches_jax():
    """The search's row-subsampled positions at 256x128 (0 mismatches at
    this size, as for the full grid)."""
    w, h, s = 256, 128, 16
    rng = np.random.default_rng(5)
    mv = rng.integers(-384, 385, (h // s, w // s, 2)).astype(np.int32)
    jr = JaxReproj(JaxERP(w, h), w, h, 1)
    tr = MVReprojection(ERP(w, h), w, h, 1, device="cpu")
    for model in (1, 2, 3, 6):
        want = np.asarray(jr.reproject_frame(model, jnp.asarray(mv), s,
                                             None, 4))
        got = tr.reproject_frame(model, torch.from_numpy(mv), s, None,
                                 4).numpy()
        assert got.shape == want.shape == (h // 16, w // 4, 2)
        np.testing.assert_array_equal(got, want)


def _tied(rng):
    """Stacks full of ties: few distinct values, and whole-zero columns."""
    x = rng.integers(0, 3, (6, 40, 50)).astype(np.int32)
    x[:, :5] = 0
    x[3:, 5:10] = x[:3, 5:10]
    return x


def test_first_argmin_is_jnp_argmin_on_ties(rng):
    """jnp.argmin returns the first minimum; the search puts the centre,
    the earlier model and the earlier candidate first and relies on it."""
    x = _tied(rng)
    want = np.asarray(jnp.argmin(jnp.asarray(x), axis=0))
    got = first_argmin(torch.from_numpy(x), 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:5] == 0).all()
    np.testing.assert_array_equal(
        torch.argmin(torch.from_numpy(x), dim=0).numpy(), want)
    xl = np.moveaxis(x, 0, -1).copy()
    np.testing.assert_array_equal(
        first_argmin(torch.from_numpy(xl), 2).numpy(),
        np.asarray(jnp.argmin(jnp.asarray(xl), axis=-1)))
    f = x.astype(np.float32) * 0.5
    np.testing.assert_array_equal(
        first_argmin(torch.from_numpy(f), 0).numpy(), want)


@pytest.mark.cuda
def test_first_argmin_on_the_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _tied(rng)
    want = np.argmin(x, axis=0)
    np.testing.assert_array_equal(
        first_argmin(torch.from_numpy(x).cuda(), 0).cpu().numpy(), want)
