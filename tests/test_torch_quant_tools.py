"""PyTorch port, the quantization and transform tools of the I picture
against the JAX package on the same numpy inputs (tolerance 0):
scaling-list quantize/dequantize, RDOQ, transform-skip quantization, the
XLA-order rate tables, dependent quantization's trellis and dequantizer
(the plain versions of kernels D1/D2; the kernels themselves on the card,
`cuda`-marked), LFNST and the stacked MTS transforms.

Single-core cost: about 20 s (mostly the JAX jit of quantize_dep at each
size and QP)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import depquant as jax_dq
from vvc_mm_tpu.common import lfnst as jax_lfnst
from vvc_mm_tpu.common import quant as jax_quant
from vvc_mm_tpu.common import transforms as jax_tr
from vvc_mm_tpu.common import wavefront as jax_wf
from vvc_mm_tpu_torch.common import depquant, lfnst, quant, transforms
from vvc_mm_tpu_torch.ops import depquant_kernel

torch.set_num_threads(1)

# tests/test_scaling_list.py's steep matrix: heavier steps at high frequency
STEEP = tuple(int(16 + 2 * (x + y)) for y in range(8) for x in range(8))
# XLA's float32 log polynomial and its copy (quant._xla_log_f32) part at
# these levels, all above the largest level a 16-bit coefficient reaches
# at the codec's QPs; pinned
RATE_MISMATCHES = (11047, 22135, 25795)


def _coeffs(rng, b, s, scale=400.0):
    yy, xx = np.mgrid[0:s, 0:s]
    c = rng.laplace(0, 1, (b, s, s)) * scale / (1 + yy + xx) ** 1.3
    return c.round().astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("s", [4, 8, 16])
def test_scaling_quantize_dequantize_match_jax(rng, s):
    log2s = s.bit_length() - 1
    np.testing.assert_array_equal(quant.scaling_weights(STEEP, s, s),
                                  jax_quant.scaling_weights(STEEP, s, s))
    c = _coeffs(rng, 64, s, 2000.0)
    for qp, intra in ((22, True), (37, False), (51, True)):
        for sc in (STEEP, None):
            lev = quant.quantize(_t(c), qp, log2s, log2s, 8, intra=intra,
                                 scaling=sc)
            want = jax_quant.quantize(jnp.asarray(c), qp, log2s, log2s, 8,
                                      intra=intra, scaling=sc)
            np.testing.assert_array_equal(lev.numpy(), np.asarray(want))
            np.testing.assert_array_equal(
                quant.dequantize(lev, qp, log2s, log2s, 8,
                                 scaling=sc).numpy(),
                np.asarray(jax_quant.dequantize(jnp.asarray(lev.numpy()), qp,
                                                log2s, log2s, 8,
                                                scaling=sc)))


@pytest.mark.parametrize("s", [4, 8, 16])
def test_rdoq_matches_jax(rng, s):
    log2s = s.bit_length() - 1
    c = _coeffs(rng, 128, s)
    for qp in (12, 27, 37, 45):
        for intra in (True, False):
            np.testing.assert_array_equal(
                quant.quantize_rdoq(_t(c), qp, log2s, log2s, 8,
                                    intra=intra).numpy(),
                np.asarray(jax_quant.quantize_rdoq(
                    jnp.asarray(c), qp, log2s, log2s, 8, intra=intra)))


def test_transform_skip_quantization_matches_jax(rng):
    r = rng.integers(-255, 256, (32, 8, 8)).astype(np.int32)
    for qp in (0, 4, 22, 37, 51):
        assert quant.ts_qp(qp) == jax_quant.ts_qp(qp)
        assert quant.qstep(qp) == jax_quant.qstep(qp)
        for intra in (True, False):
            lev = quant.quantize_ts(_t(r), qp, intra=intra)
            np.testing.assert_array_equal(
                lev.numpy(), np.asarray(jax_quant.quantize_ts(
                    jnp.asarray(r), qp, intra=intra)))
            np.testing.assert_array_equal(
                quant.dequantize_ts(lev, qp).numpy(),
                np.asarray(jax_quant.dequantize_ts(
                    jnp.asarray(lev.numpy()), qp)))
    # QP 4 is the lossless point: qStep 1
    assert torch.equal(quant.dequantize_ts(quant.quantize_ts(_t(r), 4), 4),
                       _t(r))


def test_rate_tables_match_xla():
    """The rate models' float32 2*log2(l+1)+c, read from the tables, equal
    the JAX package's jitted values at every level below 11047; the three
    pinned levels above differ in the last bit; the block sums of
    wavefront._rate_est all equal.  (Run op by op, without jit, XLA fuses
    nothing and the JAX values themselves differ.)"""
    lv = np.arange(depquant.MAX_LEVEL + 1, dtype=np.int32)
    want = np.asarray(jax.jit(jax_dq._rate_bits)(jnp.asarray(lv)))
    got = depquant.rate_bits_np()
    assert tuple(np.nonzero(got != want)[0]) == RATE_MISMATCHES
    est = np.asarray(jax.jit(jax_wf._rate_est)(
        jnp.asarray(lv.reshape(-1, 8, 8))))
    from vvc_mm_tpu_torch.common import wavefront
    mine = wavefront._rate_est(_t(lv.reshape(-1, 8, 8))).numpy()
    # XLA's order of the 64-term float32 sum (wavefront._rate_est): every
    # block's sum equal, those holding the three pinned levels included
    np.testing.assert_array_equal(mine, est)


@pytest.mark.parametrize("s", [4, 8, 16])
def test_depquant_matches_jax(rng, s):
    """The trellis and the dequantizer over QPs 0-51 (eight of them),
    on Laplacian blocks, zero blocks and saturating blocks (the MAX_LEVEL
    clip): 0 differing blocks."""
    log2s = s.bit_length() - 1
    b = {4: 48, 8: 24, 16: 8}[s]
    for qp in (0, 7, 15, 22, 30, 37, 45, 51):
        c = np.concatenate([
            _coeffs(rng, b, s), np.zeros((2, s, s), np.int32),
            rng.choice(np.array([-32768, 32767, -30000], np.int32),
                       (2, s, s))])
        lev = depquant.quantize_dep(_t(c), qp, log2s, log2s, 8)
        want = np.asarray(jax_dq.quantize_dep(jnp.asarray(c), qp, log2s,
                                              log2s, 8))
        np.testing.assert_array_equal(lev.numpy(), want)
        assert not lev[b:b + 2].any()
        np.testing.assert_array_equal(
            depquant.dequantize_dep(lev, qp, log2s, log2s, 8).numpy(),
            np.asarray(jax_dq.dequantize_dep(jnp.asarray(want), qp, log2s,
                                             log2s, 8)))
    assert depquant.quantize_dep(_t(c), 0, log2s, log2s, 8).abs().max() \
        <= depquant.MAX_LEVEL


def test_depquant_wrappers_refuse_bad_inputs():
    """The kernels' wrappers check types and shapes before any launch, and
    the CPU path never reaches them."""
    order = torch.arange(64, dtype=torch.int32)
    with pytest.raises(TypeError):
        depquant_kernel.quantize_dep(torch.zeros(2, 8, 8), order,
                                     torch.zeros(4), 1.0, 1.0, False)
    with pytest.raises(ValueError):
        depquant_kernel.dequantize_dep(torch.zeros(2, 4, 4, dtype=torch.int32),
                                       order, 1, 1, False)
    depquant_kernel.reset_launches()
    depquant.quantize_dep(torch.zeros(2, 8, 8, dtype=torch.int32), 30, 3, 3)
    assert depquant_kernel.LAUNCHES == {"quantize_dep": 0,
                                        "dequantize_dep": 0}


def test_lfnst_matches_jax(rng):
    assert np.array_equal(lfnst._kernels(), jax_lfnst._kernels())
    modes = np.arange(0, 72, dtype=np.int32)
    np.testing.assert_array_equal(
        lfnst.mode_class(_t(modes)).numpy(),
        np.asarray(jax_lfnst.mode_class(jnp.asarray(modes))))
    c = rng.integers(-32768, 32768, (40, 8, 8)).astype(np.int32)
    cls = rng.integers(0, 4, 40).astype(np.int32)
    for idx in (1, 2):
        for fn, jfn in ((lfnst.forward, jax_lfnst.forward),
                        (lfnst.inverse, jax_lfnst.inverse)):
            np.testing.assert_array_equal(
                fn(_t(c), _t(cls).long(), idx).numpy(),
                np.asarray(jfn(jnp.asarray(c), jnp.asarray(cls), idx)))
    # both candidates at once against a leading axis
    both = lfnst.forward(_t(np.stack([c, c])), _t(cls).long(),
                         torch.tensor([1, 2]))
    for i in (0, 1):
        assert torch.equal(both[i], lfnst.forward(_t(c), _t(cls).long(),
                                                  i + 1))


@pytest.mark.parametrize("s", [4, 8, 16, 32])
def test_stacked_mts_transforms_match_jax(rng, s):
    from vvc_mm_tpu_torch.common.wavefront import MTS_PAIRS
    assert transforms.dst7_allowed(s.bit_length() - 1) == \
        jax_tr.dst7_allowed(s.bit_length() - 1)
    r = rng.integers(-255, 256, (6, s, s)).astype(np.int32)
    fwd = transforms.forward_transform_pairs(_t(r), MTS_PAIRS, 8)
    for m, (th, tv) in enumerate(MTS_PAIRS):
        np.testing.assert_array_equal(
            fwd[m].numpy(), np.asarray(jax_tr.forward_transform(
                jnp.asarray(r), th, tv, bit_depth=8)))
    inv = transforms.inverse_transform_pairs(fwd, MTS_PAIRS, 8)
    for m, (th, tv) in enumerate(MTS_PAIRS):
        np.testing.assert_array_equal(
            inv[m].numpy(), np.asarray(jax_tr.inverse_transform(
                jnp.asarray(fwd[m].numpy()), th, tv, bit_depth=8)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(896, 8, 8), (256, 4, 4), (4096, 16, 16),
                                   (64, 32, 32)])
def test_cuda_depquant_kernels_match_plain(rng, shape):
    """On the card: D1 and D2 bit-exact with their plain versions (on the
    card and on the CPU) at the path's shapes, on 16x16 and 32x32 blocks
    (the global-scratch path), at QP 0, 37 and 51, on Laplacian, zero and
    saturating blocks, each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    b, s, _ = shape
    log2s = s.bit_length() - 1
    for qp in (0, 37, 51):
        for c in (_coeffs(rng, b, s), np.zeros((b, s, s), np.int32),
                  rng.choice(np.array([-32768, 32767], np.int32),
                             (b, s, s))):
            cd = _t(c).cuda()
            depquant_kernel.reset_launches()
            lev = depquant.quantize_dep(cd, qp, log2s, log2s, 8)
            rec = depquant.dequantize_dep(lev, qp, log2s, log2s, 8)
            torch.cuda.synchronize()
            assert depquant_kernel.LAUNCHES == {"quantize_dep": 1,
                                                "dequantize_dep": 1}
            assert torch.equal(lev, depquant.quantize_dep_plain(
                cd, qp, log2s, log2s, 8))
            assert torch.equal(lev.cpu(), depquant.quantize_dep(
                _t(c), qp, log2s, log2s, 8))
            assert torch.equal(rec, depquant.dequantize_dep_plain(
                lev, qp, log2s, log2s, 8))
