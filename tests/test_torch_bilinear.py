"""PyTorch port, kernel K6 (the 2-tap bilinear decision SAD): the plain
version the CPU runs is held bit-exact (tolerance 0) to the JAX package's
XLA mirror and to its Pallas kernel in interpret mode, on random and extreme
(clamped) positions; the `exact=False` arm of `_sad_fields_bilin`, which
reaches it, is held to the JAX function with row and column subsampling.
The CUDA kernel itself is held to the plain version on the card (the `cuda`
test, and chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common.mm import frame_codec as jax_fc
from vvc_mm_tpu.common.mm import mc as jax_mc
from vvc_mm_tpu.ops import mc_kernel as jax_kernel
from vvc_mm_tpu_torch.common.mm import frame_codec
from vvc_mm_tpu_torch.common.mm import mc as port_mc
from vvc_mm_tpu_torch.ops import mc_kernel

torch.set_num_threads(1)


def _setup(rng, k, h=64, w=128, m=40, extreme=False, top=256):
    ref = rng.integers(0, top, (h + 2 * m, w + 2 * m), dtype=np.int32)
    orig = rng.integers(0, top, (h, w), dtype=np.int32)
    nsy, nsx = h // 4, w // 4
    if extreme:
        pos = rng.integers(-100000, 100000, (k, nsy, nsx, 2))
        pos[:, ::3, ::2] = ((1 << 30), -(1 << 30))
    else:
        pos = np.stack(
            [rng.integers(-m * 16, (w + m - 4) * 16, (k, nsy, nsx)),
             rng.integers(-m * 16, (h + m - 4) * 16, (k, nsy, nsx))], -1)
    return ref, orig, pos.astype(np.int32), m


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("extreme", [False, True], ids=["random", "extreme"])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_bilinear_sad_plain_matches_xla_mirror_and_pallas(rng, k, extreme):
    ref, orig, pos, m = _setup(rng, k, extreme=extreme)
    jr, jo, jp = (jnp.asarray(a) for a in (ref, orig, pos))
    got = port_mc.sad_bilinear_positions(*_t(ref, orig, pos), m).numpy()
    assert got.dtype == np.int32 and got.shape == pos.shape[:3]
    np.testing.assert_array_equal(
        got, np.asarray(jax_mc.sad_bilinear_positions_xla(jr, jo, jp, m)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_kernel.sad_bilinear_positions_multi(
            jr, jo, jp, m, interpret=True)))


def test_bilinear_sad_takes_an_odd_grid_and_10_bit_samples(rng):
    """A 7 x 9 subblock grid (no TPU row gate takes it) and 10-bit samples:
    the function has no bit depth argument and never clips."""
    ref, orig, pos, m = _setup(rng, 3, h=28, w=36, top=1024)
    jr, jo, jp = (jnp.asarray(a) for a in (ref, orig, pos))
    np.testing.assert_array_equal(
        port_mc.sad_bilinear_positions(*_t(ref, orig, pos), m).numpy(),
        np.asarray(jax_mc.sad_bilinear_positions_xla(jr, jo, jp, m)))


def test_bilinear_sad_at_integer_positions_is_the_plain_sad(rng):
    """Phase 0 in both directions copies the sample: the SAD is the direct
    one against the reference shifted by whole pixels."""
    ref, orig, _, m = _setup(rng, 1)
    h, w = orig.shape
    gy, gx = np.mgrid[0:h // 4, 0:w // 4]
    pos = (np.stack([gx * 4 + 3, gy * 4 - 2], -1) * 16)[None] \
        .astype(np.int32)
    got = port_mc.sad_bilinear_positions(*_t(ref, orig, pos), m).numpy()
    shifted = ref[m - 2:m - 2 + h, m + 3:m + 3 + w]
    want = np.abs(shifted - orig).reshape(h // 4, 4, w // 4, 4).sum((1, 3))
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("exact", [False, True], ids=["bilinear", "exact"])
@pytest.mark.parametrize("row_step,col_step", [(1, 1), (2, 1), (1, 2),
                                               (2, 2)])
def test_sad_fields_bilin_matches_jax(rng, row_step, col_step, exact):
    """The block reduction and the scaling back to full-SAD range around
    K6 (exact=False) and K5 (exact=True), on a subsampled subblock grid."""
    s, k, h, w = 16, 4, 64, 128
    ref, orig, pos, m = _setup(rng, k, h=h, w=w, m=jax_fc.MC_MARGIN)
    assert m == frame_codec.MC_MARGIN
    orig_sub = np.array(jax_fc._subsample_rows(jnp.asarray(orig), row_step,
                                               col_step))
    np.testing.assert_array_equal(
        frame_codec._subsample_rows(torch.from_numpy(orig), row_step,
                                    col_step).numpy(), orig_sub)
    pos_sub = np.ascontiguousarray(pos[:, ::row_step, ::col_step])
    want = np.asarray(jax_fc._sad_fields_bilin(
        jnp.asarray(ref), jnp.asarray(orig_sub), jnp.asarray(pos_sub), s,
        row_step, col_step, exact=exact))
    got = frame_codec._sad_fields_bilin(
        *_t(ref, orig_sub, pos_sub), s, row_step, col_step, exact=exact)
    assert got.dtype == torch.int32
    assert got.shape == (k, h // s, w // s)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bilinear_wrapper_on_cpu_launches_nothing_and_checks_types(rng):
    ref, orig, pos, m = _setup(rng, 2)
    before = mc_kernel.LAUNCHES["sad_bilinear_positions"]
    mc_kernel.sad_bilinear_positions(*_t(ref, orig, pos), m)
    assert mc_kernel.LAUNCHES["sad_bilinear_positions"] == before
    assert port_mc.sad_bilinear_positions is mc_kernel.sad_bilinear_positions
    tr, to, tp = _t(ref, orig, pos)
    with pytest.raises(TypeError):
        mc_kernel._launch_search("sad_bilinear_positions", tr,
                                 tp.to(torch.int64), pos.shape[:3], (5, 5),
                                 m, None, to, None)


@pytest.mark.cuda
@pytest.mark.parametrize("extreme", [False, True], ids=["random", "extreme"])
def test_cuda_bilinear_kernel_matches_plain(rng, extreme):
    """On the card: K6 bit-exact with its plain version, the launch
    counted, at 8 and 10 bit, K = 1, 3 and 5, small and large subblock
    grids (37 subblocks a row: no multiple of a tile), and planes whose
    rows are not 16-byte aligned (the scalar-load path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for k, h, w, top, cut in ((5, 128, 256, 256, 0), (1, 128, 256, 1024, 0),
                              (5, 32, 148, 1024, 0), (5, 256, 148, 1024, 3),
                              (1, 28, 36, 256, 1), (3, 64, 128, 256, 0)):
        ref, orig, pos, m = _setup(rng, k, h=h, w=w, extreme=extreme,
                                   top=top)
        ref = np.pad(ref, ((0, 0), (0, cut)))
        r, o, p = (t.cuda() for t in _t(ref, orig, pos))
        before = mc_kernel.LAUNCHES["sad_bilinear_positions"]
        got = mc_kernel.sad_bilinear_positions(r, o, p, m)
        assert mc_kernel.LAUNCHES["sad_bilinear_positions"] == before + 1
        torch.testing.assert_close(
            got, mc_kernel.sad_bilinear_positions_plain(r, o, p, m), rtol=0,
            atol=0)
