"""PyTorch port, kernels K3/K4/K5: the plain versions the CPU runs are held
bit-exact (tolerance 0) to the JAX package's XLA mirrors and to its Pallas
kernels in interpret mode (ops/mc_kernel.py), on random and extreme
positions, at 8 and 10 bit, and at one block count the TPU kernels' layout
gate refuses (the port takes every shape).  The CUDA kernels themselves are
held to the plain versions on the card (the `cuda` tests, and
chip_smoke.py)."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common.mm import mc as jax_mc
from vvc_mm_tpu.ops import mc_kernel as jax_kernel
from vvc_mm_tpu_torch.common import interp
from vvc_mm_tpu_torch.common.mm import mc as port_mc
from vvc_mm_tpu_torch.ops import mc_kernel

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _block_setup(rng, s, k, nbx=None, h=64, w=256, m=40, extreme=False,
                 bit_depth=8, diamond=False):
    nby = h // s
    nbx = w // s if nbx is None else nbx
    w = nbx * s
    top = 1 << bit_depth
    ref = rng.integers(0, top, (h + 2 * m, w + 2 * m), dtype=np.int32)
    bands = rng.integers(0, top, (nby * 4, nbx * s), dtype=np.int32)
    if extreme:
        pos = rng.integers(-100000, 100000, (k, nby, nbx, 2))
        pos[:, ::2, ::3] = (-(1 << 30), (1 << 30))
    elif diamond:
        # a search step: each block's centre, then the other candidates
        # 1-8 pel away from it along x or y, as the diamond and the merge
        # fields ask for nearly equal windows
        gx = np.arange(nbx)[None, :] * s * 16
        gy = np.arange(nby)[:, None] * s * 16
        pos = np.repeat(np.stack(np.broadcast_arrays(gx, gy), -1)[None]
                        + rng.integers(-m * 8, m * 8, (1, nby, nbx, 2)),
                        k, axis=0)
        for i in range(1, k):
            axis, sign = (i - 1) % 4 // 2, 1 - 2 * ((i - 1) % 2)
            pos[i, ..., axis] += sign * 16 * rng.integers(1, 9)
    else:
        pos = np.stack(
            [rng.integers(-m * 16, (w + m - s - 8) * 16, (k, nby, nbx)),
             rng.integers(-m * 16, (h + m - 8) * 16, (k, nby, nbx))], -1)
    return ref, bands, pos.astype(np.int32), m


_PALLAS_CASES = {(8, 5), (16, 4), (32, 1)}


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("extreme", [False, True], ids=["random", "extreme"])
@pytest.mark.parametrize("k", [1, 4, 5])
@pytest.mark.parametrize("s", [8, 16, 32, 24])
def test_block_kernels_plain_match_xla_and_pallas(rng, s, k, extreme):
    """K3 and K4 plain versions == XLA mirrors == Pallas (interpret).  s=24
    is a width besides the codec's that the CUDA kernels take (no Pallas
    case: interpret mode is slow)."""
    ref, bands, pos, m = _block_setup(rng, s, k, extreme=extreme)
    tr, tb, tp = _t(ref, bands, pos)
    jr, jb, jp = (jnp.asarray(a) for a in (ref, bands, pos))
    got_sad = port_mc.sad_block_positions(tr, tb, tp, m, s, 8).numpy()
    got_mc = port_mc.mc_block_positions(tr, tp, m, s, 8).numpy()
    assert got_sad.dtype == np.int32 and got_mc.dtype == np.int32
    np.testing.assert_array_equal(
        got_sad, np.asarray(jax_mc.sad_block_positions_xla(jr, jb, jp, m, s,
                                                           8)))
    np.testing.assert_array_equal(
        got_mc, np.asarray(jax_mc.mc_block_positions_xla(jr, jp, m, s, 8)))
    if (s, k) in _PALLAS_CASES:     # interpret mode is slow: one K per s
        np.testing.assert_array_equal(
            got_sad, np.asarray(jax_kernel.sad_block_positions_multi(
                jr, jb, jp, m, s, 8, interpret=True)))
        np.testing.assert_array_equal(
            got_mc, np.asarray(jax_kernel.mc_block_positions_multi(
                jr, jp, m, s, 8, interpret=True)))
    # the SAD is the band prediction's distance to the original band
    want = np.abs(got_mc - bands[None]).reshape(k, -1, 4, pos.shape[2], s) \
        .sum(axis=(2, 4))
    np.testing.assert_array_equal(got_sad, want)


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_block_kernels_take_a_shape_the_tpu_gate_refuses(rng, bit_depth):
    """nbx = 20 at s = 16 fails the Pallas kernels' `nbx % (128 // s)`
    gate, so the JAX package answers it through the XLA mirror; the port's
    functions take it as any other shape.  Also the 10-bit path."""
    s, k = 16, 4
    assert jax_kernel.block_rows_per_step(4, 20, k, s, strict=False) is None
    ref, bands, pos, m = _block_setup(rng, s, k, nbx=20,
                                      bit_depth=bit_depth)
    tr, tb, tp = _t(ref, bands, pos)
    jr, jb, jp = (jnp.asarray(a) for a in (ref, bands, pos))
    np.testing.assert_array_equal(
        port_mc.sad_block_positions(tr, tb, tp, m, s, bit_depth).numpy(),
        np.asarray(jax_mc.sad_block_positions_xla(jr, jb, jp, m, s,
                                                  bit_depth)))
    np.testing.assert_array_equal(
        port_mc.mc_block_positions(tr, tp, m, s, bit_depth).numpy(),
        np.asarray(jax_mc.mc_block_positions_xla(jr, jp, m, s, bit_depth)))


def _sub_setup(rng, k, h=64, w=128, m=40, extreme=False, bit_depth=8):
    top = 1 << bit_depth
    ref = rng.integers(0, top, (h + 2 * m, w + 2 * m), dtype=np.int32)
    orig = rng.integers(0, top, (h, w), dtype=np.int32)
    nsy, nsx = h // 4, w // 4
    if extreme:
        pos = rng.integers(-100000, 100000, (k, nsy, nsx, 2))
        pos[:, ::3, ::2] = ((1 << 30), -(1 << 30))
    else:
        pos = np.stack(
            [rng.integers(-m * 16, (w + m - 8) * 16, (k, nsy, nsx)),
             rng.integers(-m * 16, (h + m - 8) * 16, (k, nsy, nsx))], -1)
    return ref, orig, pos.astype(np.int32), m


@pytest.mark.parametrize("extreme", [False, True], ids=["random", "extreme"])
@pytest.mark.parametrize("k", [1, 4, 5])
def test_subblock_sad_plain_matches_xla_loop_and_pallas(rng, k, extreme):
    """K5 plain version == the JAX dispatcher's XLA loop == Pallas
    (interpret)."""
    ref, orig, pos, m = _sub_setup(rng, k, extreme=extreme)
    tr, to, tp = _t(ref, orig, pos)
    jr, jo, jp = (jnp.asarray(a) for a in (ref, orig, pos))
    got = port_mc.sad_positions_multi(tr, to, tp, m, 8).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.asarray(jax_mc.sad_positions_multi(jr, jo, jp, m, 8)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_kernel.sad_luma_positions_multi(
            jr, jo, jp, m, 8, interpret=True)))


def test_subblock_sad_10_bit_and_odd_grid(rng):
    """10 bit, and a subblock grid (7 x 9) no TPU row gate would take."""
    ref, orig, pos, m = _sub_setup(rng, 3, h=28, w=36, bit_depth=10)
    tr, to, tp = _t(ref, orig, pos)
    jr, jo, jp = (jnp.asarray(a) for a in (ref, orig, pos))
    np.testing.assert_array_equal(
        port_mc.sad_positions_multi(tr, to, tp, m, 10).numpy(),
        np.asarray(jax_mc.sad_positions_multi(jr, jo, jp, m, 10)))


def test_filter_table_matches_cuda_source():
    """The tap table in csrc/sad_positions.cu (a 16-byte aligned global
    table that K5 reads through the read-only cache, K3/K4 through shared
    memory) equals interp's."""
    src = open(os.path.join(ROOT, "vvc_mm_tpu_torch", "csrc",
                            "sad_positions.cu")).read()
    body = src.split("c_luma_filter", 1)[1].split("};", 1)[0]
    nums = [int(v) for v in re.findall(r"-?\d+", body)]
    rows, cols = nums[:2]
    np.testing.assert_array_equal(np.array(nums[2:]).reshape(rows, cols),
                                  interp.LUMA_FILTER)


def test_cpu_tensors_launch_nothing(rng):
    """On CPU tensors the wrappers take the plain versions and count no
    launch; wrong dtypes are refused before any launch."""
    ref, bands, pos, m = _block_setup(rng, 8, 2)
    before = dict(mc_kernel.LAUNCHES)
    mc_kernel.sad_block_positions(*_t(ref, bands, pos), m, 8, 8)
    mc_kernel.mc_block_positions(*_t(ref, pos), m, 8, 8)
    assert mc_kernel.LAUNCHES == before
    assert set(before) == {"mc_luma_positions", "mc_chroma_positions",
                           "sad_block_positions", "mc_block_positions",
                           "sad_luma_positions", "sad_bilinear_positions"}
    with pytest.raises(TypeError):
        mc_kernel._check_i32("k", torch.zeros(2, 2, dtype=torch.int64))


def test_band_kernels_refuse_what_they_do_not_take():
    """K3/K4 take block widths that are multiples of 4 in [4, 512] and
    sizes whose indices fit in 31 bits; the wrappers raise for others
    before any launch."""
    ref = torch.zeros(200, 300, dtype=torch.int32)
    ok = torch.zeros(1, 1, 1, 2, dtype=torch.int32)
    for s in (4, 8, 24, 512):
        mc_kernel._check_band("k", ref, ok, s)
    for s in (6, 10, 0, 516):
        with pytest.raises(ValueError, match="multiple of 4"):
            mc_kernel._check_band("k", ref, ok, s)
    for shape in ((64, 1024, 1024, 2), (1, 70000, 1, 2)):
        with pytest.raises(ValueError, match="31-bit"):
            mc_kernel._check_band("k", ref, ok.expand(*shape), 8)


def test_subblock_kernels_refuse_what_they_do_not_take():
    """K5/K6 take every size whose indices fit in 31 bits (a 6144x3072
    plane with K = 5 among them); the wrappers raise for others before any
    launch."""
    plane = torch.zeros(1, 1, dtype=torch.int32)
    ok = torch.zeros(1, 1, 1, 2, dtype=torch.int32)
    mc_kernel._check_sub("k", plane.expand(3072 + 160, 6144 + 160),
                         ok.expand(5, 768, 1536, 2))
    for ref, shape in ((plane.expand(50000, 50000), (1, 1, 1, 2)),
                       (plane, (1024, 1024, 1024, 2)),
                       (plane, (1, 16384, 8192, 2)),
                       (plane, (1, 70000, 1, 2))):
        with pytest.raises(ValueError, match="31-bit"):
            mc_kernel._check_sub("k", ref, ok.expand(*shape))


def _sub_cases(rng, kind):
    """K5/K6 card cases: (ref, orig, positions, margin, bit depth) at 8 and
    10 bit, K = 1 and 5, subblock grids above and below K5's split size
    (37 subblocks a row: no multiple of a tile), and a plane
    whose rows are not 16-byte aligned (the scalar-load path)."""
    for k, h, w, bd, cut in ((5, 128, 256, 8, 0), (1, 128, 256, 10, 0),
                             (5, 32, 148, 10, 0), (5, 512, 148, 10, 3),
                             (1, 28, 36, 8, 1)):
        ref, orig, pos, m = _sub_setup(rng, k, h=h, w=w, bit_depth=bd,
                                       extreme=kind == "extreme")
        if kind == "diamond":
            _, _, pos, _ = _block_setup(rng, 4, k, nbx=w // 4, h=h, m=m,
                                        diamond=True)
        ref = np.pad(ref, ((0, 0), (0, cut)))
        yield (*(t.cuda() for t in _t(ref, orig, pos)), m, bd)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "extreme", "diamond"])
def test_cuda_search_kernels_match_plain(rng, kind):
    """On the card: K3, K4, K5 bit-exact with their plain versions, each
    launch counted.  K3/K4 at block widths 8, 16, 32 and 24, K = 1, 5 and
    6, 8 and 10 bit, 37 blocks a row (no multiple of any CTA tile), planes
    whose rows are 16-byte aligned or not, on random, clamped and
    diamond-like positions; K5 on the cases of _sub_cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    extreme = kind == "extreme"
    for s in (8, 16, 32, 24):
        for k, bit_depth in ((1, 8), (5, 10), (6, 8)):
            ref, bands, pos, m = _block_setup(
                rng, s, k, nbx=37, h=128, extreme=extreme,
                bit_depth=bit_depth, diamond=kind == "diamond")
            r, b, p = (t.cuda() for t in _t(ref, bands, pos))
            before = dict(mc_kernel.LAUNCHES)
            got_sad = mc_kernel.sad_block_positions(r, b, p, m, s, bit_depth)
            got_mc = mc_kernel.mc_block_positions(r, p, m, s, bit_depth)
            assert mc_kernel.LAUNCHES["sad_block_positions"] == \
                before["sad_block_positions"] + 1
            assert mc_kernel.LAUNCHES["mc_block_positions"] == \
                before["mc_block_positions"] + 1
            torch.testing.assert_close(
                got_sad, mc_kernel.sad_block_positions_plain(
                    r, b, p, m, s, bit_depth), rtol=0, atol=0)
            torch.testing.assert_close(
                got_mc, mc_kernel.mc_block_positions_plain(
                    r, p, m, s, bit_depth), rtol=0, atol=0)
            if k == 5:      # rows not 16-byte aligned: the scalar-load path
                r = r[:, 1:].contiguous()
                torch.testing.assert_close(
                    mc_kernel.sad_block_positions(r, b, p, m, s, bit_depth),
                    mc_kernel.sad_block_positions_plain(r, b, p, m, s,
                                                        bit_depth),
                    rtol=0, atol=0)
                torch.testing.assert_close(
                    mc_kernel.mc_block_positions(r, p, m, s, bit_depth),
                    mc_kernel.mc_block_positions_plain(r, p, m, s,
                                                       bit_depth),
                    rtol=0, atol=0)
    for r, o, p, m, bd in _sub_cases(rng, kind):
        before = mc_kernel.LAUNCHES["sad_luma_positions"]
        got = mc_kernel.sad_luma_positions(r, o, p, m, bd)
        assert mc_kernel.LAUNCHES["sad_luma_positions"] == before + 1
        torch.testing.assert_close(
            got, mc_kernel.sad_luma_positions_plain(r, o, p, m, bd), rtol=0,
            atol=0)


@pytest.mark.cuda
def test_cuda_kernels_take_a_6144x3072_plane(rng):
    """On the card: K1-K6 bit-exact with their plain versions on an 8-bit
    6144x3072 plane (the size of bench.py's 6K configuration), each launch
    counted: K1/K2 on the subblock grid, K3 at s=8 K=5 and s=16 K=6, K4 at
    s=16 K=4, K5/K6 with K=5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    h, w, m = 3072, 6144, 80
    ny, nx = h // 4, w // 4
    ref = torch.from_numpy(rng.integers(0, 256, (h + 2 * m, w + 2 * m),
                                        dtype=np.int32)).cuda()
    orig = torch.from_numpy(rng.integers(0, 256, (h, w),
                                         dtype=np.int32)).cuda()

    def grid_pos(k, gy, gx, step):
        base = np.stack(np.meshgrid(np.arange(gx) * step * 16,
                                    np.arange(gy) * step * 16), -1)
        pos = base + rng.integers(-m * 16, m * 16, (k, gy, gx, 2))
        return torch.from_numpy(pos.astype(np.int32)).cuda()

    def check(name, args):
        before = mc_kernel.LAUNCHES[name]
        got = getattr(mc_kernel, name)(*args)
        assert mc_kernel.LAUNCHES[name] == before + 1
        torch.testing.assert_close(
            got, getattr(mc_kernel, name + "_plain")(*args), rtol=0, atol=0)

    p = grid_pos(1, ny, nx, 4)[0]
    check("mc_luma_positions", (ref, p, m, 8))
    check("mc_chroma_positions", (ref[::2, ::2].contiguous(), p, m // 2, 8))
    for s, k in ((8, 5), (16, 6)):
        bands = torch.from_numpy(rng.integers(
            0, 256, (h // s * 4, w // s * s), dtype=np.int32)).cuda()
        check("sad_block_positions",
              (ref, bands, grid_pos(k, h // s, w // s, s), m, s, 8))
    check("mc_block_positions", (ref, grid_pos(4, h // 16, w // 16, 16), m,
                                 16, 8))
    p = grid_pos(5, ny, nx, 4)
    check("sad_luma_positions", (ref, orig, p, m, 8))
    check("sad_bilinear_positions", (ref, orig, p, m))
