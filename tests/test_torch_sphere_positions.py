"""PyTorch port, the sphere-positions kernel's plain versions
(MVReprojection.positions_plain and centers_plain, the plain versions of
ops/sphere_kernel.py's launches) against the JAX package, tolerance 0, on
MV fields made from a numpy seed.

The plain versions take K fields (per-model MV layers and a per-block
model index) at once, as the kernel does, and run the port's float32
chain; each field is held to the JAX package's own function:

- the merged positions: JAX's jitted `merged_positions`;
- the merge search's positions (`form="search"`): the JAX search's tail
  (the fields' `_merged_positions` at row step 4 feeding the exact SAD) in
  one jit, at 256x128, the size below 512 rows where the codec runs it (a
  free-standing jit compiles a form of its own: at 2048x1024 13 of 163,840
  ROT positions differ from the search form and 15 from the merged form);
- the diamond search's positions, `reproject_frame` op by op, at its row
  and column subsampling;
- `reproject_block_centers` (the decision arm at 512 rows and more).

Fields mix MVs of +-24 pel, zero MVs (and MVs zero along one axis), MVs of
40-200 pel (several focal lengths of the MPA planes: points cross to the
virtual image plane) and extreme MVs (+-2048 pel); block sizes 8, 16 and
32, row steps 1 and 4, K = 1 and 5; MPA's three planes and ROT beside
CLASSIC, at 256x128 and on a 2048x1024 row band (the top 64 rows of the
full-size ERP picture: a reprojection of 2048x64 over ERP(2048, 1024)).
A CPU test holds the launch arguments and the launch template (built
without a card) to the constants and the rsqrt table of the plain chain,
another that the launcher refuses CPU tensors, and a `cuda` test holds the
kernel to the plain version on the card (skipped here).  About 25 s
of test time in all on one core (`-n 6` spreads it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common.inter_frame import MC_MARGIN as JAX_MC_MARGIN
from vvc_mm_tpu.common.mm import frame_codec as jax_fc
from vvc_mm_tpu.common.mm.reprojection import MVReprojection as JaxReproj
from vvc_mm_tpu.lib360.projection import ERP as JaxERP
from vvc_mm_tpu_torch.common import libm_f32
from vvc_mm_tpu_torch.common.mm.reprojection import MVReprojection
from vvc_mm_tpu_torch.lib360.projection import ERP, PI, div, recip32
from vvc_mm_tpu_torch.ops import sphere_kernel as sk

torch.set_num_threads(1)

MODELS = [0, 1, 2, 3, 6]            # CLASSIC, MPA x3, ROT
SPHERE = [1, 2, 3, 6]
# (picture width, height, reprojection height): 256x128, and the top 64
# rows of 2048x1024
SMALL = (256, 128, 128)
BAND = (2048, 1024, 64)


def _pair(size):
    w, h, rh = size
    return (JaxReproj(JaxERP(w, h), w, rh, 1),
            MVReprojection(ERP(w, h), w, rh, 1, device="cpu"))


def _fields(rng, k: int, n: int, nby: int, nbx: int) -> np.ndarray:
    """(k, n, nby, nbx, 2) int32 1/16-pel MVs: +-24 pel, with an eighth of
    the blocks each zero, zero along x, 40-200 pel and +-2048 pel."""
    mv = rng.integers(-384, 385, (k, n, nby, nbx, 2))
    kind = rng.integers(0, 8, (k, n, nby, nbx))
    mv[kind == 0] = 0
    mv[..., 0][kind == 1] = 0
    big = rng.integers(640, 3201, mv.shape) * rng.choice([-1, 1], mv.shape)
    mv[kind == 2] = big[kind == 2]
    mv[kind == 3] = rng.integers(-32768, 32769, mv.shape)[kind == 3]
    return mv.astype(np.int32)


def _idx(rng, k: int, nby: int, nbx: int, n: int) -> np.ndarray:
    return rng.integers(0, n, (k, nby, nbx)).astype(np.int32)


def _shift2(f: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """frame_codec._shift2: the neighbour's field, zero outside."""
    p = np.pad(f, ((1, 1), (1, 1)) + ((0, 0),) * (f.ndim - 2))
    return p[1 + dy:1 + dy + f.shape[0], 1 + dx:1 + dx + f.shape[1]]


MERGED_CASES = [(SMALL, 8, 1), (SMALL, 16, 5), (SMALL, 32, 1),
                (BAND, 16, 1)]


@pytest.mark.parametrize("size,s,k", MERGED_CASES,
                         ids=[f"{w}x{rh}-s{s}-K{k}"
                              for (w, _, rh), s, k in MERGED_CASES])
def test_merged_positions_match_jax(size, s, k):
    jr, tr = _pair(size)
    rng = np.random.default_rng(1400 + s + k)
    nby, nbx = tr.height // s, tr.width // s
    idx = _idx(rng, k, nby, nbx, len(MODELS))
    mv = _fields(rng, k, len(MODELS), nby, nbx)
    got = tr.positions_plain(MODELS, torch.from_numpy(idx),
                                    torch.from_numpy(mv), s).numpy()
    assert got.shape == (k, tr.height // 4, tr.width // 4, 2)
    assert got.dtype == np.int32
    for f in range(k):
        want = np.asarray(jax_fc.merged_positions(
            jr, MODELS, jnp.asarray(idx[f]), jnp.asarray(mv[f]), s))
        np.testing.assert_array_equal(got[f], want)


@pytest.mark.parametrize("s", [8, 16])
def test_search_positions_match_jax(s):
    """The merge search's candidate fields (the selection, its three
    neighbour shifts and zero CLASSIC) at the search's row step."""
    w, h, _ = SMALL
    jr, tr = _pair(SMALL)
    row_step = 4 if s // 4 >= 4 else 1
    rng = np.random.default_rng(1420 + s)
    nby, nbx = h // s, w // s
    idx = _idx(rng, 1, nby, nbx, len(MODELS))[0]
    stack = _fields(rng, 1, len(MODELS), nby, nbx)[0]
    fields = [(idx, stack)] + [
        (_shift2(idx, dy, dx),
         np.stack([_shift2(st, dy, dx) for st in stack]))
        for dy, dx in ((0, -1), (-1, 0), (-1, 1))] + [
        (np.zeros_like(idx), np.zeros_like(stack))]       # zero CLASSIC
    idx_k = np.stack([i for i, _ in fields])
    mv_k = np.stack([st for _, st in fields])
    for m in (1, 2, 3):
        jr.mpa_cache(m)
    refp = jnp.asarray(rng.integers(0, 256, (h + 2 * JAX_MC_MARGIN,
                                             w + 2 * JAX_MC_MARGIN)),
                       jnp.int32)
    oy = jnp.asarray(rng.integers(0, 256, (h // row_step, w)), jnp.int32)

    @jax.jit
    def tail(i, st, refp, oy):
        pos = jnp.stack([jax_fc._merged_positions(jr, MODELS, s, None, i[f],
                                                  st[f], row_step)
                         for f in range(len(fields))])
        return pos, jax_fc._sad_fields_bilin(refp, oy, pos, s, row_step,
                                             exact=True, bit_depth=8)

    want = np.asarray(tail(jnp.asarray(idx_k), jnp.asarray(mv_k), refp,
                           oy)[0])
    got = tr.positions_plain(MODELS, torch.from_numpy(idx_k),
                                    torch.from_numpy(mv_k), s, row_step, 1,
                                    "search").numpy()
    np.testing.assert_array_equal(got, want)


OP_CASES = [(SMALL, 16, 4, 2, 5), (SMALL, 8, 1, 1, 1),
            (BAND, 32, 4, 2, 1)]


@pytest.mark.parametrize("size,s,row_step,col_step,k", OP_CASES,
                         ids=[f"{w}x{rh}-s{s}-r{r}-c{c}-K{k}"
                              for (w, _, rh), s, r, c, k in OP_CASES])
def test_diamond_positions_op_by_op_match_jax(size, s, row_step, col_step,
                                              k):
    """The diamond search's K candidates of one model, op by op, at its
    row and column subsampling: JAX's reproject_frame per candidate."""
    jr, tr = _pair(size)
    rng = np.random.default_rng(1440 + s + k)
    nby, nbx = tr.height // s, tr.width // s
    for model in SPHERE:
        mv = _fields(rng, k, 1, nby, nbx)
        got = tr.positions_plain([model], None,
                                        torch.from_numpy(mv), s, row_step,
                                        col_step, None).numpy()
        for f in range(k):
            want = np.asarray(jr.reproject_frame(
                model, jnp.asarray(mv[f, 0]), s, None, row_step))
            np.testing.assert_array_equal(got[f], want[:, ::col_step])


CENTER_CASES = [(SMALL, 16, 5), (SMALL, 8, 1), (BAND, 16, 1)]


@pytest.mark.parametrize("size,s,k", CENTER_CASES,
                         ids=[f"{w}x{rh}-s{s}-K{k}"
                              for (w, _, rh), s, k in CENTER_CASES])
def test_block_centers_match_jax(size, s, k):
    """K fields of every model, merged by the block's model index: JAX's
    reproject_block_centers per model, taken by the index."""
    jr, tr = _pair(size)
    rng = np.random.default_rng(1460 + s + k)
    nby, nbx = tr.height // s, tr.width // s
    idx = _idx(rng, k, nby, nbx, len(MODELS))
    mv = _fields(rng, k, len(MODELS), nby, nbx)
    got = tr.centers_plain(MODELS, torch.from_numpy(idx),
                                  torch.from_numpy(mv), s).numpy()
    assert got.shape == (k, nby, nbx, 2) and got.dtype == np.int32
    for f in range(k):
        per_model = np.stack([np.asarray(jr.reproject_block_centers(
            m, jnp.asarray(mv[f, i]), s)) for i, m in enumerate(MODELS)])
        want = np.take_along_axis(per_model, idx[f][None, :, :, None],
                                  axis=0)[0]
        np.testing.assert_array_equal(got[f], want)


@pytest.mark.parametrize("size,s,k", CENTER_CASES,
                         ids=[f"{w}x{rh}-s{s}-K{k}"
                              for (w, _, rh), s, k in CENTER_CASES])
def test_block_centers_search_form_match_jax_jit(size, s, k):
    """The search form of the block centres (the JAX codec computes them
    inside its search jits): K fields of every model, merged by the
    block's model index, against jax.jit(reproject_block_centers) per
    model, 0 differing centres (op by op, 8-119 of 8,192-32,768 at
    2048x1024 differ from the jit)."""
    jr, tr = _pair(size)
    rng = np.random.default_rng(1470 + s + k)
    nby, nbx = tr.height // s, tr.width // s
    idx = _idx(rng, k, nby, nbx, len(MODELS))
    mv = _fields(rng, k, len(MODELS), nby, nbx)
    got = tr.centers_plain(MODELS, torch.from_numpy(idx),
                           torch.from_numpy(mv), s, None, "search").numpy()
    for f in range(k):
        per_model = np.stack([np.asarray(jax.jit(
            lambda v, m=m: jr.reproject_block_centers(m, v, s))(
                jnp.asarray(mv[f, i]))) for i, m in enumerate(MODELS)])
        want = np.take_along_axis(per_model, idx[f][None, :, :, None],
                                  axis=0)[0]
        np.testing.assert_array_equal(got[f], want)


def test_wrapper_on_the_cpu_is_the_plain_version():
    """On a CPU reprojection the entry points return the plain versions
    and launch nothing; reproject_frame and reproject_block_centers go
    through them."""
    _, tr = _pair(SMALL)
    rng = np.random.default_rng(1480)
    idx = torch.from_numpy(_idx(rng, 2, 8, 16, len(MODELS)))
    mv = torch.from_numpy(_fields(rng, 2, len(MODELS), 8, 16))
    sk.reset_launches()
    got = tr.positions(MODELS, idx, mv, 16, 4, 2, "search")
    want = tr.positions_plain(MODELS, idx, mv, 16, 4, 2, "search")
    assert torch.equal(got, want)
    for form in (None, "search"):
        got = tr.centers(MODELS, idx, mv, 16, None, form)
        assert torch.equal(got, tr.centers_plain(MODELS, idx, mv, 16, None,
                                                 form))
    assert torch.equal(tr.reproject_frame(6, mv[0, 4], 16, None, 4),
                       tr._frame_chain(6, mv[0, 4], 16, None, 4))
    assert torch.equal(tr.reproject_block_centers(2, mv[1, 2], 16),
                       tr._centers_chain(2, mv[1, 2], 16))
    assert sk.LAUNCHES == {"sphere_positions": 0, "sphere_centers": 0}


def test_launcher_refuses_cpu_tensors():
    """The launcher runs on the card or raises: it never falls back to the
    chain."""
    _, tr = _pair(SMALL)
    tmpl = tr._template("sphere_positions", MODELS, "merged", 16)
    mv = torch.zeros((1, len(MODELS), 8, 16, 2), dtype=torch.int32)
    out = torch.empty((1, 32, 64, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        sk.launch("sphere_positions", tmpl, None, mv, out)
    assert sk.LAUNCHES["sphere_positions"] == 0


def test_launch_args_are_the_plain_chains_constants():
    """The launch's constants, built without a card, are the float32
    values the plain chain's Python scalars round to: the chain's own
    expressions give the same bits with the constant as with the scalar.
    The rsqrt table is libm_f32's, each slot's grid constant is the
    reprojection's cache, and the launch template holds them."""
    _, tr = _pair(SMALL)
    proj = tr.proj
    a = tr.launch_args(MODELS + [7], "merged", 16)
    c = a["consts"]
    assert set(c) == set(sk.CONST_NAMES)
    x = torch.from_numpy(np.random.default_rng(1490).uniform(
        -300, 300, 4096).astype(np.float32))
    t = lambda v: torch.tensor(v, dtype=torch.float32)   # noqa: E731

    def same(a_, b_):
        assert torch.equal(a_.view(torch.int32), b_.view(torch.int32))
    same(x * PI, x * t(c["pi"]))
    same(x - 2.0 * PI, x - t(c["two_pi"]))
    same(PI / 2 - x, t(c["half_pi"]) - x)
    same(x * tr.angle_res, x * t(c["angle_res"]))
    same(div(x, proj.width), x / t(c["width"]))
    same(div(x, proj.height), x / t(c["height"]))
    same(div(x, 2.0 * PI), x / t(c["two_pi"]))
    same(div(x, proj.focal), x / t(c["focal"]))
    same(proj.focal * x, x * t(c["focal"]))
    same(x + proj.pixel_offset, x + t(c["po"]))
    same(x - tr.offset, x - t(c["offset"]))
    same(x * recip32(proj.focal), x * t(c["focal_recip"]))
    same(x * -recip32(2.0 * PI), x * t(c["neg_recip_2pi"]))
    same(x * float(np.float32(recip32(PI)) * np.float32(proj.height)),
         x * t(c["y_scale"]))
    assert c["persp_c"] == 0.0 and c["half"] == 7.5
    assert a["rsqrt_tab"] is libm_f32._rsqrt_table(tr.device)
    assert a["codes"] == [0, 1, 2, 3, 6, sk.SKIP] and a["form"] == "merged"
    for m, grid in zip(MODELS + [7], a["grids"]):
        if m in (1, 2, 3):
            assert all(torch.equal(g, w) for g, w in zip(grid,
                                                         tr.mpa_cache(m)))
        elif m == 6:
            assert all(torch.equal(g, w) for g, w in zip(
                grid, tr.grid_sphere()))
        else:
            assert grid is None
    assert tr.launch_args([6], "search", 8)["grids"] == [None]
    assert tr.launch_args([1], None, 8, centers=True)["grids"] == [None]
    tmpl = tr._template("sphere_positions", MODELS + [7], "merged", 16)
    assert tmpl is tr._template("sphere_positions", MODELS + [7], "merged",
                                16)
    assert list(tmpl.code)[:6] == a["codes"] and tmpl.n_models == 6
    assert (tmpl.form, tmpl.bs, tmpl.grid_w) == (1, 16, 64)
    assert tmpl.rsqrt_tab == a["rsqrt_tab"].data_ptr()
    assert tmpl.ga[4] == tr.grid_sphere()[0].data_ptr() and tmpl.vip[4] is None
    assert tmpl.vip[1] == tr.mpa_cache(1)[2].data_ptr()
    for n in sk.CONST_NAMES:
        assert getattr(tmpl.c, n) == c[n]


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """On the card: one launch a call, bit for bit with the plain version
    run on the card, for every form at 256x128 and on a 2048x1024 picture
    (random, zero, large and extreme MVs; K = 1 and 5; with a GED layer
    filled by the chain)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(1495)
    for w, h in ((256, 128), (2048, 1024)):
        tr = MVReprojection(ERP(w, h), w, h, 1, device="cuda")
        for s, k, row_step, col_step, form in (
                (16, 1, 1, 1, "merged"), (8, 5, 1, 1, "search"),
                (16, 5, 4, 1, "search"), (16, 5, 4, 2, None),
                (32, 1, 4, 1, "merged")):
            nby, nbx = h // s, w // s
            models = MODELS + ([7] if form == "merged" else [])
            idx = torch.from_numpy(_idx(rng, k, nby, nbx, len(models)))
            mv = torch.from_numpy(_fields(rng, k, len(models), nby, nbx))
            eps = {7: (0.3, -0.5, 0.8)}
            for name, fn, plain, args in (
                    ("sphere_positions", tr.positions, tr.positions_plain,
                     (s, row_step, col_step, form, eps)),
                    ("sphere_centers", tr.centers, tr.centers_plain,
                     (s, eps))):
                before = sk.LAUNCHES[name]
                got = fn(models, idx.cuda(), mv.cuda(), *args)
                assert sk.LAUNCHES[name] == before + 1
                want = plain(models, idx.cuda(), mv.cuda(), *args)
                torch.testing.assert_close(got, want, rtol=0, atol=0)
