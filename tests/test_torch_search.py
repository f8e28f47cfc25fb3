"""PyTorch port, the encoder's search, host selection and finish stages
against the JAX package, stage by stage on the same inputs (tolerance 0).

The 256x128 clip's POC 4 (P, from POC 0) and POC 2 (B, from POC 0 and 4)
at QP 38.  The references are the decoded pictures of the committed stream:
they are decoded here by the port's DecLib, whose MD5 check against the JAX
encoder's hash SEIs proves them equal to the JAX decoder's DPB.  Stage N of
the port is fed stage N-1 of JAX (convert.search_from_numpy), so a mismatch
names its stage.  At this size the float32 positions of the two packages
agree everywhere, so every grid is equal.

The >= 512-row arm (block-translational decision SADs, kernels K3/K4),
which a small clip never reaches, has its own test at 64x512.  There one
block-centre position differs from XLA's, which moves one MV of a model
that the block did NOT select: the test compares every decision and every
SAD exactly, and the full per-model MV stacks up to that counted entry."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import deblock as jax_deblock
from vvc_mm_tpu.common import qtree as jax_qtree
from vvc_mm_tpu.common import quant as jax_quant
from vvc_mm_tpu.common.mm import frame_codec as jax_fc
from vvc_mm_tpu.common.mm import qt_codec as jax_qt
from vvc_mm_tpu.common.mm.reprojection import MVReprojection as JaxReproj
from vvc_mm_tpu.encoder import inter_coder as jax_ic
from vvc_mm_tpu.lib360.projection import ERP as JaxERP
from vvc_mm_tpu_torch.common import deblock, qtree
from vvc_mm_tpu_torch.common.mm import frame_codec, qt_codec
from vvc_mm_tpu_torch.common.mm.reprojection import MVReprojection
from vvc_mm_tpu_torch.convert import planes_from_numpy, search_from_numpy
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder import inter_coder
from vvc_mm_tpu_torch.lib360.projection import ERP
from vvc_mm_tpu_torch.utils.content import realistic_sequence

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
STREAM = os.path.join(DATA, "erp256x128_ra_mm_qp37_5f.bin")
W, H, QP, TOP, DEPTH, SR = 256, 128, 38, 16, 1, 24
ACTIVE = [0, 1, 2, 3, 6]            # CLASSIC, MPA x3, ROT
LAM = jax_quant.lambda_from_qp(QP, intra=False)


def _np(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


def _assert_tree_equal(got, want, what=""):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{what}[{i}]")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{what}[{k}]")
    else:
        assert got.shape == want.shape, (what, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.fixture(scope="module")
def world():
    dec = DecLib(device="cpu")
    frames = dec.decode_bytes(open(STREAM, "rb").read())
    assert set(dec.hash_status.values()) == {"OK"}    # == the JAX DPB
    dpb = {f.poc: f.numpy() for f in frames}
    src = [[p.astype(np.int32) for p in f]
           for f in realistic_sequence(W, H, 5)]
    return dict(
        src=src, dpb=dpb,
        jr=JaxReproj(JaxERP(W, H), W, H, 1),
        tr=MVReprojection(ERP(W, H), W, H, 1, device="cpu"))


def _j(planes):
    return [jnp.asarray(np.asarray(p, dtype=np.int32)) for p in planes]


def _t(planes):
    return planes_from_numpy(planes, device="cpu")


# ------------------------------------------------------------- P picture

@pytest.fixture(scope="module")
def jax_p(world):
    """JAX search_qt_mm + qt_rd_stats of POC 4 from POC 0."""
    oy, ou, ov = _j(world["src"][4])
    ry, ru, rv = _j(world["dpb"][0])
    per, stack = jax_qt.search_qt_mm(world["jr"], ACTIVE, oy, ry, QP, TOP,
                                     DEPTH, 8, SR, None, True)
    rd = [jax_qt.qt_rd_stats(world["jr"], ACTIVE, t[0], t[1], oy, ou, ov,
                             ry, ru, rv, QP, TOP >> i, 8, None, True)
          for i, t in enumerate(per)]
    return dict(per=_np(per), stack=np.asarray(stack), rd=_np(rd))


def test_p_search_grids_equal_jax(world, jax_p):
    oy, ou, ov = _t(world["src"][4])
    ry, ru, rv = _t(world["dpb"][0])
    per, stack = qt_codec.search_qt_mm(world["tr"], ACTIVE, oy, ry, QP, TOP,
                                       DEPTH, 8, SR, None, True)
    _assert_tree_equal(_np(per), jax_p["per"], "per-size search grids")
    np.testing.assert_array_equal(stack.numpy(), jax_p["stack"])
    assert all(t.dtype == torch.int32 for tup in per for t in tup)
    # the tree is not trivial: several models are chosen at both sizes
    assert len(np.unique(jax_p["per"][0][0])) > 1
    assert len(np.unique(jax_p["per"][1][0])) > 1


def test_p_rd_stats_equal_jax(world, jax_p):
    """qt_rd_stats of the port on JAX's selections (stage N from N-1)."""
    oy, ou, ov = _t(world["src"][4])
    ry, ru, rv = _t(world["dpb"][0])
    for i, t in enumerate(search_from_numpy(jax_p["per"], "cpu")):
        rd = qt_codec.qt_rd_stats(world["tr"], ACTIVE, t[0], t[1], oy, ou,
                                  ov, ry, ru, rv, QP, TOP >> i, 8, None,
                                  True)
        _assert_tree_equal(_np(rd), jax_p["rd"][i], f"rd stats level {i}")
        assert rd[0].dtype == rd[1].dtype == torch.int32


@pytest.fixture(scope="module")
def p_selection(jax_p):
    """The JAX package's host selection on its own search outputs."""
    splits, leaf = jax_ic.resolve_tree_qt_mm(jax_p["per"], jax_p["rd"],
                                             len(ACTIVE), LAM, DEPTH)
    midx_u, mv_u, decisions = jax_ic.select_qt_mm(
        jax_p["per"], splits, leaf, ACTIVE, LAM ** 0.5, TOP, DEPTH)
    return dict(splits=splits, leaf=leaf, midx_u=midx_u, mv_u=mv_u,
                decisions=decisions)


def test_p_host_selection_equal_jax(jax_p, p_selection):
    splits, leaf = inter_coder.resolve_tree_qt_mm(
        jax_p["per"], jax_p["rd"], len(ACTIVE), LAM, DEPTH)
    _assert_tree_equal(splits, p_selection["splits"], "splits")
    _assert_tree_equal(leaf, p_selection["leaf"], "leaf masks")
    midx_u, mv_u, decisions = inter_coder.select_qt_mm(
        jax_p["per"], splits, leaf, ACTIVE, LAM ** 0.5, TOP, DEPTH)
    np.testing.assert_array_equal(midx_u, p_selection["midx_u"])
    np.testing.assert_array_equal(mv_u, p_selection["mv_u"])
    assert decisions == p_selection["decisions"]
    assert 0 < int(splits[0].sum()) < splits[0].size   # a mixed tree
    assert any(d[0] for d in decisions) and not all(d[0] for d in decisions)


def test_p_finish_equal_jax(world, p_selection):
    """enc_finish_qt_mm + deblock: levels of every size, the unit-grid
    deblock inputs and the pre-filter reconstruction."""
    sel = p_selection
    mv32 = sel["mv_u"].astype(np.int32)
    oy, ou, ov = _j(world["src"][4])
    ry, ru, rv = _j(world["dpb"][0])
    jl, jrec, jhr, jid = jax_qt.enc_finish_qt_mm(
        world["jr"], ACTIVE, jnp.asarray(sel["midx_u"]), jnp.asarray(mv32),
        [jnp.asarray(m) for m in sel["leaf"]], oy, ou, ov, ry, ru, rv, QP,
        TOP, DEPTH, 8, None, True)
    jbs = jax_qtree.qt_boundary_strengths(jnp.asarray(mv32), jhr, jid)
    jdb = jax_deblock.deblock_frame(jrec["y"], jrec["u"], jrec["v"], *jbs,
                                    TOP >> DEPTH, QP, 8)
    midx_t, mv_t, leaf_t = search_from_numpy(
        (sel["midx_u"], mv32, list(sel["leaf"])), "cpu")
    tl, trec, thr, tid = qt_codec.enc_finish_qt_mm(
        world["tr"], ACTIVE, midx_t, mv_t, leaf_t, *_t(world["src"][4]),
        *_t(world["dpb"][0]), QP, TOP, DEPTH, 8, None, True)
    _assert_tree_equal(_np(tl), _np(jl), "levels")
    _assert_tree_equal(_np(trec), _np(jrec), "reconstruction")
    np.testing.assert_array_equal(thr.numpy(), np.asarray(jhr))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    tbs = qtree.qt_boundary_strengths(mv_t, thr, tid)
    tdb = deblock.deblock_frame(trec["y"], trec["u"], trec["v"], *tbs,
                                TOP >> DEPTH, QP, 8)
    _assert_tree_equal(_np(tdb), _np(jdb), "deblocked reconstruction")
    assert any(np.any(np.asarray(l) != 0) for trio in jl for l in trio)


# ------------------------------------------------------------- B picture

@pytest.fixture(scope="module")
def jax_b(world):
    """JAX search_b_mm_merge of POC 2 from POC 0 and POC 4."""
    out = jax_fc.search_b_mm_merge(
        world["jr"], ACTIVE, _j(world["src"][2])[0], _j(world["dpb"][0])[0],
        _j(world["dpb"][4])[0], QP, TOP, 8, SR, None, None, True)
    return _np(out)


def test_b_search_grids_equal_jax(world, jax_b):
    out = frame_codec.search_b_mm_merge(
        world["tr"], ACTIVE, _t(world["src"][2])[0], _t(world["dpb"][0])[0],
        _t(world["dpb"][4])[0], QP, TOP, 8, SR, None, None, True)
    assert len(out) == 12
    _assert_tree_equal(_np(out), jax_b, "B search grids")
    assert all(t.dtype == torch.int32 for t in out)
    assert set(np.unique(jax_b[4])) == {0, 1, 2}     # list 0, list 1, bi


@pytest.fixture(scope="module")
def b_selection(jax_b):
    return jax_ic.select_merge_b_mm(*jax_b, ACTIVE, LAM ** 0.5, TOP, None,
                                    None, None, 0)


def test_b_host_selection_equal_jax(jax_b, b_selection):
    got = inter_coder.select_merge_b_mm(*jax_b, ACTIVE, LAM ** 0.5, TOP,
                                        None, None, None, 0)
    _assert_tree_equal(got, b_selection, "B merge selection")
    mflag = b_selection[5]
    assert 0 < int(mflag.sum()) < mflag.size


def test_b_finish_equal_jax(world, b_selection):
    f_m0, f_m1, f_s0, f_s1, f_d = (np.asarray(a).astype(np.int32)
                                   for a in b_selection[:5])
    jout = jax_fc.enc_finish_b_mm_fused(
        world["jr"], ACTIVE, *(jnp.asarray(a) for a in
                               (f_m0, f_m1, f_s0, f_s1, f_s0, f_s1, f_d)),
        tuple(_j(world["src"][2])), tuple(_j(world["dpb"][0])),
        tuple(_j(world["dpb"][4])), QP, TOP, 8, None, None, True, True)
    m0, m1, s0, s1, d = search_from_numpy((f_m0, f_m1, f_s0, f_s1, f_d),
                                          "cpu")
    tout = frame_codec.enc_finish_b_mm_fused(
        world["tr"], ACTIVE, m0, m1, s0, s1, s0, s1, d,
        _t(world["src"][2]), _t(world["dpb"][0]), _t(world["dpb"][4]), QP,
        TOP, 8, None, None, True, True)
    _assert_tree_equal(_np(tout), _np(jout), "B finish")
    assert np.any(np.asarray(jout[0]) != 0)


# ----------------------------------------- the >= 512-row arm (K3 / K4)

# entries of the per-model MV stack (each a non-selected model's MV) that
# differ from the JAX package's at 64x512 because a block-centre position
# does: 0 with glibc's float32 functions copied (common/libm_f32.py;
# before, with torch's CPU math, 1 in the P search)
BLOCK_ARM_STACK_MISMATCHES = {"P": 0, "B0": 0, "B1": 0}


def _selected(stack, idx):
    return np.take_along_axis(stack, idx[None, :, :, None], 0)[0]


def test_block_arm_p_and_b_search_at_512_rows():
    """One P and one B search at a height of 512 and a width of 64 (one
    SAO/ALF region wide): reproj.height >= BLOCK_EVAL_MIN_HEIGHT takes the
    block-translational arm in the diamonds, the merge-field SADs and the
    B band decision."""
    w, h = 64, 512
    assert h >= frame_codec.BLOCK_EVAL_MIN_HEIGHT == \
        jax_fc.BLOCK_EVAL_MIN_HEIGHT
    fr = realistic_sequence(w, h, 3)
    o, r0, r1 = (fr[i][0].astype(np.int32) for i in (1, 0, 2))
    jr = JaxReproj(JaxERP(w, h), w, h, 1)
    tr = MVReprojection(ERP(w, h), w, h, 1, device="cpu")
    jp = _np(jax_fc.search_p_mm_merge(jr, ACTIVE, jnp.asarray(o),
                                      jnp.asarray(r0), QP, TOP, 8, SR, None,
                                      True))
    tp = _np(frame_codec.search_p_mm_merge(
        tr, ACTIVE, torch.from_numpy(o), torch.from_numpy(r0), QP, TOP, 8,
        SR, None, True))
    for i in (0, 2, 3, 4, 5):       # idx, sad_sel, candidates and their SADs
        np.testing.assert_array_equal(tp[i], jp[i], err_msg=f"P output {i}")
    np.testing.assert_array_equal(_selected(tp[1], tp[0]),
                                  _selected(jp[1], jp[0]))
    assert int((tp[1] != jp[1]).sum()) <= BLOCK_ARM_STACK_MISMATCHES["P"]
    assert len(np.unique(jp[0])) > 1
    jb = _np(jax_fc.search_b_mm_merge(
        jr, ACTIVE, jnp.asarray(o), jnp.asarray(r0), jnp.asarray(r1), QP,
        TOP, 8, SR, None, None, True))
    tb = _np(frame_codec.search_b_mm_merge(
        tr, ACTIVE, torch.from_numpy(o), torch.from_numpy(r0),
        torch.from_numpy(r1), QP, TOP, 8, SR, None, None, True))
    for i in (0, 1, 4, 5, 6, 7, 8, 9, 10, 11):
        np.testing.assert_array_equal(tb[i], jb[i], err_msg=f"B output {i}")
    for lst, (si, ii) in (("B0", (2, 0)), ("B1", (3, 1))):
        np.testing.assert_array_equal(_selected(tb[si], tb[ii]),
                                      _selected(jb[si], jb[ii]))
        assert int((tb[si] != jb[si]).sum()) <= \
            BLOCK_ARM_STACK_MISMATCHES[lst]
