"""PyTorch port, TMVP/HMVP and AMVR on the classic P path, function by
function against the JAX package on the same numpy inputs (tolerance 0:
every path here is integer, but for AMVR's float32 rate proxy, whose
values equal JAX's here).

  host     HmvpList (FIFO, dedup, size 5), amvp_list and the TMVP/HMVP arms
           of merge_candidates(_ref), on random grids with ties and
           duplicates, every block;
  AMVR     round_mv_amvr on numpy, torch and scalars; amvr_decide;
  P        search_p_frame with AMVR and a co-located field ->
           select_merge_p with TMVP -> finish_p_frame / reconstruct_p_frame
           with explicit weights -> encode_p_slice -> decode_p_slice, both
           ways (the port's bytes through the JAX parser, the JAX bytes
           through the port's); encode_p_frame (merge off, AMVR, weights),
           read off the JAX search + finish programs as
           tests/test_torch_classic.py does;
  2 refs   search_p_frame_2ref with AMVR -> select_merge_p_2ref with TMVP
           -> encode_p_slice_2ref / decode_p_slice_2ref, both ways.

128x64 pictures of `realistic_sequence`: POC 2 coded from POC 0 (and POC
4 as the second reference); the co-located field is a random MV field of
small values, so its candidates tie with spatial ones.  Each JAX program
is compiled once per module."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import inter_frame as jif
from vvc_mm_tpu.common import quant as jax_quant
from vvc_mm_tpu.decoder import inter_parser as jax_ip
from vvc_mm_tpu.encoder import inter_coder as jax_ic
from vvc_mm_tpu_torch.common import inter_frame as tif
from vvc_mm_tpu_torch.decoder import inter_parser
from vvc_mm_tpu_torch.encoder import inter_coder
from vvc_mm_tpu_torch.utils.content import realistic_sequence

torch.set_num_threads(1)

W, H, S, QP, SR, BD = 128, 64, 16, 38, 24, 8
NBY, NBX = H // S, W // S
LAM_SQRT = jax_quant.lambda_from_qp(QP, intra=False) ** 0.5
LAM16 = int(jax_quant.lambda_from_qp(QP, intra=False) ** 0.5 * 16)
MER = 0                      # log2_parallel_merge_level 2 at 16x16 blocks
WP = np.array([[58, 7], [66, -3], [61, 2]], np.int32)


def _np(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_np(t) for t in x)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a if a.dtype == np.bool_ else
                            a.astype(np.int32))


def _eq(got, want, what=""):
    got, want = _np(got), _np(want)
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _eq(g, w, f"{what}[{i}]")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _eq(got[k], want[k], f"{what}[{k}]")
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.fixture(scope="module")
def pics():
    clip = realistic_sequence(W, H, 5)
    rng = np.random.default_rng(8)
    return dict(orig=[p.astype(np.int32) for p in clip[2]],
                ref0=[p.astype(np.int32) for p in clip[0]],
                ref1=[p.astype(np.int32) for p in clip[4]],
                col=rng.integers(-3, 4, (NBY, NBX, 2)).astype(np.int64) * 4)


# ---------------------------------------------------------------- host

@pytest.fixture(scope="module")
def grids():
    """Small-valued random grids: spatial, co-located and history
    candidates collide often."""
    rng = np.random.default_rng(21)
    return dict(mvs=rng.integers(-2, 3, (6, 9, 2)).astype(np.int64) * 8,
                refs=rng.integers(0, 2, (6, 9)).astype(np.int32),
                col=rng.integers(-2, 3, (6, 9, 2)).astype(np.int64) * 8,
                pushes=rng.integers(-2, 3, (40, 2)).astype(np.int64) * 8)


def test_hmvp_list_equals_jax(grids):
    got, want = inter_coder.HmvpList(), jax_ic.HmvpList()
    assert inter_coder.HMVP_SIZE == jax_ic.HMVP_SIZE == 5
    for mv in grids["pushes"]:
        got.push(mv)
        want.push(mv)
        assert got.lut == want.lut
        _eq(got.cands(), want.cands())
    assert len(got.lut) == 5 and len(set(got.lut)) == 5


@pytest.mark.parametrize("mer", [0, 1])
def test_amvp_and_merge_lists_with_tmvp_equal_jax(grids, mer):
    """Every block, with and without the co-located MV and the FIFO, the
    FIFO taking each block's MV in coding order as the slice pass does."""
    g = grids
    hist_t, hist_j = inter_coder.HmvpList(), jax_ic.HmvpList()
    nby, nbx = g["refs"].shape
    for by in range(nby):
        for bx in range(nbx):
            for col in (None, g["col"][by, bx]):
                for ht, hj in ((None, None), (hist_t, hist_j)):
                    _eq(inter_coder.amvp_list(g["mvs"], by, bx, col, ht),
                        jax_ic.amvp_list(g["mvs"], by, bx, col, hj))
                    assert inter_coder.merge_candidates(
                        g["mvs"], by, bx, col, ht, mer_blocks_log2=mer) == \
                        jax_ic.merge_candidates(g["mvs"], by, bx, col, hj,
                                                mer_blocks_log2=mer)
                    assert inter_coder.merge_candidates_ref(
                        g["refs"], g["mvs"], by, bx, col, ht,
                        mer_blocks_log2=mer) == \
                        jax_ic.merge_candidates_ref(
                            g["refs"], g["mvs"], by, bx, col, hj,
                            mer_blocks_log2=mer)
            hist_t.push(g["mvs"][by, bx])
            hist_j.push(g["mvs"][by, bx])


def test_round_mv_amvr_equals_jax():
    v = np.arange(-200, 201, dtype=np.int64)
    for sh in (0, 2, 4, 6):
        want = jif.round_mv_amvr(v, sh)
        _eq(inter_coder.round_mv_amvr(v, sh), want, sh)
        _eq(tif.round_mv_amvr(torch.from_numpy(v.astype(np.int32)), sh),
            np.asarray(jif.round_mv_amvr(jnp.asarray(v.astype(np.int32)),
                                         sh)), sh)
        for x in (-33, -32, -31, -1, 0, 1, 31, 32, 33):
            assert tif.round_mv_amvr(x, sh) == jif.round_mv_amvr(x, sh)
    assert tif.AMVR_SHIFTS == jif.AMVR_SHIFTS


# ------------------------------------------------------- P, one reference

@pytest.fixture(scope="module")
def p_jax(pics):
    o = [jnp.asarray(p) for p in pics["orig"]]
    r0 = [jnp.asarray(p) for p in pics["ref0"]]
    col = jnp.asarray(pics["col"].astype(np.int32))
    search = _np(jif.search_p_frame(o[0], r0[0], col, QP, S, BD, SR, False,
                                    amvr=True))
    mvs, imv, sad, cmv, csad = search
    final, mflag, midx = jax_ic.select_merge_p(mvs, sad, cmv, csad,
                                               pics["col"], LAM_SQRT, True,
                                               MER)
    wp = jnp.asarray(WP)
    fin = _np(jif.finish_p_frame(*o, *r0, jnp.asarray(final.astype(
        np.int32)), QP, S, BD, False, wp=wp))
    rec = _np(jif.reconstruct_p_frame(
        jnp.asarray(final.astype(np.int32)),
        *[jnp.asarray(x) for x in fin[:3]], *r0, QP, S, BD, False, wp=wp))
    # encode_p_frame(amvr, wp) = the search's ME and AMVR decision +
    # finish_p_frame (the same mc_predict, weights and residual pass)
    one_shot = (mvs, imv) + _np(jif.finish_p_frame(
        *o, *r0, jnp.asarray(mvs), QP, S, BD, False, wp=wp))
    return dict(search=search, final=final, mflag=mflag, midx=midx,
                finish=fin, recon=rec, one_shot=one_shot)


def test_amvr_decide_equals_jax(pics):
    """The rounding, the SADs of the three precisions and the float32
    rate proxy (the first minimum wins), on random MVs of both signs."""
    rng = np.random.default_rng(3)
    mvs = rng.integers(-200, 200, (NBY, NBX, 2)).astype(np.int32)
    rp = np.asarray(jif.pad_ref(jnp.asarray(pics["ref0"][0])))
    want = jif.amvr_decide(jnp.asarray(pics["orig"][0]), jnp.asarray(rp),
                           jnp.asarray(mvs), S, BD, LAM16)
    got = tif.amvr_decide(_t(pics["orig"][0]), _t(rp), _t(mvs), S, BD,
                          LAM16)
    _eq(got, want)
    assert len(np.unique(np.asarray(want[0]))) > 1


def test_search_p_frame_with_amvr_and_col_equals_jax(pics, p_jax):
    got = tif.search_p_frame(_t(pics["orig"][0]), _t(pics["ref0"][0]),
                             _t(pics["col"]), QP, S, BD, SR, False,
                             amvr=True)
    _eq(got, p_jax["search"], "search_p_frame")
    imv = p_jax["search"][1]
    assert (imv > 0).any() and (imv == 0).any()


def test_select_merge_p_with_tmvp_equals_jax(pics, p_jax):
    mvs, _, sad, cmv, csad = p_jax["search"]
    got = inter_coder.select_merge_p(mvs, sad, cmv, csad, pics["col"],
                                     LAM_SQRT, True, MER)
    _eq(got, (p_jax["final"], p_jax["mflag"], p_jax["midx"]))
    assert p_jax["mflag"].any() and not p_jax["mflag"].all()


def test_finish_and_reconstruct_p_frame_with_weights_equal_jax(pics,
                                                                p_jax):
    final = _t(p_jax["final"])
    fin = tif.finish_p_frame(*map(_t, pics["orig"]), *map(_t, pics["ref0"]),
                             final, QP, S, BD, False, wp=_t(WP))
    _eq(fin, p_jax["finish"], "finish_p_frame")
    rec = tif.reconstruct_p_frame(final, *map(_t, p_jax["finish"][:3]),
                                  *map(_t, pics["ref0"]), QP, S, BD, False,
                                  wp=_t(WP))
    _eq(rec, p_jax["recon"], "reconstruct_p_frame")


def test_encode_p_frame_with_amvr_and_weights_equals_jax(pics, p_jax):
    got = tif.encode_p_frame(*map(_t, pics["orig"]), *map(_t, pics["ref0"]),
                             QP, S, BD, SR, False, wp=_t(WP), amvr=True)
    _eq(got, p_jax["one_shot"], "encode_p_frame")


@pytest.mark.parametrize("merge", [True, False])
def test_p_slice_with_tmvp_and_amvr_both_ways(pics, p_jax, merge):
    """The port's writer gives the JAX bytes; each parser reads the other
    package's bytes back to the coded grids."""
    if merge:
        mvs, levels = p_jax["final"], p_jax["finish"][:3]
        kw = dict(merge_flag=p_jax["mflag"], merge_idx=p_jax["midx"])
    else:
        mvs, levels = p_jax["one_shot"][0], p_jax["one_shot"][2:5]
        kw = {}
    kw.update(col_mvs=pics["col"], use_tmvp=True, imv=p_jax["search"][1])
    got = inter_coder.encode_p_slice(mvs, *levels, **kw)
    want = jax_ic.encode_p_slice(mvs, *levels, **kw)
    assert got == want
    pkw = dict(col_mvs=pics["col"], use_tmvp=True, use_amvr=True,
               use_merge=merge, mer_blocks_log2=MER)
    _eq(inter_parser.decode_p_slice(want, NBY, NBX, S, **pkw),
        (mvs,) + tuple(levels), "port parser, JAX bytes")
    _eq(jax_ip.decode_p_slice(got, NBY, NBX, S, **pkw),
        (mvs,) + tuple(levels), "JAX parser, port bytes")


# ------------------------------------------------------ P, two references

@pytest.fixture(scope="module")
def p2_jax(pics):
    col = jnp.asarray(pics["col"].astype(np.int32))
    search = _np(jif.search_p_frame_2ref(
        jnp.asarray(pics["orig"][0]), jnp.asarray(pics["ref0"][0]),
        jnp.asarray(pics["ref1"][0]), col, QP, S, BD, SR, False, amvr=True))
    ref_h, mvs_h, _, sad_h, cref, cmv, csad = search
    sel = jax_ic.select_merge_p_2ref(ref_h, mvs_h, sad_h, cref, cmv, csad,
                                     pics["col"], LAM_SQRT, True, MER)
    return dict(search=search, sel=sel)


def test_search_p_frame_2ref_with_amvr_equals_jax(pics, p2_jax):
    got = tif.search_p_frame_2ref(
        _t(pics["orig"][0]), _t(pics["ref0"][0]), _t(pics["ref1"][0]),
        _t(pics["col"]), QP, S, BD, SR, False, amvr=True)
    _eq(got, p2_jax["search"], "search_p_frame_2ref")
    ref_idx, imv = p2_jax["search"][0], p2_jax["search"][2]
    assert ref_idx.any() and (imv > 0).any()


def test_select_merge_p_2ref_with_tmvp_and_slice_both_ways(pics, p2_jax):
    ref_h, mvs_h, imv, sad_h, cref, cmv, csad = p2_jax["search"]
    got = inter_coder.select_merge_p_2ref(ref_h, mvs_h, sad_h, cref, cmv,
                                          csad, pics["col"], LAM_SQRT, True,
                                          MER)
    _eq(got, p2_jax["sel"], "select_merge_p_2ref")
    f_ref, f_mv, mflag, midx = p2_jax["sel"]
    rng = np.random.default_rng(5)
    levels = (rng.integers(-2, 3, (NBY, NBX, S, S)) *
              (rng.random((NBY, NBX, 1, 1)) < 0.5),
              np.zeros((NBY, NBX, S // 2, S // 2), np.int64),
              rng.integers(-1, 2, (NBY, NBX, S // 2, S // 2)) *
              (rng.random((NBY, NBX, 1, 1)) < 0.3))
    levels = tuple(lv.astype(np.int32) for lv in levels)
    kw = dict(col_mvs=pics["col"], use_tmvp=True, imv=imv,
              merge_flag=mflag, merge_idx=midx)
    got = inter_coder.encode_p_slice_2ref(f_ref, f_mv, *levels, **kw)
    want = jax_ic.encode_p_slice_2ref(f_ref, f_mv, *levels, **kw)
    assert got == want
    pkw = dict(col_mvs=pics["col"], use_tmvp=True, use_amvr=True,
               mer_blocks_log2=MER)
    _eq(inter_parser.decode_p_slice_2ref(want, NBY, NBX, S, **pkw),
        (f_ref, f_mv) + levels, "port parser, JAX bytes")
    _eq(jax_ip.decode_p_slice_2ref(got, NBY, NBX, S, **pkw),
        (f_ref, f_mv) + levels, "JAX parser, port bytes")
