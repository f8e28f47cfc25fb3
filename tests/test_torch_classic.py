"""PyTorch port, the classic (single-model) inter path, function by function
against the JAX package on the same numpy inputs (tolerance 0: every path
here is integer).

128x64 pictures of `utils.content.realistic_sequence` (a pan, a zoom, a
moving disc): the picture of POC 2 is coded from POC 0 (list 0, the past)
and POC 4 (list 1, the future), so the searched MVs are negative and
positive and mostly fractional; the interpolation tests add random MVs of
both signs, out-of-picture ones among them.  Each stage of the port is fed
the JAX package's previous stage, so a mismatch names its stage:

  interp       finalize_bi, mc_luma, mc_chroma;
  P            mc_predict, _shift_mv_field, _field_sad, search_p_frame ->
               select_merge_p -> finish_p_frame / reconstruct_p_frame ->
               encode_p_slice -> decode_p_slice; encode_p_frame (merge
               off);
  P, two refs  search_p_frame_2ref -> select_merge_p_2ref ->
               _mc_predict_2ref, finish_p_frame_2ref /
               reconstruct_p_frame_2ref -> encode_p_slice_2ref ->
               decode_p_slice_2ref;
  B            _mc_planes_internal, _combine_bi, _pred_planes_ext,
               _shift_i_field, _b_field_sad, search_b_frame(_merge) ->
               select_merge_b -> bpred_and_residual / reconstruct_b_frame
               -> encode_b_slice -> decode_b_slice (merge on and off);
  host         mvp_median and the three merge candidate lists on random
               grids, every block.

The JAX programs are compiled once per module (module-scoped fixtures),
the helpers under jax.jit (one program each, not one per operation).  Two
references are read off the JAX programs that contain them, to compile
each motion search once: search_b_frame's outputs are the first four of
search_b_frame_merge (which returns them as search_b_frame gives them),
and encode_p_frame's are search_p_frame's MVs with finish_p_frame's
levels and reconstruction (the same ME, mc_predict and residual pass);
the committed merge-off stream holds the port to the JAX encode_p_frame
itself (tests/test_torch_sequence.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import inter_frame as jif
from vvc_mm_tpu.common import interp as jinterp
from vvc_mm_tpu.common import quant as jax_quant
from vvc_mm_tpu.decoder import inter_parser as jax_ip
from vvc_mm_tpu.encoder import inter_coder as jax_ic
from vvc_mm_tpu_torch.common import inter_frame as tif
from vvc_mm_tpu_torch.common import interp as tinterp
from vvc_mm_tpu_torch.decoder import inter_parser
from vvc_mm_tpu_torch.encoder import inter_coder
from vvc_mm_tpu_torch.utils.content import realistic_sequence

torch.set_num_threads(1)

W, H, S, QP, SR, BD = 128, 64, 16, 38, 24, 8
NBY, NBX = H // S, W // S
LAM_SQRT = jax_quant.lambda_from_qp(QP, intra=False) ** 0.5
MER = 0                      # log2_parallel_merge_level 2 at 16x16 blocks


def _np(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.cpu().numpy()
    return np.asarray(tree)


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
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=what)


@pytest.fixture(scope="module")
def pics():
    clip = realistic_sequence(W, H, 5)
    return dict(orig=[p.astype(np.int32) for p in clip[2]],
                ref0=[p.astype(np.int32) for p in clip[0]],
                ref1=[p.astype(np.int32) for p in clip[4]])


def _j(planes):
    return [jnp.asarray(p) for p in planes]


def _tt(planes):
    return [_t(p) for p in planes]


def _jit(fn, *static):
    """A JAX helper as one compiled program (static_argnums `static`)."""
    return jax.jit(fn, static_argnums=static)


# ------------------------------------------------------------------ interp

def _random_mvs(rng, n):
    """MVs of both signs, fractional, some far outside the picture (the
    patch origin clamp), and the small negative values where an
    arithmetic shift and a mask differ from division."""
    mv = rng.integers(-1600, 1600, size=(n, 2), dtype=np.int32)
    mv[:8] = [[-1, -1], [-17, 15], [-33, -31], [-16, 16], [31, -32],
              [-4000, 4000], [4000, -4000], [0, 0]]
    return mv


@pytest.mark.parametrize("bd", [8, 10])
def test_mc_luma_chroma_and_finalize_bi_equal_jax(bd):
    rng = np.random.default_rng(5)
    m = tif.MC_MARGIN
    ref = rng.integers(0, 1 << bd, size=(H + 2 * m, W + 2 * m),
                       dtype=np.int32)
    refc = rng.integers(0, 1 << bd, size=(H // 2 + m, W // 2 + m),
                        dtype=np.int32)
    n = NBY * NBX
    mv = _random_mvs(rng, n)
    yb = (np.arange(n, dtype=np.int32) // NBX) * S
    xb = (np.arange(n, dtype=np.int32) % NBX) * S
    luma = _jit(jinterp.mc_luma, 4, 5, 6, 7)
    chroma = _jit(jinterp.mc_chroma, 4, 5, 6, 7)
    got_l = tinterp.mc_luma(_t(ref), _t(mv), _t(yb), _t(xb), S, S, m, bd)
    want_l = luma(jnp.asarray(ref), jnp.asarray(mv), jnp.asarray(yb),
                  jnp.asarray(xb), S, S, m, bd)
    _eq(got_l, want_l, "mc_luma")
    sc = S // 2
    got_c = tinterp.mc_chroma(_t(refc), _t(mv), _t(yb // 2), _t(xb // 2),
                              sc, sc, m // 2, bd)
    want_c = chroma(jnp.asarray(refc), jnp.asarray(mv),
                    jnp.asarray(yb // 2), jnp.asarray(xb // 2), sc, sc,
                    m // 2, bd)
    _eq(got_c, want_c, "mc_chroma")
    # the second prediction: the same blocks at the negated MVs
    got_l2 = tinterp.mc_luma(_t(ref), _t(-mv), _t(yb), _t(xb), S, S, m, bd)
    want_l2 = luma(jnp.asarray(ref), jnp.asarray(-mv), jnp.asarray(yb),
                   jnp.asarray(xb), S, S, m, bd)
    _eq(tinterp.finalize_bi(got_l, got_l2, bd),
        _jit(jinterp.finalize_bi, 2)(want_l, want_l2, bd), "finalize_bi")


def test_negative_mv_shift_and_mask_equal_jnp():
    v = np.arange(-80, 80, dtype=np.int32)
    tv = torch.from_numpy(v)
    for k, mask in ((4, 15), (5, 31)):
        np.testing.assert_array_equal((tv >> k).numpy(),
                                      np.asarray(jnp.asarray(v) >> k))
        np.testing.assert_array_equal((tv & mask).numpy(),
                                      np.asarray(jnp.asarray(v) & mask))


# ------------------------------------------------------- P, one reference

@pytest.fixture(scope="module")
def p_jax(pics):
    o, r0 = _j(pics["orig"]), _j(pics["ref0"])
    col = jnp.zeros((NBY, NBX, 2), jnp.int32)
    search = _np(jif.search_p_frame(o[0], r0[0], col, QP, S, BD, SR, False))
    mvs, _, sad, cmv, csad = search
    final, mflag, midx = jax_ic.select_merge_p(mvs, sad, cmv, csad, None,
                                               LAM_SQRT, False, MER)
    fin = _np(jif.finish_p_frame(*o, *r0, jnp.asarray(final.astype(
        np.int32)), QP, S, BD, False))
    rec = _np(jif.reconstruct_p_frame(
        jnp.asarray(final.astype(np.int32)), *[jnp.asarray(x)
                                               for x in fin[:3]],
        *r0, QP, S, BD, False))
    # encode_p_frame = the search's ME + finish_p_frame (see the docstring)
    one_shot = (search[0],) + _np(jif.finish_p_frame(
        *o, *r0, jnp.asarray(search[0]), QP, S, BD, False))
    return dict(search=search, final=final, mflag=mflag, midx=midx,
                finish=fin, recon=rec, one_shot=one_shot)


def test_mc_predict_shift_and_field_sad_equal_jax(pics, p_jax):
    mvs = p_jax["final"].astype(np.int32)
    _eq(tif.mc_predict(*_tt(pics["ref0"]), _t(mvs), S, BD),
        _jit(jif.mc_predict, 4, 5)(*_j(pics["ref0"]), jnp.asarray(mvs), S,
                                   BD), "mc_predict")
    shift = _jit(jif._shift_mv_field, 1, 2)
    for dy, dx in ((0, -1), (-1, 0), (-1, 1), (1, 1), (0, 0)):
        _eq(tif._shift_mv_field(_t(mvs), dy, dx),
            shift(jnp.asarray(mvs), dy, dx), (dy, dx))
    rp = _jit(jif.pad_ref)(jnp.asarray(pics["ref0"][0]))
    _eq(tif._field_sad(_t(pics["orig"][0]), _t(np.asarray(rp)), _t(mvs), S,
                       BD),
        _jit(jif._field_sad, 3, 4)(jnp.asarray(pics["orig"][0]), rp,
                                   jnp.asarray(mvs), S, BD), "_field_sad")


def test_search_p_frame_equals_jax(pics, p_jax):
    col = torch.zeros((NBY, NBX, 2), dtype=torch.int32)
    got = tif.search_p_frame(_t(pics["orig"][0]), _t(pics["ref0"][0]), col,
                             QP, S, BD, SR, False)
    _eq(got, p_jax["search"], "search_p_frame")
    mvs = p_jax["search"][0]
    assert (mvs < 0).any() and (mvs % 16 != 0).any()


def test_select_merge_p_equals_jax(p_jax):
    mvs, _, sad, cmv, csad = p_jax["search"]
    got = inter_coder.select_merge_p(mvs, sad, cmv, csad, None, LAM_SQRT,
                                     False, MER)
    _eq(got, (p_jax["final"], p_jax["mflag"], p_jax["midx"]))
    assert p_jax["mflag"].any() and not p_jax["mflag"].all()


def test_finish_and_reconstruct_p_frame_equal_jax(pics, p_jax):
    final = _t(p_jax["final"])
    fin = tif.finish_p_frame(*_tt(pics["orig"]), *_tt(pics["ref0"]), final,
                             QP, S, BD, False)
    _eq(fin, p_jax["finish"], "finish_p_frame")
    rec = tif.reconstruct_p_frame(final, *_tt(p_jax["finish"][:3]),
                                  *_tt(pics["ref0"]), QP, S, BD, False)
    _eq(rec, p_jax["recon"], "reconstruct_p_frame")
    _eq(rec, p_jax["finish"][3], "decoder recon == encoder recon")


def test_encode_p_frame_equals_jax(pics, p_jax):
    got = tif.encode_p_frame(*_tt(pics["orig"]), *_tt(pics["ref0"]), QP, S,
                             BD, SR, False)
    _eq(got, p_jax["one_shot"], "encode_p_frame")


@pytest.mark.parametrize("merge", [True, False])
def test_p_slice_writer_and_parser_equal_jax(p_jax, merge):
    if merge:
        mvs, levels = p_jax["final"], p_jax["finish"][:3]
        kw = dict(merge_flag=p_jax["mflag"], merge_idx=p_jax["midx"])
    else:
        mvs, levels = p_jax["one_shot"][0], p_jax["one_shot"][1:4]
        kw = {}
    got = inter_coder.encode_p_slice(mvs, *levels, **kw)
    want = jax_ic.encode_p_slice(mvs, *levels, **kw)
    assert got == want
    dec = inter_parser.decode_p_slice(got, NBY, NBX, S, use_merge=merge,
                                      mer_blocks_log2=MER)
    _eq(dec, jax_ip.decode_p_slice(want, NBY, NBX, S, use_merge=merge,
                                   mer_blocks_log2=MER))
    _eq(dec, (mvs,) + tuple(levels))


# ------------------------------------------------------ P, two references

@pytest.fixture(scope="module")
def p2_jax(pics):
    o, r0, r1 = _j(pics["orig"]), _j(pics["ref0"]), _j(pics["ref1"])
    col = jnp.zeros((NBY, NBX, 2), jnp.int32)
    search = _np(jif.search_p_frame_2ref(o[0], r0[0], r1[0], col, QP, S, BD,
                                         SR, False))
    ref_idx, mvs, _, sad, cref, cmv, csad = search
    f_ref, f_mv, mflag, midx = jax_ic.select_merge_p_2ref(
        ref_idx, mvs, sad, cref, cmv, csad, None, LAM_SQRT, False, MER)
    fr, fm = jnp.asarray(f_ref), jnp.asarray(f_mv.astype(np.int32))
    fin = _np(jif.finish_p_frame_2ref(*o, tuple(r0), tuple(r1), fr, fm, QP,
                                      S, BD, False))
    rec = _np(jif.reconstruct_p_frame_2ref(
        fr, fm, *[jnp.asarray(x) for x in fin[:3]], tuple(r0), tuple(r1),
        QP, S, BD, False))
    return dict(search=search, f_ref=f_ref, f_mv=f_mv, mflag=mflag,
                midx=midx, finish=fin, recon=rec)


def test_search_p_frame_2ref_equals_jax(pics, p2_jax):
    col = torch.zeros((NBY, NBX, 2), dtype=torch.int32)
    got = tif.search_p_frame_2ref(_t(pics["orig"][0]), _t(pics["ref0"][0]),
                                  _t(pics["ref1"][0]), col, QP, S, BD, SR,
                                  False)
    _eq(got, p2_jax["search"], "search_p_frame_2ref")
    ref_idx = p2_jax["search"][0]
    assert ref_idx.any() and not ref_idx.all()      # both references used


def test_select_merge_p_2ref_equals_jax(p2_jax):
    ref_idx, mvs, _, sad, cref, cmv, csad = p2_jax["search"]
    got = inter_coder.select_merge_p_2ref(ref_idx, mvs, sad, cref, cmv,
                                          csad, None, LAM_SQRT, False, MER)
    _eq(got, (p2_jax["f_ref"], p2_jax["f_mv"], p2_jax["mflag"],
              p2_jax["midx"]))


def test_finish_and_reconstruct_p_frame_2ref_equal_jax(pics, p2_jax):
    fr, fm = _t(p2_jax["f_ref"]), _t(p2_jax["f_mv"])
    r0, r1 = tuple(_tt(pics["ref0"])), tuple(_tt(pics["ref1"]))
    _eq(tif._mc_predict_2ref(r0, r1, fr, fm, S, BD, False),
        _jit(jif._mc_predict_2ref, 4, 5, 6)(
            tuple(_j(pics["ref0"])), tuple(_j(pics["ref1"])),
            jnp.asarray(p2_jax["f_ref"]),
            jnp.asarray(p2_jax["f_mv"].astype(np.int32)), S, BD, False),
        "_mc_predict_2ref")
    fin = tif.finish_p_frame_2ref(*_tt(pics["orig"]), r0, r1, fr, fm, QP, S,
                                  BD, False)
    _eq(fin, p2_jax["finish"], "finish_p_frame_2ref")
    rec = tif.reconstruct_p_frame_2ref(fr, fm, *_tt(p2_jax["finish"][:3]),
                                       r0, r1, QP, S, BD, False)
    _eq(rec, p2_jax["recon"], "reconstruct_p_frame_2ref")


def test_p_slice_2ref_writer_and_parser_equal_jax(p2_jax):
    args = (p2_jax["f_ref"], p2_jax["f_mv"]) + tuple(p2_jax["finish"][:3])
    kw = dict(merge_flag=p2_jax["mflag"], merge_idx=p2_jax["midx"])
    got = inter_coder.encode_p_slice_2ref(*args, **kw)
    want = jax_ic.encode_p_slice_2ref(*args, **kw)
    assert got == want
    dec = inter_parser.decode_p_slice_2ref(got, NBY, NBX, S,
                                           mer_blocks_log2=MER)
    _eq(dec, jax_ip.decode_p_slice_2ref(want, NBY, NBX, S,
                                        mer_blocks_log2=MER))
    _eq(dec, args)


# ------------------------------------------------------------------------ B

@pytest.fixture(scope="module")
def b_jax(pics):
    o, r0, r1 = _j(pics["orig"]), _j(pics["ref0"]), _j(pics["ref1"])
    search = _np(jif.search_b_frame_merge(o[0], r0[0], r1[0], QP, S, BD, SR,
                                          False))
    plain = search[:4]          # search_b_frame's outputs (see above)
    mv0, mv1, dirs, _, sad, c0, c1, cd, cs = search
    sel = jax_ic.select_merge_b(mv0, mv1, dirs, sad, c0, c1, cd, cs,
                                LAM_SQRT, MER)
    out = {}
    for merge, (m0, m1, d) in ((True, sel[:3]), (False, plain[:3])):
        j0, j1, jd = (jnp.asarray(a.astype(np.int32)) for a in (m0, m1, d))
        lev = _np(jif.bpred_and_residual(*o, tuple(r0), tuple(r1), j0, j1,
                                         jd, QP, S, BD, False))
        rec = _np(jif.reconstruct_b_frame(
            j0, j1, jd, *[jnp.asarray(x) for x in lev[:3]], tuple(r0),
            tuple(r1), QP, S, BD, False))
        out[merge] = dict(grids=(m0, m1, d), bpred=lev, recon=rec)
    return dict(search=search, plain=plain, sel=sel, out=out)


def test_b_helpers_equal_jax(pics, b_jax):
    mv0, mv1, dirs = (a.astype(np.int32) for a in b_jax["plain"][:3])
    r0, r1 = pics["ref0"], pics["ref1"]
    i0 = tif._mc_planes_internal(*_tt(r0), _t(mv0), S, BD, False)
    i1 = tif._mc_planes_internal(*_tt(r1), _t(mv1), S, BD, False)
    planes = _jit(jif._mc_planes_internal, 4, 5, 6)
    j0 = planes(*_j(r0), jnp.asarray(mv0), S, BD, False)
    j1 = planes(*_j(r1), jnp.asarray(mv1), S, BD, False)
    _eq(i0, j0, "_mc_planes_internal")
    _eq(tif._combine_bi(i0[1], i1[1], _t(dirs), NBY, NBX, BD),
        _jit(jif._combine_bi, 3, 4, 5)(j0[1], j1[1], jnp.asarray(dirs), NBY,
                                       NBX, BD), "_combine_bi")
    zeros = np.zeros((NBY, NBX), np.int32)
    _eq(tif._pred_planes_ext(i0, i1, _t(dirs), _t(zeros), NBY, NBX, BD,
                             False, False, False),
        _jit(jif._pred_planes_ext, 4, 5, 6, 7, 8, 9)(
            j0, j1, jnp.asarray(dirs), jnp.asarray(zeros), NBY, NBX, BD,
            False, False, False), "_pred_planes_ext")
    shift = _jit(jif._shift_i_field, 1, 2)
    for dy, dx in ((0, -1), (-1, 0), (-1, 1), (1, -1)):
        _eq(tif._shift_i_field(_t(dirs), dy, dx),
            shift(jnp.asarray(dirs), dy, dx), (dy, dx))
    pad = _jit(jif.pad_ref)
    rp0, rp1 = pad(jnp.asarray(r0[0])), pad(jnp.asarray(r1[0]))
    _eq(tif._b_field_sad(_t(pics["orig"][0]), _t(np.asarray(rp0)),
                         _t(np.asarray(rp1)), _t(mv0), _t(mv1), _t(dirs), S,
                         BD),
        _jit(jif._b_field_sad, 6, 7)(
            jnp.asarray(pics["orig"][0]), rp0, rp1, jnp.asarray(mv0),
            jnp.asarray(mv1), jnp.asarray(dirs), S, BD), "_b_field_sad")


def test_search_b_frame_equals_jax(pics, b_jax):
    args = (_t(pics["orig"][0]), _t(pics["ref0"][0]), _t(pics["ref1"][0]),
            QP, S, BD, SR, False)
    _eq(tif.search_b_frame(*args), b_jax["plain"], "search_b_frame")
    _eq(tif.search_b_frame_merge(*args), b_jax["search"],
        "search_b_frame_merge")
    dirs = b_jax["plain"][2]
    assert len(np.unique(dirs)) == 3             # L0, L1 and bi blocks
    assert (b_jax["plain"][1] < 0).any()


def test_b_direction_tie_takes_the_first():
    """A tie between the direction costs keeps L0 before L1 before bi, as
    jnp.argmin does: equal references make L0 and L1 tie everywhere."""
    clip = realistic_sequence(64, 32, 3)
    o, r = clip[1][0].astype(np.int32), clip[0][0].astype(np.int32)
    got = tif.search_b_frame(_t(o), _t(r), _t(r), QP, S, BD, 8, False)
    np.testing.assert_array_equal(got[0].numpy(), got[1].numpy())
    assert (got[2] == 0).all()


def test_select_merge_b_equals_jax(b_jax):
    got = inter_coder.select_merge_b(*b_jax["search"][:3],
                                     *b_jax["search"][4:], LAM_SQRT, MER)
    _eq(got, b_jax["sel"])
    assert b_jax["sel"][3].any() and not b_jax["sel"][3].all()


@pytest.mark.parametrize("merge", [True, False])
def test_bpred_and_reconstruct_b_frame_equal_jax(pics, b_jax, merge):
    want = b_jax["out"][merge]
    m0, m1, d = (_t(a) for a in want["grids"])
    r0, r1 = tuple(_tt(pics["ref0"])), tuple(_tt(pics["ref1"]))
    lev = tif.bpred_and_residual(*_tt(pics["orig"]), r0, r1, m0, m1, d, QP,
                                 S, BD, False)
    _eq(lev, want["bpred"], "bpred_and_residual")
    rec = tif.reconstruct_b_frame(m0, m1, d, *_tt(want["bpred"][:3]), r0,
                                  r1, QP, S, BD, False)
    _eq(rec, want["recon"], "reconstruct_b_frame")
    _eq(rec, want["bpred"][3], "decoder recon == encoder recon")


@pytest.mark.parametrize("merge", [True, False])
def test_b_slice_writer_and_parser_equal_jax(b_jax, merge):
    want = b_jax["out"][merge]
    kw = (dict(merge_flag=b_jax["sel"][3], merge_idx=b_jax["sel"][4])
          if merge else {})
    args = tuple(want["grids"]) + tuple(want["bpred"][:3])
    got = inter_coder.encode_b_slice(*args, **kw)
    ref = jax_ic.encode_b_slice(*args, **kw)
    assert got[0] == ref[0]
    _eq(got[1:], ref[1:], "coded grids")
    dec = inter_parser.decode_b_slice(got[0], NBY, NBX, S, use_merge=merge,
                                      mer_blocks_log2=MER)
    _eq(dec, jax_ip.decode_b_slice(ref[0], NBY, NBX, S, use_merge=merge,
                                   mer_blocks_log2=MER))
    # the decoder's grids are the coded ones (unused lists at their MVP)
    _eq(dec[:2], got[1:])


# --------------------------------------------------------------------- host

@pytest.fixture(scope="module")
def grids():
    rng = np.random.default_rng(9)
    nby, nbx = 6, 7
    # few distinct values, so that candidates repeat and dedup matters
    mvs = rng.integers(-3, 3, size=(nby, nbx, 2)).astype(np.int64) * 12
    return dict(mvs=mvs, refs=rng.integers(0, 2, size=(nby, nbx)),
                dirs=rng.integers(0, 3, size=(nby, nbx)).astype(np.int32),
                mv1=rng.integers(-3, 3, size=(nby, nbx, 2)).astype(
                    np.int64) * 8)


@pytest.mark.parametrize("mer", [0, 1, 2])
def test_candidate_lists_equal_jax(grids, mer):
    g = grids
    nby, nbx = g["dirs"].shape
    for by in range(nby):
        for bx in range(nbx):
            np.testing.assert_array_equal(
                inter_coder.mvp_median(g["mvs"], by, bx),
                jax_ic.mvp_median(g["mvs"], by, bx))
            assert inter_coder.merge_candidates(
                g["mvs"], by, bx, mer_blocks_log2=mer) == \
                jax_ic.merge_candidates(g["mvs"], by, bx,
                                        mer_blocks_log2=mer)
            assert inter_coder.merge_candidates_ref(
                g["refs"], g["mvs"], by, bx, mer_blocks_log2=mer) == \
                jax_ic.merge_candidates_ref(g["refs"], g["mvs"], by, bx,
                                            mer_blocks_log2=mer)
            assert inter_coder.merge_candidates_b(
                g["dirs"], g["mvs"], g["mv1"], by, bx,
                mer_blocks_log2=mer) == \
                jax_ic.merge_candidates_b(g["dirs"], g["mvs"], g["mv1"], by,
                                          bx, mer_blocks_log2=mer)


def test_unported_inter_tools_raise(pics):
    """Every inter tool is carried now.  MCTS (item 11b): the P searches
    and the merge-off program clamp their MVs with the JAX package's
    mcts_clamp_mvs, after the same search (sad_me stays the unclamped
    MV's, as in JAX), and the candidate fields follow the clamped field
    (tests/test_torch_mcts.py holds the clamp and a stream to JAX).
    Scaling lists (item 9) and the tools of item 8 (TMVP/HMVP, AMVR,
    GPM/CIIP, weighted prediction, BDOF, DMVR) are accepted by the
    writers, the parsers and the frame functions
    (tests/test_torch_tmvp_amvr.py, test_torch_gpm_wp.py and
    test_torch_intra_streams.py hold them to JAX)."""
    lev = np.zeros((NBY, NBX, S, S), np.int32)
    levc = np.zeros((NBY, NBX, S // 2, S // 2), np.int32)
    mvs = np.zeros((NBY, NBX, 2), np.int64)
    z = np.zeros((NBY, NBX), np.int32)
    o, r0, r1 = _tt(pics["orig"]), tuple(_tt(pics["ref0"])), \
        tuple(_tt(pics["ref1"]))
    m, d = _t(mvs), _t(z)
    tiles = (2, 1)

    def clamp(f):
        return np.asarray(jif.mcts_clamp_mvs(jnp.asarray(_np(f)), S, W, H,
                                             *tiles))

    plain = tif.search_p_frame(o[0], r0[0], m, QP, S, BD, SR, False)
    mcts = tif.search_p_frame(o[0], r0[0], m, QP, S, BD, SR, False,
                              mcts=tiles)
    _eq(mcts[0], clamp(plain[0]), "search_p_frame mcts mvs")
    _eq(mcts[2], plain[2], "search_p_frame mcts sad_me")
    _eq(mcts[3][0], tif._shift_mv_field(mcts[0], 0, -1), "left field")
    assert not np.array_equal(_np(mcts[0]), _np(plain[0]))
    two = tif.search_p_frame_2ref(o[0], r0[0], r1[0], m, QP, S, BD, SR,
                                  False, mcts=tiles)
    assert (np.abs(_np(two[1]) - clamp(two[1])) == 0).all()
    out = tif.encode_p_frame(*o, *r0, QP, S, BD, SR, False, mcts=tiles)
    _eq(out[0], clamp(tif.encode_p_frame(*o, *r0, QP, S, BD, SR,
                                         False)[0]), "encode_p_frame mcts")
    steep = tuple(int(16 + 2 * (x + y)) for y in range(8) for x in range(8))
    ly, lu, lv, rec = tif.finish_p_frame(*o, *r0, m, QP, S, BD, False,
                                         scaling=steep)
    back = tif.reconstruct_p_frame(m, ly, lu, lv, *r0, QP, S, BD,
                                   scaling=steep)
    for k in "yuv":
        assert torch.equal(back[k], rec[k])
    assert len(tif.reconstruct_b_frame(m, m, d, _t(lev), _t(levc),
                                       _t(levc), r0, r1, QP, S, BD,
                                       scaling=steep)) == 3
    assert isinstance(inter_coder.encode_p_slice(mvs, lev, levc, levc,
                                                 use_tmvp=True, imv=z), bytes)
    assert isinstance(inter_coder.encode_b_slice(mvs, mvs, z, lev, levc,
                                                 levc, use_gpm=True)[0],
                      bytes)
    assert len(inter_coder.select_merge_p(mvs, z, mvs[None], z[None], None,
                                          1.0, True)) == 3
    for kw in (dict(bdof=True), dict(dmvr=True), dict(gpm=True),
               dict(ciip=True), dict(wp0=torch.full((3, 2), 64),
                                     wp1=torch.full((3, 2), 64))):
        assert len(tif.bpred_and_residual(*o, r0, r1, m, m, d, QP, S, BD,
                                          False, **kw)) == 4
