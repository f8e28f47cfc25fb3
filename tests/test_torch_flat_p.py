"""PyTorch port, the flat multi-model P path and the B path without merge,
against the JAX package, stage by stage on the same inputs (tolerance 0).

The 256x128 clip under bench configuration 4's tools (MPA+GED+ROT+MMMVP,
flat grid): POC 4 (P, from POC 0) at QP 38 and POC 2 (B, from POC 0 and
4) at QP 38.  The references are the decoded pictures of the committed
`erp256x128_ra_fullmm_qp37_5f` stream (the port's DecLib checks them
against the JAX encoder's MD5s).  Stage N of the port is fed stage N-1 of
JAX, so a mismatch names its stage:

  search_p_mm / search_p_mm_merge (K5 at this size) -> select_merge_mm
  (MM-MVP through MMVPConverter) -> enc_finish_p_mm_fused (K1/K2,
  residual, deblock) -> encode_p_slice_mm -> decode_p_slice_mm;
  search_b_mm -> encode_b_slice_mm / decode_b_slice_mm without merge.

The P stages run with the off-pole epipole (0.3, -0.5, 0.8), whose GED
rotation is not the identity (the bench epipole (0, 0, 1) takes the
identity branch; tests/test_torch_sequence.py codes it end to end); the B
search takes the off-pole epipole on list 0 and the pole on list 1.  At
this size the searched positions of the two packages agree, so every grid
is equal."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import quant as jax_quant
from vvc_mm_tpu.common.mm import frame_codec as jax_fc
from vvc_mm_tpu.common.mm import mvp_convert as jax_mvp
from vvc_mm_tpu.common.mm.reprojection import MVReprojection as JaxReproj
from vvc_mm_tpu.decoder import inter_parser as jax_ip
from vvc_mm_tpu.encoder import inter_coder as jax_ic
from vvc_mm_tpu.lib360.projection import ERP as JaxERP
from vvc_mm_tpu_torch.common.mm import frame_codec, mvp_convert
from vvc_mm_tpu_torch.common.mm.reprojection import MVReprojection
from vvc_mm_tpu_torch.convert import planes_from_numpy
from vvc_mm_tpu_torch.decoder import inter_parser
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder import inter_coder
from vvc_mm_tpu_torch.lib360.projection import ERP
from vvc_mm_tpu_torch.utils.content import realistic_sequence

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
STREAM = os.path.join(DATA, "erp256x128_ra_fullmm_qp37_5f.bin")
W, H, QP, S, SR = 256, 128, 38, 16, 24
ACTIVE = [0, 1, 2, 3, 6, 7]          # CLASSIC, MPA x3, ROT, GED
GED = 7
LAM_SQRT = jax_quant.lambda_from_qp(QP, intra=False) ** 0.5
EPIPOLES = {"pole": (0.0, 0.0, 1.0), "off": (0.3, -0.5, 0.8)}


def _np(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


def _assert_equal(got, want, what=""):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{what}[{i}]")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_equal(got[k], want[k], f"{what}[{k}]")
    else:
        assert got.shape == want.shape, (what, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=what)


def _j(planes):
    return [jnp.asarray(np.asarray(p, dtype=np.int32)) for p in planes]


def _t(planes):
    return planes_from_numpy(planes, device="cpu")


@pytest.fixture(scope="module")
def world():
    dec = DecLib(device="cpu")
    frames = dec.decode_bytes(open(STREAM, "rb").read())
    assert set(dec.hash_status.values()) == {"OK"}    # == the JAX DPB
    return dict(
        src=[[p.astype(np.int32) for p in f]
             for f in realistic_sequence(W, H, 5)],
        dpb={f.poc: f.numpy() for f in frames},
        jr=JaxReproj(JaxERP(W, H), W, H, 1, 1),
        tr=MVReprojection(ERP(W, H), W, H, 1, 1, device="cpu"),
        jconv=jax_mvp.MMVPConverter(W, H, 1),
        tconv=mvp_convert.MMVPConverter(W, H, 1))


# ------------------------------------------------------------- P picture

@pytest.fixture(scope="module")
def p_case(world):
    """JAX's merge search, host selection (MM-MVP on) and finish of POC 4
    from POC 0 under the off-pole epipole."""
    ep = EPIPOLES["off"]
    eps = {GED: ep}
    oy, ou, ov = _j(world["src"][4])
    ref = _j(world["dpb"][0])
    out = _np(jax_fc.search_p_mm_merge(world["jr"], ACTIVE, oy, ref[0], QP,
                                       S, 8, SR, eps, True))
    sel = jax_ic.select_merge_mm(*out, ACTIVE, LAM_SQRT, S, world["jconv"],
                                 ep, 0)
    ly, lu, lv, rec = jax_fc.enc_finish_p_mm_fused(
        world["jr"], ACTIVE, jnp.asarray(sel[0]),
        jnp.asarray(sel[1].astype(np.int32)), (oy, ou, ov), tuple(ref), QP,
        S, 8, eps, True, True)
    return dict(ep=ep, eps=eps, search=out, sel=sel,
                finish=_np((ly, lu, lv, rec)))


def test_p_merge_search_equals_jax(world, p_case):
    got = frame_codec.search_p_mm_merge(
        world["tr"], ACTIVE, _t(world["src"][4])[0], _t(world["dpb"][0])[0],
        QP, S, 8, SR, p_case["eps"], True)
    _assert_equal(_np(got), p_case["search"], "search_p_mm_merge")
    assert all(t.dtype == torch.int32 for t in got)
    # GED is chosen somewhere, and not everywhere
    assert 0 < int((p_case["search"][0] == ACTIVE.index(GED)).sum()) \
        < p_case["search"][0].size


def test_p_merge_selection_equals_jax(world, p_case):
    """select_merge_mm on JAX's search outputs, with MM-MVP conversion
    (the port's converter) and without it."""
    ep = p_case["ep"]
    got = inter_coder.select_merge_mm(*p_case["search"], ACTIVE, LAM_SQRT,
                                      S, world["tconv"], ep, 0)
    _assert_equal(got, p_case["sel"], "select_merge_mm")
    assert 0 < int(got[2].sum()) < got[2].size        # merged and AMVP
    plain = inter_coder.select_merge_mm(*p_case["search"], ACTIVE,
                                        LAM_SQRT, S, None, None, 1)
    _assert_equal(plain, jax_ic.select_merge_mm(
        *p_case["search"], ACTIVE, LAM_SQRT, S, None, None, 1),
        "select_merge_mm without conversion, merge region 2x2")


def test_p_finish_equals_jax(world, p_case):
    """enc_finish_p_mm_fused (positions + K1/K2 + residual + deblock), and
    enc_finish_p_mm fed JAX's positions."""
    midx, stack = p_case["sel"][0], p_case["sel"][1].astype(np.int32)
    got = frame_codec.enc_finish_p_mm_fused(
        world["tr"], ACTIVE, torch.from_numpy(midx),
        torch.from_numpy(stack), _t(world["src"][4]),
        _t(world["dpb"][0]), QP, S, 8, p_case["eps"], True, True)
    _assert_equal(_np(got), p_case["finish"], "enc_finish_p_mm_fused")
    pos = np.array(jax_fc.merged_positions(
        world["jr"], ACTIVE, jnp.asarray(midx), jnp.asarray(stack), S,
        p_case["eps"]))
    again = frame_codec.enc_finish_p_mm(
        torch.from_numpy(midx), torch.from_numpy(stack),
        torch.from_numpy(pos), *_t(world["src"][4]), *_t(world["dpb"][0]),
        QP, S, 8, True, True)
    _assert_equal(_np(again), p_case["finish"], "enc_finish_p_mm")
    assert any(np.any(l != 0) for l in p_case["finish"][:3])


@pytest.mark.parametrize("merge", [True, False])
def test_p_slice_writer_and_parser_equal_jax(world, p_case, merge):
    """encode_p_slice_mm gives JAX's bytes with MM-MVP on (merge arm: the
    selection's flags; AMVP arm: the search's own grids), and
    decode_p_slice_mm returns JAX's parse of them: each block's model and
    its MV in that model."""
    ep = p_case["ep"]
    ly, lu, lv = p_case["finish"][:3]
    if merge:
        midx, stack, mflag, midx_m = p_case["sel"]
        kw = dict(merge_flag=mflag, merge_idx=midx_m)
    else:
        midx, stack = p_case["search"][:2]
        kw = {}
    stack = stack.astype(np.int64)
    got = inter_coder.encode_p_slice_mm(midx, ACTIVE, stack, ly, lu, lv, S,
                                        world["tconv"], ep, **kw)
    want = jax_ic.encode_p_slice_mm(midx, ACTIVE, stack, ly, lu, lv, S,
                                    world["jconv"], ep, **kw)
    assert got == want
    parsed = inter_parser.decode_p_slice_mm(
        got, H // S, W // S, S, ACTIVE, world["tconv"], ep, use_merge=merge)
    _assert_equal(parsed, jax_ip.decode_p_slice_mm(
        got, H // S, W // S, S, ACTIVE, world["jconv"], ep, use_merge=merge),
        "decode_p_slice_mm")
    np.testing.assert_array_equal(parsed[0], midx)
    np.testing.assert_array_equal(
        parsed[1], np.take_along_axis(stack, midx[None, ..., None], 0)[0])
    for a, b in zip(parsed[2:], (ly, lu, lv)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- B picture

@pytest.fixture(scope="module")
def b_case(world):
    """JAX's search_b_mm of POC 2 from POC 0 and 4 (the off-pole epipole
    for list 0, the pole for list 1) and its finish."""
    eps0, eps1 = {GED: EPIPOLES["off"]}, {GED: EPIPOLES["pole"]}
    oy = _j(world["src"][2])
    r0, r1 = _j(world["dpb"][0]), _j(world["dpb"][4])
    out = _np(jax_fc.search_b_mm(world["jr"], ACTIVE, oy[0], r0[0], r1[0],
                                 QP, S, 8, SR, eps0, eps1, True))
    st0, st1 = (jnp.asarray(a) for a in out[2:4])
    fin = jax_fc.enc_finish_b_mm_fused(
        world["jr"], ACTIVE, jnp.asarray(out[0]), jnp.asarray(out[1]), st0,
        st1, st0, st1, jnp.asarray(out[4]), tuple(oy), tuple(r0), tuple(r1),
        QP, S, 8, eps0, eps1, True, True)
    return dict(eps0=eps0, eps1=eps1, search=out, levels=_np(fin[:3]))


def test_b_search_without_merge_equals_jax(world, b_case):
    got = frame_codec.search_b_mm(
        world["tr"], ACTIVE, _t(world["src"][2])[0], _t(world["dpb"][0])[0],
        _t(world["dpb"][4])[0], QP, S, 8, SR, b_case["eps0"],
        b_case["eps1"], True)
    _assert_equal(_np(got), b_case["search"], "search_b_mm")
    assert got[4].dtype == torch.int32
    assert len(np.unique(b_case["search"][4])) == 3   # uni-0, uni-1, bi


def test_b_slice_without_merge_equals_jax(world, b_case):
    """encode_b_slice_mm's AMVP arm (skip = the neighbour's direction and
    inherited models at their MVPs) gives JAX's bytes with MM-MVP on, and
    decode_b_slice_mm's AMVP arm returns JAX's parse."""
    m0, m1, s0, s1, dirs = b_case["search"]
    ly, lu, lv = b_case["levels"]
    ep0, ep1 = b_case["eps0"][GED], b_case["eps1"][GED]
    args = (m0, m1, ACTIVE, s0.astype(np.int64), s1.astype(np.int64), dirs,
            ly, lu, lv, S)
    got = inter_coder.encode_b_slice_mm(*args, world["tconv"], ep0, ep1)
    assert got == jax_ic.encode_b_slice_mm(*args, world["jconv"], ep0, ep1)
    parsed = inter_parser.decode_b_slice_mm(got, H // S, W // S, S, ACTIVE,
                                            world["tconv"], ep0, ep1)
    _assert_equal(parsed, jax_ip.decode_b_slice_mm(
        got, H // S, W // S, S, ACTIVE, world["jconv"], ep0, ep1),
        "decode_b_slice_mm")
    np.testing.assert_array_equal(parsed[4], dirs)
