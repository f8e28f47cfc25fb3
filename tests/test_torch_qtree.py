"""PyTorch port, the classic quadtree (common/qtree.py) and the
rectangular motion searches (encoder/me.py), against the JAX package on
the same seeded numpy inputs, tolerance 0.

  searches  integer_search_rect, hierarchical_search_rect and
            fractional_refine_rect at the MTT's rect shapes;
  frames    encode_p_frame_qt and encode_b_frame_qt (the JAX programs,
            jitted as the JAX encoder runs them) at 96x64, top 32, depth
            2: splits, per-size MVs, directions, masked levels, leaf
            masks, mv_unit, has_resid_unit, leaf_id_unit and the
            reconstruction; reconstruct_qt(_b) on the decoder's side;
  syntax    the port's writers give the JAX writers' bytes on the same
            grids (merge on and off), the port's parsers read the JAX
            writers' bytes back to the JAX parsers' grids;
  streams   the port's CPU encode of ldp96x64_qt_qp37_4f (merge off) and
            ra96x64_qt_qp37_5f (merge on) equals the JAX encoder's
            committed stream byte for byte, and the port decodes both
            with every MD5 OK (0 differing decisions: no count to pin);
  property  a 32x32 block whose quadrants move apart splits (the JAX
            test's scene, on the port alone).

Cost on one core: about 60 s, nearly all the JAX programs' compiles
(encode_b_frame_qt about 30 s, encode_p_frame_qt about 18 s)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import qtree as jq
from vvc_mm_tpu.common.inter_frame import pad_ref as jax_pad_ref
from vvc_mm_tpu.decoder import inter_parser as jax_ip
from vvc_mm_tpu.encoder import inter_coder as jax_ic
from vvc_mm_tpu.encoder import me as jax_me
from vvc_mm_tpu_torch.common import qtree as tq
from vvc_mm_tpu_torch.common.inter_frame import pad_ref
from vvc_mm_tpu_torch.decoder import inter_parser
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder import inter_coder
from vvc_mm_tpu_torch.encoder import me
from vvc_mm_tpu_torch.encoder.enclib import EncLib
from vvc_mm_tpu_torch.utils.content import realistic_sequence

from tests.make_torch_port_streams import port_cfg

torch.set_num_threads(1)

W, H, TOP, DEPTH, QP, SR, BD = 96, 64, 32, 2, 32, 24, 8
ARGS = (QP, TOP, DEPTH, BD, SR, False)
DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
STREAMS = ("ldp96x64_qt_qp37_4f", "ra96x64_qt_qp37_5f")


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    if torch.is_tensor(x):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_same(got, want, what=""):
    """Nested outputs equal leaf for leaf (dicts by key)."""
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert sorted(got, key=str) == sorted(want, key=str), what
        for k in want:
            assert_same(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=what)


def _t(planes):
    return [torch.from_numpy(np.asarray(p, np.int32)) for p in planes]


def _j(planes):
    return [jnp.asarray(np.asarray(p, np.int32)) for p in planes]


@pytest.fixture(scope="module")
def clip():
    c = realistic_sequence(W, H, 5)
    return dict(orig=c[2], ref0=c[0], ref1=c[4])


@pytest.fixture(scope="module")
def port_p(clip):
    return tq.encode_p_frame_qt(*_t(clip["orig"]), *_t(clip["ref0"]),
                                *ARGS)


@pytest.fixture(scope="module")
def port_b(clip):
    return tq.encode_b_frame_qt(*_t(clip["orig"]), tuple(_t(clip["ref0"])),
                                tuple(_t(clip["ref1"])), *ARGS)


@pytest.mark.parametrize("sy,sx", [(16, 32), (32, 8), (8, 16)])
def test_rect_searches_equal_jax(clip, sy, sx):
    orig = np.asarray(clip["orig"][0], np.int32)
    lam16 = 137
    refp = pad_ref(torch.from_numpy(np.asarray(clip["ref0"][0], np.int32)),
                   80)
    jrefp = jax_pad_ref(jnp.asarray(np.asarray(clip["ref0"][0], np.int32)),
                        80)
    o, jo = torch.from_numpy(orig), jnp.asarray(orig)
    got = me.integer_search_rect(o, refp, sy, sx, 3, 80, lam16)
    want = jax_me.integer_search_rect(jo, jrefp, sy, sx, 3, 80, lam16)
    assert_same(got, want, "integer_search_rect")
    mv_i, _ = me.hierarchical_search_rect(o, refp, sy, sx, SR, 80, lam16)
    jmv_i, _ = jax_me.hierarchical_search_rect(jo, jrefp, sy, sx, SR, 80,
                                               lam16)
    assert_same(mv_i, jmv_i, "hierarchical_search_rect")
    got = me.fractional_refine_rect(o, refp, mv_i, sy, sx, 80, BD)
    want = jax_me.fractional_refine_rect(jo, jrefp, jmv_i, sy, sx, 80, BD)
    assert_same(got, want, "fractional_refine_rect")


def test_encode_p_frame_qt_equals_jax(clip, port_p):
    want = jq.encode_p_frame_qt(*_j(clip["orig"]), *_j(clip["ref0"]),
                                *ARGS)
    assert_same(port_p, want, "encode_p_frame_qt")
    rec = tq.reconstruct_qt(port_p["mv_unit"], port_p["levels"],
                            *_t(clip["ref0"]), QP, TOP, DEPTH, BD, False)
    assert_same(rec, want["recon"], "reconstruct_qt")


def test_encode_b_frame_qt_equals_jax(clip, port_b):
    want = jq.encode_b_frame_qt(*_j(clip["orig"]), tuple(_j(clip["ref0"])),
                                tuple(_j(clip["ref1"])), *ARGS)
    assert_same(port_b, want, "encode_b_frame_qt")
    assert {int(d) for g in _np(port_b["dirs"]) for d in g.ravel()} \
        == {0, 1, 2}


def _grids(out, keys):
    return [_np(out[k]) for k in keys]


@pytest.mark.parametrize("merge", [False, True])
def test_p_writer_and_parser_equal_jax(port_p, merge):
    splits, mvs, levels = _grids(port_p, ("splits", "mvs", "levels"))
    mvs = [m.astype(np.int64) for m in mvs]
    got = inter_coder.encode_p_slice_qt(splits, mvs, levels, TOP, DEPTH,
                                        use_merge=merge)
    want = jax_ic.encode_p_slice_qt(splits, mvs, levels, TOP, DEPTH,
                                    use_merge=merge)
    assert got == want
    assert_same(inter_parser.decode_p_slice_qt(want, H, W, TOP, DEPTH,
                                               use_merge=merge),
                jax_ip.decode_p_slice_qt(want, H, W, TOP, DEPTH,
                                         use_merge=merge))
    mv_u, lev, hr, lid = inter_parser.decode_p_slice_qt(
        want, H, W, TOP, DEPTH, use_merge=merge)
    assert_same((hr, lid, lev), _grids(port_p, ("has_resid_unit",
                                                "leaf_id_unit", "levels")))
    if not merge:
        assert_same(mv_u, port_p["mv_unit"])


@pytest.mark.parametrize("merge", [False, True])
def test_b_writer_and_parser_equal_jax(port_b, merge):
    splits, mv0, mv1, dirs, levels = _grids(
        port_b, ("splits", "mv0", "mv1", "dirs", "levels"))
    mv0 = [m.astype(np.int64) for m in mv0]
    mv1 = [m.astype(np.int64) for m in mv1]
    args = (splits, mv0, mv1, dirs, levels, TOP, DEPTH)
    got = inter_coder.encode_b_slice_qt(*args, use_merge=merge)
    want = jax_ic.encode_b_slice_qt(*args, use_merge=merge)
    assert got == want
    assert_same(inter_parser.decode_b_slice_qt(want, H, W, TOP, DEPTH,
                                               use_merge=merge),
                jax_ip.decode_b_slice_qt(want, H, W, TOP, DEPTH,
                                         use_merge=merge))


def test_splits_on_divergent_motion():
    """A 32x32 block whose quadrants move apart splits; the static
    background does not (tests/test_qtree.py's scene)."""
    rng = np.random.default_rng(0)
    h = w = 64
    base = rng.integers(0, 256, size=(h * 2, w * 2)).astype(np.int32)
    ref_y = base[:h, :w].copy()
    cur_y = ref_y.copy()
    cur_y[0:16, 0:16] = base[4:20, 2:18]
    cur_y[0:16, 16:32] = base[2:18, 20:36]
    cur_y[16:32, 0:16] = base[18:34, 4:20]
    u = np.full((h // 2, w // 2), 128, np.int32)
    out = tq.encode_p_frame_qt(*_t((cur_y, u, u)), *_t((ref_y, u, u)),
                               qp=30, top=32, depth=2, search_range=12)
    sp = _np(out["splits"][0])
    assert sp[0, 0] and not sp.all()
    assert np.mean((_np(out["recon"]["y"]) - cur_y) ** 2.0) < 60.0


@pytest.mark.parametrize("name", STREAMS)
def test_cpu_encode_equals_committed_stream(name):
    sd = json.load(open(os.path.join(DATA, name + ".json")))
    data = open(os.path.join(DATA, name + ".bin"), "rb").read()
    enc = EncLib(port_cfg(name), device="cpu")
    got = enc.encode_sequence(realistic_sequence(sd["width"], sd["height"],
                                                 sd["frames"]))
    assert got == data
    md5 = {p["poc"]: p["md5"] for p in sd["pocs"]}
    for r in enc.results:
        assert _md5(r.recon) == md5[r.poc]


@pytest.mark.parametrize("name", STREAMS)
def test_port_decodes_committed_stream(name):
    sd = json.load(open(os.path.join(DATA, name + ".json")))
    dec = DecLib(device="cpu")
    frames = dec.decode_bytes(open(os.path.join(DATA, name + ".bin"),
                                   "rb").read())
    assert dec.hash_status == {p["poc"]: "OK" for p in sd["pocs"]}
    assert [f.md5() for f in frames] == [p["md5"] for p in sd["pocs"]]


def _md5(planes):
    import hashlib
    m = hashlib.md5()
    for p in planes:
        m.update(np.asarray(p).astype(np.uint8).tobytes())
    return m.hexdigest()
