"""PyTorch port, the multi-type tree (common/mtt.py: BT and TT splits on
the quadtree lattice), against the JAX package on the same seeded numpy
inputs, tolerance 0.

  geometry  rect_shapes at every (top, depth) the lattice offers, and
            _crop's offsets with the chroma division at every shape of
            the 832x480 lattice (bench configuration 2's size);
  resolve   resolve_mtt's six-way argmin on float32 costs with ties;
  frames    encode_p_frame_mtt and encode_b_frame_mtt at 64x64, top 32,
            depth 2, called as the JAX encoder calls them (operation by
            operation: no jit around them, so every product and sum is
            rounded on its own): codes, square and rect MVs, directions,
            masked levels, leaf masks, the unit fields and the
            reconstruction; reconstruct_mtt(_b) on the decoder's side;
  syntax    the port's writers give the JAX writers' bytes on the same
            grids (merge on and off), the port's parsers read them back
            to the JAX parsers' grids;
  streams   the port's CPU encode of ldp64x64_mtt_qp37_4f (merge off) and
            ra64x64_mtt_qp37_5f (merge on) equals the JAX encoder's
            committed stream byte for byte, and the port decodes both
            with every MD5 OK (0 differing decisions: no count to pin);
  property  the frames use rectangular leaves, binary and ternary.

Cost on one core: about 150 s, nearly all in the one test that runs the
two JAX frames (its first call compiles the searches of the 11
shapes and every operation: about 130 s)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import mtt as jm
from vvc_mm_tpu.decoder import inter_parser as jax_ip
from vvc_mm_tpu.encoder import inter_coder as jax_ic
from vvc_mm_tpu_torch.common import mtt as tm
from vvc_mm_tpu_torch.decoder import inter_parser
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder import inter_coder
from vvc_mm_tpu_torch.encoder.enclib import EncLib
from vvc_mm_tpu_torch.utils.content import realistic_sequence

from tests.make_torch_port_streams import port_cfg
from tests.test_torch_qtree import _j, _md5, _np, _t, assert_same

torch.set_num_threads(1)

W, H, TOP, DEPTH, QP, SR, BD = 64, 64, 32, 2, 32, 24, 8
ARGS = (QP, TOP, DEPTH, BD, SR, False)
DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
STREAMS = ("ldp64x64_mtt_qp37_4f", "ra64x64_mtt_qp37_5f")


@pytest.fixture(scope="module")
def clip():
    c = realistic_sequence(W, H, 5)
    return dict(orig=c[2], ref0=c[0], ref1=c[4])


@pytest.fixture(scope="module")
def port_p(clip):
    return tm.encode_p_frame_mtt(*_t(clip["orig"]), *_t(clip["ref0"]),
                                 *ARGS)


@pytest.fixture(scope="module")
def port_b(clip):
    return tm.encode_b_frame_mtt(*_t(clip["orig"]), tuple(_t(clip["ref0"])),
                                 tuple(_t(clip["ref1"])), *ARGS)


def test_rect_shapes_and_crops_equal_jax():
    for top in (16, 32, 64, 128):
        for depth in range(4):
            if top >> depth >= 4:
                assert tm.rect_shapes(top, depth) == jm.rect_shapes(top,
                                                                    depth)
    rng = np.random.default_rng(1)
    y = rng.integers(0, 256, (480, 832)).astype(np.int32)
    c = rng.integers(0, 256, (240, 416)).astype(np.int32)
    shapes = tm.rect_shapes(32, 2)
    assert len(shapes) == 8
    for info in shapes:
        _, _, sy, sx, y_off, x_off = info
        for plane, div in ((y, 1), (c, 2)):
            got = tm._crop(torch.from_numpy(plane), y_off, x_off, div)
            want = jm._crop(jnp.asarray(plane), y_off, x_off, div)
            assert_same(got, want, str(info))
            gy, gx = tm.rect_grid(480, 832, info)
            assert got.shape == (gy * sy // div, gx * sx // div), info


def test_resolve_mtt_equals_jax():
    """Random float32 costs on the 4x4-node lattice of a 128x128 picture,
    a share of them tied, so that the first-of-equal rule decides."""
    rng = np.random.default_rng(2)
    shapes = tm.rect_shapes(TOP, DEPTH)
    per = [rng.integers(0, 400, (4 << d, 4 << d)).astype(np.float32)
           * np.float32(1.75) for d in range(DEPTH + 1)]
    rect = {}
    for info in shapes:
        gy, gx = tm.rect_grid(128, 128, info)
        rect[info[:2]] = {"cost": rng.integers(0, 200, (gy, gx)).astype(
            np.float32) * np.float32(0.5)}
    lam = 57.2
    got = tm.resolve_mtt([torch.from_numpy(p) for p in per],
                         {k: {"cost": torch.from_numpy(v["cost"])}
                          for k, v in rect.items()}, TOP, DEPTH, lam)
    want = jm.resolve_mtt([jnp.asarray(p) for p in per],
                          {k: {"cost": jnp.asarray(v["cost"])}
                           for k, v in rect.items()}, TOP, DEPTH, lam)
    assert_same(got, want)
    assert len(np.unique(_np(got[0][0]))) >= 3


def test_encode_frames_equal_jax(clip, port_p, port_b):
    want = jm.encode_p_frame_mtt(*_j(clip["orig"]), *_j(clip["ref0"]),
                                 *ARGS)
    assert_same(port_p, want, "encode_p_frame_mtt")
    rec = tm.reconstruct_mtt(port_p["mv_unit"], port_p["sq_levels"],
                             port_p["rect_levels"], *_t(clip["ref0"]), QP,
                             TOP, DEPTH, BD, False)
    assert_same(rec, want["recon"], "reconstruct_mtt")
    want = jm.encode_b_frame_mtt(*_j(clip["orig"]), tuple(_j(clip["ref0"])),
                                 tuple(_j(clip["ref1"])), *ARGS)
    assert_same(port_b, want, "encode_b_frame_mtt")
    rec = tm.reconstruct_mtt_b(port_b["mv0_unit"], port_b["mv1_unit"],
                               port_b["dirs_unit"], port_b["sq_levels"],
                               port_b["rect_levels"],
                               tuple(_t(clip["ref0"])),
                               tuple(_t(clip["ref1"])), QP, TOP, DEPTH, BD,
                               False)
    assert_same(rec, want["recon"], "reconstruct_mtt_b")


def test_rect_leaves_used(port_p, port_b):
    for out in (port_p, port_b):
        codes = set(np.concatenate([_np(c).ravel() for c in out["codes"]]))
        assert {tm.BTH, tm.BTV} & codes and {tm.TTH, tm.TTV} & codes
        assert any(_np(m).any() for m in out["rect_masks"].values())


def _p_grids(out):
    return (_np(out["codes"]), [m.astype(np.int64) for m in _np(out["sq_mv"])],
            _np(out["sq_levels"]),
            {k: _np(v).astype(np.int64) for k, v in out["rect_mv"].items()},
            _np(out["rect_levels"]))


@pytest.mark.parametrize("merge", [False, True])
def test_p_writer_and_parser_equal_jax(port_p, merge):
    grids = _p_grids(port_p)
    got = inter_coder.encode_p_slice_mtt(*grids, TOP, DEPTH, use_merge=merge)
    want = jax_ic.encode_p_slice_mtt(*grids, TOP, DEPTH, use_merge=merge)
    assert got == want
    parsed = inter_parser.decode_p_slice_mtt(want, H, W, TOP, DEPTH,
                                             use_merge=merge)
    assert_same(parsed, jax_ip.decode_p_slice_mtt(want, H, W, TOP, DEPTH,
                                                  use_merge=merge))
    assert_same(parsed[1:], (port_p["sq_levels"], port_p["rect_levels"],
                             port_p["has_resid_unit"],
                             port_p["leaf_id_unit"]))


@pytest.mark.parametrize("merge", [False, True])
def test_b_writer_and_parser_equal_jax(port_b, merge):
    o = port_b
    grids = (_np(o["codes"]),
             *([m.astype(np.int64) for m in _np(o[k])]
               for k in ("sq_mv0", "sq_mv1")),
             _np(o["sq_dirs"]), _np(o["sq_levels"]),
             *({k: _np(v).astype(np.int64) for k, v in o[key].items()}
               for key in ("rect_mv0", "rect_mv1")),
             _np(o["rect_dirs"]), _np(o["rect_levels"]))
    got = inter_coder.encode_b_slice_mtt(*grids, TOP, DEPTH, use_merge=merge)
    want = jax_ic.encode_b_slice_mtt(*grids, TOP, DEPTH, use_merge=merge)
    assert got == want
    assert_same(inter_parser.decode_b_slice_mtt(want, H, W, TOP, DEPTH,
                                                use_merge=merge),
                jax_ip.decode_b_slice_mtt(want, H, W, TOP, DEPTH,
                                          use_merge=merge))


@pytest.mark.parametrize("name", STREAMS)
def test_cpu_encode_equals_committed_stream(name):
    sd = json.load(open(os.path.join(DATA, name + ".json")))
    enc = EncLib(port_cfg(name), device="cpu")
    got = enc.encode_sequence(realistic_sequence(sd["width"], sd["height"],
                                                 sd["frames"]))
    assert got == open(os.path.join(DATA, name + ".bin"), "rb").read()
    md5 = {p["poc"]: p["md5"] for p in sd["pocs"]}
    assert {r.poc: _md5(r.recon) for r in enc.results} == md5


@pytest.mark.parametrize("name", STREAMS)
def test_port_decodes_committed_stream(name):
    sd = json.load(open(os.path.join(DATA, name + ".json")))
    dec = DecLib(device="cpu")
    frames = dec.decode_bytes(open(os.path.join(DATA, name + ".bin"),
                                   "rb").read())
    assert dec.hash_status == {p["poc"]: "OK" for p in sd["pocs"]}
    assert [f.md5() for f in frames] == [p["md5"] for p in sd["pocs"]]
