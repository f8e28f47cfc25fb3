"""PyTorch port, affine motion (common/affine.py) against the JAX package
on the same numpy inputs.

  positions  affine_positions and mixed_positions: integer math, exact, on
             random control-point MVs of both signs (odd products, so the
             rounding shift meets negative halves);
  MC         mc_predict_positions (K1/K2's plain versions) on those
             positions, exact;
  search     affine_search: a float32 4x4 normal-equation solve per block
             (einsum sums, torch.linalg.solve), rounded to integers; the
             blocks whose (mv0, dmv) differ from JAX's are counted and the
             count pinned (0 at this size on the CPU);
  P          encode_p_frame_affine (the decision, the levels, the recon)
             against JAX's, reconstruct_p_frame_affine from JAX's
             decisions, encode_p_slice_affine / decode_p_slice_affine both
             ways.

128x64 pictures of `realistic_sequence`: POC 2 coded from POC 0.  Each JAX
program is compiled once per module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import affine as jaff
from vvc_mm_tpu.decoder import inter_parser as jax_ip
from vvc_mm_tpu.encoder import inter_coder as jax_ic
from vvc_mm_tpu_torch.common import affine as taff
from vvc_mm_tpu_torch.decoder import inter_parser
from vvc_mm_tpu_torch.encoder import inter_coder
from vvc_mm_tpu_torch.utils.content import realistic_sequence

torch.set_num_threads(1)

W, H, S, QP, SR, BD = 128, 64, 16, 38, 24, 8
NBY, NBX = H // S, W // S
# blocks whose rounded affine parameters differ from the JAX encoder's on
# the CPU at this size (ROADMAP queue 3, fault 1's float32 family)
SEARCH_BLOCKS_OFF = 0


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
    clip = realistic_sequence(W, H, 3)
    return dict(orig=[p.astype(np.int32) for p in clip[2]],
                ref0=[p.astype(np.int32) for p in clip[0]])


@pytest.fixture(scope="module")
def cpmv():
    rng = np.random.default_rng(17)
    return dict(mv0=rng.integers(-300, 300, (NBY, NBX, 2)).astype(np.int32),
                dmv=rng.integers(-129, 130, (NBY, NBX, 2)).astype(np.int32),
                mvs=rng.integers(-300, 300, (NBY, NBX, 2)).astype(np.int32),
                aff=rng.random((NBY, NBX)) < 0.5)


@pytest.mark.parametrize("s", [8, 16])
def test_affine_and_mixed_positions_equal_jax(cpmv, s):
    nby, nbx = H // s, W // s
    c = {k: v[:nby, :nbx] if s == 16 else np.resize(v, (nby, nbx) +
                                                      v.shape[2:])
         for k, v in cpmv.items()}
    pos = jax.jit(jaff.affine_positions, static_argnums=(2, 3, 4))
    _eq(taff.affine_positions(_t(c["mv0"]), _t(c["dmv"]), s, W, H),
        pos(c["mv0"], c["dmv"], s, W, H), "affine_positions")
    mixed = jax.jit(jaff.mixed_positions, static_argnums=(4, 5, 6))
    _eq(taff.mixed_positions(_t(c["mvs"]), _t(c["mv0"]), _t(c["dmv"]),
                             _t(c["aff"]), s, W, H),
        mixed(c["mvs"], c["mv0"], c["dmv"], c["aff"], s, W, H),
        "mixed_positions")


def test_mc_predict_positions_equals_jax(pics, cpmv):
    pos = np.asarray(jaff.mixed_positions(
        jnp.asarray(cpmv["mvs"]), jnp.asarray(cpmv["mv0"]),
        jnp.asarray(cpmv["dmv"]), jnp.asarray(cpmv["aff"]), S, W, H))
    _eq(taff.mc_predict_positions(*map(_t, pics["ref0"]), _t(pos), BD,
                                  False),
        jaff.mc_predict_positions(*map(jnp.asarray, pics["ref0"]),
                                  jnp.asarray(pos), S, BD, False))


@pytest.fixture(scope="module")
def enc_jax(pics):
    out = jaff.encode_p_frame_affine(*map(jnp.asarray, pics["orig"]),
                                     *map(jnp.asarray, pics["ref0"]), QP, S,
                                     BD, SR, False)
    return _np(out)


def test_affine_search_count_of_differing_blocks_is_pinned(pics):
    """Seeded from random translational MVs; three K1 passes (plain on the
    CPU)."""
    rng = np.random.default_rng(2)
    mv_t = rng.integers(-120, 120, (NBY, NBX, 2)).astype(np.int32)
    want = _np(jaff.affine_search(jnp.asarray(pics["orig"][0]),
                                  jnp.asarray(pics["ref0"][0]),
                                  jnp.asarray(mv_t), S, BD, False))
    got = _np(taff.affine_search(_t(pics["orig"][0]), _t(pics["ref0"][0]),
                                 _t(mv_t), S, BD, False))
    off = ((got[0] != want[0]).any(-1) | (got[1] != want[1]).any(-1))
    assert int(off.sum()) == SEARCH_BLOCKS_OFF
    _eq(got[2][~off], want[2][~off], "sad where the parameters agree")
    assert (want[1] != 0).any()


def test_encode_p_frame_affine_equals_jax(pics, enc_jax):
    got = taff.encode_p_frame_affine(*map(_t, pics["orig"]),
                                     *map(_t, pics["ref0"]), QP, S, BD, SR,
                                     False)
    _eq(got, enc_jax, "encode_p_frame_affine")
    aff = enc_jax[1]
    assert aff.any() and not aff.all()


def test_reconstruct_p_frame_affine_equals_jax(pics, enc_jax):
    mvs, aff, dmv, ly, lu, lv, recon = enc_jax
    got = taff.reconstruct_p_frame_affine(
        *map(_t, (mvs, aff, dmv, ly, lu, lv)), *map(_t, pics["ref0"]), QP, S,
        BD, False)
    _eq(got, recon, "decoder recon == JAX encoder recon")


def test_affine_slice_writer_and_parser_both_ways(enc_jax):
    mvs, aff, dmv, ly, lu, lv, _ = enc_jax
    got = inter_coder.encode_p_slice_affine(mvs, aff, dmv, ly, lu, lv)
    want = jax_ic.encode_p_slice_affine(mvs, aff, dmv, ly, lu, lv)
    assert got == want
    expect = (mvs, aff, dmv, ly, lu, lv)
    _eq(inter_parser.decode_p_slice_affine(want, NBY, NBX, S), expect,
        "port parser, JAX bytes")
    _eq(jax_ip.decode_p_slice_affine(got, NBY, NBX, S), expect,
        "JAX parser, port bytes")

