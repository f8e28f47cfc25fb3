"""PyTorch port, GPM, CIIP and explicit weighted prediction, function by
function against the JAX package on the same numpy inputs (tolerance 0:
all of it is integer; the weight estimate is the same float64 host code).

  GPM/CIIP  gpm_weights, gpm_blend, gpm_blend_chroma, gpm_search (ties
            included), _planar, ciip_from_pred; the GPM/CIIP arms of
            search_b_frame_merge (whose first four outputs are
            search_b_frame's) and of the B combine (_pred_planes_ext,
            bpred_and_residual, reconstruct_b_frame) on dirs 0-4;
            encode_b_slice / decode_b_slice with the GEO/CIIP bins, both
            ways, for each gating of the two tools;
  WP        apply_wp, _combine_bi with per-list weights, the weighted arm
            of reconstruct_b_frame, EncLib._estimate_wp on a fade, on the
            pan and zoom of the plain clip (both give weights) and on an
            unchanged picture (None).

128x64 pictures of `realistic_sequence`: POC 2 predicted from POC 0 (list
0) and POC 4 (list 1).  Each JAX program is compiled once per module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import gpm as jgpm
from vvc_mm_tpu.common import inter_frame as jif
from vvc_mm_tpu.decoder import inter_parser as jax_ip
from vvc_mm_tpu.encoder import inter_coder as jax_ic
from vvc_mm_tpu.encoder.enclib import EncLib as JaxEncLib
from vvc_mm_tpu_torch.common import gpm as tgpm
from vvc_mm_tpu_torch.common import inter_frame as tif
from vvc_mm_tpu_torch.decoder import inter_parser
from vvc_mm_tpu_torch.encoder import inter_coder
from vvc_mm_tpu_torch.encoder.enclib import EncLib
from vvc_mm_tpu_torch.utils.content import fade_sequence, realistic_sequence

torch.set_num_threads(1)

W, H, S, QP, SR, BD = 128, 64, 16, 38, 24, 8
NBY, NBX = H // S, W // S
WP0 = np.array([[58, 7], [66, -3], [61, 2]], np.int32)
WP1 = np.array([[70, -9], [64, 0], [52, 12]], np.int32)


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
    return dict(orig=[p.astype(np.int32) for p in clip[2]],
                ref0=[p.astype(np.int32) for p in clip[0]],
                ref1=[p.astype(np.int32) for p in clip[4]])


# ------------------------------------------------------------------ GPM

@pytest.mark.parametrize("s", [8, 16])
def test_gpm_blends_search_and_ciip_equal_jax(s):
    """Random blocks; the search's SAD ties (equal p0 and p1) keep the
    lowest mode."""
    rng = np.random.default_rng(s)
    np.testing.assert_array_equal(tgpm.gpm_weights(s), jgpm.gpm_weights(s))
    assert tgpm.NUM_GPM_MODES == jgpm.NUM_GPM_MODES
    b = 24
    p0, p1, org = (rng.integers(0, 256, (b, s, s)).astype(np.int32)
                   for _ in range(3))
    p1[:4] = p0[:4]                       # every mode ties
    modes = rng.integers(0, 16, b).astype(np.int32)
    _eq(tgpm.gpm_blend(_t(p0), _t(p1), _t(modes)),
        jax.jit(jgpm.gpm_blend)(p0, p1, modes), "gpm_blend")
    c0, c1 = p0[:, ::2, ::2].copy(), p1[:, ::2, ::2].copy()
    _eq(tgpm.gpm_blend_chroma(_t(c0), _t(c1), _t(modes)),
        jax.jit(jgpm.gpm_blend_chroma)(c0, c1, modes), "gpm_blend_chroma")
    got = tgpm.gpm_search(_t(org), _t(p0), _t(p1))
    want = jax.jit(jgpm.gpm_search)(org, p0, p1)
    _eq(got, want, "gpm_search")
    assert (np.asarray(want[0])[:4] == 0).all()
    top, left = (rng.integers(0, 1024, (b, s + 1)).astype(np.int32)
                 for _ in range(2))
    _eq(tgpm._planar(_t(top), _t(left), s),
        jax.jit(jgpm._planar, static_argnums=2)(top, left, s), "_planar")
    plane = rng.integers(0, 256, (4 * s, 6 * s)).astype(np.int32)
    _eq(tgpm.ciip_from_pred(_t(plane), s),
        jax.jit(jgpm.ciip_from_pred, static_argnums=1)(plane, s),
        "ciip_from_pred")


@pytest.fixture(scope="module")
def b_jax(pics):
    """search_b_frame_merge with GPM and CIIP on (its first four outputs
    are search_b_frame's), and the B combine / reconstruction on dirs
    0-4 with the searched GPM masks."""
    o, r0, r1 = ([jnp.asarray(p) for p in pics[k]]
                 for k in ("orig", "ref0", "ref1"))
    search = _np(jif.search_b_frame_merge(o[0], r0[0], r1[0], QP, S, BD, SR,
                                          False, True, True))
    mv0, mv1, dirs, gmodes = search[:4]
    rng = np.random.default_rng(9)
    dirs_all = rng.integers(0, 5, (NBY, NBX)).astype(np.int32)
    args = (jnp.asarray(mv0), jnp.asarray(mv1), jnp.asarray(dirs_all))
    bp = _np(jif.bpred_and_residual(*o, tuple(r0), tuple(r1), *args, QP, S,
                                    BD, False, gpm_modes=jnp.asarray(gmodes),
                                    gpm=True, ciip=True))
    rec = _np(jif.reconstruct_b_frame(
        *args, *[jnp.asarray(x) for x in bp[:3]], tuple(r0), tuple(r1), QP,
        S, BD, False, gpm_modes=jnp.asarray(gmodes), gpm=True, ciip=True))
    wrec = _np(jif.reconstruct_b_frame(
        *args[:2], jnp.asarray(np.minimum(dirs_all, 2)),
        *[jnp.asarray(x) for x in bp[:3]], tuple(r0), tuple(r1), QP, S, BD,
        False, wp0=jnp.asarray(WP0), wp1=jnp.asarray(WP1)))
    return dict(search=search, dirs_all=dirs_all, bpred=bp, recon=rec,
                wrecon=wrec)


def test_search_b_frame_with_gpm_and_ciip_equals_jax(pics, b_jax):
    got = tif.search_b_frame_merge(_t(pics["orig"][0]), _t(pics["ref0"][0]),
                                   _t(pics["ref1"][0]), QP, S, BD, SR,
                                   False, True, True)
    _eq(got, b_jax["search"], "search_b_frame_merge")
    dirs = b_jax["search"][2]
    assert (dirs == 3).any()
    # candidate dirs collapse GPM/CIIP neighbours to BI
    assert b_jax["search"][7].max() <= 2


def test_bpred_and_reconstruct_with_gpm_and_ciip_equal_jax(pics, b_jax):
    mv0, mv1, _, gmodes = b_jax["search"][:4]
    args = (_t(mv0), _t(mv1), _t(b_jax["dirs_all"]))
    r0, r1 = tuple(map(_t, pics["ref0"])), tuple(map(_t, pics["ref1"]))
    got = tif.bpred_and_residual(*map(_t, pics["orig"]), r0, r1, *args, QP,
                                 S, BD, False, gpm_modes=_t(gmodes),
                                 gpm=True, ciip=True)
    _eq(got, b_jax["bpred"], "bpred_and_residual")
    rec = tif.reconstruct_b_frame(*args, *map(_t, b_jax["bpred"][:3]), r0,
                                  r1, QP, S, BD, False, gpm_modes=_t(gmodes),
                                  gpm=True, ciip=True)
    _eq(rec, b_jax["recon"], "reconstruct_b_frame")
    _eq(rec, b_jax["bpred"][3], "decoder recon == encoder recon")


def test_weighted_b_reconstruction_equals_jax(pics, b_jax):
    mv0, mv1 = b_jax["search"][:2]
    got = tif.reconstruct_b_frame(
        _t(mv0), _t(mv1), _t(np.minimum(b_jax["dirs_all"], 2)),
        *map(_t, b_jax["bpred"][:3]), tuple(map(_t, pics["ref0"])),
        tuple(map(_t, pics["ref1"])), QP, S, BD, False, wp0=_t(WP0),
        wp1=_t(WP1))
    _eq(got, b_jax["wrecon"], "reconstruct_b_frame with weights")


@pytest.mark.parametrize("tools", [(True, True), (True, False),
                                   (False, True)])
def test_b_slice_with_geo_and_ciip_bins_both_ways(b_jax, tools):
    """The GEO/CIIP bins and the GPM mask index, for each gating: dirs
    the slice's SPS cannot carry are made BI first."""
    use_gpm, use_ciip = tools
    mv0, mv1, _, gmodes = b_jax["search"][:4]
    dirs = b_jax["dirs_all"].copy()
    if not use_gpm:
        dirs[dirs == 3] = 2
    if not use_ciip:
        dirs[dirs == 4] = 2
    gm = np.where(dirs == 3, gmodes, 0).astype(np.int32)
    levels = tuple(np.asarray(x) for x in b_jax["bpred"][:3])
    kw = dict(gpm_modes=gm, use_gpm=use_gpm, use_ciip=use_ciip)
    got = inter_coder.encode_b_slice(mv0, mv1, dirs, *levels, **kw)
    want = jax_ic.encode_b_slice(mv0, mv1, dirs, *levels, **kw)
    _eq(got[1:], want[1:], "coded grids")
    assert got[0] == want[0]
    pkw = dict(use_gpm=use_gpm, use_ciip=use_ciip)
    expect = (want[1], want[2], dirs) + levels + (gm,)
    _eq(inter_parser.decode_b_slice(want[0], NBY, NBX, S, **pkw), expect,
        "port parser, JAX bytes")
    _eq(jax_ip.decode_b_slice(got[0], NBY, NBX, S, **pkw), expect,
        "JAX parser, port bytes")


# ------------------------------------------------------------------- WP

def test_apply_wp_and_weighted_combine_equal_jax():
    rng = np.random.default_rng(12)
    for bd in (8, 10):
        p = rng.integers(0, 1 << bd, (4, 16, 16)).astype(np.int32)
        for w, o in ((64, 0), (1, -128), (255, 127), (37, -5)):
            _eq(tif.apply_wp(_t(p), w, o, bd),
                jif.apply_wp(jnp.asarray(p), w, o, bd), (bd, w, o))
        i0, i1 = (rng.integers(-(1 << 13), 1 << 14, (8, 8, 8))
                  .astype(np.int32) for _ in range(2))
        dirs = rng.integers(0, 3, (2, 4)).astype(np.int32)
        comb = jax.jit(jif._combine_bi, static_argnums=(3, 4, 5, 8))
        for plane in range(3):
            _eq(tif._combine_bi(_t(i0), _t(i1), _t(dirs), 2, 4, bd,
                                _t(WP0), _t(WP1), plane),
                comb(i0, i1, dirs, 2, 4, bd, WP0, WP1, plane), (bd, plane))


def test_estimate_wp_equals_jax_on_a_fade_and_on_plain_content():
    clip = realistic_sequence(W, H, 3)
    fade = fade_sequence(clip, 0.04)
    enc = EncLib.__new__(EncLib)       # _estimate_wp reads no state
    for planes, ref in ((fade[2], fade[0]), (fade[1], fade[0]),
                        (clip[2], clip[0]), (clip[1], clip[0]),
                        (clip[0], clip[0])):
        assert enc._estimate_wp(planes, ref) == \
            JaxEncLib._estimate_wp(None, planes, ref)
    assert enc._estimate_wp(fade[2], fade[0]) is not None
    assert enc._estimate_wp(clip[0], clip[0]) is None
