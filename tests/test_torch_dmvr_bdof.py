"""PyTorch port, the decoder-side refinements of bi-predicted blocks against
the JAX package on the same numpy inputs:

  dmvr_refine      classic DMVR (common/dmvr.py): +-2-pel bilateral
                   matching on nearest-integer patches, 25 mirrored offsets
                   with (0, 0) first and a strict `<`, bi blocks only;
  bdof_bi,         BDOF (common/bdof.py): per-4x4 optical flow from the two
  combine_bi_bdof  internal predictions, floor division on negative
                   numerators, at 8 and 10 bit;
  the B arms       bpred_and_residual / reconstruct_b_frame with bdof and
                   with dmvr at 128x64;
  projected DMVR   frame_codec.projected_dmvr (the multi-model B path's
                   bilateral refinement through the reprojection) and the
                   dmvr arm of predict_b_mm at 256x128.

Everything but projected DMVR is integer math: tolerance 0.  Projected
DMVR's candidate positions are float32 sphere math (ROADMAP queue 3,
fault 1); its refined MVs must equal JAX's wherever the positions do, and
the number of differing MVs is pinned as measured."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import bdof as jax_bdof
from vvc_mm_tpu.common import dmvr as jax_dmvr
from vvc_mm_tpu.common import inter_frame as jif
from vvc_mm_tpu.common.mm import frame_codec as jax_fc
from vvc_mm_tpu.common.mm.reprojection import MVReprojection as JaxReproj
from vvc_mm_tpu.lib360.projection import ERP as JaxERP
from vvc_mm_tpu_torch.common import bdof, dmvr
from vvc_mm_tpu_torch.common import inter_frame as tif
from vvc_mm_tpu_torch.common.mm import frame_codec
from vvc_mm_tpu_torch.common.mm.reprojection import MVReprojection
from vvc_mm_tpu_torch.lib360.projection import ERP
from vvc_mm_tpu_torch.utils.content import realistic_sequence

torch.set_num_threads(1)

W, H, S, QP, BD = 128, 64, 16, 38, 8
NBY, NBX = H // S, W // S
M = tif.MC_MARGIN


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


@pytest.fixture(scope="module")
def pics():
    clip = realistic_sequence(W, H, 5)
    return dict(orig=[p.astype(np.int32) for p in clip[2]],
                ref0=[p.astype(np.int32) for p in clip[0]],
                ref1=[p.astype(np.int32) for p in clip[4]])


# -------------------------------------------------------------------- DMVR

def _dmvr_case(pics, case):
    """(padded ref0, padded ref1, mv0, mv1, dirs) as int32 numpy."""
    rng = np.random.default_rng(41)
    r0 = np.asarray(jif.pad_ref(jnp.asarray(pics["ref0"][0]), M))
    r1 = np.asarray(jif.pad_ref(jnp.asarray(pics["ref1"][0]), M))
    mv0 = rng.integers(-96, 97, (NBY, NBX, 2)).astype(np.int32)
    mv1 = (-mv0 + rng.integers(-24, 25, (NBY, NBX, 2))).astype(np.int32)
    dirs = rng.integers(0, 3, (NBY, NBX)).astype(np.int32)
    dirs[0, :3] = 2
    if case == "ties":
        # a flat reference ties every offset (the centre stays), a
        # reference periodic in 2 pixels ties pairs of offsets (the
        # earlier one in the scan wins)
        r0 = np.full_like(r0, 117)
        r1 = np.full_like(r1, 117)
        r0[:, 100:] = np.tile([10, 200], r0.shape[1] // 2)[100:]
        r1[:, 100:] = np.tile([200, 10], r1.shape[1] // 2)[100:]
        dirs[:] = 2
    elif case == "edge":
        # MVs far outside the picture: the patch origins clamp to the
        # padded plane's edges
        mv0[:, ::2] = [[-4000, 3000]]
        mv1[::2] = [[3500, -5000]]
        mv0[1, 1] = [-1, -9]            # a rounding at -8 and below
    return r0, r1, mv0, mv1, dirs


@pytest.mark.parametrize("case", ["realistic", "ties", "edge"])
def test_dmvr_refine_equals_jax(pics, case):
    r0, r1, mv0, mv1, dirs = _dmvr_case(pics, case)
    want = jax_dmvr.dmvr_refine(*(jnp.asarray(a) for a in
                                  (r0, r1, mv0, mv1, dirs)), S, M)
    got = dmvr.dmvr_refine(*(_t(a) for a in (r0, r1, mv0, mv1, dirs)), S, M)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == (NBY, NBX, 2)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    moved = (got[0].numpy() != mv0).any(-1)
    assert not moved[dirs != 2].any()        # uni blocks keep their MVs
    if case == "realistic":
        assert moved.any()                   # some bi block refines
    np.testing.assert_array_equal(got[0].numpy() - mv0,
                                  mv1 - got[1].numpy())   # mirrored


# -------------------------------------------------------------------- BDOF

def _internal_pair(bd, seed):
    """Two internal-precision (14-bit) predictions of 8 blocks, the second
    the first moved by a sub-pixel step each way and noised, so that the
    per-subblock flows take both signs."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << bd, (8, S + 4, S + 4)).astype(np.float64)
    base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 2)) / 3
    sh = 14 - bd
    p0 = base[:, 2:-2, 2:-2]
    p1 = np.empty_like(p0)
    for b in range(8):
        dy, dx = (b % 3) - 1, (b // 3 % 3) - 1
        p1[b] = base[b, 2 + dy:2 + dy + S, 2 + dx:2 + dx + S]
    noise = rng.integers(-(1 << sh), 1 << sh, p0.shape)
    i0 = (p0 * (1 << sh) - (1 << 13)).astype(np.int32)
    i1 = (p1 * (1 << sh) - (1 << 13) + noise).astype(np.int32)
    return i0, i1


@pytest.mark.parametrize("bd", [8, 10])
def test_bdof_bi_and_combine_equal_jax(bd):
    i0, i1 = _internal_pair(bd, 50 + bd)
    want = np.asarray(jax_bdof.bdof_bi(jnp.asarray(i0), jnp.asarray(i1), bd))
    got = bdof.bdof_bi(_t(i0), _t(i1), bd)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the flows take both signs, and a negative numerator that the
    # denominator does not divide (floor and truncation differ) occurs
    t0, t1 = _t(i0), _t(i1)
    gx0, _ = bdof._grad(t0)
    gx1, _ = bdof._grad(t1)
    gxs = bdof._to_sub((gx0 + gx1) >> 1, S)
    s1 = gxs.abs().sum(dim=(1, 2), dtype=torch.int32)
    s3 = bdof._signed_sum(gxs, bdof._to_sub((t0 >> 4) - (t1 >> 4), S))
    vx = bdof._flow(s3, s1)
    assert (vx < 0).any() and (vx > 0).any()
    assert ((s3 < 0) & (s1 > 0) & ((s3 << 3) % s1.clamp(min=1) != 0)).any()
    # the frame-level combine: BDOF on bi blocks, uni finalize elsewhere
    dirs = np.array([[0, 1, 2, 2], [2, 1, 0, 2]], np.int32)
    want = np.asarray(jax_bdof.combine_bi_bdof(
        jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(dirs), 2, 4, bd))
    got = bdof.combine_bi_bdof(_t(i0), _t(i1), _t(dirs), 2, 4, bd)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- the B arms

@pytest.fixture(scope="module")
def b_grids(pics):
    """The port's classic B search on the 128x64 pictures (MVs of both
    signs, mostly fractional; L0, L1 and bi blocks)."""
    o, r0, r1 = (_t(pics[k][0]) for k in ("orig", "ref0", "ref1"))
    mv0, mv1, dirs, _ = tif.search_b_frame(o, r0, r1, QP, S, BD, 24, False)
    assert set(dirs.flatten().tolist()) == {0, 1, 2}
    return mv0, mv1, dirs


@pytest.mark.parametrize("tool", ["bdof", "dmvr"])
def test_b_arms_equal_jax(pics, b_grids, tool):
    kw = dict(bdof=tool == "bdof", dmvr=tool == "dmvr")
    jo = [jnp.asarray(p) for p in pics["orig"]]
    j0 = tuple(jnp.asarray(p) for p in pics["ref0"])
    j1 = tuple(jnp.asarray(p) for p in pics["ref1"])
    jm0, jm1, jd = (jnp.asarray(g.numpy()) for g in b_grids)
    want = jif.bpred_and_residual(*jo, j0, j1, jm0, jm1, jd, QP, S, BD,
                                  False, **kw)
    want_rec = jif.reconstruct_b_frame(jm0, jm1, jd, *want[:3], j0, j1, QP,
                                       S, BD, False, **kw)
    o = [_t(p) for p in pics["orig"]]
    r0 = tuple(_t(p) for p in pics["ref0"])
    r1 = tuple(_t(p) for p in pics["ref1"])
    got = tif.bpred_and_residual(*o, r0, r1, *b_grids, QP, S, BD, False,
                                 **kw)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for k in "yuv":
        np.testing.assert_array_equal(got[3][k].numpy(),
                                      np.asarray(want[3][k]))
    rec = tif.reconstruct_b_frame(*b_grids, *got[:3], r0, r1, QP, S, BD,
                                  False, **kw)
    for k in "yuv":
        np.testing.assert_array_equal(rec[k].numpy(),
                                      np.asarray(want_rec[k]))
        np.testing.assert_array_equal(rec[k].numpy(), got[3][k].numpy())
    # the tool changes the reconstruction against the plain B path
    plain = tif.bpred_and_residual(*o, r0, r1, *b_grids, QP, S, BD, False)
    assert not torch.equal(plain[3]["y"], got[3]["y"])


# --------------------------------------------------------- projected DMVR

# 256x128, models CLASSIC, TAN and GED (epipole (1, 0, 0)); pairs of the
# same model and with CLASSIC are refined, the others not.  Refined
# stack entries that differ from the JAX package's (of 3 x 8 x 16), as
# measured with PyTorch's CPU math
PDMVR_MEASURED = (0, 0)
PD_ACTIVE = [0, 5, 7]


@pytest.fixture(scope="module")
def pdmvr_inputs():
    w, h = 256, 128
    clip = realistic_sequence(w, h, 5)
    rng = np.random.default_rng(61)
    nby, nbx = h // S, w // S
    n = len(PD_ACTIVE)
    glob = np.array([-24, 8])
    st0 = (glob + rng.integers(-40, 41, (n, nby, nbx, 2))).astype(np.int32)
    st1 = (-glob + rng.integers(-40, 41, (n, nby, nbx, 2))).astype(np.int32)
    idx0 = rng.integers(0, n, (nby, nbx)).astype(np.int32)
    idx1 = np.where(rng.uniform(size=(nby, nbx)) < 0.7, idx0,
                    rng.integers(0, n, (nby, nbx))).astype(np.int32)
    dirs = np.where(rng.uniform(size=(nby, nbx)) < 0.75, 2,
                    rng.integers(0, 2, (nby, nbx))).astype(np.int32)
    eps = {7: (1.0, 0.0, 0.0)}
    return dict(w=w, h=h, ref0=[p.astype(np.int32) for p in clip[0]],
                ref1=[p.astype(np.int32) for p in clip[4]], st0=st0,
                st1=st1, idx0=idx0, idx1=idx1, dirs=dirs, eps=eps)


def test_projected_dmvr_equals_jax(pdmvr_inputs):
    d = pdmvr_inputs
    w, h = d["w"], d["h"]
    args = (d["idx0"], d["idx1"], d["st0"], d["st1"], d["dirs"],
            d["ref0"][0], d["ref1"][0])
    jr = JaxReproj(JaxERP(w, h), w, h, 1, 1)
    tr = MVReprojection(ERP(w, h), w, h, 1, 1, device="cpu")
    want = jax_fc.projected_dmvr(jr, PD_ACTIVE,
                                 *(jnp.asarray(a) for a in args), S, BD,
                                 d["eps"], d["eps"], True)
    got = frame_codec.projected_dmvr(tr, PD_ACTIVE, *(_t(a) for a in args),
                                     S, BD, d["eps"], d["eps"], True)
    counts = []
    for g, j, st in zip(got, want, (d["st0"], d["st1"])):
        assert g.dtype == torch.int32 and g.shape == st.shape
        counts.append(int((g.numpy() != np.asarray(j)).any(-1).sum()))
        # only the selected model's entry of bi blocks moves, by one of the
        # quarter-pel plus offsets
        delta = g.numpy() - st
        moved = (delta != 0).any(-1)
        assert moved.any()
        assert set(map(tuple, delta[moved].tolist())) <= {
            (-4, 0), (4, 0), (0, -4), (0, 4)}
    assert tuple(counts) == PDMVR_MEASURED
    bi = d["dirs"] == 2
    pairs = frame_codec.dmvr_pairs(PD_ACTIVE, d["idx0"], d["idx1"],
                                   d["dirs"])
    assert pairs == sorted({(a, b) for a, b in zip(d["idx0"][bi],
                                                   d["idx1"][bi])
                            if a == b or 0 in (a, b)})
    assert (1, 2) not in pairs                  # TAN x GED: not evaluated
    # the dmvr arm of predict_b_mm: refine, then predict all three planes
    grids = (d["idx0"], d["idx1"], d["st0"], d["st1"], d["dirs"])
    want = jax_fc.predict_b_mm(
        jr, PD_ACTIVE, *(jnp.asarray(a) for a in grids),
        tuple(jnp.asarray(p) for p in d["ref0"]),
        tuple(jnp.asarray(p) for p in d["ref1"]), S, BD, d["eps"], d["eps"],
        True, True)
    got = frame_codec.predict_b_mm(
        tr, PD_ACTIVE, *(_t(a) for a in grids),
        tuple(_t(p) for p in d["ref0"]), tuple(_t(p) for p in d["ref1"]), S,
        BD, d["eps"], d["eps"], True, True)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    jax.clear_caches()
