"""PyTorch port, parallel/sharding.py on torch.distributed (ROADMAP queue 1
item 12): 2 gloo ranks on the CPU (spawned, the group's rendezvous a file
under tmp_path) run every sharded encode (tests/torch_shard_ranks.py),
and each equals the port's unsharded function bit for bit:

  intra   encode_frames_sharded, a picture a rank, against
          wavefront.encode_intra_frame (held to JAX by
          tests/test_torch_intra_enc.py);
  p, b    encode_p_frame_sharded / encode_b_frame_sharded, row slabs over
          a replicated reference, against inter_frame.encode_p_frame and
          search_b_frame + bpred_and_residual (held to JAX by
          tests/test_torch_classic.py);
  mm      encode_p_frame_mm_sharded (ERP 128x128, MPA+ROT, wrap-around:
          the second slab's MVReprojection starts at row 16) against
          frame_codec.search_p_mm, merged_positions and enc_finish_p_mm
          (held to JAX by tests/test_torch_flat_p.py and
          tests/test_torch_sequence.py);
  halo    encode_p_frame_sharded_ref (the reference row-sharded, its halo
          rows over point-to-point calls) against encode_p_frame, and at
          64x64 directly against the JAX package's encode_p_frame.

No rank codes the whole frame: a slab plus its context rows is at most
112 of 128 rows.  Cost on one core: about 10 s (the ranks 6 s)."""
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from vvc_mm_tpu.common import inter_frame as jax_inter
from vvc_mm_tpu_torch.common import inter_frame, wavefront
from vvc_mm_tpu_torch.common.mm import frame_codec
from vvc_mm_tpu_torch.parallel import sharding

from tests import torch_shard_ranks as ranks

torch.set_num_threads(1)

T = lambda a: torch.as_tensor(np.asarray(a, np.int32))  # noqa: E731


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard")
    out = str(d / "results.pkl")
    mp.spawn(ranks.run_rank, args=(2, "file://" + str(d / "rendezvous"),
                                   out), nprocs=2, join=True)
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def cases():
    return {k: make() for k, make in ranks.CASES.items()}


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), ranks.as_numpy(w))


def test_mesh(sharded):
    assert sharded["mesh"] == (2, 1, 2)


def test_frame_parallel_intra(sharded, cases):
    outs, rec = sharded["intra"]
    for i, f in enumerate(cases["intra"]):
        o, r = wavefront.encode_intra_frame(*map(T, f), ranks.QP, 8, 8)
        _equal([x[i] for x in outs] + [rec[c][i] for c in "yuv"],
               list(o) + [r[c] for c in "yuv"])


def test_row_sharded_p(sharded, cases):
    f = cases["p"]
    want = inter_frame.encode_p_frame(*map(T, f[1]), *map(T, f[0]),
                                      ranks.QP, 16, 8, 8, False)
    got = sharded["p"]
    _equal(list(got[:4]) + [got[4][c] for c in "yuv"],
           list(want[:4]) + [want[4][c] for c in "yuv"])


def test_row_sharded_b(sharded, cases):
    f = cases["b"]
    oy, ou, ov = map(T, f[1])
    r0, r1 = tuple(map(T, f[0])), tuple(map(T, f[2]))
    mv0, mv1, dirs, _ = inter_frame.search_b_frame(oy, r0[0], r1[0],
                                                   ranks.QP, 16, 8, 8, False)
    ly, lu, lv, rec = inter_frame.bpred_and_residual(
        oy, ou, ov, r0, r1, mv0, mv1, dirs, ranks.QP, 16, 8, False)
    got = sharded["b"]
    _equal(list(got[:3]) + list(got[3]) + [got[4][c] for c in "yuv"],
           [mv0, mv1, dirs, ly, lu, lv] + [rec[c] for c in "yuv"])


def test_row_sharded_mm_p(sharded, cases):
    f = cases["mm"]
    reproj, active = ranks.mm_reprojection(128, 128)
    cur, ref = list(map(T, f[1])), list(map(T, f[0]))
    midx, stack = frame_codec.search_p_mm(reproj, active, cur[0], ref[0],
                                          ranks.QP, 16, 8, 8, None, True)
    pos = frame_codec.merged_positions(reproj, active, midx, stack, 16, None)
    ly, lu, lv, rec = frame_codec.enc_finish_p_mm(
        midx, stack, pos, *cur, *ref, ranks.QP, 16, 8, True, True)
    got = sharded["mm"]
    _equal([got[0], got[1], *got[2]] + [got[3][c] for c in "yuv"],
           [midx, stack, ly, lu, lv] + [rec[c] for c in "yuv"])
    assert len(np.unique(got[0])) > 1      # more than one model chosen


def test_slab_reprojection_positions():
    """A slab's positions are the frame's at its rows, relative to its
    first row (sharding's MVReprojection(rows=))."""
    reproj, active = ranks.mm_reprojection(128, 128)
    rng = np.random.default_rng(4)
    idx = T(rng.integers(0, len(active), (8, 8)))
    stack = T(rng.integers(-200, 200, (len(active), 8, 8, 2)))
    whole = frame_codec.merged_positions(reproj, active, idx, stack, 16)
    slab = reproj.slab(48, 112)
    part = frame_codec.merged_positions(slab, active, idx[3:7],
                                        stack[:, 3:7], 16)
    want = whole[12:28].clone()
    want[..., 1] -= 48 * 16
    assert torch.equal(part, want)
    assert (slab.height, slab.rows, slab.row0) == (128, 64, 48)


def test_halo_exchange(sharded, cases):
    f = cases["halo"]
    want = inter_frame.encode_p_frame(*map(T, f[1]), *map(T, f[0]),
                                      ranks.QP, 16, 8, 8, True)
    got = sharded["halo"]
    _equal(list(got[:4]) + [got[4][c] for c in "yuv"],
           list(want[:4]) + [want[4][c] for c in "yuv"])
    # and the JAX package's unsharded encode of the same 64x64 pictures
    jw = jax_inter.encode_p_frame(*map(jnp.asarray, f[1]),
                                  *map(jnp.asarray, f[0]), ranks.QP, 16, 8,
                                  8, True)
    _equal(list(got[:4]) + [got[4][c] for c in "yuv"],
           [np.asarray(x) for x in jw[:4]] +
           [np.asarray(jw[4][c]) for c in "yuv"])


def test_sharding_refusals():
    mesh = sharding.Mesh(2, 1)
    with pytest.raises(ValueError, match="whole"):
        sharding._slab(100, 2, 0, 16)
    with pytest.raises(ValueError, match="frames over"):
        sharding.encode_frames_sharded([[None]] * 3, 32, mesh,
                                       device="cpu")
    assert sharding.default_halo(16, 24) == 32
    assert sharding.default_halo(16, 24, neighbours=True) == 48
