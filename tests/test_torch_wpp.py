"""PyTorch port, WPP entropy substreams (ROADMAP queue 1 item 11a), against
the JAX package at tolerance 0.

  streams   the port's CPU encode of tests/test_wpp.py's two inter WPP
            configurations equals the committed JAX stream byte for byte:
            64x64 RA GOP 4 with TMVP and 2 substreams (the I, P and B WPP
            writers), and 128x128 LDP with TMVP, 4 substreams and noisy
            block rows (the HMVP resets of the P merge selection); the
            port's DecLib decodes each to the JAX decoder's pictures with
            every MD5 OK;
  framing   encode_intra_slice_wpp on tests/test_wpp.py:42's grids gives
            the JAX writer's bytes (u16 count, u32 lengths, streams) and
            decode_intra_slice_wpp reads them back;
  syntax    encode_p_slice_wpp / encode_b_slice_wpp on seeded grids give
            the JAX writers' bytes, and the port's WPP parsers read them to
            the JAX parsers' grids;
  selection select_merge_p with substream_starts (and snap off, MCTS's
            form) against JAX's on tests/test_wpp.py:120's crafted grids
            and on seeded ones;
  threads   24 substreams on the writers' thread pool, the interpreter
            switching threads every microsecond: the sequential bytes.

No JAX program is compiled here (the JAX functions are host numpy).  Cost
on one core: about 5 s."""
import numpy as np
import pytest
import torch

from vvc_mm_tpu.decoder import inter_parser as jax_ip
from vvc_mm_tpu.decoder import intra_parser as jax_intra_parser
from vvc_mm_tpu.encoder import inter_coder as jax_ic
from vvc_mm_tpu.encoder import intra_coder as jax_intra_coder
from vvc_mm_tpu_torch.decoder import inter_parser, intra_parser
from vvc_mm_tpu_torch.encoder import inter_coder, intra_coder

from tests.make_torch_port_streams import assert_tool_run, port_tool_run

torch.set_num_threads(1)

STREAMS = ("ra64x64_wpp_tmvp_qp32_6f", "ldp128x128_wpp_tmvp_qp28_6f")


@pytest.mark.parametrize("name", STREAMS)
def test_wpp_stream_matches_jax(name):
    run = port_tool_run(name)
    assert run["dec"].sps.wpp and run["fields"]["num_substreams"] > 1
    assert_tool_run(run)


def test_wpp_framing_matches_jax():
    """tests/test_wpp.py:42's grids, and every intra tool's syntax."""
    rng = np.random.default_rng(0)
    nby, nbx, s = 8, 4, 8
    modes = rng.integers(0, 67, (nby, nbx)).astype(np.int32)
    ly = np.zeros((nby, nbx, s, s), np.int32)
    lu = np.zeros((nby, nbx, 4, 4), np.int32)
    lv = np.zeros((nby, nbx, 4, 4), np.int32)
    ly[2, 1, 0, 0] = 5
    data = intra_coder.encode_intra_slice_wpp(modes, ly, lu, lv,
                                              num_substreams=4)
    assert data == jax_intra_coder.encode_intra_slice_wpp(
        modes, ly, lu, lv, num_substreams=4)
    n = int.from_bytes(data[:2], "big")
    lens = [int.from_bytes(data[2 + 4 * i:6 + 4 * i], "big")
            for i in range(n)]
    assert n == 4 and sum(lens) == len(data) - 2 - 4 * n
    back = intra_parser.decode_intra_slice_wpp(data, nby, nbx, s)
    np.testing.assert_array_equal(back[0], modes)
    np.testing.assert_array_equal(back[6], ly)
    # the tool grids of the I slice, with more substreams than rows
    g = rng.integers(0, 2, (nby, nbx)).astype(np.int32)
    tools = dict(cclm=g, mrl=g, lfnst=g, ts=g, mts=g, mip=True)
    flags = {k: True for k in tools}
    data = intra_coder.encode_intra_slice_wpp(modes, ly, lu, lv,
                                              num_substreams=12, **tools)
    assert data == jax_intra_coder.encode_intra_slice_wpp(
        modes, ly, lu, lv, num_substreams=12, **tools)
    for a, b in zip(intra_parser.decode_intra_slice_wpp(data, nby, nbx, s,
                                                        **flags),
                    jax_intra_parser.decode_intra_slice_wpp(data, nby, nbx,
                                                            s, **flags)):
        np.testing.assert_array_equal(a, b)


def _grids(rng, nby, nbx, s=8):
    mv = rng.choice(np.array([-8, 0, 4, 16], np.int64), (nby, nbx, 2))
    lev = np.where(rng.random((nby, nbx, s, s)) < 0.05,
                   rng.integers(-3, 4, (nby, nbx, s, s)), 0).astype(np.int32)
    levc = np.where(rng.random((nby, nbx, s // 2, s // 2)) < 0.05,
                    rng.integers(-2, 3, (nby, nbx, s // 2, s // 2)),
                    0).astype(np.int32)
    return mv, lev, levc


@pytest.mark.parametrize("nsub", [2, 3])
def test_inter_wpp_syntax_matches_jax(nsub):
    rng = np.random.default_rng(11 + nsub)
    nby, nbx, s = 6, 5, 8
    mv, ly, lu = _grids(rng, nby, nbx, s)
    col = rng.choice(np.array([0, 4], np.int64), (nby, nbx, 2))
    mflag = rng.random((nby, nbx)) < 0.4
    midx = rng.integers(0, 6, (nby, nbx)).astype(np.int32)
    imv = rng.integers(0, 3, (nby, nbx)).astype(np.int32)
    kw = dict(col_mvs=col, use_tmvp=True, imv=imv, merge_flag=mflag,
              merge_idx=midx, num_substreams=nsub)
    data = inter_coder.encode_p_slice_wpp(mv, ly, lu, lu, **kw)
    assert data == jax_ic.encode_p_slice_wpp(mv, ly, lu, lu, **kw)
    pkw = dict(col_mvs=col, use_tmvp=True, use_amvr=True, use_merge=True)
    for a, b in zip(inter_parser.decode_p_slice_wpp(data, nby, nbx, s,
                                                    **pkw),
                    jax_ip.decode_p_slice_wpp(data, nby, nbx, s, **pkw)):
        np.testing.assert_array_equal(a, b)
    # B: uni/bi directions, merge flags and the MVP replacements
    mv1 = rng.choice(np.array([-4, 0, 8], np.int64), (nby, nbx, 2))
    dirs = rng.integers(0, 3, (nby, nbx)).astype(np.int32)
    bkw = dict(merge_flag=mflag, merge_idx=midx, num_substreams=nsub)
    data = inter_coder.encode_b_slice_wpp(mv, mv1, dirs, ly, lu, lu, **bkw)
    assert data == jax_ic.encode_b_slice_wpp(mv, mv1, dirs, ly, lu, lu,
                                             **bkw)
    got = inter_parser.decode_b_slice_wpp(data, nby, nbx, s, use_merge=True)
    want = jax_ip.decode_b_slice_wpp(data, nby, nbx, s, use_merge=True)
    # the JAX state's order: mv0, mv1, dirs, gpm_modes, lev_y, lev_u, lev_v
    want = want[:3] + want[4:] + want[3:4]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _crafted():
    """tests/test_wpp.py:120's scenario: under a 2x2-block merge region,
    block (3, 0) has no spatial candidate, and its ME MV is reachable only
    through an HMVP entry that a per-substream decoder does not hold."""
    nby, nbx = 4, 2
    mv_me = np.zeros((nby, nbx, 2), np.int64)
    for (y, x), v in {(0, 0): (8, 0), (0, 1): (8, 4), (1, 0): (4, 0),
                      (1, 1): (0, 4), (2, 0): (0, 4), (2, 1): (8, 4),
                      (3, 0): (8, 4), (3, 1): (12, 8)}.items():
        mv_me[y, x] = v
    sad_me = np.full((nby, nbx), 10.0)
    sad_me[2, 1] = 500.0

    def shift(f, dy, dx):
        p = np.zeros((nby + 2, nbx + 2) + f.shape[2:], f.dtype)
        p[1:-1, 1:-1] = f
        return p[1 + dy:1 + dy + nby, 1 + dx:1 + dx + nbx]

    cand_mvs = np.stack([shift(mv_me, 0, -1), shift(mv_me, -1, 0),
                         shift(mv_me, -1, 1), np.zeros_like(mv_me)])
    cand_sads = np.full((4, nby, nbx), 10000.0)
    cand_sads[3, 2, 1] = 5.0
    return mv_me, sad_me, cand_mvs, cand_sads, None, 8.0, 1, (2,)


def _seeded(seed):
    rng = np.random.default_rng(seed)
    nby, nbx = 9, 7
    vals = np.array([-16, -4, 0, 4, 12], np.int64)
    mv_me = rng.choice(vals, (nby, nbx, 2))
    sad_me = rng.integers(50, 400, (nby, nbx)).astype(np.int64)
    cand_mvs = rng.choice(vals, (5, nby, nbx, 2))
    cand_sads = rng.integers(20, 500, (5, nby, nbx)).astype(np.int64)
    col = rng.choice(vals, (nby, nbx, 2))
    return mv_me, sad_me, cand_mvs, cand_sads, col, 6.0, 0, (3, 6)


@pytest.mark.parametrize("case,snap", [("crafted", True), ("seeded", True),
                                       ("seeded", False)])
def test_select_merge_p_substream_resets_match_jax(case, snap):
    (mv_me, sad_me, cand_mvs, cand_sads, col, lam, mer,
     starts) = _crafted() if case == "crafted" else _seeded(5)
    for st in ((), starts):
        args = (mv_me, sad_me, cand_mvs, cand_sads, col, lam, True, mer)
        got = inter_coder.select_merge_p(*args, snap=snap,
                                         substream_starts=st)
        want = jax_ic.select_merge_p(*args, snap=snap, substream_starts=st)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got[1].any()
        if not snap:     # only the ME MV merges: the field is unchanged
            np.testing.assert_array_equal(got[0], mv_me)
    # the resets matter on the crafted grids: the decoder replay of the
    # selection with resets reproduces its field (tests/test_wpp.py:120)
    if case == "crafted":
        final, mflag, midx = inter_coder.select_merge_p(
            *args, substream_starts=starts)
        dec = mv_me.copy()
        hist = inter_coder.HmvpList()
        for by in range(mv_me.shape[0]):
            if by in starts:
                hist = inter_coder.HmvpList()
            for bx in range(mv_me.shape[1]):
                if mflag[by, bx]:
                    cands = inter_coder.merge_candidates(
                        dec, by, bx, None, hist, mer_blocks_log2=mer)
                    dec[by, bx] = cands[int(midx[by, bx])]
                hist.push(dec[by, bx])
        np.testing.assert_array_equal(dec, final)


def test_substream_bounds_match_jax_encoder():
    """The HMVP reset rows EncLib hands the selection are the JAX
    encoder's (enclib.py:780-783) for every row count and substream
    count."""
    for nby in range(1, 40):
        for nsub in range(1, 9):
            n = max(1, min(nsub, nby))
            want = tuple(round(i * nby / n) for i in range(1, n))
            assert inter_coder.wpp_substream_starts(nby, nsub) == want


def test_wpp_threads_give_the_sequential_bytes():
    """Substreams coded on more threads than cores, the interpreter
    switching threads every microsecond: the framed payload is the
    sequential one (each substream its own coder; ex.map keeps row
    order), run after run."""
    import sys
    rng = np.random.default_rng(21)
    nby, nbx, s = 24, 6, 8
    mv, ly, lu = _grids(rng, nby, nbx, s)
    mflag = rng.random((nby, nbx)) < 0.4
    midx = rng.integers(0, 6, (nby, nbx)).astype(np.int32)
    kw = dict(use_tmvp=True, merge_flag=mflag, merge_idx=midx)
    bounds = intra_coder.wpp_bounds(nby, 24)
    want = intra_coder.wpp_frame([
        inter_coder.encode_p_slice(mv, ly, lu, lu, rows=(a, b), **kw)
        for a, b in zip(bounds[:-1], bounds[1:])])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(5):
            assert inter_coder.encode_p_slice_wpp(
                mv, ly, lu, lu, num_substreams=24, **kw) == want
    finally:
        sys.setswitchinterval(old)
