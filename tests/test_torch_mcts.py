"""PyTorch port, motion-constrained tile sets (ROADMAP queue 1 item 11b)
and lost-picture concealment (item 11e), against the JAX package at
tolerance 0.

  clamps    mcts_clamp_mvs and mcts_clamp on seeded MV fields (tests/
            test_mcts.py's 2x2 tiles at 16x16 blocks, and other grids)
            equal common/inter_frame.py's, and every clamped MV's 8-tap
            support stays in its tile;
  stream    the port's CPU encode of tests/test_mcts.py:49's sequence
            (128x64 LDP, 2x1 tiles, ALF off) equals the committed JAX
            stream byte for byte, and its DecLib decodes it with every MD5
            OK and reads the MCTS SEI's tile grid;
  conceal   tests/test_apps.py:98's stream (96x64 LDP, no hash SEI) with
            POC 1's slice NAL dropped: the port conceals POC 1 and decodes
            POCs 0, 2 and 3 to the JAX decoder's pictures; the nearest
            picture (the first in decoding order on a tie) is cloned once
            and kept; an empty DPB raises KeyError, as in JAX.

The clamps run op by op in the JAX package (no jit).  Cost on one core:
about 3 s."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import inter_frame as jif
from vvc_mm_tpu.decoder import declib as jax_declib
from vvc_mm_tpu_torch.common import inter_frame as tif
from vvc_mm_tpu_torch.decoder.declib import DecLib, DecodedFrame

from tests.make_torch_port_streams import (assert_tool_run, drop_first_trail,
                                           plane_md5, port_tool_run)

torch.set_num_threads(1)

# (block size, width, height, tile cols, tile rows)
GRIDS = [(16, 256, 128, 2, 2), (16, 128, 64, 2, 1), (8, 96, 64, 3, 2),
         (32, 832, 480, 2, 2)]


def _support_in_tile(mv, b, s, t0, extent):
    lo = b + (int(mv) >> 4) - 3
    hi = b + ((int(mv) + 15) >> 4) + s + 4
    return lo >= t0 and hi <= t0 + extent


@pytest.mark.parametrize("grid", GRIDS, ids=[f"{g[1]}x{g[2]}s{g[0]}t{g[3]}"
                                             f"x{g[4]}" for g in GRIDS])
def test_mcts_clamps_match_jax(grid):
    s, w, h, cols, rows = grid
    nby, nbx = h // s, w // s
    rng = np.random.default_rng(3 + s)
    mvs = rng.integers(-40 * 16, 40 * 16, (nby, nbx, 2)).astype(np.int32)
    for field in (mvs, np.zeros_like(mvs) + 8):
        got = tif.mcts_clamp_mvs(torch.from_numpy(field), s, w, h, cols,
                                 rows)
        want = np.asarray(jif.mcts_clamp_mvs(jnp.asarray(field), s, w, h,
                                             cols, rows))
        np.testing.assert_array_equal(got.numpy(), want)
        got2 = tif.mcts_clamp(torch.from_numpy(field), s, w, h,
                              (cols, rows))
        want2 = np.asarray(jif.mcts_clamp(jnp.asarray(field), s, w, h,
                                          (cols, rows)))
        np.testing.assert_array_equal(got2.numpy(), want2)
    tw, th = w // cols, h // rows
    out = got.numpy()
    for by in range(nby):
        for bx in range(nbx):
            x, y = bx * s, by * s
            if tw >= s + 16 and th >= s + 16:
                assert _support_in_tile(out[by, bx, 0], x, s,
                                        (x // tw) * tw, tw)
                assert _support_in_tile(out[by, bx, 1], y, s,
                                        (y // th) * th, th)


def test_mcts_stream_matches_jax():
    run = port_tool_run("ldp128x64_mcts_qp32_3f")
    assert_tool_run(run)
    assert run["dec"].mcts_tiles == tuple(run["sd"]["jax_decoder_mcts_tiles"])
    assert run["dec"].mcts_tiles == (2, 1)


def test_concealed_decode_matches_jax():
    name = "ldp96x64_conceal_qp35_4f"
    run = port_tool_run(name)
    assert_tool_run(run)
    rec = run["sd"]["concealed"]
    dec = DecLib(device="cpu")
    out = dec.decode_bytes(drop_first_trail(run["committed"]))
    assert dec.concealed == rec["concealed"] == [1]
    assert [f.poc for f in out] == rec["pocs"] == [0, 2, 3]
    assert [plane_md5(f.numpy()) for f in out] == rec["md5"]
    assert {str(k): v for k, v in dec.hash_status.items()} == \
        rec["hash_status"]


def test_concealment_rule_matches_jax():
    """The nearest decoded picture is cloned, the first in decoding order
    on a tie; a concealed POC is cloned once; no picture -> KeyError."""
    rng = np.random.default_rng(9)
    pics = {poc: [rng.integers(0, 256, (8, 8)).astype(np.int32)
                  for _ in range(3)] for poc in (4, 0, 8)}
    port, jax_dec = DecLib(device="cpu"), jax_declib.DecLib()
    for exc_dec in (port, jax_dec):
        with pytest.raises(KeyError):
            exc_dec._ref_by_poc(3)
    for poc, planes in pics.items():         # decoding order 4, 0, 8
        port.frames.append(DecodedFrame(poc, [torch.from_numpy(p)
                                              for p in planes]))
        jax_dec.frames.append(jax_declib.DecodedFrame(poc, planes))
    for poc in (2, 6, 3, 12, 2, 4):
        got, want = port._ref_by_poc(poc), jax_dec._ref_by_poc(poc)
        assert got.poc == want.poc == poc
        for a, b in zip(got.planes, want.planes):
            np.testing.assert_array_equal(a.numpy(), b)
    assert port.concealed == jax_dec.concealed == [2, 6, 3, 12]
    assert port._ref_by_poc(2) is port._ref_by_poc(2)
    assert port._ref_by_poc(4) is port.frames[0]
