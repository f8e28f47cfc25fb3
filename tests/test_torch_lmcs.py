"""PyTorch port, LMCS — the luma reshaper (ROADMAP queue 1 item 11c),
against the JAX package at tolerance 0.

  LUTs      estimate_codewords, build_fwd_lut and build_inv_lut at 8 and
            10 bits on seeded planes and on seeded codeword vectors (every
            segment count from 1 up), and map_plane on host arrays and on
            tensors, against common/reshape.py;
  stream    the port's CPU encode of tests/test_lmcs.py:33's sequence
            (64x64 LDP, QP 34) equals the committed JAX stream byte for
            byte; the port's DecLib decodes it with every MD5 OK, reads
            the SPS's 16 codeword counts, and its output_frames (the
            display domain) equal the JAX decoder's; the encoder's
            display-domain pictures and their Y-PSNR against the true
            source equal the JAX encoder's.

No JAX program is compiled here.  Cost on one core: about 2 s."""
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import reshape as jax_reshape
from vvc_mm_tpu_torch.common import reshape

from tests.make_torch_port_streams import (assert_tool_run, plane_md5,
                                           port_tool_run)

torch.set_num_threads(1)


def _codeword_vectors(rng, bd: int, n: int):
    """Seeded codeword vectors of 16 positive counts summing to 1 << bd,
    from nearly flat to one dominant segment."""
    out = []
    for k in range(n):
        w = rng.random(16) ** (1 + 3 * k)
        cw = np.maximum(1, np.floor(w / w.sum() * (1 << bd))).astype(np.int64)
        cw[int(np.argmax(cw))] += (1 << bd) - cw.sum()
        out.append(cw.astype(np.int32))
    return out


@pytest.mark.parametrize("bd", [8, 10])
def test_luts_match_jax(bd):
    rng = np.random.default_rng(40 + bd)
    maxv = (1 << bd) - 1
    planes = [np.clip(rng.normal(m * maxv, s * maxv, (64, 64)), 0,
                      maxv).astype(np.int32)
              for m, s in ((0.4, 0.06), (0.5, 0.25), (0.8, 0.02))]
    cws = [reshape.estimate_codewords(p, bd) for p in planes]
    for p, cw in zip(planes, cws):
        np.testing.assert_array_equal(
            cw, jax_reshape.estimate_codewords(p, bd))
        assert cw.sum() == 1 << bd and (cw >= 1).all()
    for cw in cws + _codeword_vectors(rng, bd, 6):
        fwd = reshape.build_fwd_lut(cw, bd, "cpu")
        inv = reshape.build_inv_lut(cw, bd, "cpu")
        jfwd = jax_reshape.build_fwd_lut(cw, bd)
        jinv = jax_reshape.build_inv_lut(cw, bd)
        np.testing.assert_array_equal(fwd.numpy(), jfwd)
        np.testing.assert_array_equal(inv.numpy(), jinv)
        for plane in planes:
            host = reshape.map_plane(fwd, plane)
            assert host.dtype == np.int32
            np.testing.assert_array_equal(host, jfwd[plane])
            dev = reshape.map_plane(inv, torch.from_numpy(plane))
            np.testing.assert_array_equal(dev.numpy(), jinv[plane])


def test_lmcs_stream_matches_jax():
    run = port_tool_run("ldp64x64_lmcs_qp34_3f")
    assert_tool_run(run)
    sd, dec, enc = run["sd"], run["dec"], run["enc"]
    assert dec.sps.lmcs and list(dec.sps.lmcs_cw) == sd["lmcs_cw"]
    assert [plane_md5(f.numpy()) for f in dec.output_frames()] == \
        sd["output_md5"]
    res = sorted(enc.results, key=lambda r: r.poc)
    assert [plane_md5(r.output) for r in res] == sd["encoder_output_md5"]
    # the display domain is the source's: the Y-PSNR is scored on it
    for r, f in zip(res, run["frames"]):
        assert r.recon_out is not None
        assert np.mean(np.abs(r.recon_out[0] - f[0])) < 8.0
