"""PyTorch port, the film grain SEI (ROADMAP queue 1 item 11d), against the
JAX package at tolerance 0.

  params    FilmGrainParams' SEI payload bytes equal the JAX writer's, and
            each package reads the other's back;
  analyze   seeded source/reconstruction pairs give the JAX analyzer's
            intervals (and its None where no band has grain), from host
            arrays and from tensors;
  grain     synthesize / apply_grain give the JAX synthesizer's samples (0
            differing) over every cutoff pair, several gains, POCs and
            bit depths, from host arrays and from tensors;
  stream    the port's CPU encode of tests/test_utility_apps.py:127's
            sequence (96x64 AI, QP 37, noisy luma) equals the committed
            JAX stream byte for byte, its DecLib decodes it with every MD5
            OK and parses the JAX decoder's FilmGrainParams, and the grain
            it applies to POC 0 has the JAX decoder's MD5.

No JAX program is compiled here.  Cost on one core: about 3 s."""
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import bitstream as jax_bs
from vvc_mm_tpu.common import film_grain as jax_fg
from vvc_mm_tpu_torch.common import bitstream
from vvc_mm_tpu_torch.common import film_grain as fg

from tests.make_torch_port_streams import (assert_tool_run,
                                           film_grain_record, plane_md5,
                                           port_tool_run)

torch.set_num_threads(1)

INTERVALS = dict(intervals_y=[(0, 63, 3, 7, 7), (64, 127, -2, 2, 11)],
                 intervals_cb=[(10, 200, 5, 0, 15)],
                 intervals_cr=[(128, 255, 1, 15, 0), (0, 127, 7, 5, 5)])


def _write(params, bw_cls):
    bw = bw_cls()
    params.write(bw)
    bw.align()
    return bw.get_bytes()


def test_film_grain_params_bytes_match_jax():
    for kw in (INTERVALS, dict(intervals_y=[(64, 127, 9, 7, 7)]), {}):
        p = fg.FilmGrainParams(log2_scale_factor=5, seed=70000, **kw)
        j = jax_fg.FilmGrainParams(log2_scale_factor=5, seed=70000, **kw)
        data = _write(p, bitstream.BitWriter)
        assert data == _write(j, jax_bs.BitWriter)
        back = fg.FilmGrainParams.read(bitstream.BitReader(data))
        jback = jax_fg.FilmGrainParams.read(jax_bs.BitReader(data))
        assert film_grain_record(back) == film_grain_record(jback)
        assert back.seed == 70000 & 0xFFFF


def _pair(rng, h, w, noise, flat=False):
    y = np.full((h, w), 100) if flat else rng.integers(0, 256, (h, w))
    recon = y.astype(np.int32)
    orig = np.clip(recon + rng.integers(-noise, noise + 1, (h, w)), 0, 255)
    return orig.astype(np.int32), recon


@pytest.mark.parametrize("noise,flat", [(6, False), (1, False), (9, True),
                                        (0, False)])
def test_analyze_matches_jax(noise, flat):
    rng = np.random.default_rng(noise + 100 * flat)
    orig, recon = _pair(rng, 64, 96, noise, flat)
    want = jax_fg.analyze(orig, recon)
    for o, r in ((orig, recon), (torch.from_numpy(orig),
                                 torch.from_numpy(recon))):
        assert film_grain_record(fg.analyze(o, r)) == \
            film_grain_record(want)
    assert (want is None) == (noise == 0)


@pytest.mark.parametrize("bd", [8, 10])
def test_apply_grain_matches_jax(bd):
    rng = np.random.default_rng(bd)
    maxv = (1 << bd) - 1
    planes = [rng.integers(0, maxv + 1, (72, 100)).astype(np.int32),
              rng.integers(0, maxv + 1, (36, 50)).astype(np.int32),
              rng.integers(0, maxv + 1, (36, 50)).astype(np.int32)]
    for fh, fv in ((0, 0), (3, 12), (15, 15)):
        kw = {k: [(lo, up, g, fh, fv) for (lo, up, g, _, _) in v]
              for k, v in INTERVALS.items()}
        p = fg.FilmGrainParams(seed=3 + fh, **kw)
        j = jax_fg.FilmGrainParams(seed=3 + fh, **kw)
        for poc in (0, 5):
            want = jax_fg.apply_grain(planes, j, poc, bd)
            for src in (planes, [torch.from_numpy(q) for q in planes]):
                got = fg.apply_grain(src, p, poc, bd)
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype
                    assert int((a != b).sum()) == 0


def test_film_grain_stream_matches_jax():
    run = port_tool_run("ai96x64_film_grain_qp37_2f")
    assert_tool_run(run)
    sd, dec = run["sd"], run["dec"]
    assert film_grain_record(dec.film_grain) == sd["film_grain_params"]
    assert film_grain_record(run["enc"].film_grain_params) == \
        sd["film_grain_params"]
    grain = fg.apply_grain(run["out"][0].planes, dec.film_grain, 0)
    assert plane_md5(grain) == sd["grain_poc0_md5"]
    assert not np.array_equal(grain[0], run["out"][0].numpy()[0])
