"""PyTorch port, the two-level intra partitioning (common/intra_part.py:
16x16 superblocks against four 8x8 sub-blocks), against the JAX package
on the same seeded numpy inputs, tolerance 0.

  frames    encode_intra_frame_part (the JAX program, jitted as the JAX
            encoder runs it) at 64x32 and 128x64: the split, the 16x16 and
            8x8 modes and levels of every superblock and the
            reconstruction; decode_intra_frame_part on the JAX decisions
            gives the JAX reconstruction;
  syntax    encode_intra_slice_part gives the JAX writer's bytes, and
            decode_intra_slice_part reads them back to the JAX parser's
            grids;
  streams   the port's CPU encode of ai64x32_intra_split_qp37_2f equals
            the JAX encoder's committed stream byte for byte, and the
            port decodes it with every MD5 OK (0 differing decisions: no
            count to pin);
  property  flat sky over detail uses both sizes (tests/test_intra_part.py's
            scene), and the split picture codes in fewer bits than the
            fixed 8x8 grid at a Y-PSNR within 0.25 dB.

Cost on one core: about 25 s (the JAX programs' compiles)."""
import json
import os

import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import intra_part as jp
from vvc_mm_tpu.decoder import intra_parser as jax_parser
from vvc_mm_tpu.encoder import intra_coder as jax_coder
from vvc_mm_tpu_torch.common import intra_part as tp
from vvc_mm_tpu_torch.common.wavefront import steps_to_grid, wavefront_coords
from vvc_mm_tpu_torch.decoder import intra_parser
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder import intra_coder
from vvc_mm_tpu_torch.encoder.enclib import EncCfg, EncLib
from vvc_mm_tpu_torch.utils.content import realistic_sequence

from tests.make_torch_port_streams import port_cfg
from tests.test_torch_qtree import _j, _md5, _np, _t, assert_same

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
STREAM = "ai64x32_intra_split_qp37_2f"
CASES = {(64, 32): 32, (128, 64): 27}     # size -> QP


def _grids(outs, w, h):
    coords, valid = wavefront_coords(h // tp.SB, w // tp.SB)
    return [steps_to_grid(_np(o), coords, valid) for o in outs]


@pytest.fixture(scope="module")
def port_runs():
    out = {}
    for (w, h), qp in CASES.items():
        planes = realistic_sequence(w, h, 1)[0]
        out[(w, h)] = (planes, tp.encode_intra_frame_part(*_t(planes), qp))
    return out


@pytest.mark.parametrize("size", list(CASES))
def test_encode_intra_frame_part_equals_jax(port_runs, size):
    w, h = size
    planes, (outs, recon) = port_runs[size]
    jouts, jrecon = jp.encode_intra_frame_part(*_j(planes), CASES[size], 8)
    assert_same(_grids(outs, w, h), _grids(jouts, w, h))
    assert_same(recon, jrecon)
    dec = tp.decode_intra_frame_part(*_np(jouts), CASES[size], h, w, 8,
                                     device="cpu")
    assert_same(dec, jrecon)


@pytest.mark.parametrize("size", list(CASES))
def test_slice_writer_and_parser_equal_jax(port_runs, size):
    w, h = size
    grids = _grids(port_runs[size][1][0], w, h)
    data = intra_coder.encode_intra_slice_part(*grids)
    assert data == jax_coder.encode_intra_slice_part(*grids)
    got = intra_parser.decode_intra_slice_part(data, h // tp.SB, w // tp.SB)
    assert_same(got, jax_parser.decode_intra_slice_part(data, h // tp.SB,
                                                        w // tp.SB))
    split = grids[0]
    assert_same(got[0], split)
    assert_same(got[1][split == 0], grids[1][split == 0])
    assert_same(got[2][split == 1], grids[2][split == 1])


def test_both_sizes_used():
    """Flat sky over a detailed lower half: 16x16 blocks and 8x8 splits."""
    rng = np.random.default_rng(5)
    y = np.full((64, 64), 120, np.int32)
    y[32:, :] = rng.integers(0, 255, size=(32, 64))
    u = np.full((32, 32), 128, np.int32)
    outs, _ = tp.encode_intra_frame_part(*_t((y, u, u)), 32)
    split = _grids(outs, 64, 64)[0]
    assert (split == 0).any() and (split == 1).any()


def test_split_beats_fixed_grid():
    frames = realistic_sequence(128, 64, 2)
    runs = []
    for split in (False, True):
        enc = EncLib(EncCfg(width=128, height=64, qp=37, gop="AI",
                            intra_split=split), device="cpu")
        enc.encode_sequence(frames)
        runs.append(enc.summary())
    assert runs[1]["bits"] < runs[0]["bits"]
    assert runs[1]["psnr_y"] > runs[0]["psnr_y"] - 0.25


def test_cpu_encode_equals_committed_stream():
    sd = json.load(open(os.path.join(DATA, STREAM + ".json")))
    enc = EncLib(port_cfg(STREAM), device="cpu")
    got = enc.encode_sequence(realistic_sequence(sd["width"], sd["height"],
                                                 sd["frames"]))
    assert got == open(os.path.join(DATA, STREAM + ".bin"), "rb").read()
    assert {r.poc: _md5(r.recon) for r in enc.results} == \
        {p["poc"]: p["md5"] for p in sd["pocs"]}


def test_port_decodes_committed_stream():
    sd = json.load(open(os.path.join(DATA, STREAM + ".json")))
    dec = DecLib(device="cpu")
    frames = dec.decode_bytes(open(os.path.join(DATA, STREAM + ".bin"),
                                   "rb").read())
    assert dec.hash_status == {p["poc"]: "OK" for p in sd["pocs"]}
    assert [f.md5() for f in frames] == [p["md5"] for p in sd["pocs"]]
