"""PyTorch port, whole classic streams with the random-access tools against
the JAX encoder's committed streams (tests/make_torch_port_streams.py),
192x96, QP 37, search range 24, `realistic_sequence` content:

  ra192x96_ctc_tools_qp37_9f  RA, GOP 4, 9 frames: TMVP/HMVP, AMVR, GPM,
                              CIIP, BDOF, DMVR (POC 8 a two-reference P
                              anchor with TMVP and AMVR);
  ldp192x96_affine_qp37_4f    LDP, 4 frames, affine;
  ra192x96_fade_wp_qp37_9f    the fade (step 0.04), RA, GOP 4, 9 frames,
                              weighted prediction on P and B slices.

For each: the port's CPU encode equals the committed stream byte for byte,
the port decodes it with every MD5 OK (and the encoder's reconstructions),
and the JAX DecLib decodes the port's stream bit-exactly.  Each
configuration is encoded once per module, when a test first asks for it."""
import json
import os

import numpy as np
import pytest
import torch

from vvc_mm_tpu.decoder.declib import DecLib as JaxDecLib
from vvc_mm_tpu_torch.common import bitstream as bs
from vvc_mm_tpu_torch.common.slice_ps import SPS, SliceHeader
from vvc_mm_tpu_torch.common.typedefs import SliceType
from vvc_mm_tpu_torch.decoder import declib
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder.enclib import EncCfg, EncLib
from vvc_mm_tpu_torch.utils.content import fade_sequence, realistic_sequence

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
CTC = dict(tmvp=True, amvr=True, gpm=True, ciip=True, bdof=True, dmvr=True)
WPT = dict(weighted_pred=True, weighted_bipred=True, bdof=True, dmvr=True,
           gpm=True, ciip=True)
# stream -> (gop, frames, EncCfg tools, fade step)
STREAMS = {"ra192x96_ctc_tools_qp37_9f": ("RA", 9, CTC, None),
           "ldp192x96_affine_qp37_4f": ("LDP", 4, dict(affine=True), None),
           "ra192x96_fade_wp_qp37_9f": ("RA", 9, WPT, 0.04)}
NAMES = sorted(STREAMS)


@pytest.fixture(scope="module")
def runs():
    """name -> the port's CPU encode (EncLib, bytes), made on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            gop, n, tools, fade = STREAMS[name]
            frames = realistic_sequence(192, 96, n)
            if fade:
                frames = fade_sequence(frames, fade)
            enc = EncLib(EncCfg(width=192, height=96, qp=37, gop=gop,
                                gop_size=4, search_range=24, **tools),
                         device="cpu")
            cache[name] = (enc, enc.encode_sequence(frames))
        return cache[name]
    return get


def _committed(name):
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        data = f.read()
    with open(os.path.join(DATA, name + ".json")) as f:
        return data, json.load(f)


def _headers(data):
    nals = bs.read_annexb(data)
    sps = SPS.read(bs.BitReader(nals[0].payload))
    return sps, [SliceHeader.read(bs.BitReader(n.payload), sps)
                 for n in nals if n.nal_type in (bs.NAL_IDR, bs.NAL_TRAIL)]


@pytest.mark.parametrize("name", NAMES)
def test_tools_sequence_equals_the_committed_jax_stream(runs, name):
    want, side = _committed(name)
    gop, n, tools, fade = STREAMS[name]
    assert (side["gop"], side["frames"], side.get("fade")) == (gop, n, fade)
    assert all(side[k] for k in tools)
    _, got = runs(name)
    assert got == want
    sps, headers = _headers(got)
    assert all(getattr(sps, k) for k in tools if k not in (
        "weighted_pred", "weighted_bipred"))
    two_ref = [h.poc for h in headers if len(h.ref_pocs_l0) == 2]
    assert two_ref == {"ra192x96_ctc_tools_qp37_9f": [8],
                       "ldp192x96_affine_qp37_4f": [],
                       "ra192x96_fade_wp_qp37_9f": [8]}[name]


@pytest.mark.parametrize("name", NAMES)
def test_port_decodes_the_committed_tools_stream(runs, name):
    enc, _ = runs(name)
    dec = DecLib(device="cpu")
    frames = dec.decode_bytes(_committed(name)[0])
    assert dec.hash_status == {p: "OK" for p in range(STREAMS[name][1])}
    for f, r in zip(frames, sorted(enc.results, key=lambda r: r.poc)):
        for a, b in zip(f.numpy(), r.recon):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_jax_decodes_the_port_tools_stream(runs, name):
    enc, data = runs(name)
    jdec = JaxDecLib()
    frames = jdec.decode_bytes(data)
    assert jdec.hash_status == {p: "OK" for p in range(STREAMS[name][1])}
    for f, r in zip(frames, sorted(enc.results, key=lambda r: r.poc)):
        for a, b in zip(f.planes, r.recon):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_weighted_slices_gate_the_b_tools(runs, monkeypatch):
    """Every inter slice of the fade carries weight tables (the fade
    changes the level by 4% a picture), so the decoder takes BDOF, DMVR,
    GPM and CIIP off on each B slice; the RA stream without weights keeps
    them, and its B pictures code GPM blocks."""
    seen = []
    real = declib.decode_b_slice

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append((kw["use_gpm"], kw["use_ciip"],
                     np.bincount(out[2].ravel(), minlength=5).tolist()))
        return out
    monkeypatch.setattr(declib, "decode_b_slice", spy)
    _, headers = _headers(runs("ra192x96_fade_wp_qp37_9f")[1])
    kinds = [(h.slice_type, h.wp_params is not None,
              h.wp_params_l1 is not None) for h in headers[1:]]
    assert kinds.count((SliceType.P, True, False)) == 2
    assert kinds.count((SliceType.B, True, True)) == 6
    DecLib(device="cpu").decode_bytes(runs("ra192x96_fade_wp_qp37_9f")[1])
    assert [s[:2] for s in seen] == [(False, False)] * 6
    seen.clear()
    DecLib(device="cpu").decode_bytes(runs("ra192x96_ctc_tools_qp37_9f")[1])
    assert [s[:2] for s in seen] == [(True, True)] * 6
    assert sum(s[2][3] for s in seen) > 0


def test_affine_stream_codes_affine_blocks(runs, monkeypatch):
    """Affine blocks by P picture of the committed stream (of 72 each)."""
    seen = []
    real = declib.decode_p_slice_affine

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(int(out[1].sum()))
        return out
    monkeypatch.setattr(declib, "decode_p_slice_affine", spy)
    DecLib(device="cpu").decode_bytes(runs("ldp192x96_affine_qp37_4f")[1])
    assert seen == [2, 3, 0]
