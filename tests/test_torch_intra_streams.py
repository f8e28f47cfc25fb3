"""PyTorch port, whole streams with the I picture's quantization and
transform tools against the JAX encoder's committed streams
(tests/make_torch_port_streams.py), QP 37, `realistic_sequence` content:

  ai192x96_rdoq_ts_bdpcm_qp37_2f   AI, RDOQ (not shadowed), transform skip,
                                   BDPCM;
  ai192x96_lfnst_dq_qp37_2f        AI, LFNST and dependent quantization
                                   without MTS;
  ai192x96_lossless_2f             AI, lossless: decoded == source;
  ldp192x96_scaling_qp37_4f        LDP, the steep scaling list on the one-
                                   and two-reference P pictures;
  erp256x128_ra_ctcpreset_qp37_5f  the headline tools (MPA+ROT, quadtree
                                   depth 1, RA GOP 4) with the CTC-like
                                   preset: TMVP, RDOQ, dependent
                                   quantization, MTS, LFNST;
  ai192x96_intra_pred_tools_qp37_2f        AI, the prediction tools CCLM,
                                   MIP, MRL and IBC;
  ai192x96_intra_pred_resid_tools_qp37_2f  the four with dependent
                                   quantization, MTS, LFNST, transform skip
                                   and BDPCM, the clip's left quarter screen
                                   content (the JAX encoder codes two MRL
                                   blocks that plain transform skip takes
                                   without the MRL flag but reconstructs
                                   them from ring 1: POC 0's MD5 fails in
                                   the JAX decoder, and the port's decode
                                   is held to the JAX decoder's instead);
  ai64x64_ibc_screen_qp30_1f       AI, QP 30, screen content, the four: IBC
                                   wins blocks.

For each: the port's CPU encode equals the committed stream byte for byte
(0 differing decisions: no count to pin), the port decodes it with every
MD5 OK and the encoder's reconstructions, and the JAX DecLib decodes the
port's stream bit-exactly.  The bench configuration 1 streams with these
tools decode in the port with every MD5 OK; their encodes (and the
832x480 and 2048x1024 streams) are held byte for byte by chip_smoke.py
phases 8k-8m.

Single-core cost: about 60 s (the 256x128 preset encode and the JAX
decoders' compiles)."""
import json
import os

import numpy as np
import pytest
import torch

from vvc_mm_tpu.decoder.declib import DecLib as JaxDecLib
from vvc_mm_tpu_torch.common import bitstream as bs
from vvc_mm_tpu_torch.common.slice_ps import SPS, MMConfig
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder.enclib import EncCfg, EncLib
from vvc_mm_tpu_torch.utils.content import realistic_sequence

from tests.make_torch_port_streams import (MIXED, SCREEN, STREAM_QP,
                                           mixed_sequence, screen_frame)

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
STEEP = tuple(int(16 + 2 * (x + y)) for y in range(8) for x in range(8))
PRESET = dict(tmvp=True, rdoq=True, dep_quant=True, mts=True, lfnst=True)
PRED = dict(cclm=True, mip=True, mrl=True, ibc=True)
RESID = dict(dep_quant=True, mts=True, lfnst=True, transform_skip=True,
             bdpcm=True)
# stream -> (width, height, gop, frames, EncCfg fields)
STREAMS = {
    "ai192x96_rdoq_ts_bdpcm_qp37_2f": (
        192, 96, "AI", 2, dict(rdoq=True, transform_skip=True, bdpcm=True)),
    "ai192x96_lfnst_dq_qp37_2f": (192, 96, "AI", 2,
                                  dict(lfnst=True, dep_quant=True)),
    "ai192x96_lossless_2f": (192, 96, "AI", 2, dict(lossless=True)),
    "ldp192x96_scaling_qp37_4f": (
        192, 96, "LDP", 4, dict(gop_size=4, search_range=24,
                                scaling_list=STEEP)),
    "erp256x128_ra_ctcpreset_qp37_5f": (
        256, 128, "RA", 5, dict(gop_size=4, qt_depth=1, search_range=24,
                                wrap_around=True,
                                mm=MMConfig(mpa=True, rot=True), **PRESET)),
    "ai192x96_intra_pred_tools_qp37_2f": (192, 96, "AI", 2, PRED),
    "ai192x96_intra_pred_resid_tools_qp37_2f": (192, 96, "AI", 2,
                                                dict(PRED, **RESID)),
    "ai64x64_ibc_screen_qp30_1f": (64, 64, "AI", 1, PRED),
}
NAMES = sorted(STREAMS)
# the SPS fields each stream must carry
SPS_FIELDS = {"ai192x96_rdoq_ts_bdpcm_qp37_2f": dict(ts=True, bdpcm=True),
              "ai192x96_lfnst_dq_qp37_2f": dict(lfnst=True, dep_quant=True),
              "ai192x96_lossless_2f": dict(lossless=True, deblocking=False),
              "ldp192x96_scaling_qp37_4f": dict(scaling_list=STEEP),
              "erp256x128_ra_ctcpreset_qp37_5f": dict(
                  tmvp=True, dep_quant=True, mts=True, lfnst=True),
              "ai192x96_intra_pred_tools_qp37_2f": PRED,
              "ai192x96_intra_pred_resid_tools_qp37_2f": dict(
                  PRED, dep_quant=True, mts=True, lfnst=True, ts=True,
                  bdpcm=True),
              "ai64x64_ibc_screen_qp30_1f": PRED}


def _frames(name: str, w: int, h: int, n: int):
    if name in SCREEN:
        return [screen_frame(w, h)] * n
    frames = realistic_sequence(w, h, n)
    return mixed_sequence(frames, MIXED[name]) if name in MIXED else frames


def _committed(name: str) -> tuple[bytes, dict]:
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        data = f.read()
    with open(os.path.join(DATA, name + ".json")) as f:
        return data, json.load(f)


@pytest.fixture(scope="module")
def runs():
    """name -> (EncLib, bytes, source frames) of the port's CPU encode,
    made on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            w, h, gop, n, fields = STREAMS[name]
            frames = _frames(name, w, h, n)
            enc = EncLib(EncCfg(width=w, height=h,
                                qp=STREAM_QP.get(name, 37), gop=gop,
                                **fields), device="cpu")
            cache[name] = (enc, enc.encode_sequence(frames), frames)
        return cache[name]
    return get


@pytest.mark.parametrize("name", NAMES)
def test_cpu_encode_equals_committed_stream(runs, name):
    enc, data, _ = runs(name)
    want, side = _committed(name)
    assert data == want
    sps = SPS.read(bs.BitReader(bs.read_annexb(data)[0].payload))
    for k, v in SPS_FIELDS[name].items():
        assert getattr(sps, k) == v, k
    assert [r.bits for r in sorted(enc.results, key=lambda r: r.poc)] == \
        [p["bits"] for p in side["pocs"]]
    if "intra_tool_blocks" in side:
        # every prediction tool is chosen in one stream or another; the
        # residual stream's TS/BDPCM pick overrides IBC and MRL choices
        used = side["intra_tool_blocks"]
        assert used["ibc"] > 0
        if name == "ai192x96_intra_pred_resid_tools_qp37_2f":
            assert used["ts_over_ibc"] > 0 and used["ts_over_mrl"] > 0
        if name == "ai192x96_intra_pred_tools_qp37_2f":
            assert min(used[k] for k in ("mip", "mrl", "cclm")) > 0


def _reference_verdicts(side: dict, n: int) -> dict:
    """The JAX decoder's MD5 verdicts on a committed stream: all OK but
    where its sidecar records the JAX encoder's own mismatch."""
    rec = side.get("jax_decoder_md5")
    return ({int(k): v for k, v in rec.items()} if rec
            else {p: "OK" for p in range(n)})


@pytest.mark.parametrize("name", NAMES)
def test_port_decodes_committed_stream(runs, name):
    enc, _, frames = runs(name)
    want, side = _committed(name)
    dec = DecLib(device="cpu")
    out = dec.decode_bytes(want)
    verdicts = _reference_verdicts(side, len(frames))
    assert dec.hash_status == verdicts
    if set(verdicts.values()) != {"OK"}:
        # the JAX encoder's reconstruction is no decoder's: the port's
        # decode is held to the JAX decoder's, picture for picture
        jdec = JaxDecLib()
        jout = jdec.decode_bytes(want)
        assert jdec.hash_status == verdicts
        for f, j in zip(out, jout):
            for got, ref in zip(f.numpy(), j.planes):
                np.testing.assert_array_equal(got, np.asarray(ref))
        assert side["intra_tool_blocks"]["ts1_over_mrl"] > 0
        return
    recon = {r.poc: r.recon for r in enc.results}
    for f in out:
        for got, ref in zip(f.numpy(), recon[f.poc]):
            np.testing.assert_array_equal(got, ref)
    if STREAMS[name][4].get("lossless"):
        for f in out:
            for got, src in zip(f.numpy(), frames[f.poc]):
                np.testing.assert_array_equal(got, src)


@pytest.mark.parametrize("name", NAMES)
def test_jax_decodes_port_stream(runs, name):
    _, data, frames = runs(name)
    dec = JaxDecLib()
    dec.decode_bytes(data)
    assert dec.hash_status == _reference_verdicts(_committed(name)[1],
                                                  len(frames))


@pytest.mark.parametrize("name", ["ai416x240_tools_qp37_2f",
                                  "ai416x240_lossless_2f",
                                  "ai416x240_intra_pred_dq_qp37_2f"])
def test_port_decodes_configuration_1_tool_streams(name):
    """Bench configuration 1 with dependent quantization, MTS, LFNST,
    transform skip and BDPCM, lossless, and the four prediction tools with
    dependent quantization: the committed JAX streams decode in the port
    with every MD5 OK (the lossless one to its source)."""
    data, side = _committed(name)
    dec = DecLib(device="cpu")
    out = dec.decode_bytes(data)
    assert dec.hash_status == {0: "OK", 1: "OK"}
    if side.get("lossless"):
        src = realistic_sequence(416, 240, 2)
        for f in out:
            for got, want in zip(f.numpy(), src[f.poc]):
                np.testing.assert_array_equal(got, want)
