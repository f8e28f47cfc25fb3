"""PyTorch port, the slice as a whole: `EncLib(cfg, device="cpu")
.encode_sequence(frames)` against the JAX package.

(a) 256x128, 5 frames, RA with GOP 4 and the QP cascade: the Annex-B bytes
    equal the committed `erp256x128_ra_mm_qp37_5f.bin`, which is the JAX
    encoder's `encode_sequence` output for the same source (so no JAX
    encode runs here): parameter sets, I picture, P and B pictures and
    every hash SEI, byte for byte.
(b) 6 frames at GOP 4 (two anchors: the second is handed the first as its
    second reference, and the device DPB is pruned): the stream decodes to
    hash OK x6 in the port's DecLib and in the JAX DecLib.
(c) gop="AI", 2 frames at 64x32: equal to the JAX encoder's stream byte for
    byte (I picture with deblocking, SAO and ALF, headers, hash SEIs).
(d) gop="LDP", 3 frames at 64x32: decodes to hash OK x3 in both decoders.
"""
import os

import numpy as np
import pytest
import torch

from vvc_mm_tpu.common.slice_ps import MMConfig as JaxMMConfig
from vvc_mm_tpu.decoder.declib import DecLib as JaxDecLib
from vvc_mm_tpu.encoder import enclib as jax_enclib
from vvc_mm_tpu_torch.common import bitstream as bs
from vvc_mm_tpu_torch.common.slice_ps import MMConfig
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder.enclib import EncCfg, EncLib
from vvc_mm_tpu_torch.utils.content import realistic_sequence

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
STREAM = os.path.join(DATA, "erp256x128_ra_mm_qp37_5f.bin")


def _cfg(cls, mm_cls, w=256, h=128, **kw):
    args = dict(width=w, height=h, qp=37, gop="RA", gop_size=4, qt_depth=1,
                inter_block_size=16, search_range=24, wrap_around=True,
                merge=True, mm=mm_cls(mpa=True, rot=True))
    args.update(kw)
    return cls(**args)


@pytest.fixture(scope="module")
def ra5():
    enc = EncLib(_cfg(EncCfg, MMConfig), device="cpu")
    src = realistic_sequence(256, 128, 5)
    return dict(enc=enc, src=src, data=enc.encode_sequence(src))


def test_sequence_equals_the_committed_jax_stream(ra5):
    want = open(STREAM, "rb").read()
    got_nals, want_nals = bs.read_annexb(ra5["data"]), bs.read_annexb(want)
    assert [n.nal_type for n in got_nals] == [n.nal_type for n in want_nals]
    for i, (a, b) in enumerate(zip(got_nals, want_nals)):
        assert a.temporal_id == b.temporal_id, i
        assert a.payload == b.payload, f"NAL {i} (type {a.nal_type})"
    assert ra5["data"] == want
    assert [n.nal_type for n in got_nals[:4]] == [bs.NAL_SPS, bs.NAL_PPS,
                                                  bs.NAL_IDR, bs.NAL_SEI]


def test_sequence_results_and_summary(ra5):
    enc = ra5["enc"]
    assert [r.poc for r in enc.results] == [0, 1, 2, 3, 4]
    s = enc.summary()
    assert s["frames"] == 5 and s["fps"] > 0
    assert s["bits"] == sum(r.bits for r in enc.results)
    assert enc.results[0].bits > max(r.bits for r in enc.results[1:])
    assert enc._dpb_dev == {}            # nothing is needed any more
    dec = DecLib(device="cpu")
    frames = dec.decode_bytes(ra5["data"])
    assert dec.hash_status == {p: "OK" for p in range(5)}
    for f, r in zip(frames, enc.results):
        for a, b in zip(f.numpy(), r.recon):
            np.testing.assert_array_equal(a, b)


def test_headers_equal_jax(ra5):
    jenc = jax_enclib.EncLib(_cfg(jax_enclib.EncCfg, JaxMMConfig))
    got, want = ra5["enc"].encode_headers(), jenc.encode_headers()
    assert [(n.nal_type, n.temporal_id, n.payload) for n in got] == \
        [(n.nal_type, n.temporal_id, n.payload) for n in want]
    assert [n.nal_type for n in got] == [bs.NAL_SPS, bs.NAL_PPS]


def test_second_reference_is_accepted_and_ignored(ra5):
    """encode_p_frame takes the JAX signature's ref2 / ref2_poc; with a
    multi-model configuration the JAX package ignores them, and so do the
    bytes here."""
    src, rec0 = ra5["src"], ra5["enc"].results[0].recon
    nals = []
    for kw in ({}, dict(ref2=rec0, ref2_poc=0)):
        enc = EncLib(_cfg(EncCfg, MMConfig), device="cpu")
        nal, res = enc.encode_p_frame(4, src[4], rec0, 0, qp=38, **kw)
        assert res.poc == 4
        nals.append(nal)
    assert nals[0].payload == nals[1].payload
    assert nals[0].nal_type == bs.NAL_TRAIL


@pytest.fixture(scope="module")
def ra6():
    """Six frames, GOP 4: the anchors are POC 4 and POC 5."""
    enc = EncLib(_cfg(EncCfg, MMConfig), device="cpu")
    calls, kept = [], []
    p_frame = enc.encode_p_frame

    def spy(poc, planes, ref, ref_poc, qp=None, ref2=None, ref2_poc=-1):
        calls.append((poc, ref_poc, ref2 is not None, ref2_poc, qp))
        out = p_frame(poc, planes, ref, ref_poc, qp=qp, ref2=ref2,
                      ref2_poc=ref2_poc)
        kept.append(sorted(enc._dpb_dev))
        return out

    enc.encode_p_frame = spy
    data = enc.encode_sequence(realistic_sequence(256, 128, 6))
    return dict(enc=enc, data=data, calls=calls, kept=kept)


def test_two_anchor_sequence_passes_ref2_and_prunes_the_dpb(ra6):
    assert ra6["calls"] == [(4, 0, False, -1, 38), (5, 4, True, 0, 38)]
    # inside the second anchor's call the DPB holds what it refers to
    assert ra6["kept"][1] == [0, 4, 5]
    assert ra6["enc"]._dpb_dev == {}
    order = [n for n in bs.read_annexb(ra6["data"])
             if n.nal_type in (bs.NAL_IDR, bs.NAL_TRAIL)]
    assert len(order) == 6
    # the hash SEI of a B picture rides its temporal id
    seis = [n.temporal_id for n in bs.read_annexb(ra6["data"])
            if n.nal_type == bs.NAL_SEI]
    assert seis == [0, 0, 1, 2, 2, 0]


def test_two_anchor_sequence_decodes_in_the_port(ra6):
    dec = DecLib(device="cpu")
    frames = dec.decode_bytes(ra6["data"])
    assert dec.hash_status == {p: "OK" for p in range(6)}
    assert [f.poc for f in frames] == list(range(6))


def test_two_anchor_sequence_decodes_in_the_jax_decoder(ra6):
    dec = JaxDecLib()
    dec.decode_bytes(ra6["data"])
    assert dec.hash_status == {p: "OK" for p in range(6)}


def _small(n):
    return realistic_sequence(64, 32, n)


def test_all_intra_sequence_equals_jax_byte_for_byte():
    kw = dict(w=64, h=32, gop="AI")
    src = _small(2)
    enc = EncLib(_cfg(EncCfg, MMConfig, **kw), device="cpu")
    got = enc.encode_sequence(src)
    want = jax_enclib.EncLib(
        _cfg(jax_enclib.EncCfg, JaxMMConfig, **kw)).encode_sequence(src)
    for i, (a, b) in enumerate(zip(bs.read_annexb(got),
                                   bs.read_annexb(want))):
        assert a.payload == b.payload, f"NAL {i} (type {a.nal_type})"
    assert got == want
    assert [n.nal_type for n in bs.read_annexb(got)] == [
        bs.NAL_SPS, bs.NAL_PPS, bs.NAL_IDR, bs.NAL_SEI, bs.NAL_IDR,
        bs.NAL_SEI]
    assert [r.poc for r in enc.results] == [0, 1]


def test_low_delay_sequence_decodes_in_both_decoders():
    """The AI/LDP loop: I, P, P with the last two reconstructions kept on
    the device; a single frame under RA takes the same loop."""
    enc = EncLib(_cfg(EncCfg, MMConfig, w=64, h=32, gop="LDP"),
                 device="cpu")
    data = enc.encode_sequence(_small(3))
    assert sorted(enc._dpb_dev) == [1, 2]
    kinds = [n.nal_type for n in bs.read_annexb(data)
             if n.nal_type != bs.NAL_SEI]
    assert kinds == [bs.NAL_SPS, bs.NAL_PPS, bs.NAL_IDR, bs.NAL_TRAIL,
                     bs.NAL_TRAIL]
    for lib in (DecLib(device="cpu"), JaxDecLib()):
        lib.decode_bytes(data)
        assert lib.hash_status == {0: "OK", 1: "OK", 2: "OK"}
    one = EncLib(_cfg(EncCfg, MMConfig, w=64, h=32), device="cpu")
    nals = bs.read_annexb(one.encode_sequence(_small(1)))
    assert [n.nal_type for n in nals] == [bs.NAL_SPS, bs.NAL_PPS,
                                          bs.NAL_IDR, bs.NAL_SEI]
