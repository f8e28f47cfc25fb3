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
(e) bench configurations 3 (MPA, flat grid) and 4 (MPA+GED+ROT+MMMVP with
    the epipole (1, 0, 0, 0, 1), flat grid), and 4 with the off-pole
    epipole (4, 0, 0.3, -0.5, 0.8), at 256x128 against the committed JAX
    streams: configuration 4 and its variant byte for byte, and every
    committed stream decodes in the port, every port stream in the JAX
    DecLib.  Configuration 3 is byte for byte too: its one B-picture
    subblock position (POC 2, list 1, MPA top/bottom near the pole) that
    rounded one 1/16 pel away from XLA's while the port used torch's
    math library (ROADMAP queue 3 fault 1) now rounds as XLA's, with
    glibc's float32 sin/cos/tan/atan2 copied (common/libm_f32.py) and the
    jit's compiled float32 form of the MPA motion.  The same configuration with merge off decodes in
    both decoders.  Configuration 4 plus 3DT, TAN and projected DMVR
    (`allmm_dmvr`, 8 active models) is byte for byte too; fed JAX's
    positions, projected DMVR's candidates among them, the port decodes
    the committed stream as well.
(f) the classic (single-model) inter path at 192x96 against the committed
    JAX streams of tests/make_torch_port_streams.py: RA GOP 4 with 9
    frames (POC 8 a two-reference P anchor), LDP with 4 frames (POC 2 and
    3 two-reference P pictures), RA with merge off and RA with BDOF and
    DMVR: the port's CPU encode equals each byte for byte, the port
    decodes each with every MD5 OK, and the JAX DecLib decodes the port's
    LDP and BDOF+DMVR streams bit-exactly.  Bench configuration 1 (AI,
    416x240, 2 frames) equals its committed JAX stream byte for byte.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common.mm import frame_codec as jax_fc
from vvc_mm_tpu.common.mm import mc as jax_mc
from vvc_mm_tpu.common.mm.reprojection import MVReprojection as JaxReproj
from vvc_mm_tpu.common.slice_ps import MMConfig as JaxMMConfig
from vvc_mm_tpu.decoder.declib import DecLib as JaxDecLib
from vvc_mm_tpu.encoder import enclib as jax_enclib
from vvc_mm_tpu.lib360.projection import ERP as JaxERP
from vvc_mm_tpu_torch.common import bitstream as bs
from vvc_mm_tpu_torch.common.mm import epipole
from vvc_mm_tpu_torch.common.slice_ps import SPS, MMConfig, SliceHeader
from vvc_mm_tpu_torch.common.typedefs import SliceType
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


# ----------------------------------------------- bench configurations 3, 4

# name -> (MMConfig fields, epipoles, EncCfg fields beside the models):
# the configurations of tests/make_torch_port_streams.py, flat grid, merge
# on
BENCH = {
    "mpa": (dict(mpa=True), [], {}),
    "fullmm": (dict(mpa=True, ged=True, rot=True, mmmvp=True),
               [(1, 0, 0.0, 0.0, 1.0)], {}),
    "fullmm_ep": (dict(mpa=True, ged=True, rot=True, mmmvp=True),
                  [(4, 0, 0.3, -0.5, 0.8)], {}),
    "allmm_dmvr": (dict(mpa=True, t3d=True, tan=True, rot=True, ged=True,
                        mmmvp=True), [(1, 0, 0.0, 0.0, 1.0)],
                   dict(dmvr=True)),
}
# NAL indices (0 SPS, 1 PPS, 2 IDR, 3 its SEI, then slice and SEI of POC
# 4, 2, 1, 3) where the port's CPU stream differs from the committed JAX
# one, and the port decoder's MD5 verdicts on the committed stream where
# they are not all OK: none since ROADMAP queue 3 fault 1 closed for MPA
NAL_DIFFS = {"mpa": [], "fullmm": [], "fullmm_ep": [], "allmm_dmvr": []}
OWN_POSITIONS_HASH: dict = {}


def _bench_cfg(cls, mm_cls, name, **kw):
    mm, eps, tools = BENCH[name]
    return _cfg(cls, mm_cls, qt_depth=0, mm=mm_cls(**mm), epipoles=list(eps),
                **tools, **kw)


def _bench_stream(name):
    return open(os.path.join(DATA, f"erp256x128_ra_{name}_qp37_5f.bin"),
                "rb").read()


@pytest.fixture(scope="module")
def bench_runs():
    src = realistic_sequence(256, 128, 5)
    out = {}
    for name in BENCH:
        enc = EncLib(_bench_cfg(EncCfg, MMConfig, name), device="cpu")
        out[name] = dict(enc=enc, data=enc.encode_sequence(src))
    return out


def _jax_positions(w=256, h=128):
    """A DecLib positions_fn giving the JAX decoder's merged positions,
    and for projected DMVR's candidates (a one-model list at a row step)
    the JAX package's one-model positions under jax.jit."""
    jr = JaxReproj(JaxERP(w, h), w, h, 1, 1)

    def fn(active, midx, stack, block_size, epipoles, row_step):
        stack = jnp.asarray(np.asarray(stack, np.int32))
        if row_step == 1:
            return np.array(jax_fc.merged_positions(
                jr, active, jnp.asarray(np.asarray(midx, np.int32)), stack,
                block_size, epipoles))
        (model,) = active
        ep = (epipoles or {}).get(model)
        if model == 0:
            return np.array(jax_mc.classic_positions(
                jr.offset, w, h, stack[0], block_size, row_step))
        return np.array(jax.jit(lambda mvs: jr.reproject_frame(
            model, mvs, block_size, ep, row_step))(stack[0]))
    return fn


@pytest.mark.parametrize("name", sorted(BENCH))
def test_bench_sequence_against_the_committed_jax_stream(bench_runs, name):
    got = bs.read_annexb(bench_runs[name]["data"])
    want = bs.read_annexb(_bench_stream(name))
    assert [n.nal_type for n in got] == [n.nal_type for n in want]
    diffs = [i for i, (a, b) in enumerate(zip(got, want))
             if a.payload != b.payload]
    assert diffs == NAL_DIFFS[name]
    sps = SPS.read(bs.BitReader(got[0].payload))
    for a, b in zip(got, want):
        if a.nal_type not in (bs.NAL_IDR, bs.NAL_TRAIL):
            continue
        ra, rb = bs.BitReader(a.payload), bs.BitReader(b.payload)
        ha, hb = SliceHeader.read(ra, sps), SliceHeader.read(rb, sps)
        assert ha.poc == hb.poc and ha.epipole_delta == hb.epipole_delta
        # every picture's CABAC data (modes, MVs, levels) is JAX's
        assert a.payload[ra._pos // 8:] == b.payload[rb._pos // 8:]
    if not NAL_DIFFS[name]:
        assert bench_runs[name]["data"] == _bench_stream(name)


def test_p_anchor_codes_the_epipole_delta(bench_runs):
    """Config 4 with the off-pole epipole: the P anchor's PH carries the
    2^-24 fixed-point delta against the global epipole (the predictor when
    nothing is coded yet); the bench epipole (0, 0, 1) codes a zero delta;
    B slices carry none."""
    for name, ep in (("fullmm_ep", (0.3, -0.5, 0.8)),
                     ("fullmm", (0.0, 0.0, 1.0))):
        nals = bs.read_annexb(bench_runs[name]["data"])
        sps = SPS.read(bs.BitReader(nals[0].payload))
        heads = {}
        for n in nals:
            if n.nal_type == bs.NAL_TRAIL:
                sh = SliceHeader.read(bs.BitReader(n.payload), sps)
                heads[sh.poc] = sh
        want = tuple(a - b for a, b in zip(epipole.to_fixed(ep),
                                           epipole.to_fixed((0, 0, 1))))
        assert heads[4].epipole_delta == want
        assert any(want) == (name == "fullmm_ep")
        assert all(heads[p].epipole_delta is None for p in (1, 2, 3))


@pytest.mark.parametrize("name", sorted(BENCH))
def test_port_decodes_the_committed_bench_stream(name):
    """DecLib(device="cpu") on the JAX encoder's stream: every MD5 OK when
    fed the JAX decoder's positions (the hook carries the epipoles), and
    with its own positions every MD5 OK."""
    data = _bench_stream(name)
    dec = DecLib(device="cpu", positions_fn=_jax_positions())
    dec.decode_bytes(data)
    assert dec.hash_status == {p: "OK" for p in range(5)}
    own = DecLib(device="cpu")
    own.decode_bytes(data)
    assert own.hash_status == OWN_POSITIONS_HASH.get(
        name, {p: "OK" for p in range(5)})


@pytest.mark.parametrize("name", sorted(BENCH))
def test_jax_decodes_the_port_bench_stream(bench_runs, name):
    """The JAX DecLib on the port's stream, and the port's own DecLib: its
    MD5s are the port encoder's."""
    data = bench_runs[name]["data"]
    own = DecLib(device="cpu")
    frames = own.decode_bytes(data)
    assert own.hash_status == {p: "OK" for p in range(5)}
    for f, r in zip(frames, sorted(bench_runs[name]["enc"].results,
                                   key=lambda r: r.poc)):
        for a, b in zip(f.numpy(), r.recon):
            np.testing.assert_array_equal(a, b)
    jdec = JaxDecLib()
    jdec.decode_bytes(data)
    assert jdec.hash_status == OWN_POSITIONS_HASH.get(
        name, {p: "OK" for p in range(5)})


def test_bench_config_without_merge_decodes_in_both_decoders():
    """Config 4 with merge off: the flat P path's AMVP arm (skip = the
    inherited model at its MVP) and search_b_mm with the B slice's AMVP
    arm, MM-MVP on."""
    enc = EncLib(_bench_cfg(EncCfg, MMConfig, "fullmm", merge=False),
                 device="cpu")
    data = enc.encode_sequence(realistic_sequence(256, 128, 5))
    for lib in (DecLib(device="cpu"), JaxDecLib()):
        lib.decode_bytes(data)
        assert lib.hash_status == {p: "OK" for p in range(5)}
    assert enc.summary()["psnr_y"] > 27.0


# ---------------------------------------------- the classic inter path

# stream -> (gop, frames, merge, tools): tests/make_torch_port_streams.py
# CLASSIC
CLASSIC = {"ra192x96_qp37_9f": ("RA", 9, True, {}),
           "ldp192x96_qp37_4f": ("LDP", 4, True, {}),
           "ra192x96_nomerge_qp37_5f": ("RA", 5, False, {}),
           "ra192x96_bdof_dmvr_qp37_9f": ("RA", 9, True,
                                          dict(bdof=True, dmvr=True))}


@pytest.fixture(scope="module")
def classic_runs():
    """The port's CPU encode of each classic stream's configuration."""
    out = {}
    for name, (gop, n, merge, tools) in CLASSIC.items():
        enc = EncLib(EncCfg(width=192, height=96, qp=37, gop=gop, gop_size=4,
                            search_range=24, merge=merge, **tools),
                     device="cpu")
        out[name] = dict(enc=enc, data=enc.encode_sequence(
            realistic_sequence(192, 96, n)))
    return out


def _classic_stream(name):
    return open(os.path.join(DATA, name + ".bin"), "rb").read()


@pytest.mark.parametrize("name", sorted(CLASSIC))
def test_classic_sequence_equals_the_committed_jax_stream(classic_runs,
                                                          name):
    got = bs.read_annexb(classic_runs[name]["data"])
    want = bs.read_annexb(_classic_stream(name))
    assert [n.nal_type for n in got] == [n.nal_type for n in want]
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.temporal_id == b.temporal_id, i
        assert a.payload == b.payload, f"NAL {i} (type {a.nal_type})"
    assert classic_runs[name]["data"] == _classic_stream(name)
    # the two-reference P pictures list both references in their header
    sps = SPS.read(bs.BitReader(got[0].payload))
    two_ref = sorted(
        h.poc for h in (SliceHeader.read(bs.BitReader(n.payload), sps)
                        for n in got if n.nal_type == bs.NAL_TRAIL)
        if len(h.ref_pocs_l0) == 2)
    assert two_ref == {"ra192x96_qp37_9f": [8], "ldp192x96_qp37_4f": [2, 3],
                       "ra192x96_nomerge_qp37_5f": [],
                       "ra192x96_bdof_dmvr_qp37_9f": [8]}[name]
    assert (sps.bdof, sps.dmvr) == (CLASSIC[name][3].get("bdof", False),
                                    CLASSIC[name][3].get("dmvr", False))


@pytest.mark.parametrize("name", sorted(CLASSIC))
def test_port_decodes_the_committed_classic_stream(classic_runs, name):
    dec = DecLib(device="cpu")
    frames = dec.decode_bytes(_classic_stream(name))
    n = CLASSIC[name][1]
    assert dec.hash_status == {p: "OK" for p in range(n)}
    for f, r in zip(frames, sorted(classic_runs[name]["enc"].results,
                                   key=lambda r: r.poc)):
        for a, b in zip(f.numpy(), r.recon):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["ldp192x96_qp37_4f",
                                  "ra192x96_bdof_dmvr_qp37_9f"])
def test_jax_decodes_the_port_classic_stream(classic_runs, name):
    """The LDP stream (two of its three P pictures take two references)
    and the RA stream with BDOF and DMVR on its B pictures."""
    jdec = JaxDecLib()
    frames = jdec.decode_bytes(classic_runs[name]["data"])
    n = CLASSIC[name][1]
    assert jdec.hash_status == {p: "OK" for p in range(n)}
    enc = classic_runs[name]["enc"]
    for f, r in zip(frames, sorted(enc.results, key=lambda r: r.poc)):
        for a, b in zip(f.planes, r.recon):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_bdof_dmvr_change_the_classic_stream(classic_runs):
    """BDOF and DMVR act on the RA stream's B pictures only: against the
    same configuration without them, the I and P pictures' payloads are
    equal (no P picture refers to a B picture) and some B picture's
    differ."""
    got = bs.read_annexb(classic_runs["ra192x96_bdof_dmvr_qp37_9f"]["data"])
    plain = bs.read_annexb(classic_runs["ra192x96_qp37_9f"]["data"])
    sps = SPS.read(bs.BitReader(got[0].payload))
    same = {}
    for a, b in zip(got, plain):
        if a.nal_type in (bs.NAL_IDR, bs.NAL_TRAIL):
            kind = SliceHeader.read(bs.BitReader(a.payload), sps).slice_type
            same.setdefault(kind == SliceType.B, []).append(
                a.payload == b.payload)
    assert all(same[False]) and len(same[False]) == 3
    assert not all(same[True]) and len(same[True]) == 6


def test_bench_configuration_1_equals_the_committed_jax_stream():
    """`ai416x240_qp37_encode_fps` (bench.py:101-102): AI at 416x240, every
    other EncCfg field at its default, 2 frames: the port's CPU encode is
    the JAX encoder's stream byte for byte, and the port decodes it with
    every MD5 OK."""
    want = open(os.path.join(DATA, "ai416x240_qp37_2f.bin"), "rb").read()
    got = EncLib(EncCfg(width=416, height=240, qp=37, gop="AI"),
                 device="cpu").encode_sequence(realistic_sequence(416, 240, 2))
    assert got == want
    dec = DecLib(device="cpu")
    dec.decode_bytes(want)
    assert dec.hash_status == {0: "OK", 1: "OK"}
