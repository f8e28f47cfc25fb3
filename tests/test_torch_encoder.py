"""PyTorch port, the encoder slice as a whole: EncLib(device="cpu") encodes
POC 4 (P), 2, 1, 3 (B) of the 256x128 clip from the port's decode of the
committed stream's I picture.

(a) Picture by picture, the JAX package's EncLib is given the same source
    and the same reference pictures (the port's reconstructions, its own
    device DPB emptied first): the CABAC payload, the deblocked pre-filter
    reconstruction and the SAO parameters are equal bit for bit; the ALF
    coefficients that differ are counted (float32 statistics there, exact
    sums here; measured: none), and so are the final pictures.
(b) The committed parameter sets, I picture and its hash SEI, followed by
    the port's four NAL units and hash SEIs, decode to hash status OK for
    all five pictures in the port's DecLib and in the JAX DecLib.

All four pictures are coded at QP 38 (the cascade's P and first B layer),
so that the JAX side compiles each of its programs once."""
import os

import numpy as np
import pytest
import torch

from vvc_mm_tpu.common.slice_ps import MMConfig as JaxMMConfig
from vvc_mm_tpu.decoder.declib import DecLib as JaxDecLib
from vvc_mm_tpu.encoder import enclib as jax_enclib
from vvc_mm_tpu.encoder import filter_stage as jax_fs
from vvc_mm_tpu.encoder import inter_coder as jax_ic
from vvc_mm_tpu_torch.common.bitstream import (BitReader, NAL_SEI,
                                               read_annexb, write_annexb)
from vvc_mm_tpu_torch.common.slice_ps import MMConfig, SliceHeader
from vvc_mm_tpu_torch.common.typedefs import ProjectionID
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder.enclib import (EncCfg, EncLib, FrameResult,
                                             ctc_qp)
from vvc_mm_tpu_torch.utils.content import realistic_sequence

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
STREAM = os.path.join(DATA, "erp256x128_ra_mm_qp37_5f.bin")
W, H, QP = 256, 128, 38
ORDER = [(4, 0, -1, 0), (2, 0, 4, 1), (1, 0, 2, 2), (3, 2, 4, 2)]
MAX_ALF_COEFF_MISMATCHES = 0     # measured over the four pictures


def _cfg(cls, mm_cls):
    return cls(width=W, height=H, qp=37, gop="RA", qt_depth=1,
               inter_block_size=16, search_range=24, wrap_around=True,
               merge=True, mm=mm_cls(mpa=True, rot=True))


@pytest.fixture(scope="module")
def runs():
    """Encode the four pictures with the port, and each of them with the
    JAX package on the port's inputs; returns per-POC records of both."""
    head = []
    for nal in read_annexb(open(STREAM, "rb").read()):
        head.append(nal)
        if nal.nal_type == NAL_SEI:
            break
    dec = DecLib(device="cpu")
    dec.decode_bytes(write_annexb(head))
    assert dec.hash_status == {0: "OK"}
    src = realistic_sequence(W, H, 5)
    enc = EncLib(_cfg(EncCfg, MMConfig), device="cpu")
    jenc = jax_enclib.EncLib(_cfg(jax_enclib.EncCfg, JaxMMConfig))
    assert EncLib.ra_coding_order(5, 16) == ORDER == \
        jax_enclib.EncLib.ra_coding_order(5, 16)

    seen = {}
    saved = (jax_fs.sao_dispatch, jax_ic.encode_p_slice_qt_mm,
             jax_ic.encode_b_slice_mm)

    def sao_dispatch(recon, *args, **kwargs):
        seen["prefilter"] = {k: np.asarray(v) for k, v in recon.items()}
        return saved[0](recon, *args, **kwargs)

    def p_writer(*args, **kwargs):
        seen["payload"] = saved[1](*args, **kwargs)
        return seen["payload"]

    def b_writer(*args, **kwargs):
        seen["payload"] = saved[2](*args, **kwargs)
        return seen["payload"]

    jax_fs.sao_dispatch = sao_dispatch
    jax_ic.encode_p_slice_qt_mm = p_writer
    jax_ic.encode_b_slice_mm = b_writer
    dpb = {0: dec.frames[0].numpy()}
    out = {}
    try:
        for poc, r0, r1, tid in ORDER:
            if r1 < 0:
                nal, res = enc.encode_p_frame(poc, src[poc], dpb[r0], r0,
                                              qp=QP)
            else:
                nal, res = enc.encode_b_frame(poc, src[poc], dpb[r0], r0,
                                              dpb[r1], r1, tid, qp=QP)
            port = dict(
                nal=nal, res=res, payload=enc.payload,
                header=enc.slice_header, sei=enc._hash_sei(poc, res.recon,
                                                           tid),
                prefilter={k: v.numpy()
                           for k, v in enc.prefilter_recon.items()})
            jenc._dpb_dev.clear()        # same references as the port
            jenc._mm_seed = jenc._mm_seed_qt = None
            seen.clear()
            if r1 < 0:
                jnal, jres = jenc.encode_p_frame(poc, src[poc], dpb[r0], r0,
                                                 qp=QP)
            else:
                jnal, jres = jenc.encode_b_frame(poc, src[poc], dpb[r0], r0,
                                                 dpb[r1], r1, tid, qp=QP)
            out[poc] = dict(port=port, jax=dict(nal=jnal, res=jres, **seen))
            dpb[poc] = res.recon
    finally:
        (jax_fs.sao_dispatch, jax_ic.encode_p_slice_qt_mm,
         jax_ic.encode_b_slice_mm) = saved
    return dict(head=head, pics=out, enc=enc)


@pytest.mark.parametrize("poc", [4, 2, 1, 3])
def test_payload_and_prefilter_recon_equal_jax(runs, poc):
    p, j = runs["pics"][poc]["port"], runs["pics"][poc]["jax"]
    assert p["payload"] == j["payload"]
    assert len(p["payload"]) > 50
    for k in "yuv":
        np.testing.assert_array_equal(p["prefilter"][k], j["prefilter"][k])
    assert isinstance(p["res"], FrameResult) and p["res"].poc == poc
    assert p["nal"].nal_type == j["nal"].nal_type
    assert p["nal"].temporal_id == j["nal"].temporal_id


def _header(nal, sps):
    return SliceHeader.read(BitReader(nal.payload), sps)


def _coeff_pairs(a, b):
    """Pairs of coefficient arrays of two ALF parameter trees."""
    if a is None or b is None:
        assert a is None and b is None
        return
    if isinstance(a[0], np.ndarray):
        np.testing.assert_array_equal(a[1], b[1])      # region enables
        yield np.asarray(a[0]), np.asarray(b[0])
        return
    for x, y in zip(a, b):
        yield from _coeff_pairs(x, y)


def test_filter_parameters_against_jax(runs):
    """SAO parameters equal; ALF coefficient differences counted; with
    none, the slice headers and so the whole NAL units are equal, and the
    final pictures too."""
    sps = runs["enc"].sps
    mismatches = 0
    for poc, rec in runs["pics"].items():
        hp = _header(rec["port"]["nal"], sps)
        hj = _header(rec["jax"]["nal"], sps)
        for a, b in zip(hp.sao_params or (), hj.sao_params or ()):
            assert (a is None) == (b is None)
            for x, y in zip(a or (), b or ()):
                np.testing.assert_array_equal(x, y)
        assert (hp.sao_params is None) == (hj.sao_params is None)
        for name in ("alf_params", "alf_chroma_params", "ccalf_params"):
            for x, y in _coeff_pairs(getattr(hp, name), getattr(hj, name)):
                mismatches += int((x != y).sum())
    assert mismatches <= MAX_ALF_COEFF_MISMATCHES
    if mismatches == 0:
        for poc, rec in runs["pics"].items():
            assert rec["port"]["nal"].payload == rec["jax"]["nal"].payload
            for a, b in zip(rec["port"]["res"].recon,
                            rec["jax"]["res"].recon):
                np.testing.assert_array_equal(a, b)
            assert rec["port"]["res"].bits == rec["jax"]["res"].bits
            assert abs(rec["port"]["res"].psnr_y
                       - rec["jax"]["res"].psnr_y) < 1e-4


def _stream(runs):
    nals = list(runs["head"])
    for poc, _, _, _ in ORDER:
        nals += [runs["pics"][poc]["port"]["nal"],
                 runs["pics"][poc]["port"]["sei"]]
    return write_annexb(nals)


def test_own_stream_decodes_in_the_port(runs):
    dec = DecLib(device="cpu")
    frames = dec.decode_bytes(_stream(runs))
    assert dec.hash_status == {p: "OK" for p in range(5)}
    for f in frames[1:]:
        for a, b in zip(f.numpy(), runs["pics"][f.poc]["port"]["res"].recon):
            np.testing.assert_array_equal(a, b)


def test_own_stream_decodes_in_the_jax_decoder(runs):
    dec = JaxDecLib()
    dec.decode_bytes(_stream(runs))
    assert dec.hash_status == {p: "OK" for p in range(5)}


def test_summary_and_cascade(runs):
    s = runs["enc"].summary()
    assert s["frames"] == 4 and s["bits"] > 0 and s["fps"] > 0
    assert 25.0 < s["psnr_y"] < 40.0
    assert [ctc_qp(37, "I"), ctc_qp(37, "P")] == [34, 38]
    assert [ctc_qp(37, "B", t) for t in range(6)] == [38, 38, 41, 42, 43, 43]
    assert ctc_qp(2, "I") == 1


# the one refusal left: a calibrated source projection with a motion
# model (it has no focal length for the MPA plane; the JAX encoder fails on
# it at the first P picture); the accepted configurations are what items
# 7, 8 and 9a-9c ported (GED with
# epipoles, MM-MVP, the flat P path, B pictures without merge, 3DT, TAN,
# projected DMVR; on the classic path DMVR, BDOF and the random-access
# tools of 8b: TMVP/HMVP, AMVR, GPM, CIIP, weighted prediction and affine;
# under a multi-model configuration affine is carried and ignored, as in
# the JAX package; the I picture's quantization and transform tools and
# scaling lists; its prediction tools of 9d and 9e: CCLM, MIP, MRL, IBC;
# the block partitioning of 9f and 11: the classic quadtree, its
# multi-type tree and the two-level intra partitioning; the sequence tools
# of 11a-11d: WPP, LMCS, the film grain SEI and MCTS tiles; 11f and 11g:
# rate control, the MCTF pre-filter, the 360 metrics and Equisolid
# content)
REFUSED = {"calibrated_mm": (dict(mm=MMConfig(
    mpa=True, rot=True, projection=ProjectionID.CALIBRATED)),
    "no focal length")}
CLASSIC = dict(mm=MMConfig(), qt_depth=0)
ACCEPTED = {
    "fullmm": dict(mm=MMConfig(mpa=True, ged=True, rot=True, mmmvp=True),
                   epipoles=[(1, 0, 0.0, 0.0, 1.0)], qt_depth=0),
    "geda_nomerge": dict(mm=MMConfig(mpa=True, geda=True), merge=False),
    "t3d": dict(mm=MMConfig(mpa=True, t3d=True)),
    "tan": dict(mm=MMConfig(mpa=True, ged=True, tan=True)),
    "projected_dmvr": dict(dmvr=True),
    "classic_bdof_dmvr": dict(CLASSIC, bdof=True, dmvr=True),
    "affine": dict(affine=True),
    "classic_tmvp": dict(CLASSIC, tmvp=True),
    "classic_affine": dict(CLASSIC, affine=True),
    "gpm": dict(CLASSIC, gpm=True),
    "weighted_bipred": dict(CLASSIC, weighted_bipred=True),
    "amvr": dict(CLASSIC, amvr=True),
    "ciip": dict(CLASSIC, ciip=True),
    "weighted_pred": dict(CLASSIC, weighted_pred=True),
    "rdoq": dict(rdoq=True),
    "dep_quant": dict(dep_quant=True),
    "lfnst": dict(lfnst=True),
    "mts": dict(mts=True),
    "transform_skip": dict(transform_skip=True),
    "bdpcm": dict(transform_skip=True, bdpcm=True),
    "lossless": dict(lossless=True),
    "scaling_list": dict(CLASSIC, scaling_list=(16,) * 64),
    "cclm": dict(cclm=True),
    "mip": dict(mip=True),
    "mrl": dict(mrl=True),
    "ibc": dict(ibc=True),
    "intra_split": dict(intra_split=True),
    "classic_qtree": dict(CLASSIC, qt_depth=1),
    "classic_mtt": dict(CLASSIC, qt_depth=2, mtt=True),
    "wpp": dict(wpp=True),
    "lmcs": dict(lmcs=True),
    "film_grain": dict(film_grain=True),
    "mcts_tiles": dict(CLASSIC, mcts_tiles=(2, 1)),
    "rate_control": dict(target_bitrate_kbps=500),
    "mctf": dict(mctf=True),
    "metrics_360": dict(metrics_360=True),
    "equisolid": dict(mm=MMConfig(mpa=True, rot=True,
                                  projection=ProjectionID.EQUISOLID))}
CASES = (["no_card"] + [f"refused-{k}" for k in REFUSED]
         + [f"accepted-{k}" for k in ACCEPTED])


@pytest.mark.parametrize("case", CASES)
def test_unported_branches_raise(case):
    if case == "no_card":
        with pytest.raises(RuntimeError):
            if not torch.cuda.is_available():
                EncLib(_cfg(EncCfg, MMConfig))      # no card: no CPU fallback
            else:
                raise RuntimeError("a card is present")
        return
    kind, name = case.split("-", 1)
    kw, why = REFUSED[name] if kind == "refused" else (ACCEPTED[name], None)
    cfg = _cfg(EncCfg, MMConfig)
    for k, v in kw.items():
        setattr(cfg, k, v)
    if why is not None:
        with pytest.raises(NotImplementedError, match=why):
            EncLib(cfg, device="cpu")
        return
    enc = EncLib(cfg, device="cpu")
    assert enc.mvp_conv is not None or not cfg.mm.mmmvp
    assert enc.sps.mm.active_models() == cfg.mm.active_models()
    for tool in ("dmvr", "bdof", "affine", "tmvp", "amvr", "gpm", "ciip",
                 "dep_quant", "lfnst", "mts", "bdpcm", "lossless", "cclm",
                 "mip", "mrl", "ibc", "wpp"):
        assert getattr(enc.sps, tool) == getattr(cfg, tool), tool
    assert [n.payload[0] for n in enc.encode_headers()[2:]] == (
        [enc.SEI_MCTS] if cfg.mcts_tiles else [])
    assert enc.sps.ts == (cfg.transform_skip or cfg.lossless)
    assert enc.sps.scaling_list == tuple(cfg.scaling_list)
    if cfg.lossless:       # QP 4 transform skip, filters off, as in JAX
        assert cfg.qp == 4 and not (cfg.deblocking or cfg.sao or cfg.alf
                                    or cfg.dep_quant)
