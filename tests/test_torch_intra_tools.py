"""PyTorch port, the I picture's residual tools against the JAX package on
the same inputs (tolerance 0): the wavefront's MTS / LFNST / BDPCM
helpers, `encode_intra_frame`'s nine outputs and reconstruction at 64x32
for each tool set (dependent quantization, RDOQ, MTS + LFNST, LFNST
without MTS, transform skip with BDPCM, lossless, and all of them), the
slice writer's bytes, the port's parser and wavefront decode reading them
back, and the SPS fields of the tools through both packages' writers and
parsers.

Single-core cost: about 35 s (mostly the JAX jit of each tool set's
wavefront encode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import slice_ps as jax_ps
from vvc_mm_tpu.common import wavefront as jax_wf
from vvc_mm_tpu.encoder import intra_coder as jax_ic
from vvc_mm_tpu_torch.common import bitstream, slice_ps, wavefront
from vvc_mm_tpu_torch.common.rom import DCT2
from vvc_mm_tpu_torch.decoder.intra_parser import decode_intra_slice
from vvc_mm_tpu_torch.encoder import intra_coder
from vvc_mm_tpu_torch.utils.content import realistic_sequence

torch.set_num_threads(1)

OUT_NAMES = ("mode", "lm_flag", "lfnst_idx", "mrl", "tsm", "mtsm", "lev_y",
             "lev_u", "lev_v")
# tool set -> (encode_intra_frame options, QP)
TOOL_SETS = {
    "dq": (dict(dep_quant=True), 30),
    "rdoq": (dict(use_rdoq=True), 30),
    "mts_lfnst_dq": (dict(dep_quant=True, use_mts=True, use_lfnst=True), 27),
    "lfnst_dq": (dict(dep_quant=True, use_lfnst=True), 37),
    "ts_bdpcm_rdoq": (dict(use_ts=True, use_bdpcm=True, use_rdoq=True), 32),
    "lossless": (dict(lossless=True), 4),
    "all": (dict(dep_quant=True, use_mts=True, use_lfnst=True, use_ts=True,
                 use_bdpcm=True), 22),
}
# the decoder's options of an encoder tool set (RDOQ and BDPCM are
# encoder-only: the BDPCM direction rides the transform-skip grid)
DEC_KEYS = {"dep_quant": "dep_quant", "use_lfnst": "use_lfnst",
            "use_ts": "use_ts", "lossless": "lossless", "use_mts": "use_mts"}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def planes():
    return [np.asarray(p, np.int32) for p in realistic_sequence(64, 32, 1)[0]]


@pytest.fixture(scope="module")
def blocks():
    """Predictions, residuals and modes of 24 8x8 blocks."""
    r = np.random.default_rng(7)
    pred = r.integers(0, 256, (24, 8, 8)).astype(np.int32)
    resid = np.clip(pred + r.laplace(0, 12, (24, 8, 8)).round(), 0,
                    255).astype(np.int32) - pred
    mode = r.integers(0, 67, 24).astype(np.int32)
    return pred, resid, mode


@pytest.mark.parametrize("dep", [False, True])
@pytest.mark.parametrize("use_lfnst", [False, True])
def test_mts_encode_decode_match_jax(blocks, dep, use_lfnst):
    pred, resid, mode = blocks
    got = wavefront._tq_mts_encode(_t(pred), _t(resid), _t(mode), 30, 8, 8,
                                   dep, use_lfnst)
    want = jax_wf._tq_mts_encode(jnp.asarray(pred), jnp.asarray(resid),
                                 jnp.asarray(mode), 30, 8, 8, dep, use_lfnst)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[3] > 0).any() and (not use_lfnst or (got[2] > 0).any())
    lev, _, lf, mts = (np.asarray(w) for w in want)
    rec = wavefront._tq_mts_decode(_t(pred), _t(lev), _t(mode), _t(mts),
                                   _t(lf), 30, 8, 8, dep, use_lfnst)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("dep", [False, True])
def test_lfnst_encode_decode_match_jax(blocks, dep):
    pred, resid, mode = blocks
    got = wavefront._tq_lfnst_encode(_t(pred), _t(resid), _t(mode), 30, 8,
                                     8, dep)
    want = jax_wf._tq_lfnst_encode(jnp.asarray(pred), jnp.asarray(resid),
                                   jnp.asarray(mode), 30, 8, 8, dep)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rec = wavefront._tq_lfnst_decode(_t(pred), got[0], _t(mode), got[2], 30,
                                     8, 8, dep)
    assert torch.equal(rec, got[1])


def test_bdpcm_matches_jax(rng):
    q = rng.integers(-300, 300, (6, 8, 8)).astype(np.int32)
    for hor in (True, False):
        d = wavefront._bdpcm_diff(_t(q), hor)
        np.testing.assert_array_equal(
            d.numpy(), np.asarray(jax_wf._bdpcm_diff(jnp.asarray(q), hor)))
        np.testing.assert_array_equal(
            wavefront._bdpcm_cumsum(d, hor).numpy(), q)
    assert wavefront.MTS_PAIRS == jax_wf.MTS_PAIRS
    assert wavefront.MTS_PAIRS[0] == (DCT2, DCT2)


@pytest.fixture(scope="module", params=sorted(TOOL_SETS))
def encoded(request, planes):
    """One 64x32 picture through both wavefront encoders with a tool set."""
    kw, qp = TOOL_SETS[request.param]
    jouts, jrecon = jax_wf.encode_intra_frame(
        *[jnp.asarray(p) for p in planes], qp, 8, 8, **kw)
    outs, recon = wavefront.encode_intra_frame(
        *[_t(p) for p in planes], qp, 8, 8, **kw)
    coords, valid = wavefront.wavefront_coords(4, 8)
    return dict(name=request.param, kw=kw, qp=qp, outs=outs, recon=recon,
                jouts=[np.asarray(o) for o in jouts],
                jrecon={k: np.asarray(v) for k, v in jrecon.items()},
                coords=coords, valid=valid)


def test_encode_intra_frame_tools_match_jax(encoded):
    e = encoded
    for name, o, jo in zip(OUT_NAMES, e["outs"], e["jouts"]):
        np.testing.assert_array_equal(o.numpy(), jo, name)
    for k in "yuv":
        np.testing.assert_array_equal(e["recon"][k].numpy(), e["jrecon"][k])
    outs = dict(zip(OUT_NAMES, e["jouts"]))
    kw = e["kw"]
    if kw.get("use_mts"):
        assert (outs["mtsm"] > 0).any()
    if kw.get("use_lfnst"):
        assert (outs["lfnst_idx"] > 0).any()
    if kw.get("use_ts") or kw.get("lossless"):
        assert (outs["tsm"] > 0).any()
    if kw.get("use_bdpcm"):
        assert (outs["tsm"] >= 2).any()


def test_intra_tools_slice_and_decode_roundtrip(encoded, planes):
    """The writer's bytes equal the JAX writer's; the port's parser reads
    the grids back and its wavefront decode gives the encoder's
    reconstruction (the source itself under lossless)."""
    e, kw = encoded, encoded["kw"]
    grids = dict(zip(OUT_NAMES, (wavefront.steps_to_grid(
        o, e["coords"], e["valid"]) for o in e["jouts"])))
    ts_syntax = kw.get("use_ts", False)
    args = dict(lfnst=grids["lfnst_idx"] if kw.get("use_lfnst") else None,
                ts=grids["tsm"] if ts_syntax else None,
                bdpcm=kw.get("use_bdpcm", False),
                mts=grids["mtsm"] if kw.get("use_mts") else None)
    lev = [grids[k] for k in ("lev_y", "lev_u", "lev_v")]
    payload = intra_coder.encode_intra_slice(grids["mode"], *lev, **args)
    assert payload == jax_ic.encode_intra_slice(grids["mode"], *lev, **args)
    back = decode_intra_slice(payload, 4, 8, 8,
                              lfnst=bool(kw.get("use_lfnst")),
                              ts=ts_syntax, bdpcm=kw.get("use_bdpcm", False),
                              mts=bool(kw.get("use_mts")))
    tsg = np.ones_like(back[4]) if kw.get("lossless") else back[4]
    for got, name in zip((back[0], back[2], tsg, back[5], *back[6:]),
                         ("mode", "lfnst_idx", "tsm", "mtsm", "lev_y",
                          "lev_u", "lev_v")):
        np.testing.assert_array_equal(got, grids[name], name)
    steps = {n: wavefront.grid_to_steps(g, e["coords"], e["valid"])
             for n, g in grids.items()}
    dec = wavefront.decode_intra_frame(
        steps["mode"], steps["lev_y"], steps["lev_u"], steps["lev_v"],
        e["qp"], 32, 64, 8, 8, device="cpu",
        lfnst_steps=steps["lfnst_idx"], ts_steps=steps["tsm"],
        mts_steps=steps["mtsm"],
        **{DEC_KEYS[k]: v for k, v in kw.items() if k in DEC_KEYS})
    for k in "yuv":
        np.testing.assert_array_equal(dec[k].numpy(), e["jrecon"][k])
    if kw.get("lossless"):
        for k, p in zip("yuv", planes):
            np.testing.assert_array_equal(dec[k].numpy(), p)


def test_remaining_intra_tools_are_refused():
    """No tool of the I picture is refused now: an unknown option to the
    wavefront or the parser is a TypeError.  The prediction tools parse
    (tests/test_torch_intra_pred_tools.py holds them to JAX), and so does
    the two-level intra partitioning (tests/test_torch_intra_part.py).
    WPP's substreams (item 11a): the port's DecLib takes a WPP SPS, and
    the WPP writer gives the JAX writer's bytes, parsed back by both
    packages (tests/test_torch_wpp.py holds the streams to JAX)."""
    y = torch.zeros((16, 16), dtype=torch.int32)
    c = torch.zeros((8, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        wavefront.encode_intra_frame(y, c, c, 30, use_split=True)
    with pytest.raises(TypeError):
        decode_intra_slice(b"\x00" * 8, 2, 2, 8, split=True)
    g = np.zeros((2, 2), np.int32)
    lev = np.zeros((2, 2, 8, 8), np.int32)
    levc = np.zeros((2, 2, 4, 4), np.int32)
    for kw in (dict(mip=True), dict(cclm=g), dict(mrl=g), dict(ibc=True)):
        data = intra_coder.encode_intra_slice(g, lev, levc, levc, **kw)
        back = decode_intra_slice(data, 2, 2, 8, **{k: True for k in kw})
        np.testing.assert_array_equal(back[0], g)
    from vvc_mm_tpu.decoder import intra_parser as jax_parser
    from vvc_mm_tpu.encoder import intra_coder as jax_coder
    from vvc_mm_tpu_torch.decoder import intra_parser
    from vvc_mm_tpu_torch.decoder.declib import DecLib
    dec = DecLib(device="cpu")
    dec._activate_sps(slice_ps.SPS(width=16, height=16, wpp=True))
    assert dec.sps.wpp
    modes = np.array([[0, 50], [18, 1]], np.int32)
    lev[1, 0, 0, 0] = 3
    for kw in (dict(num_substreams=2), dict(mip=True, cclm=g, mrl=g)):
        data = intra_coder.encode_intra_slice_wpp(modes, lev, levc, levc,
                                                  **kw)
        assert data == jax_coder.encode_intra_slice_wpp(modes, lev, levc,
                                                        levc, **kw)
        flags = {k: True for k in kw if k != "num_substreams"}
        back = intra_parser.decode_intra_slice_wpp(data, 2, 2, 8, **flags)
        for a, b in zip(back, jax_parser.decode_intra_slice_wpp(
                data, 2, 2, 8, **flags)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(back[0], modes)
        np.testing.assert_array_equal(back[6], lev)


def test_sps_tool_fields_roundtrip_both_packages():
    """The SPS fields of the tools (slice_ps.py:216-295), written by the
    port and read by the JAX package, written back by it and read by the
    port: every field survives."""
    steep = tuple(int(16 + 2 * (x + y)) for y in range(8) for x in range(8))
    fields = dict(scaling_list=steep, dep_quant=True, lfnst=True, mts=True,
                  ts=True, bdpcm=True, lossless=True)
    sps = slice_ps.SPS(width=192, height=96, **fields)
    bw = bitstream.BitWriter()
    sps.write(bw)
    from vvc_mm_tpu.common.bitstream import BitReader as JaxReader
    from vvc_mm_tpu.common.bitstream import BitWriter as JaxWriter
    jsps = jax_ps.SPS.read(JaxReader(bw.get_bytes()))
    for k, v in fields.items():
        assert getattr(jsps, k) == v, k
    jw = JaxWriter()
    jsps.write(jw)
    assert jw.get_bytes() == bw.get_bytes()
    back = slice_ps.SPS.read(bitstream.BitReader(jw.get_bytes()))
    for k, v in fields.items():
        assert getattr(back, k) == v, k
    assert back == sps
