"""PyTorch port, the I picture's prediction tools (MIP, CCLM, MRL, IBC)
against the JAX package on the same inputs (tolerance 0): the MIP tables
(computed in each package from the same float64 recipe) and predictions
at 8 and 10 bits with saturated boundaries, the CCLM model on border ties
and on int32-wrapping slopes, `wavefront.encode_intra_frame`'s nine
outputs and reconstruction at 64x32 for each tool alone, the four
together, and the four with the residual tools (JAX's jit-compiled
encoder: 0 differing decisions), the slice writer's bytes, and the port's
parser and wavefront decode reading them back.

Single-core cost: about 40 s (mostly the JAX jit of each tool set's
wavefront encode and decode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import cclm as jax_cclm
from vvc_mm_tpu.common import mip as jax_mip
from vvc_mm_tpu.common import wavefront as jax_wf
from vvc_mm_tpu.encoder import intra_coder as jax_ic
from vvc_mm_tpu_torch.common import cclm, mip, wavefront
from vvc_mm_tpu_torch.decoder.intra_parser import decode_intra_slice
from vvc_mm_tpu_torch.encoder import intra_coder
from vvc_mm_tpu_torch.utils.content import realistic_sequence

torch.set_num_threads(1)

OUT_NAMES = ("mode", "lm_flag", "lfnst_idx", "mrl", "tsm", "mtsm", "lev_y",
             "lev_u", "lev_v")
W, H = 64, 32
RESID = dict(dep_quant=True, use_mts=True, use_lfnst=True, use_ts=True,
             use_bdpcm=True)
FOUR = dict(use_cclm=True, use_mip=True, use_mrl=True, use_ibc=True)
# tool set -> (source, encode_intra_frame options, QP)
TOOL_SETS = {
    "cclm": ("natural", dict(use_cclm=True), 30),
    "mip": ("natural", dict(use_mip=True), 30),
    "mrl": ("natural", dict(use_mrl=True), 27),
    "ibc": ("screen", dict(use_ibc=True), 30),
    "four": ("natural", FOUR, 32),
    "four_screen": ("screen", FOUR, 30),
    "four_resid": ("mixed", dict(FOUR, **RESID), 27),
}
DEC_KEYS = ("dep_quant", "use_lfnst", "use_ts", "use_mts", "use_cclm",
            "use_mip", "use_mrl", "use_ibc")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sources():
    nat = [np.asarray(p, np.int32) for p in realistic_sequence(W, H, 1)[0]]
    tile = np.random.default_rng(11).integers(0, 256, (8, 8))
    y = np.tile(tile, (H // 8, W // 8)).astype(np.int32)
    screen = [y, (y[::2, ::2] // 2).astype(np.int32),
              (y[::2, ::2] // 3).astype(np.int32)]
    # the left half screen content, the right half natural
    mixed = [np.concatenate([s[:, :s.shape[1] // 2], n[:, n.shape[1] // 2:]],
                            1) for s, n in zip(screen, nat)]
    return dict(natural=nat, screen=screen, mixed=mixed)


# --------------------------------------------------------------- MIP

@pytest.mark.parametrize("red", [4, 8])
def test_mip_matrices_equal_jax(red):
    np.testing.assert_array_equal(mip._matrices(red), jax_mip._matrices(red))


@pytest.mark.parametrize("s", [4, 8, 16, 32])
def test_mip_upsampler_equals_jax(s):
    red = min(s, 8)
    np.testing.assert_array_equal(mip._upsampler(s, red),
                                  jax_mip._upsampler(s, red))


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("s", [4, 8, 16])
def test_predict_mip_matches_jax(s, bit_depth):
    rng = np.random.default_rng(s + bit_depth)
    maxv = (1 << bit_depth) - 1
    n = 4 * s + 1
    cref = rng.integers(0, maxv + 1, (12, n)).astype(np.int32)
    cref[0] = maxv                                 # saturated boundaries
    cref[1] = 0
    cref[2, :2 * s] = maxv                         # left max, top min
    cref[2, 2 * s:] = 0
    cref[3, :2 * s] = 0
    cref[3, 2 * s:] = maxv
    cref[4, ::2] = maxv                            # alternating extremes
    cref[4, 1::2] = 0
    got = mip.predict_mip_all(_t(cref), s, bit_depth)
    want = np.asarray(jax_mip.predict_mip_all(jnp.asarray(cref), s,
                                              bit_depth))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    modes = rng.integers(0, mip.N_MIP_MODES, 12).astype(np.int32)
    np.testing.assert_array_equal(
        mip.predict_mip_mode(_t(cref), _t(modes), s, bit_depth).numpy(),
        np.asarray(jax_mip.predict_mip_mode(jnp.asarray(cref),
                                            jnp.asarray(modes), s,
                                            bit_depth)))


# --------------------------------------------------------------- CCLM

def _cclm_cases(bit_depth):
    rng = np.random.default_rng(bit_depth)
    maxv = (1 << bit_depth) - 1
    n = 8
    bl = rng.integers(0, maxv + 1, (40, n)).astype(np.int32)
    bc = rng.integers(0, maxv + 1, (40, n)).astype(np.int32)
    bl[0] = 100                                    # all luma tied: diff 0
    bl[1] = [5, 5, 5, 9, 9, 9, 5, 9]               # ties at both ends
    bc[1] = [0, maxv, 7, 1, maxv, 3, 2, 0]
    # diff 1 with the full chroma range: a = maxv << 16 (overflows a*l)
    for i in range(2, 12):
        lo = int(rng.integers(0, maxv))
        bl[i] = [lo, lo, lo + 1, lo + 1, lo, lo + 1, lo, lo + 1]
        bc[i] = [0, 0, maxv, maxv, 0, maxv, 0, maxv]
        if i % 2:
            bc[i] = maxv - bc[i]                   # negative slope
    bl[12] = [0, 0, 1, 1, 0, 1, 0, 1]
    bc[12] = [maxv, maxv, 0, 0, maxv, 0, maxv, 0]
    dsl = rng.integers(0, maxv + 1, (40, 4, 4)).astype(np.int32)
    dsl[2:13] = maxv
    return bl, bc, dsl


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_cclm_params_and_predict_match_jax(bit_depth):
    bl, bc, dsl = _cclm_cases(bit_depth)
    a, b = cclm.cclm_params(_t(bl), _t(bc))
    ja, jb = (np.asarray(v) for v in jax_cclm.cclm_params(
        jnp.asarray(bl), jnp.asarray(bc)))
    assert a.dtype == b.dtype == torch.int32
    np.testing.assert_array_equal(a.numpy(), ja)
    np.testing.assert_array_equal(b.numpy(), jb)
    assert (np.abs(ja.astype(np.int64) * bl.max(1)) >= 2 ** 31).any(), \
        "no case wraps int32"
    got = cclm.cclm_predict(_t(dsl), a, b, bit_depth)
    want = np.asarray(jax_cclm.cclm_predict(
        jnp.asarray(dsl), jnp.asarray(ja), jnp.asarray(jb), bit_depth))
    np.testing.assert_array_equal(got.numpy(), want)
    blk = np.random.default_rng(3).integers(0, 256, (5, 8, 8)) \
        .astype(np.int32)
    np.testing.assert_array_equal(
        cclm.downsample_luma(_t(blk)).numpy(),
        np.asarray(jax_cclm.downsample_luma(jnp.asarray(blk))))


# ------------------------------------------------------------ wavefront

@pytest.fixture(scope="module")
def sources():
    return _sources()


@pytest.fixture(scope="module", params=sorted(TOOL_SETS))
def encoded(request, sources):
    src, kw, qp = TOOL_SETS[request.param]
    planes = sources[src]
    jouts, jrecon = jax_wf.encode_intra_frame(
        *[jnp.asarray(p) for p in planes], qp, 8, 8, **kw)
    outs, recon = wavefront.encode_intra_frame(
        *[_t(p) for p in planes], qp, 8, 8, **kw)
    coords, valid = wavefront.wavefront_coords(H // 8, W // 8)
    return dict(name=request.param, kw=kw, qp=qp, outs=outs, recon=recon,
                jouts=[np.asarray(o) for o in jouts],
                jrecon={k: np.asarray(v) for k, v in jrecon.items()},
                coords=coords, valid=valid)


def test_encode_intra_frame_pred_tools_match_jax(encoded):
    e = encoded
    diffs = {n: int((o.numpy() != jo).sum())
             for n, o, jo in zip(OUT_NAMES, e["outs"], e["jouts"])}
    assert diffs == dict.fromkeys(OUT_NAMES, 0), diffs
    for k in "yuv":
        np.testing.assert_array_equal(e["recon"][k].numpy(), e["jrecon"][k])
    o = {n: wavefront.steps_to_grid(jo, e["coords"], e["valid"])
         for n, jo in zip(OUT_NAMES, e["jouts"])}
    kw = e["kw"]
    if kw.get("use_ibc"):
        assert (o["mode"] >= wavefront.IBC_BASE).any()
    if e["name"] == "four_screen":
        return              # IBC copies every block but the first column
    if kw.get("use_mip"):
        assert ((o["mode"] >= 67) & (o["mode"] < 128)).any()
    if kw.get("use_mrl"):
        assert (o["mrl"] > 0).any()
    if kw.get("use_cclm"):
        assert (o["lm_flag"] > 0).any()


def test_pred_tools_slice_and_decode_roundtrip(encoded):
    """The writer's bytes equal the JAX writer's; the port's parser reads
    the grids back and its wavefront decode gives the encoder's
    reconstruction."""
    e, kw = encoded, encoded["kw"]
    g = {n: wavefront.steps_to_grid(o, e["coords"], e["valid"])
         for n, o in zip(OUT_NAMES, e["jouts"])}
    args = dict(cclm=g["lm_flag"] if kw.get("use_cclm") else None,
                mip=kw.get("use_mip", False),
                lfnst=g["lfnst_idx"] if kw.get("use_lfnst") else None,
                mrl=g["mrl"] if kw.get("use_mrl") else None,
                ts=g["tsm"] if kw.get("use_ts") else None,
                bdpcm=kw.get("use_bdpcm", False),
                ibc=kw.get("use_ibc", False),
                mts=g["mtsm"] if kw.get("use_mts") else None)
    lev = [g[k] for k in ("lev_y", "lev_u", "lev_v")]
    payload = intra_coder.encode_intra_slice(g["mode"], *lev, **args)
    assert payload == jax_ic.encode_intra_slice(g["mode"], *lev, **args)
    back = decode_intra_slice(
        payload, H // 8, W // 8, 8, lfnst=bool(kw.get("use_lfnst")),
        ts=bool(kw.get("use_ts")), bdpcm=kw.get("use_bdpcm", False),
        mts=bool(kw.get("use_mts")), cclm=bool(kw.get("use_cclm")),
        mip=bool(kw.get("use_mip")), mrl=bool(kw.get("use_mrl")),
        ibc=bool(kw.get("use_ibc")))
    for got, name in zip(back, OUT_NAMES):
        np.testing.assert_array_equal(got, g[name], name)
    st = {n: wavefront.grid_to_steps(v, e["coords"], e["valid"])
          for n, v in g.items()}
    dec = wavefront.decode_intra_frame(
        st["mode"], st["lev_y"], st["lev_u"], st["lev_v"], e["qp"], H, W, 8,
        8, device="cpu", lfnst_steps=st["lfnst_idx"], ts_steps=st["tsm"],
        mts_steps=st["mtsm"], cclm_steps=st["lm_flag"], mrl_steps=st["mrl"],
        **{k: v for k, v in kw.items() if k in DEC_KEYS})
    for k in "yuv":
        np.testing.assert_array_equal(dec[k].numpy(), e["jrecon"][k])


def test_ts_pick_overrides_ibc_and_mrl():
    """With transform skip and BDPCM on, the residual pick runs after the
    IBC and MRL choices: a BDPCM pick replaces an IBC mode (the block
    codes HOR/VER) and clears MRL, in both packages alike."""
    planes = _sources()["mixed"]
    kw = dict(FOUR, **RESID)
    outs, _ = wavefront.encode_intra_frame(*[_t(p) for p in planes], 27, 8,
                                           8, **kw)
    jouts, _ = jax_wf.encode_intra_frame(*[jnp.asarray(p) for p in planes],
                                         27, 8, 8, **kw)
    for o, jo in zip(outs, jouts):
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    mode, mrl, tsm = (outs[i].numpy() for i in (0, 3, 4))
    assert not (mrl[tsm > 0] > 0).any()
    assert not ((mode >= wavefront.IBC_BASE) & (tsm >= 2)).any()
