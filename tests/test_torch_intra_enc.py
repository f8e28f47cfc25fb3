"""PyTorch port, the I picture's encoder against the JAX package on the same
source planes (made from a numpy seed): `rdcost.satd` (integer, exact), the
vectorised MPM list, `wavefront.encode_intra_frame` (all nine per-step
outputs and the three reconstructed planes: tolerance 0; the mode decision
is an argmin over a float32 cost, so mode mismatches are counted and the
count asserted: measured 0), and `intra_coder.encode_intra_slice` (payload
bytes equal on the same grids).  The port's own parser and wavefront decode
read the payload back to the encoder's grids and reconstruction."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import rdcost as jax_rdcost
from vvc_mm_tpu.common import wavefront as jax_wf
from vvc_mm_tpu.encoder import intra_coder as jax_ic
from vvc_mm_tpu_torch.common import rdcost, wavefront
from vvc_mm_tpu_torch.decoder.intra_parser import decode_intra_slice
from vvc_mm_tpu_torch.encoder import intra_coder
from vvc_mm_tpu_torch.utils import xfer
from vvc_mm_tpu_torch.utils.content import realistic_sequence

torch.set_num_threads(1)

MAX_MODE_MISMATCHES = 0      # measured at every case below
# (width, height, qp, bit depth)
CASES = {"64x32_qp22": (64, 32, 22, 8), "64x32_qp34": (64, 32, 34, 8),
         "64x32_10bit": (64, 32, 30, 10), "256x128_qp34": (256, 128, 34, 8)}
OUT_NAMES = ("mode", "lm_flag", "lfnst_idx", "mrl", "tsm", "mtsm", "lev_y",
             "lev_u", "lev_v")


@pytest.mark.parametrize("h,w", [(4, 4), (8, 8), (16, 16), (8, 4), (4, 16)])
def test_satd_sse_sad_match_jax(rng, h, w):
    a = rng.integers(0, 1024, (5, 67, h, w), dtype=np.int32)
    b = rng.integers(0, 1024, (5, 1, h, w), dtype=np.int32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for fn, jfn in ((rdcost.satd, jax_rdcost.satd),
                    (rdcost.sse, jax_rdcost.sse),
                    (rdcost.sad, jax_rdcost.sad)):
        got = fn(ta, tb)
        assert got.dtype == torch.int32 and got.shape == (5, 67)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jfn(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32])
def test_hadamard_butterfly_is_the_matrix_product(rng, n):
    np.testing.assert_array_equal(rdcost.hadamard_matrix(n),
                                  jax_rdcost.hadamard_matrix(n))
    x = rng.integers(-1000, 1000, (3, 5, n)).astype(np.int32)
    np.testing.assert_array_equal(
        rdcost._hadamard_last(torch.from_numpy(x)).numpy(),
        x @ rdcost.hadamard_matrix(n).T)
    with pytest.raises(ValueError):
        rdcost.hadamard_matrix(6)


def test_mpm3_matches_jax_and_host_on_every_pair():
    left, above = (g.reshape(-1).astype(np.int32)
                   for g in np.mgrid[-1:67, -1:67])
    got = wavefront._mpm3(torch.from_numpy(left),
                          torch.from_numpy(above)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_wf._mpm3(jnp.asarray(left), jnp.asarray(above))))
    for l, a, row in zip(left, above, got):
        assert wavefront.mpm3_host(int(l), int(a)) == list(row)


def test_steps_to_grid_inverts_grid_to_steps(rng):
    coords, valid = wavefront.wavefront_coords(4, 8)
    grid = rng.integers(-9, 9, (4, 8, 2, 2)).astype(np.int32)
    steps = wavefront.grid_to_steps(grid, coords, valid)
    np.testing.assert_array_equal(
        wavefront.steps_to_grid(steps, coords, valid), grid)
    np.testing.assert_array_equal(
        wavefront.steps_to_grid(steps, coords, valid),
        jax_wf.steps_to_grid(steps, coords, valid))


def _source(w, h, bit_depth):
    planes = realistic_sequence(w, h, 1)[0]
    return [np.asarray(p, np.int32) << (bit_depth - 8) for p in planes]


@pytest.fixture(scope="module", params=sorted(CASES))
def encoded(request):
    """One picture through both wavefront encoders."""
    w, h, qp, bd = CASES[request.param]
    planes = _source(w, h, bd)
    jouts, jrecon = jax_wf.encode_intra_frame(
        *[jnp.asarray(p) for p in planes], qp, 8, bd)
    outs, recon = wavefront.encode_intra_frame(
        *[torch.from_numpy(p) for p in planes], qp, 8, bd)
    coords, valid = wavefront.wavefront_coords(h // 8, w // 8)
    return dict(w=w, h=h, qp=qp, bd=bd, planes=planes, outs=outs,
                recon=recon, jouts=[np.asarray(o) for o in jouts],
                jrecon={k: np.asarray(v) for k, v in jrecon.items()},
                coords=coords, valid=valid)


def test_encode_intra_frame_outputs_match_jax(encoded):
    e = encoded
    assert len(e["outs"]) == 9
    grids, jgrids = {}, {}
    for name, o, jo in zip(OUT_NAMES, e["outs"], e["jouts"]):
        assert tuple(o.shape) == jo.shape, name
        grids[name] = wavefront.steps_to_grid(o.numpy(), e["coords"],
                                              e["valid"])
        jgrids[name] = jax_wf.steps_to_grid(jo, e["coords"], e["valid"])
    mismatches = int((grids["mode"] != jgrids["mode"]).sum())
    assert mismatches <= MAX_MODE_MISMATCHES
    for name in OUT_NAMES:
        np.testing.assert_array_equal(grids[name], jgrids[name], name)
    for k in "yuv":
        np.testing.assert_array_equal(e["recon"][k].numpy(), e["jrecon"][k])
    # the masked lanes of a step too: the whole scan output is equal
    for name, o, jo in zip(OUT_NAMES, e["outs"], e["jouts"]):
        np.testing.assert_array_equal(o.numpy(), jo, name)
    assert len(np.unique(grids["mode"])) > 3
    assert np.abs(grids["lev_y"]).sum() > 0


def test_encode_intra_slice_payload_matches_jax(encoded):
    e = encoded
    pulled = xfer.pull_levels(*e["outs"])
    for p, jo in zip(pulled, e["jouts"]):
        assert p.dtype == np.int32
        np.testing.assert_array_equal(p, jo)
    modes, _, _, _, _, _, ly, lu, lv = (
        wavefront.steps_to_grid(p, e["coords"], e["valid"]) for p in pulled)
    payload = intra_coder.encode_intra_slice(modes, ly, lu, lv)
    assert payload == jax_ic.encode_intra_slice(modes, ly, lu, lv)
    assert len(payload) > 20
    # the port's parser and wavefront decode read it back
    nby, nbx = modes.shape
    back = decode_intra_slice(payload, nby, nbx, 8)
    for got, want in zip((back[0], back[6], back[7], back[8]),
                         (modes, ly, lu, lv)):
        np.testing.assert_array_equal(got, want)
    steps = [wavefront.grid_to_steps(g, e["coords"], e["valid"])
             for g in (modes, ly, lu, lv)]
    dec = wavefront.decode_intra_frame(*steps, e["qp"], e["h"], e["w"], 8,
                                       e["bd"], device="cpu")
    for k in "yuv":
        assert torch.equal(dec[k], e["recon"][k])


def test_intra_tools_are_refused():
    """Only an unknown option is refused now: the prediction tools (CCLM,
    MIP, MRL, IBC; tests/test_torch_intra_pred_tools.py) and the residual
    tools (tests/test_torch_intra_tools.py) are carried and held to JAX."""
    y = torch.zeros((16, 16), dtype=torch.int32)
    c = torch.zeros((8, 8), dtype=torch.int32)
    for tool in ("use_cclm", "use_mip", "use_mrl", "use_ibc", "use_lfnst",
                 "use_ts", "use_bdpcm", "lossless", "use_mts", "use_rdoq",
                 "dep_quant"):
        outs, _ = wavefront.encode_intra_frame(y, c, c, 30, **{tool: True})
        assert len(outs) == 9
    with pytest.raises(TypeError):
        wavefront.encode_intra_frame(y, c, c, 30, use_nothing=True)
    g = np.zeros((2, 2), np.int32)
    lev = np.zeros((2, 2, 8, 8), np.int32)
    levc = np.zeros((2, 2, 4, 4), np.int32)
    for kw in (dict(mip=True), dict(cclm=g), dict(mrl=g), dict(ibc=True)):
        assert intra_coder.encode_intra_slice(g, lev, levc, levc, **kw) == \
            jax_ic.encode_intra_slice(g, lev, levc, levc, **kw)
    assert isinstance(intra_coder.encode_intra_slice(
        g, lev, levc, levc, ts=g, bdpcm=True, lfnst=g, mts=g), bytes)
