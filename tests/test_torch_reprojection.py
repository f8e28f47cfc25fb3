"""PyTorch port, normative float32 positions: the port's merged positions
against the JAX package's (the decoder's jit-compiled merged_positions),
for CLASSIC, MPA x3 and ROT on random MV fields.

CLASSIC is integer math and must be exact.  The sphere models are float32
sin/cos/tan/atan2 math rounded to 1/16 pel: the port copies glibc's
float32 functions, which XLA's CPU code calls (common/libm_f32.py), and
the float32 form of the jit-compiled merged positions (FMAs, XLA's rsqrt,
constants folded in double), so every position equals JAX's.  Every
mismatch must be exactly one 1/16-pel unit, and the number of mismatching
subblocks may not exceed the count measured on the development machine's
CPU (no slack): 0 everywhere (before: 288/206/122 for MPA and 131 for ROT
at 2048x1024)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common.mm import frame_codec as jax_fc
from vvc_mm_tpu.common.mm.reprojection import MVReprojection as JaxReproj
from vvc_mm_tpu.lib360.projection import ERP as JaxERP
from vvc_mm_tpu_torch.common.mm import frame_codec
from vvc_mm_tpu_torch.common.mm.reprojection import MVReprojection
from vvc_mm_tpu_torch.lib360.projection import ERP

torch.set_num_threads(1)

BLOCK = 16
# (width, height) -> model id -> max subblocks whose position differs;
# measured with seed 100 + model id, MVs uniform in +-24 pel
MEASURED = {
    (256, 128): {0: 0, 1: 0, 2: 0, 3: 0, 6: 0},
    (2048, 1024): {0: 0, 1: 0, 2: 0, 3: 0, 6: 0},
}
CASES = [(wh, m) for wh in MEASURED for m in MEASURED[wh]]


@pytest.mark.parametrize("size,model", CASES,
                         ids=[f"{w}x{h}-m{m}" for (w, h), m in CASES])
def test_positions_match_jax(size, model):
    w, h = size
    rng = np.random.default_rng(100 + model)
    mv = rng.integers(-384, 385, (h // BLOCK, w // BLOCK, 2)).astype(np.int32)
    idx = np.zeros((h // BLOCK, w // BLOCK), np.int32)
    want = np.asarray(jax_fc.merged_positions(
        JaxReproj(JaxERP(w, h), w, h, 1), [model], jnp.asarray(idx),
        jnp.asarray(mv[None]), BLOCK))
    got = frame_codec.merged_positions(
        MVReprojection(ERP(w, h), w, h, 1, device="cpu"), [model],
        torch.from_numpy(idx),
        torch.from_numpy(mv[None]), BLOCK).numpy()
    assert got.shape == want.shape == (h // 4, w // 4, 2)
    assert got.dtype == np.int32
    d = got - want
    assert np.abs(d).max() <= 1, "a mismatch larger than one 1/16 pel"
    n_sub = int((d != 0).any(-1).sum())
    assert n_sub <= MEASURED[size][model], n_sub


def test_grid_sphere_is_folded_once(monkeypatch):
    """The merged form's folded grid points (host double sin/cos,
    ERP.to_sphere_folded) are computed once per MVReprojection and then
    sliced, not again at each merged-positions call; every row_step gives
    what the op-by-op fold of its own rows gives.  to_sphere_folded takes
    host tensors only."""
    w, h = 256, 128
    proj = ERP(w, h)
    calls = []
    folded = ERP.to_sphere_folded
    monkeypatch.setattr(ERP, "to_sphere_folded",
                        lambda self, x, y: calls.append(1) or folded(self, x,
                                                                     y))
    reproj = MVReprojection(proj, w, h, 1, device="cpu")
    mv = torch.from_numpy(np.random.default_rng(7).integers(
        -384, 385, (h // BLOCK, w // BLOCK, 2)).astype(np.int32))
    for model in (4, 5, 6, 7):            # 3DT, TAN, ROT, GED (flavour 1)
        for row_step in (1, 4):
            reproj.reproject_frame(model, mv, BLOCK, (0.3, -0.5, 0.8),
                                   row_step, form="merged")
    assert len(calls) == 1
    for row_step in (1, 4):
        want = folded(proj, reproj.grid_x[::row_step],
                      reproj.grid_y[::row_step])
        got = [c[::row_step] for c in reproj.grid_sphere()]
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="host tensors"):
        proj.to_sphere_folded(torch.zeros(2, device="meta"),
                              torch.zeros(2, device="meta"))
