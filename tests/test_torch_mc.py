"""PyTorch port, kernels K1/K2: the plain versions the CPU runs are held
bit-exact (tolerance 0) to the JAX package's XLA mirrors, to its Pallas
kernels in interpret mode (ops/mc_kernel.py) and to the round-1 Pallas
kernels K7 (ops/mc_pallas.py).  The CUDA kernels themselves are held to
the plain versions on the card (the `cuda` tests, and chip_smoke.py)."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import interp as jax_interp
from vvc_mm_tpu.common.mm import mc as jax_mc
from vvc_mm_tpu.ops import mc_kernel as jax_kernel
from vvc_mm_tpu.ops import mc_pallas as jax_k7
from vvc_mm_tpu_torch.common import interp
from vvc_mm_tpu_torch.common.inter_frame import pad_ref
from vvc_mm_tpu_torch.ops import mc_kernel

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(rng, h=64, w=128, m=40, kind="random"):
    """A padded 8-bit plane and (h/4, w/4, 2) positions: "random" over the
    plane and its margin, "extreme" (clamped), or "coherent" (neighbours a
    few pel apart around one shared motion, as merged MM positions are)."""
    ref = rng.integers(0, 255, (h + 2 * m, w + 2 * m), dtype=np.int32)
    nsy, nsx = h // 4, w // 4
    if kind == "extreme":
        pos = rng.integers(-100000, 100000, (nsy, nsx, 2))
    elif kind == "coherent":
        grid = np.stack(np.meshgrid(np.arange(nsx) * 64,
                                    np.arange(nsy) * 64), -1)
        pos = grid + rng.integers(-m * 8, m * 8, (1, 1, 2)) + \
            rng.integers(-24, 24, (nsy, nsx, 2))
    else:
        pos = np.stack([rng.integers(-m * 16, (w + m - 8) * 16, (nsy, nsx)),
                        rng.integers(-m * 16, (h + m - 8) * 16, (nsy, nsx))],
                       -1)
    return ref, pos.astype(np.int32), m


def _port(fn, ref, pos, m, bd=8):
    return fn(torch.from_numpy(ref), torch.from_numpy(pos), m, bd).numpy()


@pytest.mark.parametrize("case", ["random", "extreme", "10bit-odd"])
@pytest.mark.parametrize("plane", ["luma", "chroma"])
def test_plain_matches_xla_mirror_and_pallas(rng, plane, case):
    """The 10-bit case lies on a plane of odd width (the kernels' scalar
    loads on the card) and is held to the XLA mirror only: interpret mode
    is slow."""
    if case == "10bit-odd":
        ref, pos, m = _setup(rng, h=32, w=85)
        ref, bd = ref * 4 + 3, 10
        assert ref.shape[1] % 2 == 1
    else:
        ref, pos, m = _setup(rng, kind=case)
        bd = 8
    if plane == "luma":
        port = _port(mc_kernel.mc_luma_positions, ref, pos, m, bd)
        xla = jax_mc._mc_luma_positions_xla(jnp.asarray(ref),
                                            jnp.asarray(pos), m, bd)
    else:
        port = _port(mc_kernel.mc_chroma_positions, ref, pos, m, bd)
        xla = jax_mc._mc_chroma_positions_xla(jnp.asarray(ref),
                                              jnp.asarray(pos), m, bd)
    np.testing.assert_array_equal(port, np.asarray(xla))
    if bd != 8:
        return
    pallas = (jax_kernel.mc_luma_positions if plane == "luma"
              else jax_kernel.mc_chroma_positions)
    pal = pallas(jnp.asarray(ref), jnp.asarray(pos), m, 8, interpret=True)
    np.testing.assert_array_equal(port, np.asarray(pal))


@pytest.mark.parametrize("plane", ["luma", "chroma"])
def test_plain_matches_round1_pallas_k7(rng, plane):
    """K7 (ops/mc_pallas.py) computes the same function as K1/K2."""
    if plane == "luma":
        ref, pos, m = _setup(rng, h=32, w=64, m=16)
        want = jax_k7.mc_luma_positions(jnp.asarray(ref), jnp.asarray(pos),
                                        m, interpret=True)
        got = _port(mc_kernel.mc_luma_positions, ref, pos, m)
    else:
        m, h, w = 8, 16, 32
        ref = rng.integers(0, 256, (h + 2 * m, w + 2 * m), dtype=np.int32)
        nsy, nsx = h // 2, w // 2
        base = np.stack(np.meshgrid(np.arange(nsx) * 64,
                                    np.arange(nsy) * 64), -1)
        pos = (base + rng.integers(-64, 64, (nsy, nsx, 2))).astype(np.int32)
        want = jax_k7.mc_chroma_positions(jnp.asarray(ref), jnp.asarray(pos),
                                          m, interpret=True)
        got = _port(mc_kernel.mc_chroma_positions, ref, pos, m)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_plain_takes_shapes_no_pallas_path_takes(rng):
    """nsx=20, nsy=5 (no Pallas layout admits it) and 10-bit samples,
    against the XLA mirror."""
    ref, pos, m = _setup(rng, h=20, w=80, m=24)
    ref = ref * 4
    for name, xla in (("mc_luma_positions", jax_mc._mc_luma_positions_xla),
                      ("mc_chroma_positions",
                       jax_mc._mc_chroma_positions_xla)):
        got = _port(getattr(mc_kernel, name), ref, pos, m, 10)
        want = xla(jnp.asarray(ref), jnp.asarray(pos), m, 10)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_filter_tables_match_cuda_source():
    """The __constant__ tables in csrc/mc_positions.cu equal interp's."""
    src = open(os.path.join(ROOT, "vvc_mm_tpu_torch", "csrc",
                            "mc_positions.cu")).read()
    for name, table in (("c_luma_filter", interp.LUMA_FILTER),
                        ("c_chroma_filter", interp.CHROMA_FILTER)):
        body = src.split(name, 1)[1].split("};", 1)[0]
        nums = [int(v) for v in re.findall(r"-?\d+", body)]
        rows, cols = nums[:2]
        vals = np.array(nums[2:]).reshape(rows, cols)
        np.testing.assert_array_equal(vals, table)
    np.testing.assert_array_equal(interp.LUMA_FILTER, jax_interp.LUMA_FILTER)
    np.testing.assert_array_equal(interp.CHROMA_FILTER,
                                  jax_interp.CHROMA_FILTER)


@pytest.mark.parametrize("wrap", [False, True])
def test_pad_ref_matches_jax(rng, wrap):
    from vvc_mm_tpu.common.inter_frame import pad_ref as jax_pad
    plane = rng.integers(0, 255, (12, 20), dtype=np.int32)
    got = pad_ref(torch.from_numpy(plane), 24, wrap).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jax_pad(jnp.asarray(plane), 24, wrap)))


def test_wrapper_counts_only_kernel_launches(rng):
    """CPU tensors take the plain version: no kernel launch is counted."""
    ref, pos, m = _setup(rng, h=16, w=32)
    mc_kernel.reset_launches()
    _port(mc_kernel.mc_luma_positions, ref, pos, m)
    _port(mc_kernel.mc_chroma_positions, ref, pos, m)
    assert mc_kernel.LAUNCHES["mc_luma_positions"] == 0
    assert mc_kernel.LAUNCHES["mc_chroma_positions"] == 0
    assert all(v == 0 for v in mc_kernel.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "extreme", "coherent"])
def test_cuda_kernels_match_plain(rng, kind):
    """On the card: each kernel bit-exact with its plain version, with its
    launch counted, at 8 bit on 2048x1024 and 256x128 planes, at 10 bit on
    536x1000 (250 subblocks a row: no multiple of a CTA's width) and on a
    536x1000 plane cut so that its rows are not 16-byte aligned (the
    scalar-load path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for h, w, bd, cut in ((1024, 2048, 8, 0), (128, 256, 8, 0),
                          (536, 1000, 10, 0), (536, 1000, 10, 3)):
        ref, pos, _ = _setup(rng, h=h, w=w, m=80, kind=kind)
        ref = (ref << (bd - 8))[:, cut:]
        p = torch.from_numpy(pos).cuda()
        for name, sub, m in (("mc_luma_positions", 1, 80),
                             ("mc_chroma_positions", 2, 40)):
            r = torch.from_numpy(np.ascontiguousarray(ref[::sub, ::sub]))
            r = r.cuda()
            assert (r.shape[1] % 4 != 0) == (cut != 0)
            before = mc_kernel.LAUNCHES[name]
            got = getattr(mc_kernel, name)(r, p, m, bd)
            assert mc_kernel.LAUNCHES[name] == before + 1
            want = getattr(mc_kernel, name + "_plain")(r, p, m, bd)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
