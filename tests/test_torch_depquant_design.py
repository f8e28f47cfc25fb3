"""PyTorch port, the decompositions of kernels D1/D2 (dependent
quantization's trellis and dequantizer, csrc/depquant.cu) in their plain
versions, against the JAX package on the same numpy inputs (tolerance 0):

- quantize_dep_plain takes, for each destination state, only the three
  candidates that reach it, in flat order, with the dead-state rule;
- dequantize_dep_plain takes the states by dq_states' XOR prefix of the
  level parities, in log2(n) doubling steps, not a loop over positions.

Single-core cost: about 7 s of test time, nearly all of it the JAX package's
compiles (one trellis and one dequantizer per size and QP)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vvc_mm_tpu.common import depquant as jax_dq
from vvc_mm_tpu_torch.common import depquant

torch.set_num_threads(1)


def _blocks(rng, b, s):
    """Laplacian blocks, two zero blocks, two saturating blocks (the
    MAX_LEVEL clip at low QPs)."""
    yy, xx = np.mgrid[0:s, 0:s]
    lap = (rng.laplace(0, 1, (b, s, s)) * 400.0 / (1 + yy + xx) ** 1.3)
    sat = rng.choice(np.array([-32768, 32767, -30000, 31000]), (2, s, s))
    return np.concatenate([lap.round(), np.zeros((2, s, s)), sat]
                          ).astype(np.int32)


def _sequential_states(parity: np.ndarray) -> np.ndarray:
    """The state before each position, stepping the machine position by
    position (what the JAX package's scan does)."""
    state, out = 0, []
    for par in parity:
        out.append(state)
        state = int(depquant.TRANS[state][par])
    return np.array(out, dtype=np.int64)


@pytest.mark.parametrize("s", [4, 8, 16, 32])
def test_plain_decompositions_match_jax(rng, s):
    """n = 16, 64 and 256 at QPs 0, 37 and 51, n = 1024 at QP 37: the
    three-candidate trellis and the XOR-prefix dequantizer give the JAX
    package's levels and coefficients, 0 apart."""
    log2s = s.bit_length() - 1
    c = _blocks(rng, {4: 8, 8: 6, 16: 2, 32: 1}[s], s)
    for qp in (37,) if s == 32 else (0, 37, 51):
        lev = depquant.quantize_dep_plain(torch.from_numpy(c), qp, log2s,
                                          log2s)
        want = np.asarray(jax_dq.quantize_dep(jnp.asarray(c), qp, log2s,
                                              log2s, 8))
        np.testing.assert_array_equal(lev.numpy(), want)
        np.testing.assert_array_equal(
            depquant.dequantize_dep_plain(lev, qp, log2s, log2s).numpy(),
            np.asarray(jax_dq.dequantize_dep(jnp.asarray(want), qp, log2s,
                                             log2s, 8)))


def test_crafted_cost_ties_match_jax(rng):
    """Exact cost ties decided by the flat order and the dead-state rule:
    at QP 28 the half-step scale of an 8x8 or 4x4 block is a power of two,
    so magnitudes of 0 .. 3 half steps (in halves) put x on and midway
    between the lattice levels, and with lambda 0 equal errors tie
    exactly.
    At the first positions only state 0 (then 0 and 2) is alive, so the
    other destinations are dead and their three candidates all cost
    3e38."""
    for s in (4, 8):
        log2s = s.bit_length() - 1
        xscale = depquant.dq_params(28, log2s, log2s, 8)["xscale"]
        assert np.log2(xscale) == int(np.log2(xscale))
        half = rng.integers(0, 7, (16, s, s)) * 0.5
        sign = rng.choice([-1, 1], (16, s, s))
        c = (half / xscale * sign).astype(np.int32)
        lev = depquant.quantize_dep_plain(torch.from_numpy(c), 28, log2s,
                                          log2s, lam=0.0)
        want = np.asarray(jax_dq.quantize_dep(jnp.asarray(c), 28, log2s,
                                              log2s, 8, lam=0.0))
        np.testing.assert_array_equal(lev.numpy(), want)


def test_dq_states_match_the_machine_on_a_batch(rng):
    par = rng.integers(0, 2, (64, 300))
    got = depquant.dq_states(torch.from_numpy(par)).numpy()
    for row, g in zip(par, got):
        np.testing.assert_array_equal(g, _sequential_states(row))
    # the state's quantizer offset is its high bit
    np.testing.assert_array_equal(got >> 1, depquant.STATE_OFF[got])


@settings(max_examples=30, deadline=None, database=None)
@given(st.lists(st.integers(0, 1), min_size=1, max_size=4096))
def test_dq_states_prefix_matches_sequential_machine(parity):
    """The XOR prefix against the state machine stepped position by
    position, on any parity sequence up to a 64x64 block's."""
    par = np.array(parity, dtype=np.int64)
    np.testing.assert_array_equal(
        depquant.dq_states(torch.from_numpy(par[None]))[0].numpy(),
        _sequential_states(par))
