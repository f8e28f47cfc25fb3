"""PyTorch port, the plain versions of kernel L1 (common/libm_f32.py):
glibc's float32 sinf, cosf, sincosf, tanf and atan2f, against glibc itself
called through ctypes on libm.so.6, on 2^20 seeded inputs each plus the
edge cases (+-0, subnormals, the neighbours of +-pi/2 and +-pi, |x| past
120 for the large-argument reduction, +-inf, NaN, every sign quadrant of
atan2f): 0 differences (NaN compared as NaN).  XLA's expansions of
arcsin, arccos and arctan (ops/libm_kernel.py) against the jit-compiled
jnp functions, the correctly rounded sqrt against numpy's, the emulated
fused multiply-adds against exact rational arithmetic, and XLA's rsqrt
(the RSQRTSS estimate and two Newton steps) against jax.lax.rsqrt
jit-compiled on this CPU.

The copied functions are glibc 2.36's for x86-64 as its ifunc selects
them on a CPU with FMA and AVX2; on another glibc or CPU the reference
moves, so the comparison with the host's libm is skipped there.

Single-core cost: about 15 s."""
import ctypes
import ctypes.util
import fractions
import os
import platform

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu_torch.common import libm_f32 as lf
from vvc_mm_tpu_torch.ops import libm_kernel

torch.set_num_threads(1)

N = 1 << 20


def _host_glibc():
    """(libm handle, reason to skip or None)."""
    libc_ver = platform.libc_ver()
    if libc_ver[0] != "glibc" or libc_ver[1] != "2.36":
        return None, f"glibc 2.36 copied, host has {libc_ver}"
    if platform.machine() != "x86_64":
        return None, "the x86-64 build of glibc is copied"
    flags = ""
    if os.path.exists("/proc/cpuinfo"):
        flags = open("/proc/cpuinfo").read()
    if " fma " not in flags or " avx2 " not in flags:
        return None, "glibc selects its FMA build only with FMA and AVX2"
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name in ("sinf", "cosf", "tanf"):
        getattr(lib, name).restype = ctypes.c_float
        getattr(lib, name).argtypes = [ctypes.c_float]
    lib.atan2f.restype = ctypes.c_float
    lib.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
    lib.sincosf.restype = None
    lib.sincosf.argtypes = [ctypes.c_float, ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_float)]
    return lib, None


LIBM, SKIP = _host_glibc()
needs_glibc = pytest.mark.skipif(LIBM is None, reason=SKIP or "")


def _bits(u):
    return np.asarray(u, np.uint32).view(np.float32)


def _edges() -> np.ndarray:
    f = np.float32
    pts = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-40,
           -1e-40, 1.1754942e-38, 2 ** -12, 2 ** -13, 2 ** -126, 119.9,
           120.0, 120.1, 1e4, 3.4e38, -3.4e38]
    for c in (np.pi / 2, np.pi, 3 * np.pi / 2, 2 * np.pi, np.pi / 4,
              0.6744, 0.4375, 1.1875, 2.4375, 2 ** 25):
        x = f(c)
        for k in range(-3, 4):
            y = x
            for _ in range(abs(k)):
                y = np.nextafter(y, f(np.inf) if k > 0 else f(-np.inf))
            pts += [y, -y]
    return np.array(pts, np.float32)


def _inputs(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n4 = N // 4
    return np.concatenate([
        _bits(rng.integers(0, 1 << 32, n4, dtype=np.uint64)),  # any float
        rng.uniform(-8, 8, n4).astype(np.float32),             # angles
        rng.uniform(-130, 130, n4).astype(np.float32),         # reductions
        (rng.standard_normal(N - 3 * n4) * 1e-3).astype(np.float32),
        _edges()])


def _same(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a)
                                                     & np.isnan(b))


def _host1(name: str, x: np.ndarray) -> np.ndarray:
    fn = getattr(LIBM, name)
    return np.array([fn(v) for v in x.tolist()], np.float32)


@needs_glibc
@pytest.mark.parametrize("name", ["sinf", "cosf", "tanf"])
def test_plain_unary_equals_glibc(name):
    x = _inputs({"sinf": 1, "cosf": 2, "tanf": 3}[name])
    want = _host1(name, x)
    got = getattr(lf, name)(torch.from_numpy(x)).numpy()
    bad = ~_same(got, want)
    assert not bad.any(), (int(bad.sum()), x[bad][:5], got[bad][:5],
                           want[bad][:5])


@needs_glibc
def test_plain_sincosf_equals_glibc():
    x = _inputs(4)[:N // 4]
    s, c = ctypes.c_float(), ctypes.c_float()
    ws, wc = [], []
    for v in x.tolist():
        LIBM.sincosf(v, ctypes.byref(s), ctypes.byref(c))
        ws.append(s.value)
        wc.append(c.value)
    gs, gc = lf.sincosf(torch.from_numpy(x))
    assert _same(gs.numpy(), np.array(ws, np.float32)).all()
    assert _same(gc.numpy(), np.array(wc, np.float32)).all()


@needs_glibc
def test_plain_atan2f_equals_glibc():
    rng = np.random.default_rng(5)
    y = _inputs(6)
    x = np.concatenate([_bits(rng.integers(0, 1 << 32, N // 2,
                                            dtype=np.uint64)),
                        rng.standard_normal(len(y) - N // 2)
                        .astype(np.float32)])
    rng.shuffle(x)
    # every sign quadrant and the special operands against each other
    sp = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 1e-40,
                   -1e-40, 3.0, -3.0, 1e30, -1e30], np.float32)
    gy, gx = np.meshgrid(sp, sp)
    y = np.concatenate([y, gy.ravel()])
    x = np.concatenate([x, gx.ravel()])
    x[:64] = 1.0                        # x == 1 takes atanf(y)
    want = np.array([LIBM.atan2f(a, b) for a, b in zip(y.tolist(),
                                                        x.tolist())],
                    np.float32)
    got = lf.atan2f(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    bad = ~_same(got, want)
    assert not bad.any(), (int(bad.sum()), y[bad][:5], x[bad][:5])


def test_expansions_match_jit_jax():
    """ops/libm_kernel's arcsin / arccos / arctan (on the CPU: plain
    versions) against jax.jit(jnp.arcsin) etc.; sqrt against numpy's
    correctly rounded float32 sqrt."""
    rng = np.random.default_rng(7)
    u = np.concatenate([rng.uniform(-1, 1, 1 << 18),
                        [-1.0, 1.0, 0.0, -0.0, 1.0000001, -1.0000001,
                         0.99999994, -0.99999994]]).astype(np.float32)
    t = np.concatenate([(rng.standard_normal(1 << 18) * 10),
                        [0.0, -0.0, np.inf, -np.inf, 1e30]]) \
        .astype(np.float32)
    for fn, jfn, a in ((libm_kernel.asin, jnp.arcsin, u),
                       (libm_kernel.acos, jnp.arccos, u),
                       (libm_kernel.atan, jnp.arctan, t)):
        want = np.asarray(jax.jit(jfn)(jnp.asarray(a)))
        got = fn(torch.from_numpy(a)).numpy()
        assert _same(got, want).all(), jfn.__name__
    q = np.abs(_inputs(8))
    q = q[~np.isnan(q)]
    np.testing.assert_array_equal(
        lf.sqrtf(torch.from_numpy(q)).numpy().view(np.int32),
        np.sqrt(q).view(np.int32))


def test_fma_emulation_is_exact():
    """fma64 and fma32 against exact rational arithmetic rounded once."""
    rng = np.random.default_rng(9)
    a, b, c = (rng.standard_normal(4000) * 10 ** rng.uniform(-3, 3, 4000)
               for _ in range(3))
    c[:1000] = -(a[:1000] * b[:1000])          # heavy cancellation
    got = lf.fma64(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for i in range(0, 4000, 7):
        exact = (fractions.Fraction(a[i]) * fractions.Fraction(b[i])
                 + fractions.Fraction(c[i]))
        assert got[i] == float(exact), i
    a32, b32, c32 = (v.astype(np.float32) for v in (a, b, c))
    got32 = lf.fma32(*(torch.from_numpy(v) for v in (a32, b32, c32)))
    for i in range(0, 4000, 7):
        exact = (fractions.Fraction(float(a32[i]))
                 * fractions.Fraction(float(b32[i]))
                 + fractions.Fraction(float(c32[i])))
        assert got32[i].item() == float(np.float32(_round32(exact))), i


def _round32(q: fractions.Fraction) -> float:
    """q rounded once to float32 (nearest, ties to even)."""
    if q == 0:
        return 0.0
    f = np.float32(float(q))               # within one ulp of q
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    best = min(cands, key=lambda v: (abs(fractions.Fraction(float(v)) - q),
                                     int(np.array(v).view(np.int32)) & 1))
    return float(best)


def _intel() -> bool:
    return os.path.exists("/proc/cpuinfo") and \
        "GenuineIntel" in open("/proc/cpuinfo").read()


@pytest.mark.skipif(not _intel(), reason="the RSQRTSS table copied is an "
                    "Intel core's; other vendors' estimates differ")
def test_rsqrt_xla_form():
    """XLA's rsqrt (jax.lax.rsqrt jit-compiled on this CPU): the RSQRTSS
    estimate (exponent parity and ten mantissa bits) refined by two Newton
    steps in FMAs, bit for bit; and within one ulp of 1/sqrt."""
    rng = np.random.default_rng(10)
    x = np.concatenate([rng.uniform(0.01, 1e4, 1 << 16),
                        2.0 ** rng.integers(-120, 120, 1000),
                        _bits(rng.integers(0, 1 << 31, 1 << 16,
                                           dtype=np.uint64))]) \
        .astype(np.float32)
    x = np.concatenate([x, np.array([0.0, -0.0, np.inf, -1.0, 1e-40],
                                    np.float32)])
    got = lf.rsqrt_xla(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    assert _same(got, want).all(), int((~_same(got, want)).sum())
    ok = np.isfinite(x) & (x > 1e-30)
    exact = 1 / np.sqrt(x[ok].astype(np.float64))
    ulp = np.spacing(exact.astype(np.float32)).astype(np.float64)
    assert (np.abs(got[ok].astype(np.float64) - exact) <= ulp).all()
