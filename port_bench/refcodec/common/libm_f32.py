"""float32 sin, cos, tan, atan2 and sqrt rounded as the JAX package's CPU
code rounds them — plain torch versions of kernel L1.

XLA's CPU backend compiles `jnp.sin`/`cos`/`tan`/`arctan2` into calls of
glibc's float32 `sinf`, `cosf`, `sincosf`, `tanf` and `atan2f`, and expands
`arcsin`, `arccos` and `arctan` into `atan2` (ops/libm_kernel.py copies
the expansions).  Neither torch's nor CUDA's math library rounds like glibc,
so the sphere positions, which are rounded to 1/16 pel and are normative,
came out one unit apart at some subblocks.  These functions copy glibc
2.36 for x86-64 as its ifunc selects it on a CPU with FMA and AVX2:

- `sinf`/`cosf`/`sincosf`: the FMA build of sysdeps/ieee754/flt-32/
  s_sinf.c / s_cosf.c (double-precision polynomials, every `a + b*c`
  contracted into one fused multiply-add, reduction `x - n*pi/2` fused
  too); `sincosf` returns what `sinf` and `cosf` return.
- `tanf`: s_tanf.c (no FMA build): the same double reduction with the
  product and the difference rounded on their own, then fdlibm's float
  `__kernel_tanf`.
- `atan2f`: fdlibm's float e_atan2f.c and s_atanf.c.

Double arithmetic runs in float64 tensors, each operation rounded on its
own; a fused multiply-add is emulated exactly (an error-free product and
sums, rounding to odd: Boldo and Melquiond, "Emulation of FMA and
correctly rounded sums", IEEE TC 2008).  float32 arithmetic runs in
float32 tensors.  Every function runs on the device of its input; the
wrappers of `ops/libm_kernel.py` launch the CUDA kernel on the card.
"""
from __future__ import annotations

import struct

import torch

F32, F64, I32, I64 = torch.float32, torch.float64, torch.int32, torch.int64


def _f(h: int) -> float:
    """The float32 whose bits are h, as a Python float (exact)."""
    return struct.unpack("<f", struct.pack("<I", h))[0]


def _d(h: str) -> float:
    return float.fromhex(h)


# __sincosf_table (s_sincosf.h): c0, c1, s1, c2, s2, c3, s3, c4 of table 0
# (table 1 negates the cosine coefficients)
HPI_INV = _d("0x1.45f306dc9c883p+23")     # 2/pi * 2^24
HPI = _d("0x1.921fb54442d18p+0")
PI63 = _d("0x1.921fb54442d18p-62")
C0, C1 = 1.0, _d("-0x1.ffffffd0c621cp-2")
C2, C3 = _d("0x1.55553e1068f19p-5"), _d("-0x1.6c087e89a359dp-10")
C4 = _d("0x1.99343027bf8c3p-16")
S1, S2 = _d("-0x1.555545995a603p-3"), _d("0x1.1107605230bc4p-7")
S3 = _d("-0x1.994eb3774cf24p-13")
# __inv_pio4: 2/pi in overlapping 32-bit windows, 8 bits apart
INV_PIO4 = (0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
            0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757,
            0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
            0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c,
            0x95993c43, 0x993c4390, 0x3c439041)
# __kernel_tanf (k_tanf.c)
T = tuple(_f(h) for h in (
    0x3eaaaaab, 0x3e088889, 0x3d5d0dd1, 0x3cb327a4, 0x3c11371f, 0x3b6b6916,
    0x3abede48, 0x3a1a26c8, 0x398137b9, 0x38a3f445, 0x3895c07a, 0xb79bae5f,
    0x37d95384))
PIO4_HI, PIO4_LO = _f(0x3f490fda), _f(0x33222168)
# s_atanf.c
ATAN_HI = tuple(_f(h) for h in (0x3eed6338, 0x3f490fda, 0x3f7b985e,
                                0x3fc90fda))
ATAN_LO = tuple(_f(h) for h in (0x31ac3769, 0x33222168, 0x33140fb4,
                                0x33a22168))
AT_ODD = tuple(_f(h) for h in (0x3c8569d7, 0x3d4bda59, 0x3d886b35, 0x3dba2e6e,
                               0x3e124925, 0x3eaaaaab))   # aT[10], ..., aT[0]
AT_EVEN = tuple(_f(h) for h in (0xbd15a221, 0x3d6ef16b, 0x3d9d8795,
                                0x3de38e38, 0x3e4ccccd))  # aT[9]; -aT[7..1]
# e_atan2f.c
PI_F, PI_O_2_F, PI_O_4_F = _f(0x40490fdb), _f(0x3fc90fdb), _f(0x3f490fdb)
PI_LO_NEG = _f(0x33bbbd2e)          # -pi_lo
HALF_PI_LO_NEG = _f(0x333bbd2e)     # -0.5 * pi_lo
TINY = _f(0x0da24260)
PI3_O_4_F = struct.unpack("<f", struct.pack("<f", 3.0 * PI_O_4_F))[0]


# ---------------------------------------------------------------------------
# exact double arithmetic
# ---------------------------------------------------------------------------
def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    c = a * 134217729.0                     # 2^27 + 1
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_odd_sum(a, b):
    """a + b rounded to odd: an inexact sum whose last bit is even moves
    one unit toward the exact value, a step of its word."""
    s, e = _two_sum(a, b)
    bits = s.view(I64)
    step = ((e != 0) & ((bits & 1) == 0)).to(I64)
    return (bits + step * torch.where((e > 0) == (s > 0), 1, -1)).view(F64)


def fma64(a, b, c):
    """round(a*b + c) of float64 tensors, rounded once (finite, normal
    intermediates; every use here stays far from over- and underflow)."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, ul)
    vh, vl = _two_sum(uh, th)
    return vh + _round_odd_sum(tl, vl)


def _tab(t, *vals):
    """vals[t] per element, t an int64 index tensor."""
    return torch.tensor(vals, dtype=F64, device=t.device)[t]


def sqrtf(x):
    """Correctly rounded float32 sqrt (torch's CPU float32 sqrt is not)."""
    return torch.sqrt(x.to(F64)).to(F32)


# ---------------------------------------------------------------------------
# sinf / cosf (s_sinf.c, s_cosf.c, s_sincosf.h; FMA build)
# ---------------------------------------------------------------------------
def _reduce_fast(x, fused: bool):
    n = (((x * HPI_INV).to(I32) + 0x800000) >> 24).to(I64)
    nd = n.to(F64)
    if fused:
        return fma64(-nd, torch.full_like(x, HPI), x), n
    return x - nd * HPI, n


def _reduce_large(bits):
    """Payne-Hanek reduction of |x| (bits: int64 float32 words); zeros
    where no element needs it (|x| < 120 throughout, the common case)."""
    if not bool((((bits >> 20) & 0x7ff) > 0x42e).any()):
        return torch.zeros_like(bits, dtype=F64), torch.zeros_like(bits)
    arr = torch.tensor(INV_PIO4, dtype=I64, device=bits.device)
    k = (bits >> 26) & 15
    shift = (bits >> 23) & 7
    xi = ((bits & 0x7fffff) | 0x800000) << shift            # < 2^31
    m32 = (1 << 32) - 1
    r0 = (xi * arr[k]) & m32
    r1 = xi * arr[k + 4]
    r2 = xi * arr[k + 8]
    res = ((r2 >> 32) | (r0 << 32)) + r1                    # mod 2^64
    n = ((res + (1 << 61)) >> 62) & 3
    res = res - (n << 62)
    return res.to(F64) * PI63, n


def _poly(x, x2, odd, t):
    """sinf_poly: the sine polynomial x + x^3 s1 + x^7 (s2 + x^2 s3) where
    odd is 0, the cosine one c1' + x^4 c2 + x^6 (c3 + x^2 c4), c1' =
    c0 + x^2 c1 (table t), where it is 1; both as fma(fma(x2, F, E), Q,
    fma(B, P, A)) with per-element coefficients."""
    o = odd == 1
    sg = torch.where(t == 1, -1.0, 1.0).to(F64)

    def coef(c_sin, c_cos):
        return torch.where(o, c_cos * sg, torch.full_like(x, c_sin))
    x3 = x2 * x
    x4 = x2 * x2
    a = torch.where(o, fma64(x2, C1 * sg, C0 * sg), x)
    b = torch.where(o, x4, x3)
    q = torch.where(o, x2 * x4, x2 * x3)
    inner = fma64(x2, coef(S3, C4), coef(S2, C3))
    return fma64(inner, q, fma64(b, coef(S1, C2), a))


def _poly_plain(x, x2, odd, t):
    """_poly with each multiply and add rounded on its own."""
    o = odd == 1
    sg = torch.where(t == 1, -1.0, 1.0).to(F64)
    x3, x4 = x2 * x, x2 * x2
    sres = x + x3 * S1 + (x2 * x3) * (S2 + x2 * S3)
    cres = sg * ((C0 + x2 * C1) + x4 * C2 + (x2 * x4) * (C3 + x2 * C4))
    return torch.where(o, cres, sres)


def _sincos_core(y, want_cos: bool):
    """sinf / cosf: the double arithmetic is first run with each operation
    rounded on its own, which lies within 2^-46 (|x| + |result|) of
    glibc's fused result; where that bound straddles a float32 rounding
    boundary (about one element in 10^5, every |x| >= 120 and the
    special values), glibc's arithmetic itself (_sincos_exact) decides."""
    y = y.to(F32)
    bits = y.view(I32).to(I64)
    top = (bits >> 20) & 0x7ff
    x = y.to(F64)
    xr, n = _reduce_fast(torch.where(top <= 0x42e, x, torch.zeros_like(x)),
                         fused=False)
    small = top < 0x3f4
    xr = torch.where(small, x, xr)
    q = torch.where(small, torch.zeros_like(n), n)
    s = _tab(q & 3, 1.0, -1.0, -1.0, 1.0)
    odd = q & 1 ^ 1 if want_cos else q & 1
    v = _poly_plain(xr * s, xr * xr, odd, (q >> 1) & 1)
    err = (x.abs() + v.abs()) * 2.0 ** -46
    r = v.to(F32)
    exact = ((v - err).to(F32) != (v + err).to(F32)) | (top > 0x42e) \
        | (top < 0x398)
    if bool(exact.any()):
        r[exact] = _sincos_exact(y[exact], want_cos)
    return r


def _sincos_exact(y, want_cos: bool):
    y = y.to(F32)
    bits = y.view(I32).to(I64)
    top = (bits >> 20) & 0x7ff
    x = y.to(F64)
    xr, n = _reduce_fast(torch.where(top <= 0x42e, x, torch.zeros_like(x)),
                         fused=True)
    xl, nl = _reduce_large(bits)
    sign = (bits >> 31) & 1
    large = top > 0x42e
    small = top < 0x3f4
    xr = torch.where(large, xl, xr)
    q = torch.where(large, nl + sign, n)                    # sign quadrant
    npar = torch.where(large, nl, n) & 1
    xr = torch.where(small, x, xr)
    q = torch.where(small, torch.zeros_like(q), q)
    npar = torch.where(small, torch.zeros_like(npar), npar)
    s = _tab(q & 3, 1.0, -1.0, -1.0, 1.0)
    t = (q >> 1) & 1
    odd = npar ^ 1 if want_cos else npar
    r = _poly(xr * s, xr * xr, odd, t).to(F32)
    tiny = top < 0x398
    r = torch.where(tiny, torch.ones_like(y) if want_cos else y, r)
    return torch.where(top >= 0x7f8, y - y, r)      # inf, NaN -> NaN


def sinf(y):
    return _sincos_core(y, want_cos=False)


def cosf(y):
    return _sincos_core(y, want_cos=True)


# ---------------------------------------------------------------------------
# tanf (s_tanf.c, k_tanf.c)
# ---------------------------------------------------------------------------
def _trunc12(v):
    """v with the low 12 bits of its float32 word cleared."""
    return (v.view(I32) & -4096).view(F32)


def _kernel_tanf(x, y, iy):
    """__kernel_tanf(x, y, iy) in float32; iy is +-1 (int32 tensor)."""
    hx = x.view(I32)
    ix = hx & 0x7fffffff
    big = ix >= 0x3f2ca140
    neg = big & (hx < 0)
    xb = torch.where(neg, -x, x)
    yb = torch.where(neg, -y, y)
    z = PIO4_HI - xb
    w = PIO4_LO - yb
    xb = w + z
    x1 = torch.where(big, xb, x)
    y1 = torch.where(big, torch.zeros_like(y), y)
    sgn = (1 - ((hx >> 30) & 2)).to(F32)
    ivf = iy.to(F32)
    near = sgn * ivf * (1.0 - (2 * iy).to(F32) * xb)
    z = x1 * x1
    w = z * z
    r = T[11] * w + T[9]
    v = T[12] * w + T[10]
    for i in (7, 5, 3, 1):
        r = r * w + T[i]
        v = v * w + T[i + 1]
    v = v * z
    s = x1 * z
    r = ((v + r) * s + y1) * z + y1
    r = (s * T[0]) + r
    w = x1 + r
    res_big = sgn * (ivf - (x1 - (w * w / (w + ivf) - r)) * 2.0)
    zt = _trunc12(w)
    v2 = r - (zt - x1)
    a = torch.div(torch.full_like(w, -1.0), w)
    t = _trunc12(a)
    res_inv = t + a * ((1.0 + t * zt) + t * v2)
    res = torch.where(iy == 1, w, res_inv)
    res = torch.where(big, torch.where(xb.abs() < _f(0x39000000), near,
                                       res_big), res)
    tiny = ix < 0x39000000
    m1 = torch.full_like(x, -1.0)
    res_tiny = torch.where(iy == 1, x, torch.div(m1, x))
    res_tiny = torch.where((ix == 0) & (iy == -1), torch.div(-m1, x.abs()),
                           res_tiny)
    return torch.where(tiny, res_tiny, res)


def tanf(xf):
    xf = xf.to(F32)
    bits = xf.view(I32).to(I64)
    ix = bits & 0x7fffffff
    top = (bits >> 20) & 0x7ff
    x = xf.to(F64)
    dx, n = _reduce_fast(torch.where(top <= 0x42e, x, torch.zeros_like(x)),
                         fused=False)
    dl, nl = _reduce_large(bits)
    dl = torch.where(bits < 0, -dl, dl)
    large = top > 0x42e
    dx = torch.where(large, dl, dx)
    n = torch.where(large, nl, n)
    y0 = dx.to(F32)
    y1 = (dx - y0.to(F64)).to(F32)
    iy = (1 - ((n & 1) << 1)).to(I32)
    small = ix <= 0x3f490fda
    y0 = torch.where(small, xf, y0)
    y1 = torch.where(small, torch.zeros_like(y1), y1)
    iy = torch.where(small, torch.ones_like(iy), iy)
    r = _kernel_tanf(y0, y1, iy)
    return torch.where(ix >= 0x7f800000, xf - xf, r)


# ---------------------------------------------------------------------------
# atanf / atan2f (s_atanf.c, e_atan2f.c)
# ---------------------------------------------------------------------------
def atanf(xf):
    xf = xf.to(F32)
    hx = xf.view(I32)
    ix = hx & 0x7fffffff
    a = xf.abs()
    one = torch.ones_like(a)
    x0 = (a + a - 1.0) / (a + 2.0)
    x1 = (a - 1.0) / (a + 1.0)
    x2 = (a - 1.5) / (a * 1.5 + 1.0)
    x3 = torch.div(-one, a)
    ids = torch.where(ix < 0x3f300000, 0, torch.where(
        ix < 0x3f980000, 1, torch.where(ix < 0x401c0000, 2, 3)))
    red = ix >= 0x3ee00000
    ids = torch.where(red, ids, -1)
    x = torch.where(ids == 0, x0, torch.where(ids == 1, x1, torch.where(
        ids == 2, x2, torch.where(ids == 3, x3, xf))))
    z = x * x
    w = z * z
    s1 = AT_ODD[0] * one
    for c in AT_ODD[1:]:
        s1 = s1 * w + c
    s1 = s1 * z
    s2 = AT_EVEN[0] * w
    for c in AT_EVEN[1:]:
        s2 = (s2 - c) * w
    q = (s1 + s2) * x
    plain = x - q
    idc = ids.clamp(min=0).to(I64)
    hi = torch.tensor(ATAN_HI, dtype=F32, device=xf.device)[idc]
    lo = torch.tensor(ATAN_LO, dtype=F32, device=xf.device)[idc]
    zr = hi - ((q - lo) - x)
    zr = torch.where(hx < 0, -zr, zr)
    r = torch.where(red, zr, plain)
    r = torch.where(ix < 0x31000000, xf, r)
    huge = torch.where(hx > 0, ATAN_LO[3] + ATAN_HI[3] * one,
                       -ATAN_HI[3] - ATAN_LO[3] * one)
    r = torch.where(ix >= 0x4c000000, huge, r)
    return torch.where(ix > 0x7f800000, xf + xf, r)


def atan2f(yf, xf):
    yf, xf = torch.broadcast_tensors(yf.to(F32), xf.to(F32))
    hx, hy = xf.view(I32), yf.view(I32)
    ix, iy = hx & 0x7fffffff, hy & 0x7fffffff
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)
    one = torch.ones_like(yf)
    pi_t = PI_F + TINY * one
    mpi_t = -PI_F - TINY * one
    hpi_t = torch.where(hy < 0, -PI_O_2_F - TINY * one, PI_O_2_F * one + TINY)
    # finite general case (atanf once: of y itself where x is 1)
    k = (iy - ix) >> 23
    x_one = hx == 0x3f800000
    z_one = atanf(torch.where(x_one, yf, (yf / xf).abs()))
    z = z_one
    z = torch.where((hx < 0) & (k < -60), torch.zeros_like(z), z)
    z = torch.where((iy - ix) > 0x1e7fffff, PI_O_2_F - HALF_PI_LO_NEG * one, z)
    r = torch.where(m == 0, z, torch.where(
        m == 1, -z, torch.where(m == 2, PI_F - (z + PI_LO_NEG),
                                (z + PI_LO_NEG) - PI_F)))
    r = torch.where(iy == 0x7f800000, hpi_t, r)
    # x infinite
    inf_inf = torch.where(m == 0, TINY + PI_O_4_F * one, torch.where(
        m == 1, -PI_O_4_F - TINY * one, torch.where(
            m == 2, PI3_O_4_F + TINY * one, -PI3_O_4_F - TINY * one)))
    inf_fin = torch.where(m == 0, torch.zeros_like(yf), torch.where(
        m == 1, -torch.zeros_like(yf), torch.where(m == 2, pi_t, mpi_t)))
    r = torch.where(ix == 0x7f800000,
                    torch.where(iy == 0x7f800000, inf_inf, inf_fin), r)
    r = torch.where(ix == 0, hpi_t, r)
    r = torch.where(iy == 0, torch.where(m < 2, yf, torch.where(
        m == 2, pi_t, mpi_t)), r)
    r = torch.where(x_one, z_one, r)
    return torch.where((ix > 0x7f800000) | (iy > 0x7f800000), xf + yf, r)


# ---------------------------------------------------------------------------
# XLA's float32 forms: contracted multiply-adds and its rsqrt
# ---------------------------------------------------------------------------
def fma32(a, b, c):
    """round(a*b + c) of float32 tensors (or float32 constants beside
    them), rounded once: XLA's CPU backend
    contracts a product that feeds an add into one FMA instruction.  The
    product is exact in float64; the sum is rounded to odd there, so the
    rounding to float32 is the single rounding of the exact value."""
    t = next(v for v in (a, b, c) if isinstance(v, torch.Tensor))
    a, b, c = torch.broadcast_tensors(*(
        torch.as_tensor(v, dtype=F32, device=t.device).to(F64)
        for v in (a, b, c)))
    return _round_odd_sum(a * b, c).to(F32)


# XLA's CPU exp (its own float32 polynomial, not glibc's): the argument
# clamped to [-87.8, 88.8], n = floor(x log2(e) + 0.5) clamped to +-127,
# t = x - n ln(2) in two steps, a degree-5 polynomial by Horner, then
# exp(t) = 1 + (t + t^2 p(t)) scaled by 2^n through the exponent bits
# (n = -127 gives 0).  Every multiply-add is one FMA, as XLA's backend
# contracts them.
_EXP_LO, _EXP_HI = -87.80000305175781, 88.80000305175781
_EXP_LOG2E = 1.4426950216293335
_EXP_C1, _EXP_C2 = 0.693359375, -0.00021219444170128554
_EXP_P = (0.00019875691214110702, 0.001398199936375022,
          0.008333452045917511, 0.04166579619050026, 0.1666666567325592,
          0.5)


# RSQRTSS of the Intel Xeon that wrote the JAX package's reference: the
# estimate depends on the exponent's parity and the top 10 mantissa bits;
# per parity, the first entry's float32 word >> 11 and then the decrements
# from entry to entry, minus one, two bits each.
_RSQRT_FIRST = (0x7effe, 0x7e69f)
_RSQRT_STEPS = (
    "ffffffbffffbffeffbfefefefefbefbefbeefbbeeefbbbbbbbbbaeeebbaeebae"
    "ebaeaebaeaeaeaeabaaeaaeaaeaaaeaaaabaaaaaaaaaaaaaaaaaa6aaaaa6aaa6"
    "aa9aa9aa6a9aa6a6a6a6a69a9a69a69a69a699a699a666999a66666999999999"
    "9966666599966599665996596659659659596595959656565655959565595655"
    "9559556555955595556555559555555565555555555555555555555515555555"
    "4555554555545555155455515545545545515455154551515454545454545454"
    "5151454515145145451451451451145144514511445144511444511444511144"
    "4451111114444444445111111111104444444444111111044441110444111044",
    "9aa6a9a9aa69a9a6a69a69a699a6699a66699999a66666599999966659966596"
    "6596596596595965656565656559565595595595565556555565555555955555"
    "5555555555555554555555515555455545554555155155154551545515454545"
    "4545454515145451454514514514514451451144514451144451114445111114"
    "4444445111111111111044444444111110444111044411044110441104110411"
    "0410441041041041041040410410104041010404101010101010101010100404"
    "0101004010040100400401001001001001000400100040010001000040001000"
    "0400001000001000000400000004000000000100000000000000000000000000")
_RSQRT_TABLE: dict = {}


def _rsqrt_table(device) -> torch.Tensor:
    """The 2048 estimates (float32 words) as an int64 tensor on `device`."""
    key = str(device)
    if key not in _RSQRT_TABLE:
        words = []
        for first, steps in zip(_RSQRT_FIRST, _RSQRT_STEPS):
            v = first
            for ch in steps:
                for d in (int(ch, 16) >> 2, int(ch, 16) & 3):
                    words.append(v << 11)
                    v -= d + 1
        assert len(words) == 2048
        _RSQRT_TABLE[key] = torch.tensor(words, dtype=I64, device=device)
    return _RSQRT_TABLE[key]


def rsqrt_xla(x):
    """float32 1/sqrt(x) as XLA's CPU backend emits `rsqrt`: the RSQRTSS
    estimate refined by two Newton steps, e = fma(x*y, y, -1) and
    y = fma(-0.5*y, e, y); a zero, subnormal, negative or infinite x takes
    the estimate itself."""
    x = x.to(F32)
    bits = x.view(I32).to(I64)
    e = (bits >> 23) & 0xff
    par = (e - 127) & 1
    half = (e - 127 - par) >> 1
    est = _rsqrt_table(x.device)[par * 1024 + ((bits >> 13) & 1023)]
    y = ((est - (half << 23)) & 0xffffffff).to(I32).view(F32)
    normal = (e > 0) & (e < 255) & (bits >= 0) & (bits < (1 << 31))
    y = torch.where(normal, y, torch.where(
        (e == 0), torch.where(bits < 0, -torch.full_like(x, float("inf")),
                              torch.full_like(x, float("inf"))),
        torch.where(x == float("inf"), torch.zeros_like(x),
                    torch.full_like(x, float("nan")))))
    for _ in range(2):
        err = fma32(x * y, y, torch.full_like(x, -1.0))
        y = torch.where(normal, fma32(y * -0.5, err, y), y)
    return y
