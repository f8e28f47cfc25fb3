// glibc 2.36's float32 sinf, cosf, tanf and atan2f as device functions,
// rounded exactly as glibc rounds them on x86-64 (kernel L1's arithmetic).
//
// The JAX package's sphere positions are float32 code that XLA's CPU
// backend compiles into calls of glibc's sinf / cosf / sincosf / tanf /
// atan2f (arcsin, arccos and arctan it expands into atan2).  The positions
// are rounded to 1/16 pel and are normative, and CUDA's own sinf / atan2f
// round otherwise, so the card computes glibc's functions here:
//
//  * g_sincosf: the FMA build of sysdeps/ieee754/flt-32/s_sinf.c and
//    s_cosf.c, which glibc's ifunc selects on a CPU with FMA and AVX2:
//    the argument in double, reduced by x - n*pi/2 (one fma) or by the
//    Payne-Hanek multiply above 120, then a double polynomial in which
//    every a + b*c is one fma, rounded once to float.
//  * g_tanf: s_tanf.c (no FMA build): the same reduction with the product
//    and the difference rounded on their own, split into two floats, then
//    fdlibm's float __kernel_tanf.
//  * g_atan2f: fdlibm's float e_atan2f.c and s_atanf.c.
//
// A source that includes this header is built with -fmad=false, so that
// nvcc contracts no multiply and add that glibc keeps apart; every
// intended fused multiply-add is an explicit fma().  The plain versions
// are common/libm_f32.py.  LIBM_FN, defined before the include, sets how
// the four functions are declared (by default plain __device__ functions).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#ifndef LIBM_FN
#define LIBM_FN __device__
#endif

namespace {


__device__ __forceinline__ uint32_t fbits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ float bitsf(uint32_t u) { return __uint_as_float(u); }

// __sincosf_table[0]; table 1 negates the cosine coefficients
constexpr double HPI_INV = 0x1.45f306dc9c883p+23;
constexpr double HPI = 0x1.921fb54442d18p+0;
constexpr double PI63 = 0x1.921fb54442d18p-62;
constexpr double C0 = 1.0, C1 = -0x1.ffffffd0c621cp-2, C2 = 0x1.55553e1068f19p-5,
                 C3 = -0x1.6c087e89a359dp-10, C4 = 0x1.99343027bf8c3p-16;
constexpr double S1 = -0x1.555545995a603p-3, S2 = 0x1.1107605230bc4p-7,
                 S3 = -0x1.994eb3774cf24p-13;

__constant__ uint32_t INV_PIO4[24] = {
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
    0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757,
    0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
    0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c,
    0x95993c43, 0x993c4390, 0x3c439041};

__device__ __forceinline__ int reduce_fast_n(double x) {
  return (static_cast<int>(x * HPI_INV) + 0x800000) >> 24;
}

// Payne-Hanek reduction of |x|; returns the remainder, *np the quadrant
__device__ __forceinline__ double reduce_large(uint32_t xi, int* np) {
  const uint32_t* arr = &INV_PIO4[(xi >> 26) & 15];
  int shift = (xi >> 23) & 7;
  xi = (xi & 0xffffff) | 0x800000;
  xi <<= shift;
  uint64_t res0 = xi * arr[0];
  uint64_t res1 = static_cast<uint64_t>(xi) * arr[4];
  uint64_t res2 = static_cast<uint64_t>(xi) * arr[8];
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  uint64_t n = (res0 + (1ULL << 61)) >> 62;
  res0 -= n << 62;
  *np = static_cast<int>(n);
  return static_cast<double>(static_cast<int64_t>(res0)) * PI63;
}

// sinf_poly: the sine polynomial for even n, the cosine one (table t) odd
__device__ __forceinline__ float sinf_poly(double x, double x2, int t, int n) {
  if ((n & 1) == 0) {
    double x3 = x2 * x;
    double s1 = fma(x2, S3, S2);
    double x7 = x2 * x3;
    double s = fma(x3, S1, x);
    return static_cast<float>(fma(s1, x7, s));
  }
  double sg = t ? -1.0 : 1.0;
  double x4 = x2 * x2;
  double c1 = fma(x2, C1 * sg, C0 * sg);
  double c2 = fma(x2, C4 * sg, C3 * sg);
  double x6 = x2 * x4;
  double c = fma(x4, C2 * sg, c1);
  return static_cast<float>(fma(c2, x6, c));
}

__device__ __forceinline__ double sign_of(int q) {
  return ((q & 3) == 1 || (q & 3) == 2) ? -1.0 : 1.0;
}

LIBM_FN float g_sincosf(float y, bool want_cos) {
  double x = y;
  uint32_t top = (fbits(y) >> 20) & 0x7ff;
  if (top < 0x3f4) {
    if (top < 0x398) return want_cos ? 1.0f : y;
    return sinf_poly(x, x * x, 0, want_cos ? 1 : 0);
  }
  if (top <= 0x42e) {
    int n = reduce_fast_n(x);
    x = fma(-static_cast<double>(n), HPI, x);
    double s = sign_of(n);
    return sinf_poly(x * s, x * x, (n >> 1) & 1, want_cos ? n ^ 1 : n);
  }
  if (top < 0x7f8) {
    uint32_t xi = fbits(y);
    int sign = xi >> 31;
    int n;
    x = reduce_large(xi, &n);
    double s = sign_of(n + sign);
    return sinf_poly(x * s, x * x, ((n + sign) >> 1) & 1, want_cos ? n ^ 1 : n);
  }
  return y - y;
}

// __kernel_tanf (k_tanf.c)
__constant__ float T[13] = {
    0x1.555556p-2f, 0x1.111112p-3f, 0x1.ba1ba2p-5f, 0x1.664f48p-6f,
    0x1.226e3ep-7f, 0x1.d6d22cp-9f, 0x1.7dbc90p-10f, 0x1.344d90p-11f,
    0x1.026f72p-12f, 0x1.47e88ap-14f, 0x1.2b80f4p-14f, -0x1.375cbep-16f,
    0x1.b2a708p-16f};

__device__ float kernel_tanf(float x, float y, int iy) {
  int32_t hx = static_cast<int32_t>(fbits(x));
  int32_t ix = hx & 0x7fffffff;
  if (ix < 0x39000000) {
    if ((ix | (iy + 1)) == 0) return 1.0f / fabsf(x);
    if (iy == 1) return x;
    return -1.0f / x;
  }
  const bool big = ix >= 0x3f2ca140;
  if (big) {
    if (hx < 0) { x = -x; y = -y; }
    float z = bitsf(0x3f490fda) - x;
    float w = bitsf(0x33222168) - y;
    x = w + z;
    y = 0.0f;
    if (fabsf(x) < 0x1p-13f)
      return static_cast<float>((1 - ((hx >> 30) & 2)) * iy) *
             (1.0f - static_cast<float>(2 * iy) * x);
  }
  float z = x * x;
  float w = z * z;
  float r = T[11] * w + T[9];
  float v = T[12] * w + T[10];
  r = r * w + T[7]; v = v * w + T[8];
  r = r * w + T[5]; v = v * w + T[6];
  r = r * w + T[3]; v = v * w + T[4];
  r = r * w + T[1]; v = v * w + T[2];
  v = v * z;
  float s = x * z;
  r = ((v + r) * s + y) * z + y;
  r = s * T[0] + r;
  w = x + r;
  if (big) {
    float fv = static_cast<float>(iy);
    return static_cast<float>(1 - ((hx >> 30) & 2)) *
           (fv - (x - (w * w / (w + fv) - r)) * 2.0f);
  }
  if (iy == 1) return w;
  float zt = bitsf(fbits(w) & 0xfffff000u);
  float v2 = r - (zt - x);
  float a = -1.0f / w;
  float t = bitsf(fbits(a) & 0xfffff000u);
  float s2 = 1.0f + t * zt;
  return t + a * (s2 + t * v2);
}

LIBM_FN float g_tanf(float xf) {
  uint32_t u = fbits(xf);
  uint32_t ix = u & 0x7fffffff;
  if (ix <= 0x3f490fda) return kernel_tanf(xf, 0.0f, 1);
  if (ix >= 0x7f800000) return xf - xf;
  double dx = xf;
  int n;
  if (((u >> 20) & 0x7ff) <= 0x42e) {
    n = reduce_fast_n(dx);
    dx = dx - static_cast<double>(n) * HPI;
  } else {
    dx = reduce_large(u, &n);
    if (u >> 31) dx = -dx;
  }
  float y0 = static_cast<float>(dx);
  float y1 = static_cast<float>(dx - static_cast<double>(y0));
  return kernel_tanf(y0, y1, 1 - ((n & 1) << 1));
}

// s_atanf.c
__constant__ float ATAN_HI[4] = {0x1.dac670p-2f, 0x1.921fb4p-1f, 0x1.f730bcp-1f,
                                 0x1.921fb4p+0f};
__constant__ float ATAN_LO[4] = {0x1.586ed2p-28f, 0x1.4442d0p-25f,
                                 0x1.281f68p-25f, 0x1.4442d0p-24f};

__device__ float g_atanf(float x) {
  int32_t hx = static_cast<int32_t>(fbits(x));
  int32_t ix = hx & 0x7fffffff;
  int id;
  if (ix >= 0x4c000000) {
    if (ix > 0x7f800000) return x + x;
    if (hx > 0) return ATAN_LO[3] + ATAN_HI[3];
    return -ATAN_HI[3] - ATAN_LO[3];
  }
  if (ix < 0x3ee00000) {
    if (ix < 0x31000000) return x;
    id = -1;
  } else {
    x = fabsf(x);
    if (ix < 0x3f980000) {
      if (ix < 0x3f300000) { id = 0; x = (x + x - 1.0f) / (x + 2.0f); }
      else { id = 1; x = (x - 1.0f) / (x + 1.0f); }
    } else {
      if (ix < 0x401c0000) { id = 2; x = (x - 1.5f) / (x * 1.5f + 1.0f); }
      else { id = 3; x = -1.0f / x; }
    }
  }
  float z = x * x;
  float w = z * z;
  float s1 = 0x1.0ad3aep-6f;
  s1 = s1 * w + 0x1.97b4b2p-5f;
  s1 = s1 * w + 0x1.10d66ap-4f;
  s1 = s1 * w + 0x1.745cdcp-4f;
  s1 = s1 * w + 0x1.24924ap-3f;
  s1 = s1 * w + 0x1.555556p-2f;
  s1 = s1 * z;
  float s2 = -0x1.2b4442p-5f * w;
  s2 = (s2 - 0x1.dde2d6p-5f) * w;
  s2 = (s2 - 0x1.3b0f2ap-4f) * w;
  s2 = (s2 - 0x1.c71c70p-4f) * w;
  s2 = (s2 - 0x1.99999ap-3f) * w;
  float q = (s1 + s2) * x;
  if (id < 0) return x - q;
  float zr = ATAN_HI[id] - ((q - ATAN_LO[id]) - x);
  return hx < 0 ? -zr : zr;
}

// e_atan2f.c
LIBM_FN float g_atan2f(float y, float x) {
  const float pi = 0x1.921fb6p+1f, pi_o_2 = 0x1.921fb6p+0f,
              pi_o_4 = 0x1.921fb6p-1f, pi_lo_neg = 0x1.777a5cp-24f,
              tiny = 0x1.4484c0p-100f;
  int32_t hx = static_cast<int32_t>(fbits(x));
  int32_t hy = static_cast<int32_t>(fbits(y));
  int32_t ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  if (ix > 0x7f800000 || iy > 0x7f800000) return x + y;
  if (hx == 0x3f800000) return g_atanf(y);
  int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);
  if (iy == 0) {
    if (m < 2) return y;
    return m == 2 ? tiny + pi : -pi - tiny;
  }
  if (ix == 0) return hy < 0 ? -pi_o_2 - tiny : tiny + pi_o_2;
  if (ix == 0x7f800000) {
    const float pi3_o_4 = 3.0f * pi_o_4;
    if (iy == 0x7f800000) {
      switch (m) {
        case 0: return tiny + pi_o_4;
        case 1: return -pi_o_4 - tiny;
        case 2: return pi3_o_4 + tiny;
        default: return -pi3_o_4 - tiny;
      }
    }
    switch (m) {
      case 0: return 0.0f;
      case 1: return -0.0f;
      case 2: return tiny + pi;
      default: return -pi - tiny;
    }
  }
  if (iy == 0x7f800000) return hy < 0 ? -pi_o_2 - tiny : tiny + pi_o_2;
  int k = (iy - ix) >> 23;
  float z;
  if (iy - ix > 0x1e7fffff) z = pi_o_2 - 0x1.777a5cp-25f;
  else if (hx < 0 && k < -60) z = 0.0f;
  else z = g_atanf(fabsf(y / x));
  switch (m) {
    case 0: return z;
    case 1: return -z;
    case 2: return pi - (z + pi_lo_neg);
    default: return (z + pi_lo_neg) - pi;
  }
}

}  // namespace
