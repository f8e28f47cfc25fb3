// L1: float32 sinf, cosf, tanf and atan2f for Hopper (sm_90a), rounded
// exactly as glibc 2.36 rounds them on x86-64, elementwise.
//
// The arithmetic is libm_f32.cuh's (glibc's code, see there), which
// csrc/sphere_positions.cu shares: that kernel computes MPA's and ROT's
// sphere positions whole, and these elementwise entry points serve the
// other models' float32 chains (3DT, TAN, GED) and the MV conversions.
// This file is built with -fmad=false, as the header requires.  The plain
// versions are common/libm_f32.py; the wrappers, ops/libm_kernel.py.
//
// Bound: bytes.  Each element reads one or two floats and writes one; a
// thread takes one element (elementwise, no reuse), so the kernel's floor
// is its words over the memory rate, against its double operations (about
// 30 a sinf) over the FP64 rate.

#include "libm_f32.cuh"

namespace {

constexpr int THREADS = 256;

template <int F>
__global__ void __launch_bounds__(THREADS)
libm_kernel(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(THREADS) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * THREADS) {
    float v = a[i];
    float r;
    if (F == 0) r = g_sincosf(v, false);
    else if (F == 1) r = g_sincosf(v, true);
    else if (F == 2) r = g_tanf(v);
    else r = g_atan2f(v, b[i]);
    out[i] = r;
  }
}

template <int F>
int launch(const float* a, const float* b, float* out, int64_t n,
           cudaStream_t stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;
  libm_kernel<F><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {
// out[i] = f(a[i]) (atan2f: f(a[i], b[i]), a the y argument); float32
// device pointers; returns the CUDA error of the launch.
int libm_sinf(const float* a, float* out, int64_t n, cudaStream_t s) {
  return launch<0>(a, nullptr, out, n, s);
}
int libm_cosf(const float* a, float* out, int64_t n, cudaStream_t s) {
  return launch<1>(a, nullptr, out, n, s);
}
int libm_tanf(const float* a, float* out, int64_t n, cudaStream_t s) {
  return launch<2>(a, nullptr, out, n, s);
}
int libm_atan2f(const float* y, const float* x, float* out, int64_t n,
                cudaStream_t s) {
  return launch<3>(y, x, out, n, s);
}
}
