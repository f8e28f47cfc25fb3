// Dependent quantization for Hopper (sm_90a): D1 quantize_dep, the trellis
// quantizer, and D2 dequantize_dep, its normative dequantizer.
//
// They replace the two `lax.scan`s of vvc_mm_tpu/common/depquant.py
// (quantize_dep at :70, dequantize_dep at :165); the JAX package has no
// Pallas kernel for them.  VVC's dependent quantization couples two scalar
// quantizers, half a step apart, through a 4-state machine driven by level
// parity: states 0/1 reconstruct t = 2*level, states 2/3 t = 2*level - 1
// (for a nonzero level), next = TRANS[state][level & 1].  D1 picks the
// level sequence that minimises sum(err^2 + lambda*rate) along the coding
// order (the reverse diagonal scan) by a Viterbi search over the 4 states,
// 3 candidate levels a state ({0, l0, l0+1}, l0 the nearest lattice level
// below), then backtracks; D2 runs the state machine and scales.
//
// Bound: neither bytes nor operations.  Each coding position depends on
// the cost front of the one before, so one block is a serial chain of n
// steps (12 candidate costs, 4 first-minima over them) of some tens of
// dependent instructions each: about 1-2 us for an 8x8 block however many
// blocks run beside it.  The design is one thread per block, the 4 costs in
// registers; the card's parallelism is the batch (a wavefront step's blocks
// times its candidate transforms, e.g. 896 luma items at 2048x1024).  The
// (level, source state) decision of each position and destination state is
// kept for the backtrack: in shared memory for blocks of up to 64
// coefficients (32 threads x 64 x 4 words, 32 KB), in a global scratch
// laid out [position][state][block] for larger ones.
//
// Numerics follow the plain version (common/depquant.py) exactly: a
// candidate's cost is fma(err, err, cost) + lam_h*rate as XLA computes it
// on the CPU, the fused multiply-add taken in double (the product of two
// floats is exact there) and rounded once to float, every operation
// written as an _rn intrinsic so that nvcc contracts nothing else; the
// rate of a level is read from the same float32 table,
// ties take the first flat candidate (src*3 + k) and the first cheapest
// final state, and dead states carry 3e38 exactly as the plain version's
// masked entries do.  D2 is integer only, its int32 products wrapping as
// the plain version's do.
#include <cuda_runtime.h>
#include <stdint.h>

#define DQ_THREADS 32
#define DQ_SMEM_MAX_N 64
#define DQ_INF 3e38f
#define DQ_MAX_LEVEL 32767

__constant__ int c_trans[4][2] = {{0, 2}, {2, 0}, {1, 3}, {3, 1}};
__constant__ int c_soff[4] = {0, 0, 1, 1};

__device__ __forceinline__ int32_t mul_wrap(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
}

__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t rshift_round(int32_t x, int shift) {
    if (shift <= 0) return (int32_t)((uint32_t)x << (-shift));
    return add_wrap(x, 1 << (shift - 1)) >> shift;
}

__device__ __forceinline__ int32_t clip16(int32_t x) {
    return min(max(x, -32768), 32767);
}

template <bool SMEM>
__global__ void __launch_bounds__(DQ_THREADS)
quantize_dep_kernel(const int32_t* __restrict__ coeff, int b, int n,
                    const int32_t* __restrict__ order,
                    const float* __restrict__ rate, float xscale,
                    float lam_h, int odd, int32_t* __restrict__ scratch,
                    int32_t* __restrict__ out) {
    __shared__ int32_t s_dec[SMEM ? DQ_SMEM_MAX_N * 4 * DQ_THREADS : 1];
    const int item = blockIdx.x * DQ_THREADS + threadIdx.x;
    if (item >= b) return;
    const int32_t* blk = coeff + (size_t)item * n;
    // decision (level << 2 | source state) of position p, state s
    auto dec_at = [&](int p, int s) -> int32_t& {
        if (SMEM) return s_dec[(p * 4 + s) * DQ_THREADS + threadIdx.x];
        return scratch[((size_t)p * 4 + s) * b + item];
    };
    float cost[4] = {0.0f, DQ_INF, DQ_INF, DQ_INF};
    for (int p = 0; p < n; ++p) {
        int32_t v = blk[order[p]];
        int32_t mag = abs(v);
        if (odd) mag = add_wrap(mul_wrap(mag, 181), 128) >> 8;
        const float x = __fmul_rn((float)mag, xscale);
        float c[12];
        int lv[12], dst[12];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            const float ideal = __fmul_rn(__fadd_rn(x, (float)c_soff[s]),
                                          0.5f);
            const int l0 = (int)fminf(fmaxf(floorf(ideal), 0.0f),
                                      (float)(DQ_MAX_LEVEL - 1));
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const int l = k == 0 ? 0 : l0 + (k - 1);
                const float t = (float)(2 * l - (l > 0 ? c_soff[s] : 0));
                const double err = (double)__fsub_rn(x, t);
                const float d = __double2float_rn(
                    __dadd_rn((double)cost[s], __dmul_rn(err, err)));
                c[s * 3 + k] = __fadd_rn(d, __fmul_rn(lam_h, rate[l]));
                lv[s * 3 + k] = l;
                dst[s * 3 + k] = c_trans[s][l & 1];
            }
        }
#pragma unroll
        for (int sp = 0; sp < 4; ++sp) {
            // first minimum over the 12 flat candidates, entries of other
            // destinations masked to 3e38 (so an all-dead destination takes
            // flat candidate 0, as the plain version's argmin does)
            float best = dst[0] == sp ? c[0] : DQ_INF;
            int bk = 0;
#pragma unroll
            for (int k = 1; k < 12; ++k) {
                const float ck = dst[k] == sp ? c[k] : DQ_INF;
                if (ck < best) {
                    best = ck;
                    bk = k;
                }
            }
            cost[sp] = best;
            dec_at(p, sp) = (lv[bk] << 2) | (bk / 3);
        }
    }
    int cur = 0;
#pragma unroll
    for (int s = 1; s < 4; ++s)
        if (cost[s] < cost[cur]) cur = s;
    int32_t* dst_blk = out + (size_t)item * n;
    for (int p = n - 1; p >= 0; --p) {
        const int32_t d = dec_at(p, cur);
        const int pos = order[p];
        const int32_t v = blk[pos];
        const int32_t lev = d >> 2;
        dst_blk[pos] = v > 0 ? lev : (v < 0 ? -lev : 0);
        cur = d & 3;
    }
}

__global__ void __launch_bounds__(DQ_THREADS)
dequantize_dep_kernel(const int32_t* __restrict__ level, int b, int n,
                      const int32_t* __restrict__ order, int i_scale,
                      int dq_shift, int odd, int32_t* __restrict__ out) {
    const int item = blockIdx.x * DQ_THREADS + threadIdx.x;
    if (item >= b) return;
    const int32_t* blk = level + (size_t)item * n;
    int32_t* dst = out + (size_t)item * n;
    int state = 0;
    for (int p = 0; p < n; ++p) {
        const int pos = order[p];
        const int32_t l = blk[pos];
        const int32_t a = abs(l);
        const int32_t t = 2 * a - (a > 0 ? c_soff[state] : 0);
        state = c_trans[state][a & 1];
        const int32_t tv = l > 0 ? t : (l < 0 ? -t : 0);
        int32_t c = mul_wrap(tv, i_scale);
        c = odd ? clip16(rshift_round(mul_wrap(c, 181), 8 + dq_shift - 1))
                : clip16(rshift_round(c, dq_shift));
        dst[pos] = c;
    }
}

// Refuses an empty batch, a block size outside 1 .. 4096 coefficients and a
// block of more than 64 coefficients without a scratch.
extern "C" int quantize_dep(const void* coeff, int b, int n,
                            const void* order, const void* rate,
                            float xscale, float lam_h, int odd,
                            void* scratch, void* out, void* stream) {
    if (b < 1 || n < 1 || n > 4096) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((b + DQ_THREADS - 1) / DQ_THREADS);
    if (n <= DQ_SMEM_MAX_N) {
        quantize_dep_kernel<true><<<grid, DQ_THREADS, 0,
                                    (cudaStream_t)stream>>>(
            (const int32_t*)coeff, b, n, (const int32_t*)order,
            (const float*)rate, xscale, lam_h, odd, nullptr,
            (int32_t*)out);
    } else {
        if (scratch == nullptr) return (int)cudaErrorInvalidValue;
        quantize_dep_kernel<false><<<grid, DQ_THREADS, 0,
                                     (cudaStream_t)stream>>>(
            (const int32_t*)coeff, b, n, (const int32_t*)order,
            (const float*)rate, xscale, lam_h, odd, (int32_t*)scratch,
            (int32_t*)out);
    }
    return (int)cudaGetLastError();
}

extern "C" int dequantize_dep(const void* level, int b, int n,
                              const void* order, int i_scale, int dq_shift,
                              int odd, void* out, void* stream) {
    if (b < 1 || n < 1) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((b + DQ_THREADS - 1) / DQ_THREADS);
    dequantize_dep_kernel<<<grid, DQ_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)level, b, n, (const int32_t*)order, i_scale,
        dq_shift, odd, (int32_t*)out);
    return (int)cudaGetLastError();
}
