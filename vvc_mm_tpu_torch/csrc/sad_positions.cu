// Search-side position kernels for Hopper (sm_90a).
//
// K3 sad_block_positions, K4 mc_block_positions, K5 sad_luma_positions and
// K6 sad_bilinear_positions: the decision SADs of the multi-model motion
// search.  They replace the TPU kernels vvc_mm_tpu/ops/mc_kernel.py
// sad_block_positions_multi, mc_block_positions_multi,
// sad_luma_positions_multi and sad_bilinear_positions_multi.
//
//   K3/K4  For K candidate fields and every s-wide block: predict the
//          block's first 4-row band with the H.266 8-tap separable filter
//          at ONE 1/16-pel position per block.  K3 returns the SAD of the
//          band against the original band, K4 the predicted samples.
//   K5     For K candidate fields and every 4x4 subblock: predict the
//          subblock at its own position (as K1 does) and return its SAD
//          against the original.
//   K6     As K5 with the 2-tap bilinear filter (a 5x5 patch at the floor
//          position, no tap offset, no clip to the bit depth): the cheap
//          ranking SAD of a search's decision stages.
//
// Bound: memory traffic for all four at the codec's shapes (the padded
// plane, the positions and the original are read once, a few MB; the
// filter work is a few hundred M integer MACs).
// Design, K3/K4: one warp per (candidate, block).  The warp filters the
// (11, s) horizontal pass into its slice of shared memory, then its lanes
// walk the 4*s band samples for the vertical pass; K3 reduces the absolute
// differences with __shfl_down_sync and lane 0 stores one int.
// Design, K5: one half-warp per (candidate, subblock), one lane per output
// sample with the 8x8 filter read straight from the plane (the 11x11 patch
// stays in L1 between the 16 lanes), reduced over the 16 lanes.
// Design, K6: K5's layout; a lane reads the 2x2 samples around its output
// sample, filters the two rows horizontally and then vertically (the same
// roundings, in the same order, as filtering all five rows first).
// The window origin is clipped to the UNALIGNED padded shape exactly as the
// plain versions do.  Every shape and every K >= 1 is taken: nothing of the
// TPU kernels' layout (aligned superpatch + roll, scalar streams, the
// rows-per-step gates, whole-plane residency) carries over.  Arithmetic
// shifts of negative int32 values floor, as jnp's do.
#include <cuda_runtime.h>
#include <stdint.h>

// H.266 Table 8-11: 8-tap luma filter, 16 phases (common/interp.py
// LUMA_FILTER; a CPU test holds the two tables equal).
__constant__ int c_luma_filter[16][8] = {
    {  0,   0,   0,  64,   0,   0,   0,   0},
    {  0,   1,  -3,  63,   4,  -2,   1,   0},
    { -1,   2,  -5,  62,   8,  -3,   1,   0},
    { -1,   3,  -8,  60,  13,  -4,   1,   0},
    { -1,   4, -10,  58,  17,  -5,   1,   0},
    { -1,   4, -11,  52,  26,  -8,   3,  -1},
    { -1,   3,  -9,  47,  31, -10,   4,  -1},
    { -1,   4, -11,  45,  34, -10,   4,  -1},
    { -1,   4, -11,  40,  40, -11,   4,  -1},
    { -1,   4, -10,  34,  45, -11,   4,  -1},
    { -1,   4, -10,  31,  47,  -9,   3,  -1},
    { -1,   3,  -8,  26,  52, -11,   4,  -1},
    {  0,   1,  -5,  17,  58, -10,   4,  -1},
    {  0,   1,  -4,  13,  60,  -8,   3,  -1},
    {  0,   1,  -3,   8,  62,  -5,   2,  -1},
    {  0,   1,  -2,   4,  63,  -3,   1,   0}
};

#define TAPS 8
#define BAND 4                       // rows of a block's decision band
#define HROWS (BAND + TAPS - 1)      // rows of the horizontal pass

__device__ __forceinline__ int finalize_px(int vsum, int bit_depth) {
    const int val = vsum >> 6;
    const int fin_shift = 14 - bit_depth;          // IF_INTERNAL_PREC - bd
    const int pix = (val + (1 << (fin_shift - 1))) >> fin_shift;
    return min(max(pix, 0), (1 << bit_depth) - 1);
}

// K3 (SAD = true) and K4 (SAD = false).  blockDim.x = 32 * warps; dynamic
// shared memory = warps * HROWS * s ints.
template <bool SAD>
__global__ void band_positions_kernel(const int32_t* __restrict__ ref,
                                      int hp, int wp,
                                      const int32_t* __restrict__ pos,
                                      long long n_items, int nby, int nbx,
                                      int s, int margin, int bit_depth,
                                      const int32_t* __restrict__ orig_bands,
                                      int32_t* __restrict__ out) {
    extern __shared__ int32_t smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const long long item = (long long)blockIdx.x * warps + warp;
    if (item >= n_items) return;               // whole warp leaves together
    int32_t* hbuf = smem + (size_t)warp * HROWS * s;
    const int bx = (int)(item % nbx);
    const int by = (int)((item / nbx) % nby);
    const long long k = item / ((long long)nbx * nby);
    const int px = pos[2 * item];
    const int py = pos[2 * item + 1];
    int xi = (px >> 4) + margin - (TAPS / 2 - 1);
    int yi = (py >> 4) + margin - (TAPS / 2 - 1);
    xi = min(max(xi, 0), wp - (s + TAPS - 1));
    yi = min(max(yi, 0), hp - HROWS);
    const int* cx = c_luma_filter[px & 15];
    const int* cy = c_luma_filter[py & 15];
    const int shift1 = bit_depth - 8;
    const int offs1 = shift1 > 0 ? 1 << (shift1 - 1) : 0;
    const int32_t* base = ref + (size_t)yi * wp + xi;
    for (int i = lane; i < HROWS * s; i += 32) {
        const int32_t* row = base + (size_t)(i / s) * wp + (i % s);
        int hsum = 0;
#pragma unroll
        for (int t = 0; t < TAPS; ++t) hsum += row[t] * cx[t];
        if (shift1 > 0) hsum = (hsum + offs1) >> shift1;
        hbuf[i] = hsum;
    }
    __syncwarp();
    const int bw = nbx * s;                    // width of a band plane
    int acc = 0;
    for (int i = lane; i < BAND * s; i += 32) {
        const int r = i / s, c = i % s;
        int vsum = 0;
#pragma unroll
        for (int t = 0; t < TAPS; ++t) vsum += hbuf[(r + t) * s + c] * cy[t];
        const int pix = finalize_px(vsum, bit_depth);
        const size_t o = (size_t)(by * BAND + r) * bw + (size_t)bx * s + c;
        if (SAD) {
            acc += abs(pix - orig_bands[o]);
        } else {
            out[(size_t)k * nby * BAND * bw + o] = pix;
        }
    }
    if (SAD) {
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
            acc += __shfl_down_sync(0xffffffffu, acc, d);
        if (lane == 0) out[item] = acc;
    }
}

template <bool SAD>
static int launch_band(const void* ref, int hp, int wp, const void* pos,
                       int n_k, int nby, int nbx, int s, int margin,
                       int bit_depth, const void* orig_bands, void* out,
                       void* stream) {
    const size_t per_warp = (size_t)HROWS * s * sizeof(int32_t);
    int warps = 4;
    while (warps > 1 && warps * per_warp > 48 * 1024) warps >>= 1;
    if (per_warp > 48 * 1024) return (int)cudaErrorInvalidValue;
    const long long n_items = (long long)n_k * nby * nbx;
    const long long blocks = (n_items + warps - 1) / warps;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    band_positions_kernel<SAD>
        <<<(unsigned)blocks, 32 * warps, warps * per_warp,
           (cudaStream_t)stream>>>(
            (const int32_t*)ref, hp, wp, (const int32_t*)pos, n_items, nby,
            nbx, s, margin, bit_depth, (const int32_t*)orig_bands,
            (int32_t*)out);
    return (int)cudaGetLastError();
}

// K5: 16 lanes per (candidate, subblock).
__global__ void sad_luma_positions_kernel(const int32_t* __restrict__ ref,
                                          int hp, int wp,
                                          const int32_t* __restrict__ orig,
                                          const int32_t* __restrict__ pos,
                                          long long n_items, int nsy,
                                          int nsx, int margin, int bit_depth,
                                          int32_t* __restrict__ out) {
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long item = tid >> 4;
    const int l = threadIdx.x & 15;
    const bool live = item < n_items;
    int acc = 0;
    if (live) {
        const int sx = (int)(item % nsx);
        const int sy = (int)((item / nsx) % nsy);
        const int px = pos[2 * item];
        const int py = pos[2 * item + 1];
        int xi = (px >> 4) + margin - (TAPS / 2 - 1);
        int yi = (py >> 4) + margin - (TAPS / 2 - 1);
        xi = min(max(xi, 0), wp - (4 + TAPS - 1));
        yi = min(max(yi, 0), hp - (4 + TAPS - 1));
        const int* cx = c_luma_filter[px & 15];
        const int* cy = c_luma_filter[py & 15];
        const int shift1 = bit_depth - 8;
        const int offs1 = shift1 > 0 ? 1 << (shift1 - 1) : 0;
        const int r = l >> 2, c = l & 3;
        const int32_t* row = ref + (size_t)(yi + r) * wp + xi + c;
        int vsum = 0;
#pragma unroll
        for (int t = 0; t < TAPS; ++t) {
            int hsum = 0;
#pragma unroll
            for (int u = 0; u < TAPS; ++u) hsum += row[u] * cx[u];
            if (shift1 > 0) hsum = (hsum + offs1) >> shift1;
            vsum += hsum * cy[t];
            row += wp;
        }
        const int pix = finalize_px(vsum, bit_depth);
        acc = abs(pix - orig[(size_t)(sy * 4 + r) * (nsx * 4) + sx * 4 + c]);
    }
    // every lane of the warp takes part; a half-warp sums its 16 lanes
#pragma unroll
    for (int d = 8; d > 0; d >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, d, 16);
    if (live && l == 0) out[item] = acc;
}

// K6: 16 lanes per (candidate, subblock), 2-tap bilinear.
__global__ void sad_bilinear_positions_kernel(
        const int32_t* __restrict__ ref, int hp, int wp,
        const int32_t* __restrict__ orig, const int32_t* __restrict__ pos,
        long long n_items, int nsy, int nsx, int margin,
        int32_t* __restrict__ out) {
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long item = tid >> 4;
    const int l = threadIdx.x & 15;
    const bool live = item < n_items;
    int acc = 0;
    if (live) {
        const int sx = (int)(item % nsx);
        const int sy = (int)((item / nsx) % nsy);
        const int px = pos[2 * item];
        const int py = pos[2 * item + 1];
        const int xi = min(max((px >> 4) + margin, 0), wp - 5);
        const int yi = min(max((py >> 4) + margin, 0), hp - 5);
        const int fx = px & 15, fy = py & 15;
        const int r = l >> 2, c = l & 3;
        const int32_t* p = ref + (size_t)(yi + r) * wp + xi + c;
        const int h0 = (p[0] * (16 - fx) + p[1] * fx + 8) >> 4;
        const int h1 = (p[wp] * (16 - fx) + p[wp + 1] * fx + 8) >> 4;
        const int pix = (h0 * (16 - fy) + h1 * fy + 8) >> 4;
        acc = abs(pix - orig[(size_t)(sy * 4 + r) * (nsx * 4) + sx * 4 + c]);
    }
    // every lane of the warp takes part; a half-warp sums its 16 lanes
#pragma unroll
    for (int d = 8; d > 0; d >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, d, 16);
    if (live && l == 0) out[item] = acc;
}

extern "C" int sad_block_positions(const void* ref, int hp, int wp,
                                   const void* orig_bands, const void* pos,
                                   int n_k, int nby, int nbx, int s,
                                   int margin, int bit_depth, void* out,
                                   void* stream) {
    return launch_band<true>(ref, hp, wp, pos, n_k, nby, nbx, s, margin,
                             bit_depth, orig_bands, out, stream);
}

extern "C" int mc_block_positions(const void* ref, int hp, int wp,
                                  const void* pos, int n_k, int nby, int nbx,
                                  int s, int margin, int bit_depth, void* out,
                                  void* stream) {
    return launch_band<false>(ref, hp, wp, pos, n_k, nby, nbx, s, margin,
                              bit_depth, nullptr, out, stream);
}

extern "C" int sad_luma_positions(const void* ref, int hp, int wp,
                                  const void* orig, const void* pos, int n_k,
                                  int nsy, int nsx, int margin, int bit_depth,
                                  void* out, void* stream) {
    const long long n_items = (long long)n_k * nsy * nsx;
    const int threads = 256;
    const long long blocks = (n_items * 16 + threads - 1) / threads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    sad_luma_positions_kernel<<<(unsigned)blocks, threads, 0,
                                (cudaStream_t)stream>>>(
        (const int32_t*)ref, hp, wp, (const int32_t*)orig,
        (const int32_t*)pos, n_items, nsy, nsx, margin, bit_depth,
        (int32_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int sad_bilinear_positions(const void* ref, int hp, int wp,
                                      const void* orig, const void* pos,
                                      int n_k, int nsy, int nsx, int margin,
                                      void* out, void* stream) {
    const long long n_items = (long long)n_k * nsy * nsx;
    const int threads = 256;
    const long long blocks = (n_items * 16 + threads - 1) / threads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    sad_bilinear_positions_kernel<<<(unsigned)blocks, threads, 0,
                                    (cudaStream_t)stream>>>(
        (const int32_t*)ref, hp, wp, (const int32_t*)orig,
        (const int32_t*)pos, n_items, nsy, nsx, margin, (int32_t*)out);
    return (int)cudaGetLastError();
}
