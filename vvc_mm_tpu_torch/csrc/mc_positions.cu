// Position-based subblock motion compensation for Hopper (sm_90a).
//
// K1 mc_luma_positions and K2 mc_chroma_positions: every multi-model
// P/B reconstruction predicts each 4x4 luma (2x2 chroma 4:2:0) subblock
// from its own absolute 1/16-pel position (1/32 pel for chroma) with the
// H.266 separable 8-tap (4-tap) filter.  They replace the TPU kernels
// vvc_mm_tpu/ops/mc_kernel.py mc_luma_positions (_mc_luma_kernel) and
// mc_chroma_positions (_mc_chroma_kernel).
//
// Bound: memory traffic.  One pass reads the padded reference plane and
// the positions once and writes the prediction: at 2048x1024 luma 10.5 MB
// of plane (80-sample margins), 1.0 MB of positions and 8.4 MB of output,
// 5.9 us at an H100 SXM's 3.35 TB/s; its 63 M MACs (480 a 4x4 subblock:
// 11 rows x 4 columns x 8 taps horizontally, 16 x 8 vertically) take 3.8
// us at the int32 multiply-add rate (33.5 T/s).  Chroma: 2.6 + 1.0 + 2.1
// MB, 1.7 us, against 56 MACs a 2x2 subblock, 0.4 us.
//
// What held the first design back (one thread per output sample, 32x8
// threads, taps in __constant__ memory at each thread's phase; 23% and
// 40% of the bound on an H100): every sample re-read its whole window and re-ran the
// horizontal filter for each of its rows (a K1 thread made 64 scalar
// loads and 72 MACs, 1,024 loads and 1,152 MACs a subblock for a 121-word
// patch); a warp held 8 (K2: 16) subblocks with their own positions, so
// each load touched as many separate windows; and the constant cache
// serialised the up to 8 (16) phases of a warp on every tap.  On this card
// a kernel of this family costs about load instructions times the cache
// lines each touches.
//
// Design now:
//   - one thread per subblock, filtered separably as the TPU kernel does:
//     each patch row is loaded once, its S horizontal sums are taken and
//     rounded, and each is added at once into the S x S vertical sums it
//     feeds (output row i takes patch row r with tap cy[r - i]), all in
//     registers and unrolled so every index is known at compile time;
//   - a warp holds 32 neighbouring subblocks of one subblock row, so its
//     loads of a patch row cover neighbouring windows, and its stores of an
//     output row are 32 contiguous 16-byte (K2: 8-byte) pieces; the
//     positions are read as one 8-byte load a thread;
//   - where the plane's rows are aligned to them, a patch row is read as
//     the aligned chunks that cover it and shifted by the window's offset
//     in its chunk with select stages, no read passing the row's last
//     needed chunk: K1 three or four 16-byte chunks (the fourth only when
//     the window starts in its chunk's second half) and two select stages;
//     K2 three 8-byte chunks and one stage (on an H100, 8-byte chunks made
//     K2 faster and K1 slower: K1's extra loads cost more than the selects
//     they save); other planes take scalar loads;
//   - each thread reads its horizontal and vertical taps once, as 16-byte
//     loads through the read-only data cache from the tables below, which
//     lie in global memory: no per-thread phase indexes __constant__
//     memory, and no shared copy and barrier delay the first loads (both
//     measured slower).
// The patch origin is clipped to the UNALIGNED padded shape exactly as
// the plain version does, and every shape is taken.  The filter stays in
// int32; arithmetic shifts of negative int32 values floor, as jnp's do.
#include <cuda_runtime.h>
#include <stdint.h>

#include "load_row.cuh"

// H.266 Table 8-11: 8-tap luma filter, 16 phases (common/interp.py
// LUMA_FILTER; a CPU test holds the two tables equal).
__device__ __align__(16) int c_luma_filter[16][8] = {
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

// H.266 Table 8-13: 4-tap chroma filter, 32 phases (CHROMA_FILTER).
__device__ __align__(16) int c_chroma_filter[32][4] = {
    {  0,  64,   0,   0},
    { -1,  63,   2,   0},
    { -2,  62,   4,   0},
    { -2,  60,   7,  -1},
    { -2,  58,  10,  -2},
    { -3,  57,  12,  -2},
    { -4,  56,  14,  -2},
    { -4,  55,  15,  -2},
    { -4,  54,  16,  -2},
    { -5,  53,  18,  -2},
    { -6,  52,  20,  -2},
    { -6,  49,  24,  -3},
    { -6,  46,  28,  -4},
    { -5,  44,  29,  -4},
    { -4,  42,  30,  -4},
    { -4,  39,  33,  -4},
    { -4,  36,  36,  -4},
    { -4,  33,  39,  -4},
    { -4,  30,  42,  -4},
    { -4,  29,  44,  -5},
    { -4,  28,  46,  -6},
    { -3,  24,  49,  -6},
    { -2,  20,  52,  -6},
    { -2,  18,  53,  -5},
    { -2,  16,  54,  -4},
    { -2,  15,  55,  -4},
    { -2,  14,  56,  -4},
    { -2,  12,  57,  -3},
    { -2,  10,  58,  -2},
    { -1,   7,  60,  -2},
    {  0,   4,  62,  -2},
    {  0,   2,  63,  -1}
};

#define MC_THREADS 128               // threads (subblocks) of a CTA

template <int TAPS> __device__ const int* filter_table();
template <> __device__ const int* filter_table<8>() {
    return &c_luma_filter[0][0];
}
template <> __device__ const int* filter_table<4>() {
    return &c_chroma_filter[0][0];
}

// Output samples per subblock side S (4 or 2) as one 16- or 8-byte store.
template <int S> struct Vec;
template <> struct Vec<4> {
    static __device__ __forceinline__ void store(int32_t* p, const int* v) {
        *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
    }
};
template <> struct Vec<2> {
    static __device__ __forceinline__ void store(int32_t* p, const int* v) {
        *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
    }
};

// One thread per S x S subblock, TAPS-tap filter, 1/2^FRAC_BITS pel; CH
// as load_row's.  Grid: (subblock rows, tiles of MC_THREADS subblocks).
template <int S, int TAPS, int FRAC_BITS, int CH>
__global__ void __launch_bounds__(MC_THREADS)
mc_positions_kernel(const int32_t* __restrict__ ref, int hp, int wp,
                    const int32_t* __restrict__ pos, int nsx, int margin,
                    int bit_depth, int32_t* __restrict__ out) {
    constexpr int W = S + TAPS - 1;              // patch side
    constexpr int PHASES = 1 << FRAC_BITS;
    const int sy = blockIdx.x;
    const int sx = blockIdx.y * MC_THREADS + threadIdx.x;
    if (sx >= nsx) return;
    const int2 p = __ldg(reinterpret_cast<const int2*>(pos) +
                         (size_t)sy * nsx + sx);
    // patch origin, clipped to the unaligned padded plane (mm/mc.py)
    const int xi = min(max((p.x >> FRAC_BITS) + margin - (TAPS / 2 - 1), 0),
                       wp - W);
    const int yi = min(max((p.y >> FRAC_BITS) + margin - (TAPS / 2 - 1), 0),
                       hp - W);
    int cx[TAPS], cy[TAPS];
    const int4* f4 = reinterpret_cast<const int4*>(filter_table<TAPS>());
#pragma unroll
    for (int q = 0; q < TAPS / 4; ++q) {
        const int4 a = __ldg(f4 + (p.x & (PHASES - 1)) * (TAPS / 4) + q);
        const int4 b = __ldg(f4 + (p.y & (PHASES - 1)) * (TAPS / 4) + q);
        cx[4 * q] = a.x; cx[4 * q + 1] = a.y;
        cx[4 * q + 2] = a.z; cx[4 * q + 3] = a.w;
        cy[4 * q] = b.x; cy[4 * q + 1] = b.y;
        cy[4 * q + 2] = b.z; cy[4 * q + 3] = b.w;
    }
    const int shift1 = bit_depth - 8;
    const int offs1 = shift1 > 0 ? 1 << (shift1 - 1) : 0;
    const int o = xi & (CH - 1);
    const int32_t* row = ref + (size_t)yi * wp + (xi - o);
    int v[S][S];
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
        for (int c = 0; c < S; ++c) v[r][c] = 0;
#pragma unroll
    for (int y = 0; y < W; ++y, row += wp) {
        int x[W];
        load_row<W, CH>(row, o, x);
#pragma unroll
        for (int c = 0; c < S; ++c) {
            int h = offs1;           // the rounding offset, added first
#pragma unroll
            for (int u = 0; u < TAPS; ++u) h += x[c + u] * cx[u];
            h >>= shift1;
#pragma unroll
            for (int r = 0; r < S; ++r)
                if (y - r >= 0 && y - r < TAPS) v[r][c] += cy[y - r] * h;
        }
    }
    const int fin_shift = 14 - bit_depth;        // IF_INTERNAL_PREC - bd
    const int fin_offs = fin_shift > 0 ? 1 << (fin_shift - 1) : 0;
    const int maxv = (1 << bit_depth) - 1;
    const int ow = nsx * S;
    int32_t* dst = out + (size_t)sy * S * ow + (size_t)sx * S;
#pragma unroll
    for (int r = 0; r < S; ++r) {
        int px[S];
#pragma unroll
        for (int c = 0; c < S; ++c)
            px[c] = min(max(((v[r][c] >> 6) + fin_offs) >> fin_shift, 0),
                        maxv);
        Vec<S>::store(dst + (size_t)r * ow, px);
    }
}

// Refuses what the kernel does not take: an empty grid, a plane smaller
// than one patch, more tiles than a grid column holds, positions not
// 8-byte or an output not S*4-byte aligned (read and written a subblock at
// a time).  K1 reads patch rows as 16-byte chunks, K2 as 8-byte chunks
// (fewer selects for its 5-word rows), where the plane's rows are aligned
// to them; scalar loads otherwise.
template <int S, int TAPS, int FRAC_BITS>
static int launch(const void* ref, int hp, int wp, const void* pos, int nsy,
                  int nsx, int margin, int bit_depth, void* out,
                  void* stream) {
    constexpr int W = S + TAPS - 1;
    constexpr int CH = S == 4 ? 4 : 2;
    if (nsy < 1 || nsx < 1 || hp < W || wp < W)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)nsy, (unsigned)((nsx + MC_THREADS - 1) /
                                              MC_THREADS));
    if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
    if ((uintptr_t)pos % 8 || (uintptr_t)out % (4 * S))
        return (int)cudaErrorMisalignedAddress;
    const bool vec = wp % CH == 0 && (uintptr_t)ref % (4 * CH) == 0;
    auto kernel = vec ? mc_positions_kernel<S, TAPS, FRAC_BITS, CH>
                      : mc_positions_kernel<S, TAPS, FRAC_BITS, 1>;
    kernel<<<grid, MC_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ref, hp, wp, (const int32_t*)pos, nsx, margin,
        bit_depth, (int32_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int mc_luma_positions(const void* ref, int hp, int wp,
                                 const void* pos, int nsy, int nsx,
                                 int margin, int bit_depth, void* out,
                                 void* stream) {
    return launch<4, 8, 4>(ref, hp, wp, pos, nsy, nsx, margin, bit_depth,
                           out, stream);
}

extern "C" int mc_chroma_positions(const void* ref, int hp, int wp,
                                   const void* pos, int nsy, int nsx,
                                   int margin, int bit_depth, void* out,
                                   void* stream) {
    return launch<2, 4, 5>(ref, hp, wp, pos, nsy, nsx, margin, bit_depth,
                           out, stream);
}
