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
// Bound (the least time on an H100 SXM: every input and output word once
// over 3.35 TB/s, against 2 operations a MAC over the 33.5 T/s int32
// multiply-add rate, 64 a clock per SM): K3 is bound by its operations at
// the codec's shapes (s=8 K=5: 157 M MACs, 9.4 us; s=16 K=6: 94 M, 5.6
// us), K4 at s=16 K=4 by its bytes (5.7 us; its 63 M MACs take 3.8 us).
// K5 and K6 are bound by bytes.
// Design, K3/K4.  What held the first version (one warp per item,
// 11-18% of this bound) back was instruction issue and L1 requests: 64-bit
// division of the item index, a runtime `i / s` and `i % s` in both loops,
// eight scalar L1 loads per horizontal output and a lane-wasting 11*s over
// 32 split.  Now:
//   - a 3-D grid (block tiles, block row, candidate chunks) and 32-bit
//     index math; the wrapper refuses sizes that do not fit in 31 bits;
//   - every block width runs the same code: a thread owns 4 band columns
//     whatever s, so no loop depends on s, and the item index is divided
//     once per thread;
//   - one CTA takes a tile of blocks of one block row with all K
//     candidates (up to the tile's size) side by side, so the nearly equal
//     windows of a block's candidates are read together and served from L1;
//   - a thread owns 4 adjacent band columns of one item.  Per window row it
//     reads the 11 samples its 4 horizontal outputs need once, as three or
//     four 16-byte loads where the plane's rows are 16-byte aligned (a
//     shift by the window's offset in its chunk follows) and as 11 scalar
//     loads where they are not; it folds each horizontal output at once
//     into the 4 rows of vertical sums it keeps in registers, so nothing
//     goes through shared memory.  Staging the windows in shared memory
//     first (per item, or one box per CTA) was slower on the card: the
//     copies cost more than the L1 requests they save;
//   - K4 stores each band row's 4 samples as one 16-byte store, lanes in
//     band-row order (coalesced); K3 reads the original band the same way
//     and sums a (candidate, block)'s s/4 partial SADs with shared-memory
//     atomics, one int out per item.
// The filter stays in int32: exact for any int32 sample, as the plain
// version is (fp32 taps measured no faster).  Nothing of the TPU kernels'
// layout (aligned superpatch + roll, scalar streams, row gates) carries
// over.
// Design, K5: one half-warp per (candidate, subblock), one lane per output
// sample with the 8x8 filter read straight from the plane (the 11x11 patch
// stays in L1 between the 16 lanes), reduced over the 16 lanes.
// Design, K6: K5's layout; a lane reads the 2x2 samples around its output
// sample, filters the two rows horizontally and then vertically (the same
// roundings, in the same order, as filtering all five rows first).
// The window origin is clipped to the UNALIGNED padded shape exactly as the
// plain versions do.  Every shape and every K >= 1 is taken (K3/K4: every
// block width s that is a multiple of 4, up to 512).  Arithmetic shifts of
// negative int32 values floor, as jnp's do.
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

#define BAND_THREADS 128             // threads of a K3/K4 CTA
#define BAND_MAX_S 512               // widest block a K3/K4 CTA takes

// K3 (SAD = true) and K4 (SAD = false) for block width s, a multiple of 4
// up to BAND_MAX_S.  VEC: the plane rows are 16-byte aligned, so a thread
// reads its window row as 16-byte chunks.  Grid: (tiles of tx blocks, nby
// block rows, chunks of kc candidates); BAND_THREADS threads, s/4 per
// (candidate, block) item, item j = k_local * tx + b_local: the candidates
// of a block are neighbours in the CTA.  No loop depends on s.
template <bool SAD, bool VEC>
__global__ void __launch_bounds__(BAND_THREADS)
band_positions_kernel(const int32_t* __restrict__ ref, int hp, int wp,
                      const int32_t* __restrict__ pos, int n_k, int nby,
                      int nbx, int s, int tx, int kc, int margin,
                      int bit_depth, const int32_t* __restrict__ orig_bands,
                      int32_t* __restrict__ out) {
    const int tpi = s >> 2;                      // threads per item
    const int items = BAND_THREADS / tpi;
    __shared__ int red[BAND_THREADS];
    __shared__ int filt[16 * TAPS];
    const int t = threadIdx.x;
    const int j = t / tpi, g = t - j * tpi;
    const int kl = j / tx, bl = j - kl * tx;
    const int k = blockIdx.z * kc + kl, bx = blockIdx.x * tx + bl;
    const int by = blockIdx.y;
    const bool live = j < items && kl < kc && k < n_k && bx < nbx;
    if (SAD && g == 0 && j < items) red[j] = 0;
    for (int i = t; i < 16 * TAPS; i += BAND_THREADS)
        filt[i] = (&c_luma_filter[0][0])[i];
    __syncthreads();
    int acc = 0;
    if (live) {
        const int it = (k * nby + by) * nbx + bx;
        const int px = pos[2 * it], py = pos[2 * it + 1];
        const int xi = min(max((px >> 4) + margin - (TAPS / 2 - 1), 0),
                           wp - (s + TAPS - 1));
        const int yi = min(max((py >> 4) + margin - (TAPS / 2 - 1), 0),
                           hp - HROWS);
        int ch[TAPS], cv[TAPS];
#pragma unroll
        for (int u = 0; u < TAPS; ++u) {
            ch[u] = filt[(px & 15) * TAPS + u];
            cv[u] = filt[(py & 15) * TAPS + u];
        }
        const int shift1 = bit_depth - 8;
        const int offs1 = shift1 > 0 ? 1 << (shift1 - 1) : 0;
        // this thread's band columns 4g..4g+3 read window columns
        // 4g..4g+10; VEC: from the 16-byte chunk holding column 4g on
        const int o = VEC ? xi & 3 : 0;
        const int32_t* row = ref + yi * wp + xi - o + 4 * g;
        int v[BAND][4];
#pragma unroll
        for (int r = 0; r < BAND; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) v[r][c] = 0;
#pragma unroll
        for (int y = 0; y < HROWS; ++y, row += wp) {
            int x[11];
            if (VEC) {
                // 3 or 4 chunks (the 4th only when o >= 2: never past the
                // row's last needed chunk), then shift left by o
                const int4* q = reinterpret_cast<const int4*>(row);
                const int4 a = __ldg(q), b = __ldg(q + 1), d = __ldg(q + 2);
                const int4 e = o >= 2 ? __ldg(q + 3) : make_int4(0, 0, 0, 0);
                const int w[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                                   d.x, d.y, d.z, d.w, e.x, e.y, e.z, e.w};
                int w1[13];
#pragma unroll
                for (int i = 0; i < 13; ++i) w1[i] = (o & 1) ? w[i + 1] : w[i];
#pragma unroll
                for (int i = 0; i < 11; ++i) x[i] = (o & 2) ? w1[i + 2] : w1[i];
            } else {
#pragma unroll
                for (int i = 0; i < 11; ++i) x[i] = __ldg(row + i);
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                int h = 0;
#pragma unroll
                for (int u = 0; u < TAPS; ++u) h += x[c + u] * ch[u];
                h = (h + offs1) >> shift1;
#pragma unroll
                for (int r = 0; r < BAND; ++r)
                    if (y - r >= 0 && y - r < TAPS) v[r][c] += cv[y - r] * h;
            }
        }
        const int bw = nbx * s;                  // width of a band plane
#pragma unroll
        for (int r = 0; r < BAND; ++r) {
            const int4 p = make_int4(finalize_px(v[r][0], bit_depth),
                                     finalize_px(v[r][1], bit_depth),
                                     finalize_px(v[r][2], bit_depth),
                                     finalize_px(v[r][3], bit_depth));
            const int ob = (by * BAND + r) * bw + bx * s + 4 * g;
            if (SAD) {
                const int4 q = __ldg(reinterpret_cast<const int4*>(orig_bands + ob));
                acc += abs(p.x - q.x) + abs(p.y - q.y) + abs(p.z - q.z) +
                       abs(p.w - q.w);
            } else {
                *reinterpret_cast<int4*>(out + k * nby * BAND * bw + ob) = p;
            }
        }
    }
    if (SAD) {
        if (live) atomicAdd(&red[j], acc);
        __syncthreads();
        if (live && g == 0) out[(k * nby + by) * nbx + bx] = red[j];
    }
}

// Refuses what the kernel does not take: s not a multiple of 4 in [4,
// BAND_MAX_S], a plane smaller than one window, indices beyond 31 bits, a
// band plane not 16-byte aligned (the original for K3, the output for K4).
template <bool SAD>
static int launch_band(const void* ref, int hp, int wp, const void* pos,
                       int n_k, int nby, int nbx, int s, int margin,
                       int bit_depth, const void* orig_bands, void* out,
                       void* stream) {
    const long long lim = 0x7fffffffLL;
    if (s < 4 || s > BAND_MAX_S || s % 4 != 0 || n_k < 1 || nby < 1 ||
        nbx < 1 || hp < HROWS || wp < s + TAPS - 1 ||
        (long long)hp * wp > lim ||
        2LL * n_k * nby * nbx > lim ||
        (long long)n_k * nby * BAND * nbx * s > lim)
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)(SAD ? orig_bands : out) & 15)   // read / written 16 B
        return (int)cudaErrorMisalignedAddress;      // at a time
    const int items = BAND_THREADS / (s / 4);
    const int kc = n_k < items ? n_k : items, tx = items / kc;
    const dim3 grid((unsigned)((nbx + tx - 1) / tx), (unsigned)nby,
                    (unsigned)((n_k + kc - 1) / kc));
    if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
    const bool vec = wp % 4 == 0 && (uintptr_t)ref % 16 == 0;
    auto kernel = vec ? band_positions_kernel<SAD, true>
                      : band_positions_kernel<SAD, false>;
    kernel<<<grid, BAND_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ref, hp, wp, (const int32_t*)pos, n_k, nby, nbx, s,
        tx, kc, margin, bit_depth, (const int32_t*)orig_bands,
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
