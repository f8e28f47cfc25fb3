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
// K5 is bound by its operations (480 MACs a subblock), K6 by its bytes.
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
// Design, K5/K6.  The first versions (one half-warp per item, a lane per
// output sample, 5% and 13% of the bound) re-read the whole window and
// re-ran the horizontal filter for every output sample (K5: 1,024 scalar
// loads and 1,152 MACs a subblock for a 121-word patch), read the taps
// from __constant__ memory at each lane's phase, and divided 64-bit item
// indices.  Now:
//   - a 3-D grid (tiles of a subblock row, subblock rows, field chunks),
//     32-bit index math (the launcher refuses larger sizes); positions
//     read as one 8-byte load, the original block as four 16-byte loads
//     issued first, one int32 SAD written per item;
//   - K5 filters separably in registers as K1 (csrc/mc_positions.cu) does:
//     each patch row read once as three or four aligned 16-byte chunks
//     with two select stages (scalar loads where the plane's rows are not
//     16-byte aligned), its horizontal sums folded at once into the
//     vertical sums; taps read once from a global table through the
//     read-only cache.  K6 reads each of its five window rows as two
//     aligned 16-byte chunks;
//   - one thread an item, the fields of a subblock side by side in one
//     CTA (K3's trick): their nearly equal windows and their common
//     original block come from L1 (on an H100 this beat one field a CTA on
//     the full 2048x1024 grid, and lost at K = 1);
//   - K5 grids of at most 16,384 items (the codec's two search grids:
//     10,240 and 1,280 items) are set by one thread's chain of dependent
//     loads, not by throughput: there a split kernel gives an item 4
//     lanes, 3 patch rows a lane, and a reduce-scatter of the partial
//     vertical sums over the lanes by shuffles.  On an H100 it beat one
//     thread an item on both search grids and lost 2.4x on the full
//     2048x1024 grid (655,360 items); chip_smoke.py times the launch
//     rule's alternatives.
// The window origin is clipped to the UNALIGNED padded shape exactly as the
// plain versions do.  Every shape and every K >= 1 is taken (K3/K4: every
// block width s that is a multiple of 4, up to 512).  Arithmetic shifts of
// negative int32 values floor, as jnp's do.
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

#define TAPS 8
#define BAND 4                       // rows of a block's decision band
#define HROWS (BAND + TAPS - 1)      // rows of the horizontal pass

__device__ __forceinline__ int finalize_px(int vsum, int bit_depth) {
    const int val = vsum >> 6;
    const int fin_shift = 14 - bit_depth;          // IF_INTERNAL_PREC - bd
    const int fin_offs = fin_shift > 0 ? 1 << (fin_shift - 1) : 0;
    const int pix = (val + fin_offs) >> fin_shift;
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

#define SUB_THREADS 128             // threads of a K5/K6 CTA of one field
#define SUB_MAX_THREADS 256         // the most a K5/K6 launch may take

// The (field, subblock) item of thread t, with `split` threads an item:
// item j = t / split of the CTA is subblock j % tx of a tile of one
// subblock row, field j / tx of the CTA's chunk of kc fields.  A warp thus
// holds neighbouring subblocks of one field (32 / split of them); a CTA the
// chunk's fields of each subblock.
struct SubItem {
    int part, k, sx, sy, it;
    bool live;
    __device__ __forceinline__ SubItem(int split, int n_k, int nsy, int nsx,
                                       int tx, int kc) {
        const int t = threadIdx.x;
        const int j = t / split, kl = j / tx;
        part = t - j * split;
        k = blockIdx.z * kc + kl;
        sx = blockIdx.x * tx + (j - kl * tx);
        sy = blockIdx.y;
        live = kl < kc && k < n_k && sx < nsx;
        it = live ? (k * nsy + sy) * nsx + sx : 0;
    }
};

// The original's 4x4 block at og (rows ow words apart): four 16-byte
// loads.
__device__ __forceinline__ void load_block(const int32_t* og, int ow,
                                           int (*q)[4]) {
#pragma unroll
    for (int r = 0; r < BAND; ++r) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(og + r * ow));
        q[r][0] = v.x; q[r][1] = v.y; q[r][2] = v.z; q[r][3] = v.w;
    }
}

// The 8 taps of `phase` as two 16-byte loads through the read-only cache.
__device__ __forceinline__ void load_taps(int phase, int* c) {
    const int4* f4 = reinterpret_cast<const int4*>(&c_luma_filter[phase][0]);
    const int4 a = __ldg(f4), b = __ldg(f4 + 1);
    c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
    c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
}

// K5, one thread per item: filtered separably as K1 does.  Each of the 11
// patch rows is loaded once (CH as load_row's), its 4 horizontal sums are
// rounded and folded at once into the 4x4 vertical sums in registers.  The
// original block is read first: it does not wait for the positions.
template <int CH>
__global__ void __launch_bounds__(SUB_MAX_THREADS)
sad_luma_positions_kernel(const int32_t* __restrict__ ref, int hp, int wp,
                          const int32_t* __restrict__ orig,
                          const int32_t* __restrict__ pos, int n_k, int nsy,
                          int nsx, int tx, int kc, int margin, int bit_depth,
                          int32_t* __restrict__ out) {
    const SubItem s(1, n_k, nsy, nsx, tx, kc);
    if (!s.live) return;
    const int ow = 4 * nsx;
    const int32_t* og = orig + s.sy * BAND * ow + 4 * s.sx;
    int q[BAND][4];
    load_block(og, ow, q);
    const int2 p = __ldg(reinterpret_cast<const int2*>(pos) + s.it);
    // patch origin, clipped to the unaligned padded plane (mm/mc.py)
    const int xi = min(max((p.x >> 4) + margin - (TAPS / 2 - 1), 0),
                       wp - HROWS);
    const int yi = min(max((p.y >> 4) + margin - (TAPS / 2 - 1), 0),
                       hp - HROWS);
    int cx[TAPS], cy[TAPS];
    load_taps(p.x & 15, cx);
    load_taps(p.y & 15, cy);
    const int shift1 = bit_depth - 8;
    const int offs1 = shift1 > 0 ? 1 << (shift1 - 1) : 0;
    const int o = xi & (CH - 1);
    const int32_t* row = ref + yi * wp + (xi - o);
    int v[BAND][4];
#pragma unroll
    for (int r = 0; r < BAND; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) v[r][c] = 0;
#pragma unroll
    for (int y = 0; y < HROWS; ++y, row += wp) {
        int x[HROWS];
        load_row<HROWS, CH>(row, o, x);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            int h = offs1;           // the rounding offset, added first
#pragma unroll
            for (int u = 0; u < TAPS; ++u) h += x[c + u] * cx[u];
            h >>= shift1;
#pragma unroll
            for (int r = 0; r < BAND; ++r)
                if (y - r >= 0 && y - r < TAPS) v[r][c] += cy[y - r] * h;
        }
    }
    int acc = 0;
#pragma unroll
    for (int r = 0; r < BAND; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
            acc += abs(finalize_px(v[r][c], bit_depth) - q[r][c]);
    out[s.it] = acc;
}

// K5 for grids of less than a wave (at most SPLIT_MAX_ITEMS items): 4 lanes
// an item, so that each lane's chain of loads and multiply-adds is short.  Lane p filters patch rows
// 3p..3p+2 horizontally and folds them into partial vertical sums of all
// 4 output rows; a reduce-scatter over the 4 lanes (12 shuffles) leaves
// lane p output row p, whose SAD the lanes then sum.
template <int CH>
__global__ void __launch_bounds__(SUB_MAX_THREADS)
sad_luma_split_positions_kernel(const int32_t* __restrict__ ref, int hp, int wp,
                     const int32_t* __restrict__ orig,
                     const int32_t* __restrict__ pos, int n_k, int nsy,
                     int nsx, int tx, int kc, int margin, int bit_depth,
                     int32_t* __restrict__ out) {
    const SubItem s(4, n_k, nsy, nsx, tx, kc);
    const int lane = s.part;
    int v[BAND][4];
#pragma unroll
    for (int r = 0; r < BAND; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) v[r][c] = 0;
    int4 q = make_int4(0, 0, 0, 0);
    if (s.live) {
        const int ow = 4 * nsx;
        q = __ldg(reinterpret_cast<const int4*>(
            orig + (s.sy * BAND + lane) * ow + 4 * s.sx));
        const int2 p = __ldg(reinterpret_cast<const int2*>(pos) + s.it);
        const int xi = min(max((p.x >> 4) + margin - (TAPS / 2 - 1), 0),
                           wp - HROWS);
        const int yi = min(max((p.y >> 4) + margin - (TAPS / 2 - 1), 0),
                           hp - HROWS);
        int cx[TAPS];
        load_taps(p.x & 15, cx);
        const int* fy = &c_luma_filter[p.y & 15][0];
        const int shift1 = bit_depth - 8;
        const int offs1 = shift1 > 0 ? 1 << (shift1 - 1) : 0;
        const int o = xi & (CH - 1);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
            const int y = 3 * lane + t;          // row 11 (lane 3) is none:
            const int32_t* row =                 // row 10 again, no taps
                ref + (yi + min(y, HROWS - 1)) * wp + (xi - o);
            int x[HROWS];
            load_row<HROWS, CH>(row, o, x);
            int cv[BAND];
#pragma unroll
            for (int r = 0; r < BAND; ++r)
                cv[r] = y - r >= 0 && y - r < TAPS ? __ldg(fy + y - r) : 0;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                int h = offs1;
#pragma unroll
                for (int u = 0; u < TAPS; ++u) h += x[c + u] * cx[u];
                h >>= shift1;
#pragma unroll
                for (int r = 0; r < BAND; ++r) v[r][c] += cv[r] * h;
            }
        }
    }
    // every lane of the warp takes part (blockDim is a multiple of 32):
    // lanes p and p^2 trade rows so that p keeps rows 2(p>>1) and
    // 2(p>>1)+1, then p and p^1 so that p keeps row p
    const bool hi = lane & 2, odd = lane & 1;
    int w[2][4], f[4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int send = hi ? v[i][c] : v[i + 2][c];
            w[i][c] = (hi ? v[i + 2][c] : v[i][c]) +
                      __shfl_xor_sync(0xffffffffu, send, 2);
        }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int send = odd ? w[0][c] : w[1][c];
        f[c] = (odd ? w[1][c] : w[0][c]) +
               __shfl_xor_sync(0xffffffffu, send, 1);
    }
    const int qa[4] = {q.x, q.y, q.z, q.w};
    int acc = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
        acc += abs(finalize_px(f[c], bit_depth) - qa[c]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (s.live && lane == 0) out[s.it] = acc;
}

// K6: one thread per item.  The 5x5 window (CH as load_row's: two 16-byte
// chunks a row) is filtered with the plain version's roundings in its
// order: horizontally on all five rows, then vertically; no clip.  The
// original block is read first, as K5's.
template <int CH>
__global__ void __launch_bounds__(SUB_MAX_THREADS)
sad_bilinear_positions_kernel(const int32_t* __restrict__ ref, int hp,
                              int wp, const int32_t* __restrict__ orig,
                              const int32_t* __restrict__ pos, int n_k,
                              int nsy, int nsx, int tx, int kc, int margin,
                              int32_t* __restrict__ out) {
    const SubItem s(1, n_k, nsy, nsx, tx, kc);
    if (!s.live) return;
    const int ow = 4 * nsx;
    const int32_t* og = orig + s.sy * BAND * ow + 4 * s.sx;
    int q[BAND][4];
    load_block(og, ow, q);
    const int2 p = __ldg(reinterpret_cast<const int2*>(pos) + s.it);
    const int xi = min(max((p.x >> 4) + margin, 0), wp - 5);
    const int yi = min(max((p.y >> 4) + margin, 0), hp - 5);
    const int fx = p.x & 15, fy = p.y & 15;
    const int o = xi & (CH - 1);
    const int32_t* row = ref + yi * wp + (xi - o);
    int h[5][4];
#pragma unroll
    for (int y = 0; y < 5; ++y, row += wp) {
        int x[5];
        load_row<5, CH>(row, o, x);
#pragma unroll
        for (int c = 0; c < 4; ++c)
            h[y][c] = (x[c] * (16 - fx) + x[c + 1] * fx + 8) >> 4;
    }
    int acc = 0;
#pragma unroll
    for (int r = 0; r < BAND; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
            acc += abs(((h[r][c] * (16 - fy) + h[r + 1][c] * fy + 8) >> 4) -
                       q[r][c]);
    out[s.it] = acc;
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

// K5/K6 launch shape.  One thread an item, the fields of a subblock side
// by side in a CTA (kc of them, up to MAX_KC, each a tile of tx
// subblocks): their nearly equal windows and their shared original block
// are read together, from L1.  K5 grids of at most SPLIT_MAX_ITEMS items
// take the split kernel instead, 4 lanes an item in CTAs of SPLIT_TX items
// of one field: there one thread's chain of dependent loads sets the time.
// Refuses what the kernels do not take: an empty grid, a plane smaller
// than one window, indices beyond 31 bits, positions not 8-byte or an
// original not 16-byte aligned (read a subblock at a time), kc outside
// [1, MAX_KC].
#define SPLIT_MAX_ITEMS 16384
#define SPLIT_TX 16
#define MAX_KC (SUB_MAX_THREADS / 32)

struct SubLaunch {
    int tx, kc, threads;
    dim3 grid;
};

static int sub_launch(const void* ref, int hp, int wp, const void* orig,
                      const void* pos, int n_k, int nsy, int nsx, int win,
                      bool split, int kc, SubLaunch* l) {
    const long long lim = 0x7fffffffLL;
    if (n_k < 1 || nsy < 1 || nsx < 1 || hp < win || wp < win ||
        (long long)hp * wp > lim || 2LL * n_k * nsy * nsx > lim ||
        16LL * nsy * nsx > lim || kc < 1 || kc > MAX_KC)
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)pos % 8 || (uintptr_t)orig % 16)
        return (int)cudaErrorMisalignedAddress;
    if (split) {
        l->kc = 1;
        l->tx = SPLIT_TX;
        l->threads = 4 * SPLIT_TX;
    } else {
        l->kc = min(n_k, kc);
        l->tx = max(32, (SUB_THREADS / l->kc) & ~31);
        l->threads = l->tx * l->kc;
    }
    l->grid = dim3((unsigned)((nsx + l->tx - 1) / l->tx), (unsigned)nsy,
                   (unsigned)((n_k + l->kc - 1) / l->kc));
    if (l->grid.y > 65535u || l->grid.z > 65535u)
        return (int)cudaErrorInvalidValue;
    return 0;
}

// K5 with the launch given: the split kernel, or one thread an item with
// up to kc fields a CTA.  sad_luma_positions applies the launch rule; this
// form lets a timing run set its alternatives side by side.
extern "C" int sad_luma_positions_as(const void* ref, int hp, int wp,
                                     const void* orig, const void* pos,
                                     int n_k, int nsy, int nsx, int margin,
                                     int bit_depth, int split, int kc,
                                     void* out, void* stream) {
    SubLaunch l;
    const int err = sub_launch(ref, hp, wp, orig, pos, n_k, nsy, nsx, HROWS,
                               split != 0, kc, &l);
    if (err) return err;
    const bool vec = wp % 4 == 0 && (uintptr_t)ref % 16 == 0;
    auto kernel = split ? (vec ? sad_luma_split_positions_kernel<4>
                               : sad_luma_split_positions_kernel<1>)
                        : (vec ? sad_luma_positions_kernel<4>
                               : sad_luma_positions_kernel<1>);
    kernel<<<l.grid, l.threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ref, hp, wp, (const int32_t*)orig,
        (const int32_t*)pos, n_k, nsy, nsx, l.tx, l.kc, margin, bit_depth,
        (int32_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int sad_luma_positions(const void* ref, int hp, int wp,
                                  const void* orig, const void* pos, int n_k,
                                  int nsy, int nsx, int margin, int bit_depth,
                                  void* out, void* stream) {
    const int split = (long long)n_k * nsy * nsx <= SPLIT_MAX_ITEMS;
    return sad_luma_positions_as(ref, hp, wp, orig, pos, n_k, nsy, nsx,
                                 margin, bit_depth, split, MAX_KC, out,
                                 stream);
}

// K6 with up to kc fields a CTA; sad_bilinear_positions takes MAX_KC.
extern "C" int sad_bilinear_positions_as(const void* ref, int hp, int wp,
                                         const void* orig, const void* pos,
                                         int n_k, int nsy, int nsx,
                                         int margin, int kc, void* out,
                                         void* stream) {
    SubLaunch l;
    const int err = sub_launch(ref, hp, wp, orig, pos, n_k, nsy, nsx, 5,
                               false, kc, &l);
    if (err) return err;
    const bool vec = wp % 4 == 0 && (uintptr_t)ref % 16 == 0;
    auto kernel = vec ? sad_bilinear_positions_kernel<4>
                      : sad_bilinear_positions_kernel<1>;
    kernel<<<l.grid, l.threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ref, hp, wp, (const int32_t*)orig,
        (const int32_t*)pos, n_k, nsy, nsx, l.tx, l.kc, margin,
        (int32_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int sad_bilinear_positions(const void* ref, int hp, int wp,
                                      const void* orig, const void* pos,
                                      int n_k, int nsy, int nsx, int margin,
                                      void* out, void* stream) {
    return sad_bilinear_positions_as(ref, hp, wp, orig, pos, n_k, nsy, nsx,
                                     margin, MAX_KC, out, stream);
}
