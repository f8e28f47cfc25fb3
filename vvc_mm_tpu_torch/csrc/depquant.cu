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
// then backtracks; D2 runs the state machine and scales.
//
// Bound: neither bytes nor operations.  D1's coding positions form a chain:
// each depends on the cost front of the one before, so a block takes n
// dependent steps however many blocks run beside it.  The design shortens
// that step and spreads the batch (a wavefront step's blocks times its
// candidate transforms, e.g. 896 luma items at 2048x1024) over the SMs:
//
//  * A CTA takes DQ_BPC = 8 blocks with 512 threads.  All of them load the
//    blocks coalesced and compute, for every (position, block), what the
//    cost front does not touch: per lattice (the state offset) and term
//    (zero, even, odd level) the squared error in double and lam_h*rate
//    (the rate of levels below 256 staged in shared memory), into shared
//    memory.  Then the first warp runs the chains, reading only that, a
//    step's terms loaded a step ahead.  8 blocks a CTA put the I
//    picture's 896 luma items on 112 of the 132 SMs.
//  * Of the 12 flat candidates (source*3 + k) only three reach each
//    destination state d: both of d's sources are the states of one
//    quantizer, 2*(d&1) and 2*(d&1)+1, one offering the zero level and the
//    even one of {l0, l0+1}, the other the odd one (common/depquant.py's
//    DEST_SRC / DEST_TERM).  A step is 3 candidates and 2 minima per
//    destination, not 12 candidates and 11 compare-selects.
//  * 4 lanes a block, lane d the destination d, the two source costs by
//    __shfl_sync, so a step is 2 shuffles, 2 float->double conversions, 3
//    double adds, 3 roundings to float, 3 float adds and 2 minima.  (One
//    thread a block, the 4 destinations in its registers, converts 16
//    costs a step, not 5, and was slower at the codec's shapes:
//    measure_depquant.py keeps it as a variant.)
//  * Each lane stores its decision as one byte per (position, state), the
//    source state times 8 plus the code (0-2), so the backtrack's step is
//    a shift and a mask of one shared-memory word; an epilogue over all
//    threads recomputes each level from the staged coefficient and
//    writes the blocks coalesced.  Decisions stay in shared
//    memory up to 256 coefficients a block, and go to a global scratch laid
//    out [position][block] (one CTA's bytes of a position side by side)
//    above.  The codec's sizes (n = 16, 64) are template instances with
//    the whole block staged and the chain unrolled; other sizes stage 64
//    positions at a time.
//
// Numerics follow the plain version (common/depquant.py) exactly: a
// candidate's cost is fma(err, err, cost) + lam_h*rate as XLA computes it
// on the CPU, the fused multiply-add taken in double (the product of two
// floats is exact there) and rounded once to float, every operation
// written as an _rn intrinsic so that nvcc contracts nothing else; the
// rate of a level is read from the same float32 table; ties take the
// first candidate in flat order and the first cheapest final state, and
// dead states carry 3e38.  The JAX package gives a dead destination (all
// its candidates 3e38) level 0 from source 0, but no backtrack reads it:
// the path starts at the cheapest final state, which is live, and a live
// state's cheapest candidate comes from a live source.  So a dead
// destination keeps the first of its three, like any other.
//
// D2: a warp takes 32 coding positions of one block at a time (16 of each
// of two blocks for n <= 16).  The state machine is affine over GF(2):
// with state = 2*b1 + b0, next = (b0 ^ parity, b1), so the states before
// the positions of a chunk are two XOR prefixes of the level parities,
// one over the positions of each index parity, which a ballot and a
// popcount give; the state after a chunk carries to the next.  Integer
// only, its int32 products wrapping as the plain version's do.
#include <cuda_runtime.h>
#include <stdint.h>

#define DQ_INF 3e38f
#define DQ_MAX_LEVEL 32767
#define DQ_BPC 8             // D1: blocks of coefficients a CTA
#ifndef DQ_THREADS
#define DQ_THREADS 512       // D1: threads a CTA; its first warp chains
#endif
#define DQ_CHUNK 64          // D1: coding positions staged at a time
#define DQ_SMEM_DEC_N 256    // D1: decisions in shared memory up to this n
#define DQ_RATE_SMEM 256     // D1: rate entries staged in shared memory
#define DQ2_THREADS 128      // D2: 4 warps a CTA

// D1's phase marks, for measure_depquant.py: nothing unless built with
// -DDQ_CLOCK_MARKS; then thread 0 of CTAs 0-63 keeps clock64() at phase
// boundary k in dq_clk_marks[CTA * 8 + k], read by dq_clk_marks_read.
#ifdef DQ_CLOCK_MARKS
__device__ long long dq_clk_marks[512];
#define DQ_MARK(k)                                                         \
    if (threadIdx.x == 0 && blockIdx.x < 64)                               \
        dq_clk_marks[blockIdx.x * 8 + (k)] = clock64()
extern "C" int dq_clk_marks_read(void* host) {
    return (int)cudaMemcpyFromSymbol(host, dq_clk_marks,
                                     sizeof(dq_clk_marks));
}
#else
#define DQ_MARK(k)
#endif

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

// |coeff| in float32 half-step units, as the plain version computes it
__device__ __forceinline__ float half_steps(int32_t v, float xscale,
                                            int odd) {
    int32_t mag = abs(v);
    if (odd) mag = add_wrap(mul_wrap(mag, 181), 128) >> 8;
    return __fmul_rn((float)mag, xscale);
}

// l0 = clamp(floor((x + soff) / 2), 0, MAX_LEVEL - 1) of the quantizer
// of offset soff; its even level is (l0 + 1) & ~1, its odd one l0 | 1
__device__ __forceinline__ int lattice_l0(float x, int soff) {
    const float ideal = __fmul_rn(__fadd_rn(x, (float)soff), 0.5f);
    return (int)fminf(fmaxf(floorf(ideal), 0.0f),
                      (float)(DQ_MAX_LEVEL - 1));
}

// the level of term tm (0 zero, 1 even, 2 odd) around l0
__device__ __forceinline__ int term_level(int l0, int tm) {
    return tm == 0 ? 0 : (tm == 1 ? (l0 + 1) & ~1 : l0 | 1);
}

// The term (0 zero, 1 even, 2 odd level) of code j of destination d, in
// flat order (common/depquant.py DEST_TERM), by d's kind d >> 1
__device__ __forceinline__ int cand_term(int d, int j) {
    return (d >> 1) ? (j + 2) % 3 : j;
}

// The terms of one (position, block, lattice): squared errors in double
// and lam_h*rate of the zero, even and odd level
struct Terms {
    double z, e, o;
    float lz, le, lo;
};

// One step of destination d (lattice d & 1, kind d >> 1).  Of its two
// source states, `maj` offers the zero and the even level, `mn` the odd
// one: for kind 0 maj is the lower state and the flat order is (maj,
// zero), (maj, even), (mn, odd); for kind 1 maj is the upper state and the
// order is (mn, odd), (maj, zero), (maj, even).  Returns the cheapest cost
// (fminf, so the chain does not wait for the decision) and sets the
// decision byte: the first cheapest candidate's source state * 8 + its
// code j.
__device__ __forceinline__ float dest_step(int d, float maj, float mn,
                                           const Terms& t, uint32_t& dec) {
    const double dmaj = (double)maj, dmn = (double)mn;
    const float cz = __fadd_rn(__double2float_rn(__dadd_rn(dmaj, t.z)), t.lz);
    const float ce = __fadd_rn(__double2float_rn(__dadd_rn(dmaj, t.e)), t.le);
    const float co = __fadd_rn(__double2float_rn(__dadd_rn(dmn, t.o)), t.lo);
    const float best = fminf(fminf(cz, ce), co);
    const int kind = d >> 1, lo = 2 * (d & 1);
    int j, src;
    if (kind == 0) {
        j = cz == best ? 0 : (ce == best ? 1 : 2);
        src = lo + (j == 2);
    } else {
        j = co == best ? 0 : (cz == best ? 1 : 2);
        src = lo + (j != 0);
    }
    dec = (uint32_t)(src << 3 | j);
    return best;
}

// Shared memory of one D1 CTA.  e2/lr: [position in chunk][block][lattice]
// [term]; dec: [position][block] one byte a state; path: [position][block]
// the state on the backtracked path, times 8.
template <int N, bool GDEC>
struct DqShared {
    static constexpr int CH = N ? N : DQ_CHUNK;
    static constexpr int ND = GDEC ? 1 : (N ? N : DQ_SMEM_DEC_N);
    double e2[CH][DQ_BPC][2][3];
    float lr[CH][DQ_BPC][2][3];
    uint32_t dec[ND][DQ_BPC];
    uint8_t path[ND][DQ_BPC];
    int32_t raw[N ? DQ_BPC : 1][N ? N : 1];    // the blocks (N > 0)
    int16_t ord[CH];                           // coding order of the chunk
    int16_t inv[N ? N : 1];                    // raster -> coding (N > 0)
    float rate[DQ_RATE_SMEM];      // the rate of levels 0 .. DQ_RATE_SMEM-1
};

// D1.  N: the block's coefficients when a template instance (16, 64), 0
// for any n (staged DQ_CHUNK positions at a time).  GDEC: decisions in
// the global scratch (n > 256).
template <int N, bool GDEC>
__global__ void __launch_bounds__(DQ_THREADS)
quantize_dep_kernel(const int32_t* __restrict__ coeff, int b, int n_rt,
                    const int32_t* __restrict__ order,
                    const float* __restrict__ rate, float xscale,
                    float lam_h, int odd, uint32_t* __restrict__ g_dec,
                    uint8_t* __restrict__ g_path,
                    int32_t* __restrict__ out) {
    using S = DqShared<N, GDEC>;
    constexpr int NN = N ? N : 1;       // N where N > 0 (for the indexing)
    constexpr int STAGE_IT = (S::CH * DQ_BPC + DQ_THREADS - 1) / DQ_THREADS;
    __shared__ S sh;
    const int n = N ? N : n_rt;
    const int tid = threadIdx.x;
    const int blk0 = blockIdx.x * DQ_BPC;
    const int nblk = min(DQ_BPC, b - blk0);
    // this thread's block and destination state in the chain
    const int cb = tid >> 2, d = tid & 3;
    const bool chains = tid < 32;
    auto dec_at = [&](int p, int k) -> uint32_t* {
        if (GDEC) return g_dec + (size_t)p * b + blk0 + k;
        return &sh.dec[p][k];
    };
    DQ_MARK(0);
    for (int i = tid; i < DQ_RATE_SMEM; i += DQ_THREADS) sh.rate[i] = rate[i];
    if (N) {
        for (int i = tid; i < nblk * N; i += DQ_THREADS)
            sh.raw[i / NN][i % NN] = coeff[(size_t)blk0 * N + i];
        for (int p = tid; p < N; p += DQ_THREADS) {
            const int pos = order[p];
            sh.ord[p] = (int16_t)pos;
            sh.inv[pos] = (int16_t)p;
        }
    }
    const float lr0 = __fmul_rn(lam_h, rate[0]);
    float cost = d == 0 ? 0.0f : DQ_INF;        // the cost of state d
    for (int c0 = 0; c0 < n; c0 += S::CH) {
        const int ch = min(S::CH, n - c0);
        if (!N) {
            __syncthreads();            // the last chunk's chain is done
            for (int p = tid; p < ch; p += DQ_THREADS)
                sh.ord[p] = order[c0 + p];
        }
        __syncthreads();
        DQ_MARK(1);
        // prologue: the terms of every (position, block) of the chunk
#pragma unroll
        for (int it = 0; it < STAGE_IT; ++it) {
            const int i = tid + it * DQ_THREADS;
            if (i >= ch * DQ_BPC) break;
            const int p = i / DQ_BPC, k = i % DQ_BPC;
            int32_t v = 0;
            if (k < nblk)
                v = N ? sh.raw[k][sh.ord[p]]
                      : coeff[(size_t)(blk0 + k) * n + sh.ord[p]];
            const float x = half_steps(v, xscale, odd);
            const double ez = (double)x;
            const double e2z = __dmul_rn(ez, ez);
#pragma unroll
            for (int soff = 0; soff < 2; ++soff) {
                const int l0 = lattice_l0(x, soff);
                sh.e2[p][k][soff][0] = e2z;
                sh.lr[p][k][soff][0] = lr0;
#pragma unroll
                for (int tm = 1; tm < 3; ++tm) {
                    const int l = term_level(l0, tm);
                    const float t = (float)(2 * l - (l > 0 ? soff : 0));
                    const double err = (double)__fsub_rn(x, t);
                    sh.e2[p][k][soff][tm] = __dmul_rn(err, err);
                    const float r =
                        l < DQ_RATE_SMEM ? sh.rate[l] : __ldg(rate + l);
                    sh.lr[p][k][soff][tm] = __fmul_rn(lam_h, r);
                }
            }
        }
        __syncthreads();
        DQ_MARK(2);
        // the chain over the chunk's positions, each step's terms loaded
        // a step ahead
        if (chains) {
            const int lat = d & 1, kind = d >> 1;
            const int maj_lane = (tid & ~3) + 2 * lat + kind;
            const int mn_lane = (tid & ~3) + 2 * lat + 1 - kind;
            auto terms = [&](int p) -> Terms {
                const double* e = sh.e2[p][cb][lat];
                const float* l = sh.lr[p][cb][lat];
                return Terms{e[0], e[1], e[2], l[0], l[1], l[2]};
            };
            Terms cur_t = terms(0);
#pragma unroll(N ? N : 4)
            for (int p = 0; p < ch; ++p) {
                const Terms next_t = terms(min(p + 1, ch - 1));
                const float maj = __shfl_sync(0xffffffffu, cost, maj_lane);
                const float mn = __shfl_sync(0xffffffffu, cost, mn_lane);
                uint32_t dec;
                cost = dest_step(d, maj, mn, cur_t, dec);
                if (cb < nblk)
                    reinterpret_cast<uint8_t*>(dec_at(c0 + p, cb))[d] =
                        (uint8_t)dec;
                cur_t = next_t;
            }
        }
    }
    DQ_MARK(3);
    // the first cheapest final state, then the backtrack: one thread a
    // block walks the positions down, each step a shift and a mask of a
    // decision word loaded ahead, 16 at a time
    uint32_t cur8 = 0;
    float fin = __shfl_sync(0xffffffffu, cost, tid & ~3);
#pragma unroll
    for (int s = 1; s < 4; ++s) {
        const float c = __shfl_sync(0xffffffffu, cost, (tid & ~3) + s);
        if (c < fin) {
            fin = c;
            cur8 = 8u * s;
        }
    }
    __syncthreads();                    // every decision stored
    if (chains && d == 0 && cb < nblk) {
#pragma unroll(N ? (N + 15) / 16 : 1)
        for (int p0 = n - 1; p0 >= 0; p0 -= 16) {
            uint32_t w[16];
#pragma unroll
            for (int k = 0; k < 16; ++k)
                w[k] = p0 - k >= 0 ? *dec_at(p0 - k, cb) : 0u;
#pragma unroll
            for (int k = 0; k < 16; ++k) {
                const int p = p0 - k;
                if (p < 0) break;
                if (GDEC) g_path[(size_t)p * b + blk0 + cb] = (uint8_t)cur8;
                else sh.path[GDEC ? 0 : p][cb] = (uint8_t)cur8;
                cur8 = (w[k] >> cur8) & 0x18u;
            }
        }
    }
    __syncthreads();
    DQ_MARK(4);
    // epilogue: each position's level from its state, code and staged x
    auto level_at = [&](int p, int k, int32_t v) -> int32_t {
        uint32_t c8, w;
        if (GDEC) {
            c8 = g_path[(size_t)p * b + blk0 + k];
            w = g_dec[(size_t)p * b + blk0 + k];
        } else {
            c8 = sh.path[GDEC ? 0 : p][k];
            w = sh.dec[GDEC ? 0 : p][k];
        }
        const int code = (w >> c8) & 3;
        const int st = c8 >> 3;
        const int l0 = lattice_l0(half_steps(v, xscale, odd), st & 1);
        const int lev = term_level(l0, cand_term(st, code));
        return v > 0 ? lev : (v < 0 ? -lev : 0);
    };
    if (N) {
#pragma unroll
        for (int it = 0; it < (DQ_BPC * NN + DQ_THREADS - 1) / DQ_THREADS;
             ++it) {
            const int i = tid + it * DQ_THREADS;
            if (i >= nblk * N) break;
            const int k = i / NN, pos = i % NN;
            out[(size_t)blk0 * N + i] = level_at(sh.inv[pos], k,
                                                 sh.raw[k][pos]);
        }
    } else {
        for (int i = tid; i < nblk * n; i += DQ_THREADS) {
            const int k = i / n, p = i % n;
            const size_t at = (size_t)(blk0 + k) * n + order[p];
            out[at] = level_at(p, k, coeff[at]);
        }
    }
    DQ_MARK(5);
}

// D2: SEG lanes a block (16 for n <= 16, else 32), a warp's 32 lanes
// taking SEG coding positions of each of its 32 / SEG blocks at a time.
template <int SEG>
__global__ void __launch_bounds__(DQ2_THREADS)
dequantize_dep_kernel(const int32_t* __restrict__ level, int b, int n,
                      const int32_t* __restrict__ order, int i_scale,
                      int dq_shift, int odd, int32_t* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int warp = (blockIdx.x * DQ2_THREADS + threadIdx.x) >> 5;
    const int blk = warp * (32 / SEG) + lane / SEG;
    const int sl = lane % SEG;                  // position in the chunk
    const int base = lane - sl;                 // the segment's first lane
    const uint32_t seg_mask = SEG == 32 ? 0xffffffffu : 0xffffu;
    // positions of the chunk before this one, of its index parity and of
    // the other
    const uint32_t below = (1u << sl) - 1u;
    const uint32_t same = below & ((sl & 1) ? 0xaaaaaaaau : 0x55555555u);
    const uint32_t other = below & ~same;
    const bool valid_blk = blk < b;
    const int32_t* src = level + (size_t)blk * n;
    int32_t* dst = out + (size_t)blk * n;
    uint32_t c1 = 0, c0 = 0;                    // state at the chunk start
    for (int c = 0; c < n; c += SEG) {
        const int p = c + sl;
        const bool valid = valid_blk && p < n;
        int pos = 0;
        int32_t l = 0;
        if (valid) {
            pos = __ldg(order + p);
            l = src[pos];
        }
        const int32_t a = abs(l);
        const uint32_t m =
            (__ballot_sync(0xffffffffu, a & 1) >> base) & seg_mask;
        // the state before position p: the chunk start's bits, swapped
        // after an odd number of steps, then the XOR prefixes
        const uint32_t b1 = ((sl & 1) ? c0 : c1) ^ (__popc(m & other) & 1);
        if (valid) {
            const int32_t t = 2 * a - (a > 0 ? (int32_t)b1 : 0);
            const int32_t tv = l > 0 ? t : (l < 0 ? -t : 0);
            int32_t v = mul_wrap(tv, i_scale);
            v = odd ? clip16(rshift_round(mul_wrap(v, 181), 8 + dq_shift - 1))
                    : clip16(rshift_round(v, dq_shift));
            dst[pos] = v;
        }
        // SEG steps (an even number) keep the bits in place
        c1 ^= __popc(m & 0xaaaaaaaau) & 1;
        c0 ^= __popc(m & 0x55555555u) & 1;
    }
}

template <int N>
static void launch_quantize(unsigned grid, cudaStream_t st, bool gdec,
                            const int32_t* coeff, int b, int n,
                            const int32_t* order, const float* rate,
                            float xscale, float lam_h, int odd,
                            uint32_t* g_dec, uint8_t* g_path, int32_t* out) {
    if (gdec)
        quantize_dep_kernel<N, true><<<grid, DQ_THREADS, 0, st>>>(
            coeff, b, n, order, rate, xscale, lam_h, odd, g_dec, g_path,
            out);
    else
        quantize_dep_kernel<N, false><<<grid, DQ_THREADS, 0, st>>>(
            coeff, b, n, order, rate, xscale, lam_h, odd, g_dec, g_path,
            out);
}

// D1.  Refuses an empty batch, a block size outside 1 .. 4096
// coefficients, and a block of more than 256 coefficients without a
// scratch of b*n*5 bytes (b*n decision words, then b*n path bytes).
extern "C" int quantize_dep(const void* coeff, int b, int n,
                            const void* order, const void* rate,
                            float xscale, float lam_h, int odd,
                            void* scratch, void* out, void* stream) {
    if (b < 1 || n < 1 || n > 4096) return (int)cudaErrorInvalidValue;
    const bool gdec = n > DQ_SMEM_DEC_N;
    if (gdec && scratch == nullptr) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((b + DQ_BPC - 1) / DQ_BPC);
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t* c = (const int32_t*)coeff;
    const int32_t* o = (const int32_t*)order;
    const float* r = (const float*)rate;
    uint32_t* g_dec = (uint32_t*)scratch;
    uint8_t* g_path = gdec ? (uint8_t*)(g_dec + (size_t)b * n) : nullptr;
    int32_t* y = (int32_t*)out;
    if (n == 64)
        launch_quantize<64>(grid, st, gdec, c, b, n, o, r, xscale, lam_h,
                            odd, g_dec, g_path, y);
    else if (n == 16)
        launch_quantize<16>(grid, st, gdec, c, b, n, o, r, xscale, lam_h,
                            odd, g_dec, g_path, y);
    else
        launch_quantize<0>(grid, st, gdec, c, b, n, o, r, xscale, lam_h,
                           odd, g_dec, g_path, y);
    return (int)cudaGetLastError();
}

extern "C" int dequantize_dep(const void* level, int b, int n,
                              const void* order, int i_scale, int dq_shift,
                              int odd, void* out, void* stream) {
    if (b < 1 || n < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int seg = n <= 16 ? 16 : 32;
    const int per_cta = (DQ2_THREADS / 32) * (32 / seg);
    const unsigned grid = (unsigned)((b + per_cta - 1) / per_cta);
    if (seg == 16)
        dequantize_dep_kernel<16><<<grid, DQ2_THREADS, 0, st>>>(
            (const int32_t*)level, b, n, (const int32_t*)order, i_scale,
            dq_shift, odd, (int32_t*)out);
    else
        dequantize_dep_kernel<32><<<grid, DQ2_THREADS, 0, st>>>(
            (const int32_t*)level, b, n, (const int32_t*)order, i_scale,
            dq_shift, odd, (int32_t*)out);
    return (int)cudaGetLastError();
}
