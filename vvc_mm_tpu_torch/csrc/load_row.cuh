// Loading one window row of an int32 plane, shared by the position kernels
// of mc_positions.cu and sad_positions.cu.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// Patch row `row` (its first needed word at offset o of a CH-word chunk)
// -> x[0..W-1].  CH = 4 or 2: the aligned 16- or 8-byte chunks covering
// the row, never one past its last needed chunk, then shifted left by o;
// CH = 1: scalar loads.
template <int W, int CH>
__device__ __forceinline__ void load_row(const int32_t* row, int o, int* x) {
    if (CH == 4) {
        // chunks covering words o .. o+W-1 for the largest o (3); chunk j
        // is read only when it holds one of them
        constexpr int NCH = (W + 6) / 4;
        const int4* q = reinterpret_cast<const int4*>(row);
        int w[4 * NCH];
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
            const int4 c = (4 * j <= W - 1 || 4 * j <= o + W - 1)
                               ? __ldg(q + j) : make_int4(0, 0, 0, 0);
            w[4 * j] = c.x; w[4 * j + 1] = c.y;
            w[4 * j + 2] = c.z; w[4 * j + 3] = c.w;
        }
        int w1[W + 2];
#pragma unroll
        for (int i = 0; i < W + 2; ++i) w1[i] = (o & 1) ? w[i + 1] : w[i];
#pragma unroll
        for (int i = 0; i < W; ++i) x[i] = (o & 2) ? w1[i + 2] : w1[i];
    } else if (CH == 2) {
        constexpr int NCH = (W + 2) / 2;     // o = 1 needs word W
        const int2* q = reinterpret_cast<const int2*>(row);
        int w[2 * NCH];
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
            const int2 c = (2 * j <= W - 1 || 2 * j <= o + W - 1)
                               ? __ldg(q + j) : make_int2(0, 0);
            w[2 * j] = c.x; w[2 * j + 1] = c.y;
        }
#pragma unroll
        for (int i = 0; i < W; ++i) x[i] = o ? w[i + 1] : w[i];
    } else {
#pragma unroll
        for (int i = 0; i < W; ++i) x[i] = __ldg(row + i);
    }
}
