// The row walk y = A @ x over a row-sorted edge list (ops/csr.py:CSR), for Hopper
// (sm_90a): the bodies of the COO product's kernels (coo_kernels.cu) and of B7's
// (packets_kernels.cu), whose __global__ wrappers keep each product's kernel names.
//
// Layout (built once by ops/csr.py:row_csrs, stable-sorted by row):
//   col    int32[E]  the x row each sorted edge gathers
//   eid    int32[E]  the entry whose weight weight[eid[k]] it reads: its index in the
//                    COO edge list, or B7's slot p * K + k (dead slots are not listed)
//   work   int4[n_items]  (row, first edge, end edge, partial slot or -1 for a row
//                          that is one chunk), longest chunk first; every row has at
//                          least one item, so an empty row is written as zeros
//   splits int4[n_split]  (row, first partial slot, chunks, 0) of each split row
//
// Semantics: per edge k, g = weight[eid[k]] * x[col[k]]; y[row] is the f32 sum of its
// g in row order, from +0.0.  With BF16 compute (B7's bf16 compute dtype) weight and x
// are rounded to bf16 first (the wrapper hands in x as bf16 bits, rounded once a call)
// and g is rounded to bf16 after the (exact) f32 product, as the TPU kernel stages g
// at the compute dtype.  f32 compute multiplies and adds with IEEE rounding
// (__fmul_rn, __fadd_rn: no FMA contraction), so a row that is one chunk has the bits
// of the gather and index_add_ on the CPU.  A bf16 output (OUT_BF16) is rounded once.
//
// Bound on the H100: bytes.  Operations are 2*E*D; the least bytes are 12 an edge, x
// read once and y written once (375 MB at the ogbn-arxiv stand-in's 2.33M edges and
// D = 256, f32).  The practical floor is the gather: each edge reads a D-wide x row,
// E*D*itemsize bytes (2.4 GB there), partly served by the 50 MB L2, where a
// power-law graph's hub rows stay.
//
// Design: one warp a work item.  Its lanes load 32 (col, eid) pairs and their weights
// at once and broadcast them with __shfl_sync; each lane owns 4 columns of each
// 128-column group (one 16-byte f32 or 8-byte bf16 load of the x row, or 4 scalar
// loads when D % 4 != 0 or x is not 16-byte aligned) and keeps the row's sum in
// registers: V groups, V = 2 for D > 128, else 1; wider D takes more CTAs in grid.y.
// The loads of 8 / V edges start before their adds.  No shared memory and no atomics:
// the result is the same bits from launch to launch.  A power-law graph's hub rows are
// cut into chunks of at most CHUNK_EDGES (ops/csr.py), longest first, so no warp's row
// is the kernel's tail; a chunk of a split row writes one f32 row of partial sums, and
// the reduce pass adds a row's partials in chunk order and rounds once (never a bf16
// partial).  Every output row is written.
//
// MODE runs B7's diagnostic variants (packets_kernels.cu:spmm_packets_ablation):
// SLOTS_ONLY reads the edges and weights and gathers no x, NO_GATHER reads x row 0 for
// every edge, GATHER_ONLY adds each lane's column sums into one value, written once a
// warp to row `row` of y, and writes no partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_dtypes.cuh"

namespace row_spmm {

constexpr int THREADS = 256;           // 8 warps a CTA, one work item each
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 128;             // columns of one group: 32 lanes x 4
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Mode { FULL = 0, SLOTS_ONLY = 1, NO_GATHER = 2, GATHER_ONLY = 3 };

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
    return tpg::bf16_bits(lo) | ((uint32_t)tpg::bf16_bits(hi) << 16);
}

// a lane's 4 columns of group c0 of row `row` of a [*, d] array (bf16 bits when
// XB16): c0 + 4 lane .. + 3 (VEC) or c0 + lane + 32 m; zero past d
template <bool XB16, bool VEC>
__device__ __forceinline__ void load4(const void* __restrict__ src, size_t row, int c0,
                                      int lane, int d, float v[4]) {
    if (VEC) {  // d % 4 == 0, so c < d covers c + 3
        const int c = c0 + 4 * lane;
        if (c >= d) {
            v[0] = v[1] = v[2] = v[3] = 0.f;
        } else if (XB16) {
            const uint2 u = __ldg((const uint2*)((const uint16_t*)src + row * d + c));
            v[0] = tpg::bf16_widen(u.x & 0xffffu);
            v[1] = tpg::bf16_widen(u.x >> 16);
            v[2] = tpg::bf16_widen(u.y & 0xffffu);
            v[3] = tpg::bf16_widen(u.y >> 16);
        } else {
            const float4 f = __ldg((const float4*)((const float*)src + row * d + c));
            v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
        }
        return;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        const int c = c0 + lane + 32 * m;
        const size_t i = row * d + c;
        v[m] = c >= d ? 0.f
             : XB16 ? tpg::bf16_widen(__ldg((const uint16_t*)src + i))
                    : __ldg((const float*)src + i);
    }
}

// the same 4 columns of row `row` of a [*, d] f32 or bf16 array
template <bool OUT_BF16, bool VEC>
__device__ __forceinline__ void store4(void* __restrict__ dst, size_t row, int c0, int lane,
                                       int d, const float v[4]) {
    if (VEC) {
        const int c = c0 + 4 * lane;
        if (c >= d) return;
        const size_t i = row * d + c;
        if (OUT_BF16)
            *(uint2*)((uint16_t*)dst + i) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
        else
            *(float4*)((float*)dst + i) = make_float4(v[0], v[1], v[2], v[3]);
        return;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        const int c = c0 + lane + 32 * m;
        if (c >= d) continue;
        const size_t i = row * d + c;
        if (OUT_BF16)
            ((uint16_t*)dst)[i] = tpg::bf16_bits(v[m]);
        else
            ((float*)dst)[i] = v[m];
    }
}

// the main pass: one warp a work item, y rows of the rows that are one chunk and f32
// partials of the chunks of split rows
template <bool BF16, bool OUT_BF16, bool VEC, int V, int MODE>
__device__ __forceinline__ void walk(const int32_t* __restrict__ col,
                                     const int32_t* __restrict__ eid,
                                     const float* __restrict__ weight,
                                     const int4* __restrict__ work, int n_items,
                                     const void* __restrict__ x, void* __restrict__ y,
                                     float* __restrict__ partial, int d) {
    constexpr int U = 8 / V;                      // edges whose x rows are in flight together
    const int lane = threadIdx.x & 31;
    const int item = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (item >= n_items) return;                  // the whole warp
    const int4 it = work[item];
    const int c0 = blockIdx.y * GROUP * V;
    float acc[V][4];
#pragma unroll
    for (int g = 0; g < V; ++g)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[g][m] = 0.f;

    for (int base = it.y; base < it.z; base += 32) {
        const int k = base + lane;
        const bool ok = k < it.z;
        const int my_c = ok ? col[k] : 0;
        float my_w = ok ? weight[eid[k]] : 0.f;
        if (BF16) my_w = tpg::bf16_round(my_w);   // once an edge, before the shuffles
        const int n = min(32, it.z - base);       // warp-uniform
        for (int j0 = 0; j0 < n; j0 += U) {       // j0 + t <= 31: U divides 32
            float v[U][V][4];
#pragma unroll
            for (int t = 0; t < U; ++t) {
                const int s = __shfl_sync(FULL_MASK, my_c, j0 + t);
                if (j0 + t < n) {
#pragma unroll
                    for (int g = 0; g < V; ++g) {
                        if (MODE == SLOTS_ONLY)
                            v[t][g][0] = v[t][g][1] = v[t][g][2] = v[t][g][3] = 1.f;
                        else
                            load4<BF16, VEC>(x, MODE == NO_GATHER ? 0 : (size_t)s,
                                             c0 + g * GROUP, lane, d, v[t][g]);
                    }
                }
            }
#pragma unroll
            for (int t = 0; t < U; ++t) {
                const float wt = __shfl_sync(FULL_MASK, my_w, j0 + t);
                if (j0 + t < n) {
#pragma unroll
                    for (int g = 0; g < V; ++g) {
                        if (BF16) {  // exact f32 products, rounded two at a time (cvt.rn.bf16x2)
#pragma unroll
                            for (int m = 0; m < 4; m += 2) {
                                const __nv_bfloat162 b = __floats2bfloat162_rn(
                                    __fmul_rn(wt, v[t][g][m]), __fmul_rn(wt, v[t][g][m + 1]));
                                acc[g][m] = __fadd_rn(acc[g][m], __low2float(b));
                                acc[g][m + 1] = __fadd_rn(acc[g][m + 1], __high2float(b));
                            }
                        } else {
#pragma unroll
                            for (int m = 0; m < 4; ++m)
                                acc[g][m] = __fadd_rn(acc[g][m], __fmul_rn(wt, v[t][g][m]));
                        }
                    }
                }
            }
        }
    }
    if (MODE == GATHER_ONLY) {                    // one value a lane, one write a warp
        float s = 0.f;
#pragma unroll
        for (int g = 0; g < V; ++g)
#pragma unroll
            for (int m = 0; m < 4; ++m) s += acc[g][m];
        if (blockIdx.y == 0 && lane < d) ((float*)y)[(size_t)it.x * d + lane] = s;
        return;
    }
    if (OUT_BF16 && it.w < 0) {                   // a bf16 row of y; partials stay f32
#pragma unroll
        for (int g = 0; g < V; ++g)
            store4<true, VEC>(y, (size_t)it.x, c0 + g * GROUP, lane, d, acc[g]);
        return;
    }
    const bool direct = it.w < 0;
    float* dst = direct ? (float*)y : partial;
    const size_t row = direct ? (size_t)it.x : (size_t)it.w;
#pragma unroll
    for (int g = 0; g < V; ++g) store4<false, VEC>(dst, row, c0 + g * GROUP, lane, d, acc[g]);
}

// the reduce pass: y rows of the split rows, the sum of each one's partials in chunk
// order, rounded once to the output dtype
template <bool OUT_BF16, bool VEC, int V>
__device__ __forceinline__ void reduce(const int4* __restrict__ splits, int n_split,
                                       const float* __restrict__ partial,
                                       void* __restrict__ y, int d) {
    const int lane = threadIdx.x & 31;
    const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (s >= n_split) return;
    const int4 sp = splits[s];
    const int c0 = blockIdx.y * GROUP * V;
    float o[V][4], v[4];
#pragma unroll
    for (int g = 0; g < V; ++g)
        load4<false, VEC>(partial, (size_t)sp.y, c0 + g * GROUP, lane, d, o[g]);
    for (int i = 1; i < sp.z; ++i) {
#pragma unroll
        for (int g = 0; g < V; ++g) {
            load4<false, VEC>(partial, (size_t)(sp.y + i), c0 + g * GROUP, lane, d, v);
#pragma unroll
            for (int m = 0; m < 4; ++m) o[g][m] = __fadd_rn(o[g][m], v[m]);
        }
    }
#pragma unroll
    for (int g = 0; g < V; ++g) store4<OUT_BF16, VEC>(y, (size_t)sp.x, c0 + g * GROUP, lane, d, o[g]);
}

// Launches k1 (V = 1) or, for d > GROUP, k2 (V = 2) over n items, a warp each, with
// args; returns cudaGetLastError() after the launch.
template <typename K1, typename K2, typename... A>
int launch_rows(K1 k1, K2 k2, int n, int d, cudaStream_t st, A... args) {
    const int v = d > GROUP ? 2 : 1;
    const dim3 grid((n + WARPS - 1) / WARPS, (d + GROUP * v - 1) / (GROUP * v));
    if (v == 2)
        k2<<<grid, THREADS, 0, st>>>(args...);
    else
        k1<<<grid, THREADS, 0, st>>>(args...);
    return (int)cudaGetLastError();
}

// Calls f(std::true_type{}) or f(std::false_type{}) for a run-time flag, so that f
// can instantiate a kernel for it.
template <typename F>
int with_flag(int flag, F&& f) {
    return flag ? f(std::true_type{}) : f(std::false_type{});
}

}  // namespace row_spmm
