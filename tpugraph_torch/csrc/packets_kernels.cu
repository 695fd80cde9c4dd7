// SpMM over the edge-packet layout of tpugraph_torch/ops/packets.py, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// tpugraph_torch/ops/packets_kernels.py, which checks every argument first.
//
// Layout: the packets keep w f32[P * K] (0 = dead slot).  The wrapper derives a
// row schedule from the packets once per EdgePackets, on their device
// (ops/packets_kernels.py:packet_schedule): every live slot (w != 0), in order of
// (global receiver row, packet, slot), as
//   src    int32[E]  col_blk * block_c + cols, the x row it gathers
//   slot   int32[E]  p * K + k, the slot whose weight w[slot] it reads
//   work   int4[n_items]  (row, first edge, end edge, partial slot or -1 for a row
//                          that is one chunk), longest chunk first; every row has
//                          at least one item, so an empty row is written as zeros
//   splits int4[n_split]  (row, first partial slot, chunks, 0) of each split row
//
// spmm_packets replaces tpugraph/ops/pallas_packets.py:spmm_packets
// (_packet_kernel_factory): y[N, D] = A @ x.
//   Semantics: per edge e, g[e] = w[e] * x[src[e]]; with a bf16 compute type w and
//   x are rounded to bf16 first and g is rounded to bf16 after the (exact) f32
//   product, as the TPU kernel stages g at the compute dtype.  y[row] is the f32
//   sum of its g in schedule order, from +0.0; a bf16 output is rounded once.
//   With bf16 compute the wrapper hands in x already rounded to bf16 (one cast a
//   call instead of one a gathered entry: the same values, half the bytes).  f32
//   compute multiplies and adds with IEEE rounding (__fmul_rn, __fadd_rn: no FMA
//   contraction), so a row that is one chunk has the bits of the plain version's
//   index_add_ on the CPU.
//   Bound on the H100: bytes.  Operations are 2*E*D; the least bytes are 12 a live
//   edge, x read once and y written once (375 MB at the ogbn-arxiv stand-in's 2.33M
//   edges and D = 256, f32).  The practical floor is the gather: each live edge
//   reads a D-wide x row, E*D*itemsize bytes (2.4 GB there), partly served by the
//   50 MB L2, where a power-law graph's hub rows stay.
//   Design: the TPU kernel turns gather and scatter into one-hot matmuls for its
//   matrix unit; Hopper gathers rows directly, and a row's sum is best kept in
//   registers.  So the kernel walks receiver rows, not packets: one warp a work
//   item.  Its lanes load 32 (src, slot) pairs and their weights at once and
//   broadcast them with __shfl_sync; each lane owns 4 columns of each 128-column
//   group (one 16-byte f32 or 8-byte bf16 load of the x row, or 4 scalar loads
//   when D % 4 != 0 or x is not 16-byte aligned) and keeps the row's sum in
//   registers: V groups, V = 2 for D > 128, else 1; wider D takes more CTAs in
//   grid.y.  The loads of 8 / V edges start before their adds.  Only live slots
//   are read: a packet's dead slots (91% of the arxiv stand-in's 27.3M) cost
//   nothing a product.  No shared memory and no atomics: the result is the same
//   bits from launch to launch.  A power-law graph's hub rows are cut into chunks
//   of at most CHUNK_EDGES (ops/packets_kernels.py), longest first, so no warp's
//   row is the kernel's tail; a chunk of a split row writes one f32 row of
//   partial sums, and spmm_packets_reduce adds a row's partials in chunk order
//   and rounds once (never a bf16 partial).  Every output row is written.
//
// spmm_packets_ablation runs the same kernel in a diagnostic mode (the
// counterpart of bench_packets_diag.py's variants), with bf16 compute, f32 output
// and D % 4 == 0: 1 slots_only (schedule and weights read, no x gather), 2
// no_gather (every x read goes to row 0), 3 gather_only (no per-row store: each
// lane adds its columns' sums into one value, written once a warp to row `row`
// of y, and no partials, so the reduce pass does not run).
//
// Each entry point launches on the caller's stream and returns cudaGetLastError()
// after its launch, or cudaErrorInvalidValue for an unknown mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;           // 8 warps a CTA, one work item each
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 128;             // columns of one group: 32 lanes x 4
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Mode { FULL = 0, SLOTS_ONLY = 1, NO_GATHER = 2, GATHER_ONLY = 3 };

__device__ __forceinline__ float bf16_round(float v) {
    uint32_t b = __float_as_uint(v);
    b += 0x7fffu + ((b >> 16) & 1u);
    return __uint_as_float(b & 0xffff0000u);
}

__device__ __forceinline__ float bf16_widen(uint32_t b) { return __uint_as_float(b << 16); }

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
    return (__float_as_uint(bf16_round(lo)) >> 16) | (__float_as_uint(bf16_round(hi)) & 0xffff0000u);
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
            v[0] = bf16_widen(u.x & 0xffffu);
            v[1] = bf16_widen(u.x >> 16);
            v[2] = bf16_widen(u.y & 0xffffu);
            v[3] = bf16_widen(u.y >> 16);
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
             : XB16 ? bf16_widen(__ldg((const uint16_t*)src + i)) : __ldg((const float*)src + i);
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
            ((uint16_t*)dst)[i] = (uint16_t)(__float_as_uint(bf16_round(v[m])) >> 16);
        else
            ((float*)dst)[i] = v[m];
    }
}

template <bool BF16, bool OUT_BF16, bool VEC, int V, int MODE>
__global__ void __launch_bounds__(THREADS)
spmm_packets_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ slot,
                    const float* __restrict__ w, const int4* __restrict__ work, int n_items,
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
        const int my_s = ok ? src[k] : 0;
        float my_w = ok ? w[slot[k]] : 0.f;
        if (BF16) my_w = bf16_round(my_w);        // once an edge, before the shuffles
        const int n = min(32, it.z - base);       // warp-uniform
        for (int j0 = 0; j0 < n; j0 += U) {       // j0 + t <= 31: U divides 32
            float v[U][V][4];
#pragma unroll
            for (int t = 0; t < U; ++t) {
                const int s = __shfl_sync(FULL_MASK, my_s, j0 + t);
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
    if (it.w < 0) {
#pragma unroll
        for (int g = 0; g < V; ++g)
            store4<OUT_BF16, VEC>(y, (size_t)it.x, c0 + g * GROUP, lane, d, acc[g]);
    } else {
#pragma unroll
        for (int g = 0; g < V; ++g)
            store4<false, VEC>(partial, (size_t)it.w, c0 + g * GROUP, lane, d, acc[g]);
    }
}

// y rows of the split rows: the sum of each one's partials in chunk order,
// rounded once to the output dtype
template <bool OUT_BF16, bool VEC, int V>
__global__ void __launch_bounds__(THREADS)
spmm_packets_reduce_kernel(const int4* __restrict__ splits, int n_split,
                           const float* __restrict__ partial, void* __restrict__ y, int d) {
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

inline dim3 grid_of(int n, int d, int v) {
    return dim3((n + WARPS - 1) / WARPS, (d + GROUP * v - 1) / (GROUP * v));
}

template <bool BF16, bool OUT_BF16, bool VEC, int V, int MODE>
int launch_v(const void* src, const void* slot, const void* w, const void* work, int n_items,
             const void* x, void* y, void* partial, int d, cudaStream_t st) {
    spmm_packets_kernel<BF16, OUT_BF16, VEC, V, MODE><<<grid_of(n_items, d, V), THREADS, 0, st>>>(
        (const int32_t*)src, (const int32_t*)slot, (const float*)w, (const int4*)work, n_items,
        x, y, (float*)partial, d);
    return (int)cudaGetLastError();
}

template <bool BF16, bool OUT_BF16, bool VEC, int MODE>
int launch(const void* src, const void* slot, const void* w, const void* work, int n_items,
           const void* x, void* y, void* partial, int d, cudaStream_t st) {
    return d > GROUP
        ? launch_v<BF16, OUT_BF16, VEC, 2, MODE>(src, slot, w, work, n_items, x, y, partial, d, st)
        : launch_v<BF16, OUT_BF16, VEC, 1, MODE>(src, slot, w, work, n_items, x, y, partial, d, st);
}

template <bool BF16, bool OUT_BF16>
int launch_vec(int vec, const void* src, const void* slot, const void* w, const void* work,
               int n_items, const void* x, void* y, void* partial, int d, cudaStream_t st) {
    return vec ? launch<BF16, OUT_BF16, true, FULL>(src, slot, w, work, n_items, x, y, partial,
                                                    d, st)
               : launch<BF16, OUT_BF16, false, FULL>(src, slot, w, work, n_items, x, y,
                                                     partial, d, st);
}

template <bool OUT_BF16, bool VEC>
int launch_reduce(const void* splits, int n_split, const void* partial, void* y, int d,
                  cudaStream_t st) {
    const int4* s = (const int4*)splits;
    const float* pp = (const float*)partial;
    if (d > GROUP)
        spmm_packets_reduce_kernel<OUT_BF16, VEC, 2>
            <<<grid_of(n_split, d, 2), THREADS, 0, st>>>(s, n_split, pp, y, d);
    else
        spmm_packets_reduce_kernel<OUT_BF16, VEC, 1>
            <<<grid_of(n_split, d, 1), THREADS, 0, st>>>(s, n_split, pp, y, d);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Main pass: y[N, d] (f32, or bf16 bits when out_bf16) for the rows that are one
// chunk, f32 partials[n_parts, d] for the chunks of split rows.  compute_bf16
// selects the bf16 roundings of w and g and takes x as bf16 bits (already
// rounded); otherwise x is f32.  vec: d % 4 == 0 and x 16-byte aligned.
int spmm_packets(const void* src, const void* slot, const void* w, const void* work,
                 int n_items, const void* x, void* y, void* partial, int compute_bf16,
                 int out_bf16, int vec, int d, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (compute_bf16)
        return out_bf16 ? launch_vec<true, true>(vec, src, slot, w, work, n_items, x, y,
                                                 partial, d, st)
                        : launch_vec<true, false>(vec, src, slot, w, work, n_items, x, y,
                                                  partial, d, st);
    return out_bf16 ? launch_vec<false, true>(vec, src, slot, w, work, n_items, x, y, partial,
                                              d, st)
                    : launch_vec<false, false>(vec, src, slot, w, work, n_items, x, y,
                                               partial, d, st);
}

// Second pass: the rows of the n_split split rows, summed from their partials in
// chunk order, rounded once to the output dtype.
int spmm_packets_reduce(const void* splits, int n_split, const void* partial, void* y,
                        int out_bf16, int vec, int d, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (out_bf16)
        return vec ? launch_reduce<true, true>(splits, n_split, partial, y, d, st)
                   : launch_reduce<true, false>(splits, n_split, partial, y, d, st);
    return vec ? launch_reduce<false, true>(splits, n_split, partial, y, d, st)
               : launch_reduce<false, false>(splits, n_split, partial, y, d, st);
}

// The main pass in a diagnostic mode (1 slots_only, 2 no_gather, 3 gather_only;
// 0 is the full kernel): bf16 compute on bf16-bits x, f32 output, d % 4 == 0.
int spmm_packets_ablation(const void* src, const void* slot, const void* w, const void* work,
                          int n_items, const void* x, void* y, void* partial, int mode, int d,
                          void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (mode) {
        case FULL:
            return launch<true, false, true, FULL>(src, slot, w, work, n_items, x, y, partial,
                                                   d, st);
        case SLOTS_ONLY:
            return launch<true, false, true, SLOTS_ONLY>(src, slot, w, work, n_items, x, y,
                                                         partial, d, st);
        case NO_GATHER:
            return launch<true, false, true, NO_GATHER>(src, slot, w, work, n_items, x, y,
                                                        partial, d, st);
        case GATHER_ONLY:
            return launch<true, false, true, GATHER_ONLY>(src, slot, w, work, n_items, x, y,
                                                          partial, d, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
