// y = A @ x over a CSR of the COO edge list, for Hopper (sm_90a).  Plain C
// interface, loaded with ctypes by tpugraph_torch/ops/coo_kernels.py, which checks
// every argument first.
//
// Replaces no Pallas kernel: the JAX package computes the COO product with XLA's
// gather and segment_sum (tpugraph/ops/message.py:22), which the port first ran as
// index_select, a multiply and an atomic index_add_ (ops/message.py:spmm).  That
// wrote an E x D message tensor, read it back twice and summed with atomics.
//
// Layout (built once a job by ops/coo_kernels.py:edge_csr, stable-sorted by row):
//   col    int32[E]  the column (sender for A, receiver for A^T) of each sorted edge
//   eid    int32[E]  its index in the original edge list; the kernel reads
//                    weight[eid[k]], so static weights and weights that carry a
//                    gradient take the same kernel
//   work   int4[n_items]  (row, first edge, end edge, partial slot or -1 for a row
//                          that is one chunk), longest chunk first; every row has at
//                          least one item, so an empty row is written as zeros
//   splits int4[n_split]  (row, first partial slot, chunks, 0) of each split row
//
// spmm_coo_csr: y[row] = sum over the row's edges k, in CSR order, of
//   weight[eid[k]] * x[col[k]], multiplied then added in f32 with IEEE rounding
//   (__fmul_rn, __fadd_rn: no FMA contraction), from +0.0, as the plain version's
//   index_add_ sums on the CPU.  A row that is one chunk is written directly;
//   the chunks of a split row write f32 partials, which spmm_coo_csr_reduce adds
//   in chunk order.  No atomics: the result is the same bits from launch to launch.
//   Bound on the H100: bytes.  Operations are 2*E*D; the gather reads E*D*4 bytes
//   of x rows (2.4 GB at arxiv's 2.33M edges and D = 256) against x's N*D*4 read
//   once (173 MB), so the practical floor is the gather, partly served by the
//   50 MB L2 (a power-law graph's hub rows are gathered most often).  The design
//   moves nothing else: no message tensor, y written once, 12 bytes of edge data
//   an edge.
//   Design: one warp a work item.  Its lanes load 32 (col, eid) pairs and their
//   weights at once, and broadcast them with __shfl_sync; each lane owns 4
//   columns of each 128-column group (one 16-byte load of the x row, or 4 scalar
//   loads when D % 4 != 0 or x is not 16-byte aligned) and keeps the row's sum
//   in registers: V groups, V = 2 for D > 128 (arxiv's 256), else 1; wider D takes
//   more CTAs in grid.y.  The loads of 8 / V edges start before their adds,
//   so 4 KB of x rows are in flight a warp.  A power-law graph's hub rows (about
//   3,000 edges for node 0 of the arxiv stand-in) are cut into chunks of at most
//   CHUNK_EDGES, and the longest chunks go first, so no warp's row is the
//   kernel's tail.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;           // 8 warps a CTA, one work item each
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 128;             // columns of one group: 32 lanes x 4
constexpr unsigned FULL = 0xffffffffu;

// a lane's 4 columns of group c0 of `row`: c0 + 4 lane .. + 3 (VEC) or c0 + lane + 32 m;
// zero past d
template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ src, size_t row, int c0,
                                      int lane, int d, float v[4]) {
    if (VEC) {  // d % 4 == 0, so c < d covers c + 3
        const int c = c0 + 4 * lane;
        if (c < d) {
            const float4 f = __ldg((const float4*)(src + row * d + c));
            v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
        } else {
            v[0] = v[1] = v[2] = v[3] = 0.f;
        }
        return;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        const int c = c0 + lane + 32 * m;
        v[m] = c < d ? __ldg(src + row * d + c) : 0.f;
    }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ dst, size_t row, int c0, int lane,
                                       int d, const float v[4]) {
    if (VEC) {
        const int c = c0 + 4 * lane;
        if (c < d) *(float4*)(dst + row * d + c) = make_float4(v[0], v[1], v[2], v[3]);
        return;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        const int c = c0 + lane + 32 * m;
        if (c < d) dst[row * d + c] = v[m];
    }
}

template <bool VEC, int V>
__global__ void __launch_bounds__(THREADS)
spmm_coo_csr_kernel(const int32_t* __restrict__ col, const int32_t* __restrict__ eid,
                    const float* __restrict__ weight, const int4* __restrict__ work,
                    int n_items, const float* __restrict__ x, float* __restrict__ y,
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
        const float my_w = ok ? weight[eid[k]] : 0.f;
        const int n = min(32, it.z - base);       // warp-uniform
        for (int j0 = 0; j0 < n; j0 += U) {       // j0 + t <= 31: U divides 32
            float v[U][V][4];
#pragma unroll
            for (int t = 0; t < U; ++t) {
                const int src = __shfl_sync(FULL, my_c, j0 + t);
                if (j0 + t < n) {
#pragma unroll
                    for (int g = 0; g < V; ++g)
                        load4<VEC>(x, (size_t)src, c0 + g * GROUP, lane, d, v[t][g]);
                }
            }
#pragma unroll
            for (int t = 0; t < U; ++t) {
                const float w = __shfl_sync(FULL, my_w, j0 + t);
                if (j0 + t < n) {
#pragma unroll
                    for (int g = 0; g < V; ++g)
#pragma unroll
                        for (int m = 0; m < 4; ++m)
                            acc[g][m] = __fadd_rn(acc[g][m], __fmul_rn(w, v[t][g][m]));
                }
            }
        }
    }
    const bool direct = it.w < 0;
    float* dst = direct ? y : partial;
    const size_t row = direct ? (size_t)it.x : (size_t)it.w;
#pragma unroll
    for (int g = 0; g < V; ++g) store4<VEC>(dst, row, c0 + g * GROUP, lane, d, acc[g]);
}

// y rows of the split rows: the sum of each one's partials in chunk order
template <bool VEC, int V>
__global__ void __launch_bounds__(THREADS)
spmm_coo_csr_reduce_kernel(const int4* __restrict__ splits, int n_split,
                           const float* __restrict__ partial, float* __restrict__ y, int d) {
    const int lane = threadIdx.x & 31;
    const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (s >= n_split) return;
    const int4 sp = splits[s];
    const int c0 = blockIdx.y * GROUP * V;
    float o[V][4], v[4];
#pragma unroll
    for (int g = 0; g < V; ++g) load4<VEC>(partial, (size_t)sp.y, c0 + g * GROUP, lane, d, o[g]);
    for (int i = 1; i < sp.z; ++i) {
#pragma unroll
        for (int g = 0; g < V; ++g) {
            load4<VEC>(partial, (size_t)(sp.y + i), c0 + g * GROUP, lane, d, v);
#pragma unroll
            for (int m = 0; m < 4; ++m) o[g][m] = __fadd_rn(o[g][m], v[m]);
        }
    }
#pragma unroll
    for (int g = 0; g < V; ++g) store4<VEC>(y, (size_t)sp.x, c0 + g * GROUP, lane, d, o[g]);
}

template <bool VEC, int V>
int launch(const void* col, const void* eid, const void* weight, const void* work, int n_items,
           const void* x, void* y, void* partial, int d, cudaStream_t st) {
    const dim3 grid((n_items + WARPS - 1) / WARPS, (d + GROUP * V - 1) / (GROUP * V));
    spmm_coo_csr_kernel<VEC, V><<<grid, THREADS, 0, st>>>(
        (const int32_t*)col, (const int32_t*)eid, (const float*)weight, (const int4*)work,
        n_items, (const float*)x, (float*)y, (float*)partial, d);
    return (int)cudaGetLastError();
}

template <bool VEC, int V>
int launch_reduce(const void* splits, int n_split, const void* partial, void* y, int d,
                  cudaStream_t st) {
    const dim3 grid((n_split + WARPS - 1) / WARPS, (d + GROUP * V - 1) / (GROUP * V));
    spmm_coo_csr_reduce_kernel<VEC, V><<<grid, THREADS, 0, st>>>(
        (const int4*)splits, n_split, (const float*)partial, (float*)y, d);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Main pass: y[N, d] f32 for the rows that are one chunk, f32 partials[n_parts, d]
// for the chunks of split rows.  vec: d % 4 == 0 and x 16-byte aligned.
int spmm_coo_csr(const void* col, const void* eid, const void* weight, const void* work,
                 int n_items, const void* x, void* y, void* partial, int d, int vec,
                 void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const bool wide = d > GROUP;
    if (vec)
        return wide ? launch<true, 2>(col, eid, weight, work, n_items, x, y, partial, d, st)
                    : launch<true, 1>(col, eid, weight, work, n_items, x, y, partial, d, st);
    return wide ? launch<false, 2>(col, eid, weight, work, n_items, x, y, partial, d, st)
                : launch<false, 1>(col, eid, weight, work, n_items, x, y, partial, d, st);
}

// Second pass: the rows of the n_split split rows, summed from their partials in
// chunk order.
int spmm_coo_csr_reduce(const void* splits, int n_split, const void* partial, void* y, int d,
                        int vec, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const bool wide = d > GROUP;
    if (vec)
        return wide ? launch_reduce<true, 2>(splits, n_split, partial, y, d, st)
                    : launch_reduce<true, 1>(splits, n_split, partial, y, d, st);
    return wide ? launch_reduce<false, 2>(splits, n_split, partial, y, d, st)
                : launch_reduce<false, 1>(splits, n_split, partial, y, d, st);
}

}  // extern "C"
