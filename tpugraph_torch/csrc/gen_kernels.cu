// GENConv's softmax aggregation (DeeperGCN, arXiv:2006.07739, "softmax_sg") over a CSR
// of the COO edge list, for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// tpugraph_torch/ops/gen_kernels.py, which checks every argument first.
//
// Replaces no Pallas kernel: the JAX package has no GENConv, and nothing there takes a
// softmax over a row's edges channel by channel.  For receiver v, channel c, over its
// in-edges u (ops/csr.py's work list of A, rows receivers; the adjacency carries one
// self-loop a node):
//   mu_u,c = ReLU(x_u,c) + eps,   w_uv,c = softmax_u (t mu_u,c),   m_v,c = sum_u w_uv,c mu_u,c
// with the weights under no_grad, so the backward (rows of A^T, senders u) is
//   dx_u,c = [x_u,c > 0] sum_v exp(t mu_u,c - lse_v,c) g_v,c,   lse_v,c = log sum_u exp(t mu_u,c).
//
//   gen_aggr_fwd: a warp a work item of A.  Each lane owns 4 channels of each
//   128-channel group (row_spmm.cuh's load4: one 16-byte load of a sender's x row, or 4
//   scalar loads when d % 4 != 0 or x is not 16-byte aligned), forms mu in registers and
//   keeps each channel's running maximum, sum of exp(s - max) and weighted sum of mu (an
//   online softmax, one exp an edge and channel: exp(-|s - max|) serves both branches).
//   Every row is normalised by its own maximum, as the published scatter_softmax is, so
//   no weight underflows whatever t and x are.  Writes m and lse = max + log(sum), or for
//   a chunk of a split row its (max, sum, weighted sum), which gen_aggr_fwd_reduce merges
//   in chunk order.  An empty row writes m = 0 and lse = +inf.
//   gen_aggr_bwd: a warp a work item of A^T.  The lane's channels of x_u and s_u = t mu_u
//   stay in registers; for each out-edge to v it gathers g_v and lse_v (two rows of d
//   floats) and adds exp(s_u - lse_v) g_v (at most g_v: s_u <= lse_v), then writes dx_u
//   with the ReLU's mask, or a chunk's masked partial, which gen_aggr_bwd_reduce (the row
//   walk's own reduce) adds in chunk order.
//   No shared memory and no atomics: every launch gives the same bits.
//
// Bound on the H100: bytes.  Operations are about 10 an edge and channel (and one exp);
// the least bytes read x (forward; x, g and lse backward) once, the indices once and
// write the outputs once: 0.25 GB forward and 0.35 GB backward at the ogbn-arxiv
// stand-in's 2,501,829 attended edges and d = 128.  The practical floor is the gather,
// E d 4 bytes a row read (1.28 GB forward, 2.56 GB backward there), partly from the
// 50 MB L2, where a power-law graph's hub rows stay.

#include <math.h>

#include "row_spmm.cuh"

namespace {

using row_spmm::FULL_MASK;
using row_spmm::GROUP;
using row_spmm::THREADS;
using row_spmm::WARPS;
using row_spmm::load4;
using row_spmm::store4;

// one sender's value xv into a channel's (maximum, sum, weighted sum)
__device__ __forceinline__ void online(float xv, float t, float eps, float& mx, float& sm,
                                       float& ac) {
    const float mu = fmaxf(xv, 0.f) + eps;
    const float s = t * mu;
    const float e = expf(-fabsf(s - mx));  // 0 on the first edge (mx = -inf)
    if (s > mx) {
        sm = fmaf(sm, e, 1.f);
        ac = fmaf(ac, e, mu);
        mx = s;
    } else {
        sm += e;
        ac = fmaf(e, mu, ac);
    }
}

template <bool VEC, int V>
__global__ void __launch_bounds__(THREADS)
gen_aggr_fwd_kernel(const int32_t* __restrict__ col, const int4* __restrict__ work,
                    int n_items, const float* __restrict__ x, float* __restrict__ m,
                    float* __restrict__ lse, float* __restrict__ partial, int n_parts, int d,
                    float t, float eps) {
    constexpr int U = 8 / V;                      // x rows in flight together
    const int lane = threadIdx.x & 31;
    const int item = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (item >= n_items) return;                  // the whole warp
    const int4 it = work[item];
    const int c0 = blockIdx.y * GROUP * V;
    float mx[V][4], sm[V][4], ac[V][4];
#pragma unroll
    for (int g = 0; g < V; ++g)
#pragma unroll
        for (int q = 0; q < 4; ++q) mx[g][q] = -INFINITY, sm[g][q] = 0.f, ac[g][q] = 0.f;

    for (int base = it.y; base < it.z; base += 32) {
        const int k = base + lane;
        const int my_c = k < it.z ? col[k] : 0;
        const int n = min(32, it.z - base);       // warp-uniform
        for (int j0 = 0; j0 < n; j0 += U) {       // j0 + u <= 31: U divides 32
            float v[U][V][4];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int s = __shfl_sync(FULL_MASK, my_c, j0 + u);
                if (j0 + u < n) {
#pragma unroll
                    for (int g = 0; g < V; ++g)
                        load4<false, VEC>(x, (size_t)s, c0 + g * GROUP, lane, d, v[u][g]);
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (j0 + u < n) {
#pragma unroll
                    for (int g = 0; g < V; ++g)
#pragma unroll
                        for (int q = 0; q < 4; ++q)
                            online(v[u][g][q], t, eps, mx[g][q], sm[g][q], ac[g][q]);
                }
            }
        }
    }
    if (it.w < 0) {                               // a row that is one chunk
#pragma unroll
        for (int g = 0; g < V; ++g) {
            float o[4], l[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                o[q] = sm[g][q] > 0.f ? ac[g][q] / sm[g][q] : 0.f;
                l[q] = sm[g][q] > 0.f ? mx[g][q] + logf(sm[g][q]) : INFINITY;
            }
            store4<false, VEC>(m, (size_t)it.x, c0 + g * GROUP, lane, d, o);
            store4<false, VEC>(lse, (size_t)it.x, c0 + g * GROUP, lane, d, l);
        }
        return;
    }
    // a chunk of a split row: partial planes (max, sum, weighted sum), n_parts rows each
    const size_t plane = (size_t)n_parts * d;
#pragma unroll
    for (int g = 0; g < V; ++g) {
        store4<false, VEC>(partial, (size_t)it.w, c0 + g * GROUP, lane, d, mx[g]);
        store4<false, VEC>(partial + plane, (size_t)it.w, c0 + g * GROUP, lane, d, sm[g]);
        store4<false, VEC>(partial + 2 * plane, (size_t)it.w, c0 + g * GROUP, lane, d, ac[g]);
    }
}

// the split rows: each one's chunks merged in chunk order by their maxima
template <bool VEC, int V>
__global__ void __launch_bounds__(THREADS)
gen_aggr_fwd_reduce_kernel(const int4* __restrict__ splits, int n_split,
                           const float* __restrict__ partial, int n_parts,
                           float* __restrict__ m, float* __restrict__ lse, int d) {
    const int lane = threadIdx.x & 31;
    const int si = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (si >= n_split) return;
    const int4 sp = splits[si];
    const int c0 = blockIdx.y * GROUP * V;
    const size_t plane = (size_t)n_parts * d;
#pragma unroll
    for (int g = 0; g < V; ++g) {
        const int cg = c0 + g * GROUP;
        float big[4], v[4];
        load4<false, VEC>(partial, (size_t)sp.y, cg, lane, d, big);
        for (int i = 1; i < sp.z; ++i) {
            load4<false, VEC>(partial, (size_t)(sp.y + i), cg, lane, d, v);
#pragma unroll
            for (int q = 0; q < 4; ++q) big[q] = fmaxf(big[q], v[q]);
        }
        float tot[4] = {0.f, 0.f, 0.f, 0.f}, acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int i = 0; i < sp.z; ++i) {
            float mi[4], si4[4], ai[4];
            load4<false, VEC>(partial, (size_t)(sp.y + i), cg, lane, d, mi);
            load4<false, VEC>(partial + plane, (size_t)(sp.y + i), cg, lane, d, si4);
            load4<false, VEC>(partial + 2 * plane, (size_t)(sp.y + i), cg, lane, d, ai);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float coef = expf(mi[q] - big[q]);
                tot[q] = fmaf(si4[q], coef, tot[q]);
                acc[q] = fmaf(ai[q], coef, acc[q]);
            }
        }
        float o[4], l[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            o[q] = tot[q] > 0.f ? acc[q] / tot[q] : 0.f;
            l[q] = tot[q] > 0.f ? big[q] + logf(tot[q]) : INFINITY;
        }
        store4<false, VEC>(m, (size_t)sp.x, cg, lane, d, o);
        store4<false, VEC>(lse, (size_t)sp.x, cg, lane, d, l);
    }
}

template <bool VEC, int V>
__global__ void __launch_bounds__(THREADS)
gen_aggr_bwd_kernel(const int32_t* __restrict__ col, const int4* __restrict__ work,
                    int n_items, const float* __restrict__ x, const float* __restrict__ gr,
                    const float* __restrict__ lse, float* __restrict__ dx,
                    float* __restrict__ partial, int d, float t, float eps) {
    constexpr int U = 8 / V;                      // (g, lse) row pairs in flight together
    const int lane = threadIdx.x & 31;
    const int item = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (item >= n_items) return;
    const int4 it = work[item];
    const int c0 = blockIdx.y * GROUP * V;
    float su[V][4], acc[V][4];
    bool live[V][4];
#pragma unroll
    for (int g = 0; g < V; ++g) {
        float xu[4];
        load4<false, VEC>(x, (size_t)it.x, c0 + g * GROUP, lane, d, xu);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            su[g][q] = t * (fmaxf(xu[q], 0.f) + eps);
            live[g][q] = xu[q] > 0.f;
            acc[g][q] = 0.f;
        }
    }
    for (int base = it.y; base < it.z; base += 32) {
        const int k = base + lane;
        const int my_c = k < it.z ? col[k] : 0;
        const int n = min(32, it.z - base);
        for (int j0 = 0; j0 < n; j0 += U) {
            float gv[U][V][4], lv[U][V][4];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int r = __shfl_sync(FULL_MASK, my_c, j0 + u);
                if (j0 + u < n) {
#pragma unroll
                    for (int g = 0; g < V; ++g) {
                        load4<false, VEC>(gr, (size_t)r, c0 + g * GROUP, lane, d, gv[u][g]);
                        load4<false, VEC>(lse, (size_t)r, c0 + g * GROUP, lane, d, lv[u][g]);
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (j0 + u < n) {
#pragma unroll
                    for (int g = 0; g < V; ++g)
#pragma unroll
                        for (int q = 0; q < 4; ++q)
                            acc[g][q] = fmaf(expf(su[g][q] - lv[u][g][q]), gv[u][g][q],
                                             acc[g][q]);
                }
            }
        }
    }
    float* dst = it.w < 0 ? dx : partial;
    const size_t row = it.w < 0 ? (size_t)it.x : (size_t)it.w;
#pragma unroll
    for (int g = 0; g < V; ++g) {
        float o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) o[q] = live[g][q] ? acc[g][q] : 0.f;
        store4<false, VEC>(dst, row, c0 + g * GROUP, lane, d, o);
    }
}

// the split rows of A^T: each one's masked partials added in chunk order
template <bool VEC, int V>
__global__ void __launch_bounds__(THREADS)
gen_aggr_bwd_reduce_kernel(const int4* __restrict__ splits, int n_split,
                           const float* __restrict__ partial, float* __restrict__ dx, int d) {
    row_spmm::reduce<false, VEC, V>(splits, n_split, partial, dx, d);
}

}  // namespace

extern "C" {

// Forward, main pass: m[N, d] and lse[N, d] f32 for the rows that are one chunk;
// partial[3, n_parts, d] (max, sum, weighted sum) for the chunks of split rows.
// vec: d % 4 == 0 and every array 16-byte aligned.
int gen_aggr_fwd(const void* col, const void* work, int n_items, const void* x, void* m,
                 void* lse, void* partial, int n_parts, int d, float t, float eps, int vec,
                 void* stream) {
    return row_spmm::with_flag(vec, [&](auto ve) {
        constexpr bool VE = decltype(ve)::value;
        return row_spmm::launch_rows(gen_aggr_fwd_kernel<VE, 1>, gen_aggr_fwd_kernel<VE, 2>,
                                     n_items, d, (cudaStream_t)stream, (const int32_t*)col,
                                     (const int4*)work, n_items, (const float*)x, (float*)m,
                                     (float*)lse, (float*)partial, n_parts, d, t, eps);
    });
}

// Forward, reduce pass: m and lse of the n_split split rows from their partials.
int gen_aggr_fwd_reduce(const void* splits, int n_split, const void* partial, int n_parts,
                        void* m, void* lse, int d, int vec, void* stream) {
    return row_spmm::with_flag(vec, [&](auto ve) {
        constexpr bool VE = decltype(ve)::value;
        return row_spmm::launch_rows(gen_aggr_fwd_reduce_kernel<VE, 1>,
                                     gen_aggr_fwd_reduce_kernel<VE, 2>, n_split, d,
                                     (cudaStream_t)stream, (const int4*)splits, n_split,
                                     (const float*)partial, n_parts, (float*)m, (float*)lse,
                                     d);
    });
}

// Backward over A^T, main pass: dx[N, d] for the rows that are one chunk, masked
// partial[n_parts, d] for the chunks of split rows.
int gen_aggr_bwd(const void* col, const void* work, int n_items, const void* x,
                 const void* g, const void* lse, void* dx, void* partial, int d, float t,
                 float eps, int vec, void* stream) {
    return row_spmm::with_flag(vec, [&](auto ve) {
        constexpr bool VE = decltype(ve)::value;
        return row_spmm::launch_rows(gen_aggr_bwd_kernel<VE, 1>, gen_aggr_bwd_kernel<VE, 2>,
                                     n_items, d, (cudaStream_t)stream, (const int32_t*)col,
                                     (const int4*)work, n_items, (const float*)x,
                                     (const float*)g, (const float*)lse, (float*)dx,
                                     (float*)partial, d, t, eps);
    });
}

// Backward, reduce pass: dx of the n_split split rows, their partials summed in order.
int gen_aggr_bwd_reduce(const void* splits, int n_split, const void* partial, void* dx,
                        int d, int vec, void* stream) {
    return row_spmm::with_flag(vec, [&](auto ve) {
        constexpr bool VE = decltype(ve)::value;
        return row_spmm::launch_rows(gen_aggr_bwd_reduce_kernel<VE, 1>,
                                     gen_aggr_bwd_reduce_kernel<VE, 2>, n_split, d,
                                     (cudaStream_t)stream, (const int4*)splits, n_split,
                                     (const float*)partial, (float*)dx, d);
    });
}

}  // extern "C"
