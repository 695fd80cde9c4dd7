// y = A @ x over a CSR of the COO edge list, for Hopper (sm_90a).  Plain C
// interface, loaded with ctypes by tpugraph_torch/ops/coo_kernels.py, which checks
// every argument first.
//
// Replaces no Pallas kernel: the JAX package computes the COO product with XLA's
// gather and segment_sum (tpugraph/ops/message.py:22), which the port first ran as
// index_select, a multiply and an atomic index_add_ (ops/message.py:spmm).  That
// wrote an E x D message tensor, read it back twice and summed with atomics.
//
// spmm_coo_csr and spmm_coo_csr_reduce are the row walk of row_spmm.cuh (f32 compute
// and output) over the CSR that ops/coo_kernels.py:edge_csr builds once a job: col the
// sender (A) or receiver (A^T) of each sorted edge, eid its index in the edge list, so
// static weights and weights that carry a gradient take the same kernel.
// row_spmm.cuh states the layout, the semantics, the bound and the design.
//
// GAT edge attention (gat_attn_*) walks the same work lists.  It replaces no Pallas
// kernel: the JAX package's attention (GraphConv(att=True)) multiplies unnormalised
// scores into the edge weights, and nothing there normalises over a row's edges.
// For receiver i, head h, over its in-edges j (self-loop included):
//   e_ij = LeakyReLU(el[j, h] + er[i, h]),  alpha_ij = softmax_j e_ij,
//   y[i, h F .. h F + F) = sum_j alpha_ij z[j, h F .. h F + F).
//   gat_attn_fwd: a warp a work item of A (rows receivers); lanes own 32 edges at a
//   time, compute their scores for every head, and the warp takes each head's
//   maximum and sum of exp(e - m) by butterfly shuffles (every lane ends with the
//   same bits), rescaling its running sums when the maximum grows (an online
//   softmax, 32 edges a step); then the 32 z rows are gathered and added with each
//   edge's weight, a lane owning 2 columns of each 64-column slot (1 where a head's
//   width is odd).  Writes y and lse = m + log(sum) per row and head, or for a
//   chunk of a split row its (m, sum, unnormalised sums), which gat_attn_fwd_reduce
//   merges in chunk order.  Bound: bytes, the E x D x 4 gather of z (7.5 GB at the
//   arxiv stand-in's 2.5M attended edges and D = 750), as spmm_coo_csr.
//   gat_attn_bwd: a warp a work item of A^T (rows senders j), z[j] held in
//   registers; for each out-edge to i it recomputes alpha_ij from lse[i], gathers
//   g[i], takes <g_i, z_j> by head (a warp sum), and accumulates dz_j += alpha g_i
//   and d el_j += ds_ij = alpha (<g_i, z_j> - t_i) LeakyReLU', with
//   t_i = <g_i, y_i> computed by the wrapper, so the softmax's backward needs no
//   pass of its own over the rows; it writes ds_ij by edge id (E x H floats).
//   gat_attn_dst_sum: d er_i = sum_j ds_ij, a warp a row of A, a fixed order.
//   Split rows as in the product: partials, then a reduce pass in chunk order; no
//   atomics, so every launch gives the same bits.

#include <math.h>

#include "row_spmm.cuh"

namespace {

using row_spmm::FULL_MASK;
using row_spmm::THREADS;
using row_spmm::WARPS;

template <bool VEC, int V>
__global__ void __launch_bounds__(THREADS)
spmm_coo_csr_kernel(const int32_t* __restrict__ col, const int32_t* __restrict__ eid,
                    const float* __restrict__ weight, const int4* __restrict__ work,
                    int n_items, const float* __restrict__ x, float* __restrict__ y,
                    float* __restrict__ partial, int d) {
    row_spmm::walk<false, false, VEC, V, row_spmm::FULL>(col, eid, weight, work, n_items, x,
                                                          y, partial, d);
}

template <bool VEC, int V>
__global__ void __launch_bounds__(THREADS)
spmm_coo_csr_reduce_kernel(const int4* __restrict__ splits, int n_split,
                           const float* __restrict__ partial, float* __restrict__ y, int d) {
    row_spmm::reduce<false, VEC, V>(splits, n_split, partial, y, d);
}

// ---------------------------------------------------------------------------
// GAT edge attention

constexpr int MAX_HEADS = 8;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
    return v;
}

// a butterfly: partners add the same two numbers, so every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    return v;
}

__device__ __forceinline__ float leaky(float x, float slope) { return x > 0.f ? x : x * slope; }

// a lane's W columns c, c + W - 1 of `row` (W = 2: one 8-byte load); zero past d
template <int W>
__device__ __forceinline__ void load_cols(const float* __restrict__ src, size_t row, int c,
                                          int d, float v[W]) {
    if (W == 2) {
        if (c < d) {
            const float2 t = __ldg((const float2*)(src + row * d + c));
            v[0] = t.x, v[W - 1] = t.y;
        } else {
            v[0] = v[W - 1] = 0.f;
        }
    } else {
        v[0] = c < d ? __ldg(src + row * d + c) : 0.f;
    }
}

template <int W>
__device__ __forceinline__ void store_cols(float* __restrict__ dst, size_t row, int c, int d,
                                           const float v[W]) {
    if (c >= d) return;
    if (W == 2)
        *(float2*)(dst + row * d + c) = make_float2(v[0], v[W - 1]);
    else
        dst[row * d + c] = v[0];
}

template <bool PAIR, int NV>
__global__ void __launch_bounds__(THREADS)
gat_attn_fwd_kernel(const int32_t* __restrict__ col, const int4* __restrict__ work, int n_items,
                    const float* __restrict__ z, const float* __restrict__ el,
                    const float* __restrict__ er, float* __restrict__ y,
                    float* __restrict__ lse, float* __restrict__ part_acc,
                    float* __restrict__ part_ms, int d, int f, int heads, float slope) {
    constexpr int W = PAIR ? 2 : 1;                        // columns a slot
    constexpr int U = NV >= 8 ? 2 : (NV >= 4 ? 4 : 8);     // z rows in flight together
    __shared__ float pw[WARPS][32][MAX_HEADS];  // each edge's exp(e - m), by head
    __shared__ float hv[WARPS][MAX_HEADS];      // a per-head value the warp shares
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int item = blockIdx.x * WARPS + warp;
    if (item >= n_items) return;                           // the whole warp
    const int4 it = work[item];
    const int c0 = blockIdx.y * 32 * W * NV;
    int hd[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        const int c = c0 + W * (lane + 32 * k);
        hd[k] = c < d ? c / f : 0;
    }
    float er_i[MAX_HEADS], m[MAX_HEADS], s[MAX_HEADS];
#pragma unroll
    for (int h = 0; h < MAX_HEADS; ++h) {
        er_i[h] = h < heads ? er[(size_t)it.x * heads + h] : 0.f;
        m[h] = -INFINITY;
        s[h] = 0.f;
    }
    float acc[NV][W];
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[k][w] = 0.f;

    for (int base = it.y; base < it.z; base += 32) {
        const int kk = base + lane;
        const bool ok = kk < it.z;
        const int my_c = ok ? col[kk] : 0;
        const int n = min(32, it.z - base);                // warp-uniform
        bool grew = false;                                 // warp-uniform
#pragma unroll
        for (int h = 0; h < MAX_HEADS; ++h) {
            if (h < heads) {
                const float e = ok ? leaky(el[(size_t)my_c * heads + h] + er_i[h], slope)
                                   : -INFINITY;
                const float mn = fmaxf(m[h], warp_max(e));
                const float scale = expf(m[h] - mn);       // 0 on the first step
                const float p = ok ? expf(e - mn) : 0.f;
                s[h] = s[h] * scale + warp_sum(p);
                grew = grew || scale != 1.f;
                m[h] = mn;
                pw[warp][lane][h] = p;
                if (lane == 0) hv[warp][h] = scale;
            }
        }
        __syncwarp();
        if (base != it.y && grew) {
#pragma unroll
            for (int k = 0; k < NV; ++k) {
                const float sc = hv[warp][hd[k]];
#pragma unroll
                for (int w = 0; w < W; ++w) acc[k][w] *= sc;
            }
        }
        for (int j0 = 0; j0 < n; j0 += U) {               // j0 + t <= 31: U divides 32
            float v[U][NV][W];
#pragma unroll
            for (int t = 0; t < U; ++t) {
                const int src = __shfl_sync(FULL_MASK, my_c, j0 + t);
                if (j0 + t < n) {
#pragma unroll
                    for (int k = 0; k < NV; ++k)
                        load_cols<W>(z, (size_t)src, c0 + W * (lane + 32 * k), d, v[t][k]);
                }
            }
#pragma unroll
            for (int t = 0; t < U; ++t) {
                if (j0 + t < n) {
#pragma unroll
                    for (int k = 0; k < NV; ++k) {
                        const float p = pw[warp][j0 + t][hd[k]];
#pragma unroll
                        for (int w = 0; w < W; ++w) acc[k][w] = fmaf(p, v[t][k][w], acc[k][w]);
                    }
                }
            }
        }
        __syncwarp();                                      // pw and hv are rewritten
    }
    if (it.w < 0) {                                        // a row that is one chunk
        if (lane == 0) {
#pragma unroll
            for (int h = 0; h < MAX_HEADS; ++h)
                if (h < heads) hv[warp][h] = s[h];
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            const float sh = hv[warp][hd[k]];
            float o[W];
#pragma unroll
            for (int w = 0; w < W; ++w) o[w] = sh > 0.f ? acc[k][w] / sh : 0.f;
            store_cols<W>(y, (size_t)it.x, c0 + W * (lane + 32 * k), d, o);
        }
        if (blockIdx.y == 0) {
#pragma unroll
            for (int h = 0; h < MAX_HEADS; ++h)
                if (h < heads && lane == h)
                    lse[(size_t)it.x * heads + h] = s[h] > 0.f ? m[h] + logf(s[h]) : INFINITY;
        }
    } else {                                               // a chunk of a split row
#pragma unroll
        for (int k = 0; k < NV; ++k)
            store_cols<W>(part_acc, (size_t)it.w, c0 + W * (lane + 32 * k), d, acc[k]);
        if (blockIdx.y == 0) {
#pragma unroll
            for (int h = 0; h < MAX_HEADS; ++h) {
                if (h < heads && lane == h) {
                    part_ms[(size_t)it.w * 2 * heads + h] = m[h];
                    part_ms[(size_t)it.w * 2 * heads + heads + h] = s[h];
                }
            }
        }
    }
}

// the split rows: each one's chunks merged in chunk order by their maxima
__global__ void __launch_bounds__(THREADS)
gat_attn_fwd_reduce_kernel(const int4* __restrict__ splits, int n_split,
                           const float* __restrict__ part_acc,
                           const float* __restrict__ part_ms, float* __restrict__ y,
                           float* __restrict__ lse, int d, int f, int heads) {
    const int lane = threadIdx.x & 31;
    const int sidx = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (sidx >= n_split) return;
    const int4 sp = splits[sidx];
    const int w2 = 2 * heads;
    for (int h = lane; h < heads; h += 32) {
        float big = -INFINITY, tot = 0.f;
        for (int i = 0; i < sp.z; ++i) big = fmaxf(big, part_ms[(size_t)(sp.y + i) * w2 + h]);
        for (int i = 0; i < sp.z; ++i) {
            const size_t r = (size_t)(sp.y + i) * w2;
            tot += part_ms[r + heads + h] * expf(part_ms[r + h] - big);
        }
        lse[(size_t)sp.x * heads + h] = tot > 0.f ? big + logf(tot) : INFINITY;
    }
    for (int c = lane; c < d; c += 32) {
        const int h = c / f;
        float big = -INFINITY, tot = 0.f, a = 0.f;
        for (int i = 0; i < sp.z; ++i) big = fmaxf(big, part_ms[(size_t)(sp.y + i) * w2 + h]);
        for (int i = 0; i < sp.z; ++i) {
            const size_t r = (size_t)(sp.y + i);
            const float coef = expf(part_ms[r * w2 + h] - big);
            tot += part_ms[r * w2 + heads + h] * coef;
            a = fmaf(part_acc[r * d + c], coef, a);
        }
        y[(size_t)sp.x * d + c] = tot > 0.f ? a / tot : 0.f;
    }
}

template <bool PAIR, int NV>
__global__ void __launch_bounds__(THREADS)
gat_attn_bwd_kernel(const int32_t* __restrict__ col, const int32_t* __restrict__ eid,
                    const int4* __restrict__ work, int n_items, const float* __restrict__ z,
                    const float* __restrict__ g, const float* __restrict__ el,
                    const float* __restrict__ er, const float* __restrict__ lse,
                    const float* __restrict__ tg, float* __restrict__ dz,
                    float* __restrict__ d_el, float* __restrict__ de,
                    float* __restrict__ part_dz, float* __restrict__ part_del, int d, int f,
                    int heads, float slope) {
    constexpr int W = PAIR ? 2 : 1;
    constexpr int U = NV >= 8 ? 2 : (NV >= 4 ? 4 : 8);
    __shared__ float aw[WARPS][32][MAX_HEADS];  // alpha_ij of each edge, by head
    __shared__ float tw[WARPS][32][MAX_HEADS];  // t_i
    __shared__ float kw[WARPS][32][MAX_HEADS];  // LeakyReLU'(el_j + er_i)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int item = blockIdx.x * WARPS + warp;
    if (item >= n_items) return;
    const int4 it = work[item];
    int hd[NV];
    float zj[NV][W], acc[NV][W];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        const int c = W * (lane + 32 * k);
        hd[k] = c < d ? c / f : 0;
        load_cols<W>(z, (size_t)it.x, c, d, zj[k]);
#pragma unroll
        for (int w = 0; w < W; ++w) acc[k][w] = 0.f;
    }
    float el_j[MAX_HEADS], dl[MAX_HEADS];
#pragma unroll
    for (int h = 0; h < MAX_HEADS; ++h) {
        el_j[h] = h < heads ? el[(size_t)it.x * heads + h] : 0.f;
        dl[h] = 0.f;
    }
    for (int base = it.y; base < it.z; base += 32) {
        const int kk = base + lane;
        const bool ok = kk < it.z;
        const int my_i = ok ? col[kk] : 0;
        const int my_e = ok ? eid[kk] : 0;
        const int n = min(32, it.z - base);
#pragma unroll
        for (int h = 0; h < MAX_HEADS; ++h) {
            if (h < heads) {
                float a = 0.f, tv = 0.f, kv = 0.f;
                if (ok) {
                    const size_t r = (size_t)my_i * heads + h;
                    const float sc = el_j[h] + er[r];
                    a = expf(leaky(sc, slope) - lse[r]);
                    tv = tg[r];
                    kv = sc > 0.f ? 1.f : slope;
                }
                aw[warp][lane][h] = a;
                tw[warp][lane][h] = tv;
                kw[warp][lane][h] = kv;
            }
        }
        __syncwarp();
        for (int j0 = 0; j0 < n; j0 += U) {
            float v[U][NV][W];
#pragma unroll
            for (int t = 0; t < U; ++t) {
                const int src = __shfl_sync(FULL_MASK, my_i, j0 + t);
                if (j0 + t < n) {
#pragma unroll
                    for (int k = 0; k < NV; ++k)
                        load_cols<W>(g, (size_t)src, W * (lane + 32 * k), d, v[t][k]);
                }
            }
#pragma unroll
            for (int t = 0; t < U; ++t) {
                const int e_t = __shfl_sync(FULL_MASK, my_e, j0 + t);
                if (j0 + t < n) {
                    const int te = j0 + t;
#pragma unroll
                    for (int h = 0; h < MAX_HEADS; ++h) {
                        if (h < heads) {
                            float q = 0.f;
#pragma unroll
                            for (int k = 0; k < NV; ++k)
                                if (hd[k] == h)
#pragma unroll
                                    for (int w = 0; w < W; ++w) q = fmaf(zj[k][w], v[t][k][w], q);
                            q = warp_sum(q);
                            const float ds = aw[warp][te][h] * (q - tw[warp][te][h]) * kw[warp][te][h];
                            dl[h] += ds;
                            if (lane == h) de[(size_t)e_t * heads + h] = ds;
                        }
                    }
#pragma unroll
                    for (int k = 0; k < NV; ++k) {
                        const float a = aw[warp][te][hd[k]];
#pragma unroll
                        for (int w = 0; w < W; ++w) acc[k][w] = fmaf(a, v[t][k][w], acc[k][w]);
                    }
                }
            }
        }
        __syncwarp();
    }
    const bool direct = it.w < 0;
    float* dst = direct ? dz : part_dz;
    const size_t row = direct ? (size_t)it.x : (size_t)it.w;
#pragma unroll
    for (int k = 0; k < NV; ++k) store_cols<W>(dst, row, W * (lane + 32 * k), d, acc[k]);
    float* dldst = direct ? d_el : part_del;
#pragma unroll
    for (int h = 0; h < MAX_HEADS; ++h)
        if (h < heads && lane == h) dldst[row * heads + h] = dl[h];
}

// the split rows: each one's partial dz and d el summed in chunk order
__global__ void __launch_bounds__(THREADS)
gat_attn_bwd_reduce_kernel(const int4* __restrict__ splits, int n_split,
                           const float* __restrict__ part_dz, const float* __restrict__ part_del,
                           float* __restrict__ dz, float* __restrict__ d_el, int d, int heads) {
    const int lane = threadIdx.x & 31;
    const int sidx = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (sidx >= n_split) return;
    const int4 sp = splits[sidx];
    for (int c = lane; c < d; c += 32) {
        float a = part_dz[(size_t)sp.y * d + c];
        for (int i = 1; i < sp.z; ++i) a += part_dz[(size_t)(sp.y + i) * d + c];
        dz[(size_t)sp.x * d + c] = a;
    }
    for (int h = lane; h < heads; h += 32) {
        float a = part_del[(size_t)sp.y * heads + h];
        for (int i = 1; i < sp.z; ++i) a += part_del[(size_t)(sp.y + i) * heads + h];
        d_el[(size_t)sp.x * heads + h] = a;
    }
}

// d er[i] = sum of de over row i of A: a warp a row, lanes strided, a butterfly sum
__global__ void __launch_bounds__(THREADS)
gat_attn_dst_sum_kernel(const int32_t* __restrict__ rowptr, const int32_t* __restrict__ eid,
                        int n, const float* __restrict__ de, float* __restrict__ der,
                        int heads) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (row >= n) return;
    const int lo = rowptr[row], hi = rowptr[row + 1];
    float a[MAX_HEADS];
#pragma unroll
    for (int h = 0; h < MAX_HEADS; ++h) a[h] = 0.f;
    for (int k = lo + lane; k < hi; k += 32) {
        const size_t e = (size_t)eid[k] * heads;
#pragma unroll
        for (int h = 0; h < MAX_HEADS; ++h)
            if (h < heads) a[h] += de[e + h];
    }
#pragma unroll
    for (int h = 0; h < MAX_HEADS; ++h) {
        if (h < heads) {
            const float v = warp_sum(a[h]);
            if (lane == h) der[(size_t)row * heads + h] = v;
        }
    }
}

template <bool PAIR, int NV>
int launch_gat_fwd(const void* col, const void* work, int n_items, const void* z,
                   const void* el, const void* er, void* y, void* lse, void* part_acc,
                   void* part_ms, int d, int f, int heads, float slope, cudaStream_t st) {
    constexpr int CB = 32 * (PAIR ? 2 : 1) * NV;
    const dim3 grid((n_items + WARPS - 1) / WARPS, (d + CB - 1) / CB);
    gat_attn_fwd_kernel<PAIR, NV><<<grid, THREADS, 0, st>>>(
        (const int32_t*)col, (const int4*)work, n_items, (const float*)z, (const float*)el,
        (const float*)er, (float*)y, (float*)lse, (float*)part_acc, (float*)part_ms, d, f,
        heads, slope);
    return (int)cudaGetLastError();
}

template <bool PAIR, int NV>
int launch_gat_bwd(const void* col, const void* eid, const void* work, int n_items,
                   const void* z, const void* g, const void* el, const void* er,
                   const void* lse, const void* t, void* dz, void* d_el, void* de,
                   void* part_dz, void* part_del, int d, int f, int heads, float slope,
                   cudaStream_t st) {
    const dim3 grid((n_items + WARPS - 1) / WARPS);
    gat_attn_bwd_kernel<PAIR, NV><<<grid, THREADS, 0, st>>>(
        (const int32_t*)col, (const int32_t*)eid, (const int4*)work, n_items, (const float*)z,
        (const float*)g, (const float*)el, (const float*)er, (const float*)lse,
        (const float*)t, (float*)dz, (float*)d_el, (float*)de, (float*)part_dz,
        (float*)part_del, d, f, heads, slope);
    return (int)cudaGetLastError();
}

#define GAT_SLOTS(X, PAIR) \
    X(PAIR, 1) X(PAIR, 2) X(PAIR, 4) X(PAIR, 8) X(PAIR, 12) X(PAIR, 16)

}  // namespace

extern "C" {

// Main pass: y[N, d] f32 for the rows that are one chunk, f32 partials[n_parts, d]
// for the chunks of split rows.  vec: d % 4 == 0 and x 16-byte aligned.
int spmm_coo_csr(const void* col, const void* eid, const void* weight, const void* work,
                 int n_items, const void* x, void* y, void* partial, int d, int vec,
                 void* stream) {
    return row_spmm::with_flag(vec, [&](auto ve) {
        constexpr bool VE = decltype(ve)::value;
        return row_spmm::launch_rows(spmm_coo_csr_kernel<VE, 1>, spmm_coo_csr_kernel<VE, 2>,
                                     n_items, d, (cudaStream_t)stream, (const int32_t*)col,
                                     (const int32_t*)eid, (const float*)weight,
                                     (const int4*)work, n_items, (const float*)x, (float*)y,
                                     (float*)partial, d);
    });
}

// Second pass: the rows of the n_split split rows, summed from their partials in
// chunk order.
int spmm_coo_csr_reduce(const void* splits, int n_split, const void* partial, void* y, int d,
                        int vec, void* stream) {
    return row_spmm::with_flag(vec, [&](auto ve) {
        constexpr bool VE = decltype(ve)::value;
        return row_spmm::launch_rows(spmm_coo_csr_reduce_kernel<VE, 1>,
                                     spmm_coo_csr_reduce_kernel<VE, 2>, n_split, d,
                                     (cudaStream_t)stream, (const int4*)splits, n_split,
                                     (const float*)partial, (float*)y, d);
    });
}

// GAT attention, forward: y[N, d] and lse[N, heads] for the rows that are one chunk,
// (m, sum) and unnormalised sums as partials for the chunks of split rows.  pair: 2
// columns a slot (f even, z 8-byte aligned); nv: slots a lane (1, 2, 4, 8, 12, 16),
// the wrapper's choice from d; columns past 32 (1 + pair) nv go to grid.y.
int gat_attn_fwd(const void* col, const void* work, int n_items, const void* z, const void* el,
                 const void* er, void* y, void* lse, void* part_acc, void* part_ms, int d,
                 int f, int heads, float slope, int pair, int nv, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
#define GAT_FWD(P, V)                                                                      \
    if ((pair != 0) == P && nv == V)                                                            \
        return launch_gat_fwd<P, V>(col, work, n_items, z, el, er, y, lse, part_acc,       \
                                    part_ms, d, f, heads, slope, st);
    GAT_SLOTS(GAT_FWD, true)
    GAT_SLOTS(GAT_FWD, false)
#undef GAT_FWD
    return (int)cudaErrorInvalidValue;
}

int gat_attn_fwd_reduce(const void* splits, int n_split, const void* part_acc,
                        const void* part_ms, void* y, void* lse, int d, int f, int heads,
                        void* stream) {
    gat_attn_fwd_reduce_kernel<<<(n_split + WARPS - 1) / WARPS, THREADS, 0,
                                 (cudaStream_t)stream>>>(
        (const int4*)splits, n_split, (const float*)part_acc, (const float*)part_ms,
        (float*)y, (float*)lse, d, f, heads);
    return (int)cudaGetLastError();
}

// GAT attention, backward over A^T: dz[N, d] and d_el[N, heads] for the rows that are
// one chunk (partials for split rows), de[E, heads] by edge id.  The whole row lies in
// one warp (the dots need every column of a head): d <= 32 (1 + pair) nv.
int gat_attn_bwd(const void* col, const void* eid, const void* work, int n_items,
                 const void* z, const void* g, const void* el, const void* er,
                 const void* lse, const void* t, void* dz, void* d_el, void* de,
                 void* part_dz, void* part_del, int d, int f, int heads, float slope,
                 int pair, int nv, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (d > 32 * (1 + pair) * nv) return (int)cudaErrorInvalidValue;
#define GAT_BWD(P, V)                                                                      \
    if ((pair != 0) == P && nv == V)                                                            \
        return launch_gat_bwd<P, V>(col, eid, work, n_items, z, g, el, er, lse, t, dz,     \
                                    d_el, de, part_dz, part_del, d, f, heads, slope, st);
    GAT_SLOTS(GAT_BWD, true)
    GAT_SLOTS(GAT_BWD, false)
#undef GAT_BWD
    return (int)cudaErrorInvalidValue;
}

int gat_attn_bwd_reduce(const void* splits, int n_split, const void* part_dz,
                        const void* part_del, void* dz, void* d_el, int d, int heads,
                        void* stream) {
    gat_attn_bwd_reduce_kernel<<<(n_split + WARPS - 1) / WARPS, THREADS, 0,
                                 (cudaStream_t)stream>>>(
        (const int4*)splits, n_split, (const float*)part_dz, (const float*)part_del,
        (float*)dz, (float*)d_el, d, heads);
    return (int)cudaGetLastError();
}

int gat_attn_dst_sum(const void* rowptr, const void* eid, int n, const void* de, void* der,
                     int heads, void* stream) {
    gat_attn_dst_sum_kernel<<<(n + WARPS - 1) / WARPS, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rowptr, (const int32_t*)eid, n, (const float*)de, (float*)der, heads);
    return (int)cudaGetLastError();
}

}  // extern "C"
