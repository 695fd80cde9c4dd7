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

#include <cuda_runtime.h>
#include <math.h>
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


// ---------------------------------------------------------------------------
// GAT edge attention

constexpr int MAX_HEADS = 8;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// a butterfly: partners add the same two numbers, so every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
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
                const int src = __shfl_sync(FULL, my_c, j0 + t);
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
                const int src = __shfl_sync(FULL, my_i, j0 + t);
                if (j0 + t < n) {
#pragma unroll
                    for (int k = 0; k < NV; ++k)
                        load_cols<W>(g, (size_t)src, W * (lane + 32 * k), d, v[t][k]);
                }
            }
#pragma unroll
            for (int t = 0; t < U; ++t) {
                const int e_t = __shfl_sync(FULL, my_e, j0 + t);
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
