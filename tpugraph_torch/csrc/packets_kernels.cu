// SpMM over the edge-packet layout of tpugraph_torch/ops/packets.py, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// tpugraph_torch/ops/packets_kernels.py, which checks every argument first.
//
// Layout: rows/cols int32[P, K] (row within the receiver block, row of x within
// the sender block), w f32[P, K] (0 = dead slot), col_blk int32[P].  The wrapper
// derives a work list from the packets' row_ptr once per EdgePackets:
//   work   int4[n_items]  (receiver block, first packet, end packet, partial slot
//                          or -1 for a block that is one chunk), largest first;
//   splits int4[n_split]  (receiver block, first partial slot, chunks, 0) for each
//                          receiver block cut into several chunks.
//
// spmm_packets replaces tpugraph/ops/pallas_packets.py:spmm_packets
// (_packet_kernel_factory): y[R*Br, D] = A @ x.
//   Semantics: per edge e, g[e] = w[e] * x[col_blk*Bc + cols[e]]; with a bf16
//   compute type w and x are rounded to bf16 first and g is rounded to bf16
//   after the (exact) f32 product, as the TPU kernel stages g at the compute
//   dtype.  y[rows[e]] += g[e] accumulates in f32; a bf16 output is rounded once.
//   With bf16 compute the wrapper hands in x already rounded to bf16 (one cast a
//   call instead of one a gathered entry: the same values, half the bytes).
//   Bound on the H100: bytes (12 bytes of edge data a slot, x and y once) against
//   2*E*D operations.  The practical floor is the gather: each live edge reads a
//   D-wide x row, E*D*itemsize bytes through the 50 MB L2 that holds x (about
//   1.07 GB in f32 and 0.54 GB in bf16 on the 65,536-node power-law graph at
//   D = 128), about 0.1 ms.
//   Design: the TPU kernel turns gather and scatter into one-hot matmuls for its
//   matrix unit; Hopper gathers rows directly.  A degree-sorted power-law graph
//   puts a fifth of its edges in receiver block 0, so one CTA per receiver
//   block leaves that block's CTAs as the kernel's tail.  Instead each receiver
//   block's packet range is cut into chunks of at most 16,384 slots (128 packets
//   of 128), and one CTA owns a (chunk, 64-column slice of D).  It accumulates
//   Br x 64 f32 in shared memory (128 KB at Br = 512, one CTA an SM) with
//   shared-memory atomics, since the rows of a chunk's edges are in no order.
//   A warp takes 32 slots at once: its lanes read the slot data once and shuffle
//   it, and each half-warp takes one edge, each lane 4 columns of the x row with
//   one 16-byte (f32) or 8-byte (bf16) load; the loads of 8 edges are issued
//   before their atomics.  The shared accumulator keeps column c of a row at
//   (c % 4) * 16 + c / 4 and the two half-warps add their 4 values in opposite
//   orders, so the 32 lanes of one atomic hit 32 banks.  A block that is one
//   chunk writes its rows directly (no atomics in device memory).  A chunk of a
//   split block writes its f32 partial to scratch, and spmm_packets_reduce sums
//   a block's partials in chunk order and rounds once: deterministic across
//   chunks, never a bf16 partial, at a cost of (split chunks) x Br x D x 4 bytes
//   written and read again (33 MB on the power-law graph at D = 128, 3% of the
//   f32 gather bytes).  f32 atomics in device memory (red.global.v4.f32 for
//   every edge, into a zeroed buffer) were slower in a trial on the H100: the
//   L2's atomic rate, not its bandwidth, set their time.  Shared-memory f32
//   atomicAdd compiles to a compare-and-swap loop (ATOMS.CAS) on sm_90; w is
//   rounded once a slot and g two values at a time with cvt.rn.bf16x2.f32.  Every output row is written; the f32 order of the
//   shared-memory atomics within a chunk varies from run to run.  Any D: with
//   D % 4 != 0 (D = 10: a 40-byte f32 row pitch) or an x that is not 16-byte
//   aligned, the same kernel takes scalar loads and stores.
//
// spmm_packets_ablation runs the same kernel in a diagnostic mode (the
// counterpart of bench_packets_diag.py's variants), with bf16 compute, f32 output
// and D % 4 == 0: 1 slots_only (slot data read and accumulated, no x gather),
// 2 no_gather (every x read goes to row 0), 3 gather_only (no shared-memory
// accumulation: each lane sums in registers and adds once at the end).
//
// Each entry point launches on the caller's stream and returns cudaGetLastError()
// after its launch, or cudaErrorInvalidValue for an unknown mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 64;       // columns of D per CTA
constexpr int THREADS = 1024;  // 32 warps
constexpr int UNROLL = 4;      // warp steps (2 edges each) whose loads are in flight together
constexpr int RED_ROWS = 8;    // rows of a split block per reduce CTA

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

// columns c..c+3 of x row `row` (bf16 bits when XB16); zero past d
template <bool XB16, bool VEC>
__device__ __forceinline__ void load4(const void* __restrict__ x, size_t row, int c, int d,
                                      float v[4]) {
    if (VEC) {  // d % 4 == 0, so c < d covers c + 3
        if (XB16) {
            const uint2 u = *(const uint2*)((const uint16_t*)x + row * d + c);
            v[0] = bf16_widen(u.x & 0xffffu);
            v[1] = bf16_widen(u.x >> 16);
            v[2] = bf16_widen(u.y & 0xffffu);
            v[3] = bf16_widen(u.y >> 16);
        } else {
            const float4 f = *(const float4*)((const float*)x + row * d + c);
            v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
        }
        return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const size_t i = row * d + c + e;
        v[e] = c + e >= d ? 0.f
             : XB16 ? bf16_widen(((const uint16_t*)x)[i]) : ((const float*)x)[i];
    }
}

// 4 values to columns c..c+3 of row `row` of a [*, d] f32 or bf16 array
template <bool OUT_BF16, bool VEC>
__device__ __forceinline__ void store4(void* __restrict__ y, size_t row, int c, int d,
                                       const float v[4]) {
    const size_t i = row * d + c;
    if (VEC) {
        if (OUT_BF16)
            *(uint2*)((uint16_t*)y + i) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
        else
            *(float4*)((float*)y + i) = make_float4(v[0], v[1], v[2], v[3]);
        return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        if (c + e >= d) break;
        if (OUT_BF16)
            ((uint16_t*)y)[i + e] = (uint16_t)(__float_as_uint(bf16_round(v[e])) >> 16);
        else
            ((float*)y)[i + e] = v[e];
    }
}

template <bool BF16, bool OUT_BF16, bool VEC, int MODE>
__global__ void __launch_bounds__(THREADS)
spmm_packets_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
                    const float* __restrict__ w, const int32_t* __restrict__ col_blk,
                    const int4* __restrict__ work, const void* __restrict__ x,
                    void* __restrict__ y, float* __restrict__ partial, int k, int br,
                    int bc, int d) {
    extern __shared__ float acc[];  // [br][COLS], column c at (c % 4) * 16 + c / 4
    const int4 item = work[blockIdx.x];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int h = lane >> 4;                       // which edge of a warp step
    const int q = lane & 15;                       // this lane's 4 columns: 4q..4q+3
    const int c = blockIdx.y * COLS + 4 * q;
    const bool in = c < d;
    for (int i = threadIdx.x; i < br * COLS; i += THREADS) acc[i] = 0.f;
    __syncthreads();

    float reg[4] = {0.f, 0.f, 0.f, 0.f};           // GATHER_ONLY's register sum
    const int groups = (k + 31) >> 5;              // 32-slot groups a packet
    for (int u = item.y * groups + warp; u < item.z * groups; u += THREADS / 32) {
        const int p = u / groups;
        const int e = (u - p * groups) * 32 + lane;
        const size_t base = (size_t)p * k;
        const bool ok = e < k;
        float my_w = ok ? w[base + e] : 0.f;
        if (BF16) my_w = bf16_round(my_w);         // once a slot, before the shuffles
        const int my_r = ok ? rows[base + e] : 0;
        const int my_c = ok ? cols[base + e] : 0;
        const unsigned live = __ballot_sync(0xffffffffu, my_w != 0.f);
        if (!live) continue;                       // a dead group (warp-uniform)
        const int n = 32 - __clz(live);            // slots up to the last live one
        const size_t xrow = MODE == NO_GATHER ? 0 : (size_t)col_blk[p] * bc;
        for (int s0 = 0; s0 < n; s0 += 2 * UNROLL) {
            float v[UNROLL][4], wt[UNROLL];
            int rt[UNROLL];
#pragma unroll
            for (int t = 0; t < UNROLL; ++t) {     // slot s0 + 2t + h <= 31
                const int j = s0 + 2 * t + h;
                wt[t] = __shfl_sync(0xffffffffu, my_w, j);
                rt[t] = __shfl_sync(0xffffffffu, my_r, j);
                const int cj = __shfl_sync(0xffffffffu, my_c, j);
                if (wt[t] != 0.f && in) {
                    if (MODE == SLOTS_ONLY) {
                        v[t][0] = v[t][1] = v[t][2] = v[t][3] = 1.f;
                    } else {
                        load4<BF16, VEC>(x, xrow + (MODE == NO_GATHER ? 0 : cj), c, d, v[t]);
                    }
                }
            }
#pragma unroll
            for (int t = 0; t < UNROLL; ++t) {
                if (wt[t] == 0.f || !in) continue;  // dead slot, or columns past d
                float g[4];
#pragma unroll
                for (int m = 0; m < 4; m += 2) {
                    if (BF16) {  // exact f32 products, rounded two at a time (cvt.rn.bf16x2)
                        const __nv_bfloat162 b =
                            __floats2bfloat162_rn(wt[t] * v[t][m], wt[t] * v[t][m + 1]);
                        g[m] = __low2float(b);
                        g[m + 1] = __high2float(b);
                    } else {
                        g[m] = wt[t] * v[t][m];
                        g[m + 1] = wt[t] * v[t][m + 1];
                    }
                }
                if (MODE == GATHER_ONLY) {
#pragma unroll
                    for (int m = 0; m < 4; ++m) reg[m] += g[m];
                    continue;
                }
                float* a = acc + rt[t] * COLS + q;
#pragma unroll
                for (int m = 0; m < 4; ++m) {      // half-warp 1 adds in the order 1 0 3 2
                    const float gm = h ? g[m ^ 1] : g[m];
                    atomicAdd(a + 16 * (m ^ h), gm);
                }
            }
        }
    }
    if (MODE == GATHER_ONLY && in) {
        float* a = acc + (warp % br) * COLS + q;
#pragma unroll
        for (int m = 0; m < 4; ++m) atomicAdd(a + 16 * m, reg[m]);
    }
    __syncthreads();

    const bool direct = item.w < 0;
    const size_t row0 = direct ? (size_t)item.x * br : (size_t)item.w * br;
    for (int i = threadIdx.x; i < br * 16; i += THREADS) {
        const int row = i >> 4, qq = i & 15;
        const int cc = blockIdx.y * COLS + 4 * qq;
        if (cc >= d) continue;
        const float* a = acc + row * COLS + qq;
        const float o[4] = {a[0], a[16], a[32], a[48]};
        if (direct)
            store4<OUT_BF16, VEC>(y, row0 + row, cc, d, o);
        else
            store4<false, VEC>(partial, row0 + row, cc, d, o);
    }
}

// y rows of each split block = the sum of its chunks' partials, in chunk order
template <bool OUT_BF16, bool VEC>
__global__ void __launch_bounds__(256)
spmm_packets_reduce_kernel(const int4* __restrict__ splits, const float* __restrict__ partial,
                           void* __restrict__ y, int br, int d) {
    const int4 s = splits[blockIdx.x];
    const int r0 = blockIdx.y * RED_ROWS;
    const int nr = min(RED_ROWS, br - r0);
    const size_t stride = (size_t)br * d;          // one partial
    const int quads = nr * ((d + 3) / 4);
    for (int i = threadIdx.x; i < quads; i += blockDim.x) {
        const int row = r0 + i / ((d + 3) / 4);
        const int c = 4 * (i % ((d + 3) / 4));
        float o[4] = {0.f, 0.f, 0.f, 0.f};
        for (int part = 0; part < s.z; ++part) {
            float v[4];
            load4<false, VEC>(partial + (size_t)(s.y + part) * stride, row, c, d, v);
#pragma unroll
            for (int m = 0; m < 4; ++m) o[m] += v[m];
        }
        store4<OUT_BF16, VEC>(y, (size_t)s.x * br + row, c, d, o);
    }
}

template <bool BF16, bool OUT_BF16, bool VEC, int MODE>
int launch(const void* rows, const void* cols, const void* w, const void* col_blk,
           const void* work, int n_items, const void* x, void* y, void* partial, int k,
           int br, int bc, int d, cudaStream_t st) {
    const size_t smem = (size_t)br * COLS * sizeof(float);
    auto kern = spmm_packets_kernel<BF16, OUT_BF16, VEC, MODE>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(n_items, (d + COLS - 1) / COLS);
    kern<<<grid, THREADS, smem, st>>>((const int32_t*)rows, (const int32_t*)cols,
                                      (const float*)w, (const int32_t*)col_blk,
                                      (const int4*)work, x, y, (float*)partial, k, br, bc, d);
    return (int)cudaGetLastError();
}

template <bool BF16, bool OUT_BF16>
int launch_vec(int vec, const void* rows, const void* cols, const void* w,
               const void* col_blk, const void* work, int n_items, const void* x, void* y,
               void* partial, int k, int br, int bc, int d, cudaStream_t st) {
    return vec ? launch<BF16, OUT_BF16, true, FULL>(rows, cols, w, col_blk, work, n_items, x,
                                                    y, partial, k, br, bc, d, st)
               : launch<BF16, OUT_BF16, false, FULL>(rows, cols, w, col_blk, work, n_items, x,
                                                     y, partial, k, br, bc, d, st);
}

}  // namespace

extern "C" {

// Main pass: y[n_rb * br, d] (f32, or bf16 bits when out_bf16) for the blocks that
// are one chunk, f32 partials[n_parts, br, d] for the chunks of split blocks.
// compute_bf16 selects the bf16 roundings of w and g and takes x as bf16 bits
// (already rounded); otherwise x is f32.  vec: d % 4 == 0 and x 16-byte aligned.
int spmm_packets(const void* rows, const void* cols, const void* w, const void* col_blk,
                 const void* work, int n_items, const void* x, void* y, void* partial,
                 int compute_bf16, int out_bf16, int vec, int k, int br, int bc, int d,
                 void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (compute_bf16)
        return out_bf16 ? launch_vec<true, true>(vec, rows, cols, w, col_blk, work, n_items, x,
                                                 y, partial, k, br, bc, d, st)
                        : launch_vec<true, false>(vec, rows, cols, w, col_blk, work, n_items,
                                                  x, y, partial, k, br, bc, d, st);
    return out_bf16 ? launch_vec<false, true>(vec, rows, cols, w, col_blk, work, n_items, x, y,
                                              partial, k, br, bc, d, st)
                    : launch_vec<false, false>(vec, rows, cols, w, col_blk, work, n_items, x,
                                               y, partial, k, br, bc, d, st);
}

// Second pass: the rows of each of the n_split split blocks, summed from their
// partials in chunk order, rounded once to the output dtype.
int spmm_packets_reduce(const void* splits, int n_split, const void* partial, void* y,
                        int out_bf16, int vec, int br, int d, void* stream) {
    const dim3 grid(n_split, (br + RED_ROWS - 1) / RED_ROWS);
    cudaStream_t st = (cudaStream_t)stream;
    const int4* s = (const int4*)splits;
    const float* pp = (const float*)partial;
    if (out_bf16) {
        if (vec) spmm_packets_reduce_kernel<true, true><<<grid, 256, 0, st>>>(s, pp, y, br, d);
        else spmm_packets_reduce_kernel<true, false><<<grid, 256, 0, st>>>(s, pp, y, br, d);
    } else {
        if (vec) spmm_packets_reduce_kernel<false, true><<<grid, 256, 0, st>>>(s, pp, y, br, d);
        else spmm_packets_reduce_kernel<false, false><<<grid, 256, 0, st>>>(s, pp, y, br, d);
    }
    return (int)cudaGetLastError();
}

// The main pass in a diagnostic mode (1 slots_only, 2 no_gather, 3 gather_only;
// 0 is the full kernel): bf16 compute on bf16-bits x, f32 output, d % 4 == 0.
int spmm_packets_ablation(const void* rows, const void* cols, const void* w,
                          const void* col_blk, const void* work, int n_items, const void* x,
                          void* y, void* partial, int mode, int k, int br, int bc, int d,
                          void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (mode) {
        case FULL:
            return launch<true, false, true, FULL>(rows, cols, w, col_blk, work, n_items, x, y,
                                                   partial, k, br, bc, d, st);
        case SLOTS_ONLY:
            return launch<true, false, true, SLOTS_ONLY>(rows, cols, w, col_blk, work, n_items,
                                                         x, y, partial, k, br, bc, d, st);
        case NO_GATHER:
            return launch<true, false, true, NO_GATHER>(rows, cols, w, col_blk, work, n_items,
                                                        x, y, partial, k, br, bc, d, st);
        case GATHER_ONLY:
            return launch<true, false, true, GATHER_ONLY>(rows, cols, w, col_blk, work,
                                                          n_items, x, y, partial, k, br, bc,
                                                          d, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
