// SpMM over the edge-packet layout of tpugraph_torch/ops/packets.py, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// tpugraph_torch/ops/packets_kernels.py, which checks every argument first.
//
// Layout: rows/cols int32[P, K] (row within the receiver block, row of x within
// the sender block), w f32[P, K] (0 = dead slot), col_blk int32[P], and row_ptr
// int32[R+1]: the packets of receiver block r are row_ptr[r]..row_ptr[r+1].
//
// spmm_packets replaces tpugraph/ops/pallas_packets.py:spmm_packets
// (_packet_kernel_factory): y[R*Br, D] = A @ x.
//   Semantics: per edge e, g[e] = w[e] * x[col_blk*Bc + cols[e]]; with a bf16
//   compute type w and x are rounded to bf16 first and g is rounded to bf16
//   after the (exact) f32 product, as the TPU kernel stages g at the compute
//   dtype.  y[rows[e]] += g[e] accumulates in f32; a bf16 output is rounded once.
//   Bound on the H100: bytes (12 bytes of edge data a slot, a 4*D-byte x row a
//   live edge, y once) against 2*E*D operations.
//   Design: the TPU kernel turns gather and scatter into one-hot matmuls for its
//   matrix unit.  Hopper gathers rows directly, so one CTA owns a (receiver
//   block, 32-column slice of D) and accumulates it in shared memory
//   (Br * 32 * 4 bytes: 64 KB at Br = 512).  Each of its 32 warps takes whole
//   packets (a degree-sorted power-law graph puts ~15% of its edges in receiver
//   block 0, so the warps of that block's CTAs set the kernel's time); its
//   lanes read 32 slots at once, then for each live slot every lane reads one
//   column of the x row (128 coalesced bytes) and adds into the shared
//   accumulator with a shared-memory atomic (warps of one CTA may hit the same
//   row).  The block is zeroed first and written whole at the end, so every
//   output row is written.  The f32 summation order of the atomics varies from
//   run to run (differences at f32 rounding level).
//
// Launches on the caller's stream and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DS = 32;        // columns of D per CTA: one per lane
constexpr int THREADS = 1024;  // 32 warps: the hub row block is the tail

__device__ __forceinline__ float bf16_round(float v) {
    uint32_t b = __float_as_uint(v);
    b += 0x7fffu + ((b >> 16) & 1u);
    return __uint_as_float(b & 0xffff0000u);
}

template <bool BF16, bool OUT_BF16>
__global__ void __launch_bounds__(THREADS)
spmm_packets_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
                    const float* __restrict__ w, const int32_t* __restrict__ col_blk,
                    const int32_t* __restrict__ row_ptr, const float* __restrict__ x,
                    void* __restrict__ y, int k, int br, int bc, int d) {
    extern __shared__ float acc[];  // [br][DS]
    const int rb = blockIdx.x;
    const int n = blockIdx.y * DS + (threadIdx.x % 32);  // this lane's column
    const bool in = n < d;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    for (int i = threadIdx.x; i < br * DS; i += THREADS) acc[i] = 0.f;
    __syncthreads();

    for (int p = row_ptr[rb] + warp; p < row_ptr[rb + 1]; p += THREADS / 32) {
        const float* xw = x + (size_t)col_blk[p] * bc * d + n;
        const size_t base = (size_t)p * k;
        for (int e0 = 0; e0 < k; e0 += 32) {
            const int e = e0 + lane;
            const int my_r = e < k ? rows[base + e] : 0;
            const int my_c = e < k ? cols[base + e] : 0;
            const float my_w = e < k ? w[base + e] : 0.f;
            const int live = min(32, k - e0);
#pragma unroll 4
            for (int j = 0; j < live; ++j) {
                const float wj = __shfl_sync(0xffffffffu, my_w, j);
                const int cj = __shfl_sync(0xffffffffu, my_c, j);
                const int rj = __shfl_sync(0xffffffffu, my_r, j);
                if (wj == 0.f || !in) continue;  // dead slot adds zero
                const float xv = xw[(size_t)cj * d];
                const float g = BF16 ? bf16_round(bf16_round(wj) * bf16_round(xv)) : wj * xv;
                atomicAdd(&acc[rj * DS + lane], g);
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < br * DS; i += THREADS) {
        const int row = i / DS, c = blockIdx.y * DS + i % DS;
        if (c >= d) continue;
        const size_t off = ((size_t)rb * br + row) * d + c;
        if (OUT_BF16)
            ((uint16_t*)y)[off] = (uint16_t)(__float_as_uint(bf16_round(acc[i])) >> 16);
        else
            ((float*)y)[off] = acc[i];
    }
}

template <bool BF16, bool OUT_BF16>
int launch(int n_row_blocks, int k, int br, int bc, int d, const void* rows,
           const void* cols, const void* w, const void* col_blk, const void* row_ptr,
           const void* x, void* y, cudaStream_t st) {
    const size_t smem = (size_t)br * DS * sizeof(float);
    auto kern = spmm_packets_kernel<BF16, OUT_BF16>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(n_row_blocks, (d + DS - 1) / DS);
    kern<<<grid, THREADS, smem, st>>>((const int32_t*)rows, (const int32_t*)cols,
                                      (const float*)w, (const int32_t*)col_blk,
                                      (const int32_t*)row_ptr, (const float*)x, y, k, br,
                                      bc, d);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y[n_row_blocks * br, d] (f32, or bf16 bits when out_bf16) = A @ x; compute_bf16
// selects the bf16 roundings of w, x and g.  Returns a CUDA error code (0 = ok).
int spmm_packets(const void* rows, const void* cols, const void* w, const void* col_blk,
                 const void* row_ptr, const void* x, void* y, int compute_bf16,
                 int out_bf16, int n_row_blocks, int k, int br, int bc, int d,
                 void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (compute_bf16)
        return out_bf16 ? launch<true, true>(n_row_blocks, k, br, bc, d, rows, cols, w,
                                             col_blk, row_ptr, x, y, st)
                        : launch<true, false>(n_row_blocks, k, br, bc, d, rows, cols, w,
                                              col_blk, row_ptr, x, y, st);
    return out_bf16 ? launch<false, true>(n_row_blocks, k, br, bc, d, rows, cols, w,
                                          col_blk, row_ptr, x, y, st)
                    : launch<false, false>(n_row_blocks, k, br, bc, d, rows, cols, w,
                                           col_blk, row_ptr, x, y, st);
}

}  // extern "C"
