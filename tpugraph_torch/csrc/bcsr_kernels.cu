// Block-sparse SpMM and SDDMM over the BCSR layout of tpugraph_torch/ops/bcsr.py,
// for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// tpugraph_torch/ops/bcsr_kernels.py, which checks every argument first.
//
// Layout: tiles float32[T, B, B] (row = receiver, col = sender), col_blk int32[T],
// row_of int32[T], row_ptr int32[R+1]; tiles of one row block are consecutive.
//
// spmm_bcsr_f32 replaces the Pallas kernel tpugraph/ops/pallas_spmm.py:spmm_bcsr
// (_spmm_kernel): y[R*B, D] = A @ x.
//   Bound on the H100: bytes.  Every tile is read once (T*B*B*4 bytes) while
//   the useful work is 2*nnz*D flops, far below the 67 TFLOP/s f32 rate.
//   Design: the Pallas kernel carries a row block across a sequential grid;
//   here one CTA owns a (row block, 64 rows, 64 columns of D) slice of the
//   output and loops over row_ptr[r]..row_ptr[r+1] itself.  Each step stages
//   a 64x32 slice of the tile and the matching 32x64 slice of x[col_blk[t]]
//   in shared memory; each of 256 threads keeps a 4x4 block of the output in
//   registers.  The output is written once, without atomics, with a fixed
//   summation order; a row block without tiles gets zeros.  The products are
//   IEEE float32 FMAs (no TF32), so results agree with the CPU float32
//   reference to rounding.
//
// sddmm_bcsr_f32 replaces tpugraph/ops/pallas_spmm.py:sddmm_bcsr (_sddmm_kernel):
//   out[t] = (dy[row_of[t] block] @ x[col_blk[t] block]^T) * (tiles[t] != 0).
//   Bound on the H100: bytes (tiles read for the support, out written:
//   2*T*B*B*4 bytes; useful work 2*nnz*D flops).
//   Design: one CTA per 64x64 sub-tile of one tile; it walks D in chunks of
//   32, staging 64x32 slices of dy and x in shared memory, 4x4 outputs per
//   thread in registers, then multiplies by the support of the current tile
//   values (entries that are exactly 0 get 0) and writes float32.
//
// Both kernels need B % 64 == 0 and launch on the caller's stream; each entry
// point returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // output rows per CTA
constexpr int BN = 64;   // output columns per CTA
constexpr int BK = 32;   // reduction chunk staged in shared memory
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int TX = BN / TN;            // 16 threads across columns
constexpr int THREADS = (BM / TM) * TX;  // 256

__global__ void __launch_bounds__(THREADS)
spmm_bcsr_kernel(const float* __restrict__ tiles, const int32_t* __restrict__ col_blk,
                 const int32_t* __restrict__ row_ptr, const float* __restrict__ x,
                 float* __restrict__ y, int block, int d) {
    __shared__ float As[BK][BM + 1];  // tile slice, k-major (+1: no bank conflicts on store)
    __shared__ float Xs[BK][BN];
    const int subs = block / BM;
    const int r = blockIdx.x / subs;
    const int m0 = (blockIdx.x % subs) * BM;
    const int n0 = blockIdx.y * BN;
    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    const int t_lo = row_ptr[r], t_hi = row_ptr[r + 1];
    for (int t = t_lo; t < t_hi; ++t) {
        const float* tile = tiles + ((size_t)t * block + m0) * block;
        const float* xb = x + (size_t)col_blk[t] * block * d;
        for (int k0 = 0; k0 < block; k0 += BK) {
            for (int i = tid; i < BM * BK; i += THREADS) {
                const int m = i / BK, k = i % BK;
                As[k][m] = tile[(size_t)m * block + k0 + k];
            }
            for (int i = tid; i < BK * BN; i += THREADS) {
                const int k = i / BN, n = i % BN;
                Xs[k][n] = (n0 + n < d) ? xb[(size_t)(k0 + k) * d + n0 + n] : 0.f;
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < BK; ++k) {
                float a[TM], b[TN];
#pragma unroll
                for (int i = 0; i < TM; ++i) a[i] = As[k][ty + i * (BM / TM)];
#pragma unroll
                for (int j = 0; j < TN; ++j) b[j] = Xs[k][tx + j * TX];
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
            __syncthreads();
        }
    }
    float* yb = y + ((size_t)r * block + m0) * d;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int n = n0 + tx + j * TX;
            if (n < d) yb[(size_t)(ty + i * (BM / TM)) * d + n] = acc[i][j];
        }
}

__global__ void __launch_bounds__(THREADS)
sddmm_bcsr_kernel(const float* __restrict__ tiles, const int32_t* __restrict__ row_of,
                  const int32_t* __restrict__ col_blk, const float* __restrict__ dy,
                  const float* __restrict__ x, float* __restrict__ out, int block, int d) {
    __shared__ float Ds[BK][BM + 1];
    __shared__ float Xs[BK][BN + 1];
    const int subs = block / BM;
    const int per_tile = subs * subs;
    const int t = blockIdx.x / per_tile;
    const int rem = blockIdx.x % per_tile;
    const int i0 = (rem / subs) * BM;
    const int j0 = (rem % subs) * BN;
    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
    const float* dyb = dy + ((size_t)row_of[t] * block + i0) * d;
    const float* xb = x + ((size_t)col_blk[t] * block + j0) * d;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
        for (int i = tid; i < BM * BK; i += THREADS) {
            const int m = i / BK, k = i % BK;
            const bool in = k0 + k < d;
            Ds[k][m] = in ? dyb[(size_t)m * d + k0 + k] : 0.f;
            Xs[k][m] = in ? xb[(size_t)m * d + k0 + k] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            float a[TM], b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = Ds[k][ty + i * (BM / TM)];
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = Xs[k][tx + j * TX];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
    const size_t base = (size_t)t * block * block;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const size_t off = base + (size_t)(i0 + ty + i * (BM / TM)) * block
                               + j0 + tx + j * TX;
            out[off] = acc[i][j] * (tiles[off] != 0.f ? 1.f : 0.f);
        }
}

}  // namespace

extern "C" {

// y[n_row_blocks * block, d] = A @ x.  Returns cudaGetLastError() after the launch.
int spmm_bcsr_f32(const void* tiles, const void* col_blk, const void* row_ptr,
                  const void* x, void* y, int n_row_blocks, int block, int d,
                  void* stream) {
    dim3 grid(n_row_blocks * (block / BM), (d + BN - 1) / BN);
    spmm_bcsr_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)tiles, (const int32_t*)col_blk, (const int32_t*)row_ptr,
        (const float*)x, (float*)y, block, d);
    return (int)cudaGetLastError();
}

// out[num_tiles, block, block] = per-tile (dy @ x^T) * (tiles != 0).
int sddmm_bcsr_f32(const void* tiles, const void* row_of, const void* col_blk,
                   const void* dy, const void* x, void* out, int num_tiles, int block,
                   int d, void* stream) {
    dim3 grid(num_tiles * (block / BM) * (block / BN));
    sddmm_bcsr_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)tiles, (const int32_t*)row_of, (const int32_t*)col_blk,
        (const float*)dy, (const float*)x, (float*)out, block, d);
    return (int)cudaGetLastError();
}

}  // extern "C"
