// SpMM over the column-stacked layout of tpugraph_torch/ops/resident_kernels.py
// (BCSRStacked), for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// that module, which checks every argument first.
//
// Layout: tiles[T, stack*B, B] (f32, bf16 bits, or int8), or int8[T, stack*B, B/2]
// when packed4 (byte (r, c) holds column c in its low nibble and column c + B/2 in
// its high nibble, unsigned); col_blk int32[T]; rows int32[T*stack], slice s of
// stack t adds into row block rows[t*stack + s].  The wrapper derives a row-block-
// major inverse index once per layout: row_ptr int32[R+1] and slots int32[T*stack]
// (the flat t*stack + s entries sorted by row block, stably).
//
// spmm_stacked_resident replaces tpugraph/ops/pallas_resident.py:spmm_stacked_resident
// (_resident_kernel_factory): y[R*B, D] = A @ x.
//   Semantics: int8 and int4 tiles widen exactly; with bf16/int8/int4 tiles x is
//   rounded to bf16 (nearest even) before the product, f32 tiles keep x in f32.
//   Products and sums are f32; a bf16 output is rounded once, at the write.
//   Bound on the H100: bytes at these densities (every tile byte read once, x and
//   y once; the useful work is 2*nnz*D operations).
//   Design: the TPU kernel keeps x and the whole output resident in ~110 MB of
//   VMEM and lets every stack read-modify-write its rows in any order.  Hopper has
//   no such memory, so ownership is inverted: one CTA owns a (row block, 64 rows,
//   64 columns of D) slice of y, walks the inverse-index list of (stack, lane)
//   slices that land in its row block, and stages a 64x32 slice of the widened
//   tile and the matching 32x64 slice of x in shared memory per step, 4x4 outputs
//   per thread in registers.  No atomics: the summation order is fixed, and every
//   output row is written, zeros where no slice lands.  Scalar IEEE FMA (no
//   tensor cores yet).
//
// Needs B % 64 == 0; launches on the caller's stream and returns
// cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int TX = BN / TN;
constexpr int THREADS = (BM / TM) * TX;  // 256

enum TileKind { F32 = 0, BF16 = 1, INT8 = 2, INT4 = 3 };

// round to the nearest bf16 (ties to even), kept in a float
__device__ __forceinline__ float bf16_round(float v) {
    uint32_t b = __float_as_uint(v);
    b += 0x7fffu + ((b >> 16) & 1u);
    return __uint_as_float(b & 0xffff0000u);
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
    return (uint16_t)(__float_as_uint(bf16_round(v)) >> 16);
}

// entry (row, col) of the [*, B] tile matrix, widened to float
template <int KIND>
__device__ __forceinline__ float tile_at(const void* tiles, size_t row, int col, int block) {
    if (KIND == F32) return ((const float*)tiles)[row * block + col];
    if (KIND == BF16)
        return __uint_as_float((uint32_t)((const uint16_t*)tiles)[row * block + col] << 16);
    if (KIND == INT8) return (float)((const int8_t*)tiles)[row * block + col];
    const int half = block / 2;
    const uint8_t byte = ((const uint8_t*)tiles)[row * half + (col % half)];
    return (float)(col < half ? (byte & 0xF) : (byte >> 4));
}

template <int KIND, bool OUT_BF16>
__global__ void __launch_bounds__(THREADS)
spmm_stacked_kernel(const void* __restrict__ tiles, const int32_t* __restrict__ col_blk,
                    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ slots,
                    const float* __restrict__ x, void* __restrict__ y, int block, int stack,
                    int d) {
    __shared__ float As[BK][BM + 1];
    __shared__ float Xs[BK][BN];
    const int subs = block / BM;
    const int rb = blockIdx.x / subs;
    const int m0 = (blockIdx.x % subs) * BM;
    const int n0 = blockIdx.y * BN;
    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int e = row_ptr[rb]; e < row_ptr[rb + 1]; ++e) {
        const int flat = slots[e];
        const int t = flat / stack, s = flat % stack;
        const size_t row0 = ((size_t)t * stack + s) * block + m0;  // first tile row
        const float* xb = x + (size_t)col_blk[t] * block * d;
        for (int k0 = 0; k0 < block; k0 += BK) {
            for (int i = tid; i < BM * BK; i += THREADS) {
                const int m = i / BK, k = i % BK;
                As[k][m] = tile_at<KIND>(tiles, row0 + m, k0 + k, block);
            }
            for (int i = tid; i < BK * BN; i += THREADS) {
                const int k = i / BN, n = i % BN;
                float v = (n0 + n < d) ? xb[(size_t)(k0 + k) * d + n0 + n] : 0.f;
                Xs[k][n] = KIND == F32 ? v : bf16_round(v);
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
    const size_t base = ((size_t)rb * block + m0) * d;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int n = n0 + tx + j * TX;
            if (n >= d) continue;
            const size_t off = base + (size_t)(ty + i * (BM / TM)) * d + n;
            if (OUT_BF16)
                ((uint16_t*)y)[off] = bf16_bits(acc[i][j]);
            else
                ((float*)y)[off] = acc[i][j];
        }
}

template <int KIND>
void launch(dim3 grid, cudaStream_t st, const void* tiles, const int32_t* col_blk,
            const int32_t* row_ptr, const int32_t* slots, const float* x, void* y,
            bool out_bf16, int block, int stack, int d) {
    if (out_bf16)
        spmm_stacked_kernel<KIND, true><<<grid, THREADS, 0, st>>>(
            tiles, col_blk, row_ptr, slots, x, y, block, stack, d);
    else
        spmm_stacked_kernel<KIND, false><<<grid, THREADS, 0, st>>>(
            tiles, col_blk, row_ptr, slots, x, y, block, stack, d);
}

}  // namespace

extern "C" {

// y[n_row_blocks * block, d] (f32, or bf16 bits when out_bf16) = A @ x.
// tile_kind: 0 f32, 1 bf16, 2 int8, 3 int4 (packed4).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unknown tile_kind.
int spmm_stacked_resident(const void* tiles, int tile_kind, const void* col_blk,
                          const void* row_ptr, const void* slots, const void* x, void* y,
                          int out_bf16, int n_row_blocks, int block, int stack, int d,
                          void* stream) {
    dim3 grid(n_row_blocks * (block / BM), (d + BN - 1) / BN);
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t* cb = (const int32_t*)col_blk;
    const int32_t* rp = (const int32_t*)row_ptr;
    const int32_t* sl = (const int32_t*)slots;
    const float* xf = (const float*)x;
    switch (tile_kind) {
        case F32: launch<F32>(grid, st, tiles, cb, rp, sl, xf, y, out_bf16, block, stack, d); break;
        case BF16: launch<BF16>(grid, st, tiles, cb, rp, sl, xf, y, out_bf16, block, stack, d); break;
        case INT8: launch<INT8>(grid, st, tiles, cb, rp, sl, xf, y, out_bf16, block, stack, d); break;
        case INT4: launch<INT4>(grid, st, tiles, cb, rp, sl, xf, y, out_bf16, block, stack, d); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
