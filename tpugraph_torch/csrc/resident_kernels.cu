// SpMM over the column-stacked layout of tpugraph_torch/ops/resident_kernels.py
// (BCSRStacked, BCSRPair), for Hopper (sm_90a).  Plain C interface, loaded with
// ctypes by that module, which checks every argument first.
//
// Layout: tiles[T, stack*B, B] (f32, bf16 bits, or int8), or int8[T, stack*B, B/2]
// when packed4 (byte (r, c) holds column c in its low nibble and column c + B/2 in
// its high nibble, unsigned); col_blk int32[T]; rows int32[T*stack], slice s of
// stack t adds into row block rows[t*stack + s].  The wrapper derives a row-block-
// major inverse index once per layout: row_ptr int32[R+1] and slots int32[T*stack]
// (the flat t*stack + s entries sorted by row block, stably).  A pair (stack 1)
// concatenates A's t1 tiles and A_t's t2 tiles and carries one inverse index for
// each half; the second half's slots are offset by t1.
//
// One phase kernel does all the work: y[R*B, D] = scale * (A @ src) over one
// inverse index, with the dtype rules of tile_dtypes.cuh (src is f32 or bf16).
//   Design: the TPU kernels keep x and the whole output resident in ~110 MB of
//   VMEM and let every stack read-modify-write its rows in any order.  Hopper has
//   no such memory, so ownership is inverted: one CTA owns a (row block, 64 rows,
//   64 columns of D) slice of y, walks the inverse-index list of (stack, lane)
//   slices that land in its row block, and stages a 64x32 slice of the widened
//   tile and the matching 32x64 slice of src in shared memory per step, 4x4 outputs
//   per thread in registers.  No atomics: the summation order is fixed, and every
//   output row is written, zeros where no slice lands.  The epilogue multiplies
//   by scale in f32 and rounds once if the output is bf16.  Scalar IEEE FMA (no
//   tensor cores yet).
//   Bound on the H100: bytes at these densities (every tile byte read once, x and
//   y once; the useful work is 2*nnz*D operations).
//
// spmm_stacked_resident replaces tpugraph/ops/pallas_resident.py:spmm_stacked_resident
// (_resident_kernel_factory): one phase, scale 1.
//
// spmm_pair_resident replaces pallas_resident.py:spmm_pair_resident
// (_pair_kernel_factory): out = A_t @ bf16(A @ x), y rounded to bf16 once.
// spmm_power_resident replaces pallas_resident.py:spmm_power_resident
// (_power_kernel_factory): (hop_scale * A_t A)^hops @ x, with bf16 at every phase
// and hop boundary: y = bf16(A @ h), h' = bf16(hop_scale * (A_t @ y)), and the last
// phase writes (hop_scale * acc) at the output dtype.
//   The TPU runs both as one sequential grid whose phase 2 reads the y that phase 1
//   left in VMEM.  On Hopper CTAs run in parallel and phase 2 reads any row block of
//   y, so no CTA of phase 2 may start before every CTA of phase 1 has written: each
//   entry point launches one phase kernel per phase on the caller's stream (2 for a
//   pair, 2*hops for a power) and stream order is the grid-wide barrier.  The
//   intermediate bf16 buffers live in device memory (16.8 MB at 65,536 x 128, inside
//   the 50 MB L2).  One persistent launch with a grid-wide barrier would be the
//   closer counterpart of the TPU's single grid; that is later work.
//
// Needs B % 64 == 0; launches on the caller's stream and returns
// cudaGetLastError() after the launches (the first error stops the sequence).

#include "tile_dtypes.cuh"

namespace {

using namespace tpg;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int TX = BN / TN;
constexpr int THREADS = (BM / TM) * TX;  // 256

template <int KIND, bool X_BF16, bool OUT_BF16>
__global__ void __launch_bounds__(THREADS)
spmm_phase_kernel(const void* __restrict__ tiles, const int32_t* __restrict__ col_blk,
                  const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ slots,
                  const void* __restrict__ src, void* __restrict__ y, float scale,
                  int block, int stack, int d) {
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
        const size_t xrow0 = (size_t)col_blk[t] * block;
        for (int k0 = 0; k0 < block; k0 += BK) {
            for (int i = tid; i < BM * BK; i += THREADS) {
                const int m = i / BK, k = i % BK;
                As[k][m] = tile_at<KIND>(tiles, row0 + m, k0 + k, block);
            }
            for (int i = tid; i < BK * BN; i += THREADS) {
                const int k = i / BN, n = i % BN;
                Xs[k][n] = (n0 + n < d)
                    ? x_operand<KIND, X_BF16>(src, (xrow0 + k0 + k) * d + n0 + n) : 0.f;
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
            if (n < d)
                store_out<OUT_BF16>(y, base + (size_t)(ty + i * (BM / TM)) * d + n,
                                    acc[i][j] * scale);
        }
}

// One phase: y[n_row_blocks * block, d] = scale * (A @ src) over (row_ptr, slots).
int run_phase(int kind, bool src_bf16, bool out_bf16, const void* tiles, const void* col_blk,
              const void* row_ptr, const void* slots, const void* src, void* y, float scale,
              int n_row_blocks, int block, int stack, int d, cudaStream_t st) {
    if (n_row_blocks == 0 || d == 0) return (int)cudaSuccess;
    const dim3 grid(n_row_blocks * (block / BM), (d + BN - 1) / BN);
    const bool known = dispatch<true>(kind, src_bf16, out_bf16, [&](auto k, auto xb, auto ob) {
        spmm_phase_kernel<decltype(k)::value, decltype(xb)::value, decltype(ob)::value>
            <<<grid, THREADS, 0, st>>>(tiles, (const int32_t*)col_blk,
                                       (const int32_t*)row_ptr, (const int32_t*)slots, src,
                                       y, scale, block, stack, d);
    });
    return known ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// y[n_row_blocks * block, d] (f32, or bf16 bits when out_bf16) = A @ x, x f32 or
// bf16 bits (x_bf16).  tile_kind: 0 f32, 1 bf16, 2 int8, 3 int4 (packed4).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unknown tile_kind.
int spmm_stacked_resident(const void* tiles, int tile_kind, const void* col_blk,
                          const void* row_ptr, const void* slots, const void* x, int x_bf16,
                          void* y, int out_bf16, int n_row_blocks, int block, int stack, int d,
                          void* stream) {
    return run_phase(tile_kind, x_bf16, out_bf16, tiles, col_blk, row_ptr, slots, x, y, 1.f,
                     n_row_blocks, block, stack, d, (cudaStream_t)stream);
}

// out[n_out_blocks * block, d] = A_t @ bf16(A @ x) over a pair (stack 1, tile_kind
// 0-2): phase 1 walks (row_ptr1, slots1) over n_mid_blocks row blocks into ybuf
// (bf16 bits, [n_mid_blocks * block, d]), phase 2 walks (row_ptr2, slots2) over
// n_out_blocks row blocks from ybuf into out.
int spmm_pair_resident(const void* tiles, int tile_kind, const void* col_blk,
                       const void* row_ptr1, const void* slots1, const void* row_ptr2,
                       const void* slots2, const void* x, int x_bf16, void* ybuf, void* out,
                       int out_bf16, int n_mid_blocks, int n_out_blocks, int block, int d,
                       void* stream) {
    if (tile_kind == INT4) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    int err = run_phase(tile_kind, x_bf16, true, tiles, col_blk, row_ptr1, slots1, x, ybuf,
                        1.f, n_mid_blocks, block, 1, d, st);
    if (err) return err;
    return run_phase(tile_kind, true, out_bf16, tiles, col_blk, row_ptr2, slots2, ybuf, out,
                     1.f, n_out_blocks, block, 1, d, st);
}

// out = (hop_scale * A_t A)^hops @ x over a square pair: per hop, phase 1 into mid
// (bf16 bits, [n_mid_blocks * block, d]), phase 2 scaled by hop_scale into hop (bf16
// bits, [n_out_blocks * block, d], the next hop's input) or, at the last hop, into
// out.
int spmm_power_resident(const void* tiles, int tile_kind, const void* col_blk,
                        const void* row_ptr1, const void* slots1, const void* row_ptr2,
                        const void* slots2, const void* x, int x_bf16, void* mid, void* hop,
                        void* out, int out_bf16, int hops, float hop_scale, int n_mid_blocks,
                        int n_out_blocks, int block, int d, void* stream) {
    if (tile_kind == INT4) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    for (int h = 0; h < hops; ++h) {
        const bool last = h == hops - 1;
        int err = run_phase(tile_kind, h == 0 ? (bool)x_bf16 : true, true, tiles, col_blk,
                            row_ptr1, slots1, h == 0 ? x : hop, mid, 1.f, n_mid_blocks, block,
                            1, d, st);
        if (err) return err;
        err = run_phase(tile_kind, true, last ? (bool)out_bf16 : true, tiles, col_blk,
                        row_ptr2, slots2, mid, last ? out : hop, hop_scale, n_out_blocks,
                        block, 1, d, st);
        if (err) return err;
    }
    return (int)cudaSuccess;
}

}  // extern "C"
