// Block-sparse SpMM and SDDMM over the BCSR layout of tpugraph_torch/ops/bcsr.py,
// for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// tpugraph_torch/ops/bcsr_kernels.py, which checks every argument first.
//
// Layout: tiles[T, B, B] (row = receiver, col = sender) in f32, bf16 bits or int8
// (tile_kind 0, 1, 2), col_blk int32[T], row_of int32[T], row_ptr int32[R+1]; tiles
// of one row block are consecutive.  x is f32 or bf16 bits (x_bf16), the output
// f32 or bf16 bits (out_bf16), with the dtype rules of tile_dtypes.cuh: int8 tiles
// widen exactly, x is rounded to bf16 for bf16/int8 tiles, sums are f32 and a bf16
// output is rounded once, at the write.
//
// spmm_bcsr replaces the Pallas kernel tpugraph/ops/pallas_spmm.py:spmm_bcsr
// (_spmm_kernel and its out_dtype twin _spmm_kernel_cast_factory): y[R*B, D] = A @ x.
//   Bound on the H100: bytes.  Every tile is read once (T*B*B*itemsize bytes) while
//   the useful work is 2*nnz*D flops, far below the 67 TFLOP/s f32 rate.
//   Design: the Pallas kernel carries a row block across a sequential grid;
//   here one CTA owns a (row block, 64 rows, 64 columns of D) slice of the
//   output and loops over row_ptr[r]..row_ptr[r+1] itself.  Each step stages
//   a 64x32 slice of the tile (widened to f32) and the matching 32x64 slice of
//   x[col_blk[t]] (cast to the tile compute type) in shared memory; each of 256
//   threads keeps a 4x4 block of the output in registers.  The output is written
//   once, without atomics, with a fixed summation order; a row block without tiles
//   gets zeros.  The products are IEEE float32 FMAs (no TF32); bf16 x bf16 products
//   are exact in f32, so results agree with the CPU reference to rounding.
//
// sddmm_bcsr replaces tpugraph/ops/pallas_spmm.py:sddmm_bcsr (_sddmm_kernel):
//   out[t] = (dy[row_of[t] block] @ x[col_blk[t] block]^T) * (tiles[t] != 0), with
//   dy, x and out f32 and the tiles of any kind (only their support is read).
//   An entry whose tile value is exactly 0 (or -0) gets +0.0; JAX writes prod * 0,
//   which is -0.0 for a negative product and NaN for a non-finite one, so the two
//   differ only for non-finite inputs.
//   Bound on the H100: bytes.  The contract makes the kernel read the tiles for
//   the support and write the dense f32 [T, B, B] output; the useful work is
//   2*nnz*D flops (0.27 GFLOP at the scaled shape, against 36 GFLOP for dense
//   sub-tile products).
//   Design: one CTA per 64x64 sub-tile of one tile.  It reads the sub-tile's
//   support once with 16-byte streaming loads (4 f32, 8 bf16 or 16 int8 entries
//   a load), keeps its bits in shared memory and counts its nonzeros.  Up to a
//   crossover count (the wrapper's sddmm_crossover(D), measured on the card:
//   494 nonzeros at D = 20, 882 at D = 128) it takes the sparse branch: it lists
//   the nonzeros, and groups of 8 lanes each take one dot product of dy[row] and
//   x[col] over D (16-byte loads where D % 4 == 0 and both are 16-byte aligned,
//   else scalar; a shuffle sum), into a
//   zeroed shared stage that is written with 16-byte streaming stores; a dead
//   padding tile costs one read and one write.  Above it (dense branch) the CTA
//   walks D in chunks of 32, staging 64x32 slices of dy and x in shared memory
//   with 4x4 outputs a thread in registers, and writes them on the support.
//
// spmm_bcsr_packed replaces tpugraph/ops/pallas_spmm.py:spmm_bcsr_packed
// (_spmm_packed_kernel_factory and its cast twin _spmm_packed_kernel_cast_factory):
// the same y = A @ x on a layout whose row blocks each hold a multiple of k_pack
// tiles (bcsr_from_coo(pad_rows_to=k)).
//   Bound on the H100: bytes, as B1.
//   Design: the TPU kernel takes k_pack tiles per grid step and double-buffers
//   the x-block DMAs by hand.  Here each CTA owns B1's (row block, 64 rows, 64
//   columns of D) output slice and walks its row block k_pack tiles at a time;
//   every 64x32 tile slice (its raw bytes, widened when read) and 32x64 f32 x slice
//   is fetched with cp.async into one of two shared-memory stages while the other
//   stage is multiplied, so the next loads (across tile and group boundaries)
//   overlap the FMAs.  A bf16 x slice (no 2-byte cp.async) is loaded and widened
//   by the threads into the free stage instead.  Dead tiles of the padded layout
//   (all zero, column block 0) add zeros.  IEEE f32 FMA, fixed summation order, no
//   atomics, every row block written.
//
// All kernels need B % 64 == 0 and launch on the caller's stream; each entry
// point returns cudaGetLastError() right after its launch, or
// cudaErrorInvalidValue for an unknown tile_kind.

#include "tile_dtypes.cuh"

namespace {

using namespace tpg;

constexpr int BM = 64;   // output rows per CTA
constexpr int BN = 64;   // output columns per CTA
constexpr int BK = 32;   // reduction chunk staged in shared memory
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int TX = BN / TN;            // 16 threads across columns
constexpr int THREADS = (BM / TM) * TX;  // 256

template <int KIND, bool X_BF16, bool OUT_BF16>
__global__ void __launch_bounds__(THREADS)
spmm_bcsr_kernel(const void* __restrict__ tiles, const int32_t* __restrict__ col_blk,
                 const int32_t* __restrict__ row_ptr, const void* __restrict__ x,
                 void* __restrict__ y, int block, int d) {
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

    using T = tile_t<KIND>;
    using X = std::conditional_t<X_BF16, uint16_t, float>;
    const int t_lo = row_ptr[r], t_hi = row_ptr[r + 1];
    for (int t = t_lo; t < t_hi; ++t) {
        const T* tile = (const T*)tiles + ((size_t)t * block + m0) * block;
        const X* xb = (const X*)x + (size_t)col_blk[t] * block * d;
        for (int k0 = 0; k0 < block; k0 += BK) {
            for (int i = tid; i < BM * BK; i += THREADS) {
                const int m = i / BK, k = i % BK;
                As[k][m] = tile_elem<KIND>(tile, (size_t)m * block + k0 + k);
            }
            for (int i = tid; i < BK * BN; i += THREADS) {
                const int k = i / BN, n = i % BN;
                Xs[k][n] = (n0 + n < d)
                    ? x_operand<KIND, X_BF16>(xb, (size_t)(k0 + k) * d + n0 + n) : 0.f;
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
    const size_t base = ((size_t)r * block + m0) * d;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int n = n0 + tx + j * TX;
            if (n < d) store_out<OUT_BF16>(y, base + (size_t)(ty + i * (BM / TM)) * d + n,
                                           acc[i][j]);
        }
}

// bit e set where entry e of the 16 bytes in v is not zero (a -0 is zero)
template <int KIND>
__device__ __forceinline__ uint32_t nonzero_bits(uint4 v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        if (KIND == F32) {
            bits |= (uint32_t)((w[i] & 0x7fffffffu) != 0) << i;
        } else if (KIND == BF16) {
            bits |= (uint32_t)((w[i] & 0x7fffu) != 0) << (2 * i);
            bits |= (uint32_t)((w[i] & 0x7fff0000u) != 0) << (2 * i + 1);
        } else {
#pragma unroll
            for (int b = 0; b < 4; ++b)
                bits |= (uint32_t)(((w[i] >> (8 * b)) & 0xffu) != 0) << (4 * i + b);
        }
    }
    return bits;
}

constexpr int GROUP = 8;  // lanes that share one dot product in the sparse branch

template <int KIND, bool VEC>
__global__ void __launch_bounds__(THREADS)
sddmm_bcsr_kernel(const void* __restrict__ tiles, const int32_t* __restrict__ row_of,
                  const int32_t* __restrict__ col_blk, const float* __restrict__ dy,
                  const float* __restrict__ x, float* __restrict__ out, int block, int d,
                  int crossover) {
    using T = tile_t<KIND>;
    constexpr int EPL = 16 / sizeof(T);              // support entries a 16-byte load
    constexpr int PER_ROW = BN / EPL;                // loads a sub-tile row
    constexpr int LOADS = BM * PER_ROW / THREADS;    // loads a thread: f32 4, bf16 2, int8 1
    __shared__ float Ds[BK][BM + 1];
    __shared__ float Xs[BK][BN + 1];
    __shared__ __align__(16) float Os[BM * BN];      // the sparse branch's output stage
    __shared__ uint16_t nz[BM * BN];                 // (i << 6) | j of each nonzero
    __shared__ uint32_t mask[BM][2];                 // support bits of each row
    __shared__ int count, listed;
    const int subs = block / BM;
    const int per_tile = subs * subs;
    const int t = blockIdx.x / per_tile;
    const int rem = blockIdx.x % per_tile;
    const int i0 = (rem / subs) * BM;
    const int j0 = (rem % subs) * BN;
    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
    float* o = out + ((size_t)t * block + i0) * block + j0;

    // the support of this sub-tile, read once with 16-byte streaming loads
    if (tid < BM * 2) mask[tid / 2][tid % 2] = 0;
    if (tid == 0) count = listed = 0;
    __syncthreads();
    const T* sup = (const T*)tiles + ((size_t)t * block + i0) * block + j0;
    uint32_t bits = 0;  // bit l * EPL + e: entry e of this thread's load l
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
        const int li = tid + l * THREADS, row = li / PER_ROW, col = (li % PER_ROW) * EPL;
        const uint32_t b = nonzero_bits<KIND>(__ldcs((const uint4*)(sup + (size_t)row * block + col)));
        if (b) atomicOr(&mask[row][col >> 5], b << (col & 31));
        bits |= b << (l * EPL);
    }
    const int mine = __reduce_add_sync(0xffffffffu, __popc(bits));
    if ((tid & 31) == 0 && mine) atomicAdd(&count, mine);
    __syncthreads();
    const int nnz = count;

    if (nnz <= crossover) {
        // sparse branch: a dot product over D for each nonzero, zeros elsewhere
        for (int i = tid; i < BM * BN / 4; i += THREADS)
            ((float4*)Os)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (uint32_t b = bits; b; b &= b - 1) {
            const int bit = __ffs(b) - 1, li = tid + (bit / EPL) * THREADS;
            nz[atomicAdd(&listed, 1)] = (uint16_t)(((li / PER_ROW) << 6)
                                                  | ((li % PER_ROW) * EPL + bit % EPL));
        }
        __syncthreads();
        const int g = tid / GROUP, gl = tid % GROUP;
        const float* dyb = dy + ((size_t)row_of[t] * block + i0) * d;
        const float* xb = x + ((size_t)col_blk[t] * block + j0) * d;
        for (int base = 0; base < nnz; base += THREADS / GROUP) {  // uniform trip count
            const int n = base + g;
            float s = 0.f;
            int ij = 0;
            if (n < nnz) {
                ij = nz[n];
                const float* a = dyb + (size_t)(ij >> 6) * d;
                const float* c = xb + (size_t)(ij & 63) * d;
                if (VEC) {
                    for (int k = 4 * gl; k < d; k += 4 * GROUP) {
                        const float4 av = *(const float4*)(a + k), cv = *(const float4*)(c + k);
                        s = fmaf(av.x, cv.x, s);
                        s = fmaf(av.y, cv.y, s);
                        s = fmaf(av.z, cv.z, s);
                        s = fmaf(av.w, cv.w, s);
                    }
                } else {
                    for (int k = gl; k < d; k += GROUP) s = fmaf(a[k], c[k], s);
                }
            }
#pragma unroll
            for (int off = GROUP / 2; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
            if (n < nnz && gl == 0) Os[ij] = s;
        }
        __syncthreads();
        for (int i = tid; i < BM * BN / 4; i += THREADS)
            __stcs((float4*)(o + (size_t)(i / (BN / 4)) * block + (i % (BN / 4)) * 4),
                   ((const float4*)Os)[i]);
        return;
    }

    // dense branch: the register-blocked dy_sub @ x_sub^T over all of D
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
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int r = ty + i * (BM / TM), c = tx + j * TX;
            o[(size_t)r * block + c] = (mask[r][c >> 5] >> (c & 31)) & 1u ? acc[i][j] : 0.f;
        }
}

// ---------------------------------------------------------------- B3

constexpr int AP = BK + 4;  // padded row of the [m][k] tile stage (16-byte rows)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// 4-byte copy; src_bytes = 0 writes a zero without reading gmem.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool in) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int KIND, bool X_BF16, bool OUT_BF16>
__global__ void __launch_bounds__(THREADS)
spmm_bcsr_packed_kernel(const void* __restrict__ tiles, const int32_t* __restrict__ col_blk,
                        const int32_t* __restrict__ row_ptr, const void* __restrict__ x,
                        void* __restrict__ y, int block, int d, int k_pack) {
    using T = tile_t<KIND>;
    constexpr int EPC = 16 / sizeof(T);      // tile elements per 16-byte copy
    constexpr bool ROUND_X = KIND != F32 && !X_BF16;
    // a staged row holds BK f32 values, or the raw bytes of BK narrower ones
    __shared__ __align__(16) float As[2][BM][AP];
    __shared__ __align__(16) float Xs[2][BK][BN];
    const int subs = block / BM;
    const int r = blockIdx.x / subs;
    const int m0 = (blockIdx.x % subs) * BM;
    const int n0 = blockIdx.y * BN;
    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
    const int chunks = block / BK;          // k-chunks of one tile
    const int t_lo = row_ptr[r];
    const int groups = (row_ptr[r + 1] - t_lo) / k_pack;
    const int steps = groups * k_pack * chunks;

    // stage step s = (tile t_lo + s / chunks, chunk s % chunks) into buffer buf
    auto load = [&](int s, int buf) {
        const int t = t_lo + s / chunks;
        const int k0 = (s % chunks) * BK;
        const T* tile = (const T*)tiles + ((size_t)t * block + m0) * block + k0;
        for (int i = tid; i < BM * (BK / EPC); i += THREADS) {
            const int m = i / (BK / EPC), q = i % (BK / EPC);
            cp_async16((T*)As[buf][m] + q * EPC, tile + (size_t)m * block + q * EPC);
        }
        const size_t xrow = ((size_t)col_blk[t] * block + k0) * d;
        for (int i = tid; i < BK * BN; i += THREADS) {
            const int k = i / BN, n = i % BN;
            const bool in = n0 + n < d;
            if (X_BF16) {
                const uint16_t* xb = (const uint16_t*)x + xrow;
                Xs[buf][k][n] = in ? bf16_widen(xb[(size_t)k * d + n0 + n]) : 0.f;
            } else {
                const float* xb = (const float*)x + xrow;
                cp_async4(&Xs[buf][k][n], in ? xb + (size_t)k * d + n0 + n : (const float*)x,
                          in);
            }
        }
    };

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    if (steps > 0) load(0, 0);
    cp_async_commit();
    int s = 0;
    for (int g = 0; g < groups; ++g) {            // k_pack tiles per iteration
        for (int j = 0; j < k_pack * chunks; ++j, ++s) {
            if (s + 1 < steps) load(s + 1, (s + 1) & 1);
            cp_async_commit();
            cp_async_wait_one();                  // stage s has landed
            __syncthreads();
            const int buf = s & 1;
#pragma unroll
            for (int k = 0; k < BK; ++k) {
                float a[TM], b[TN];
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    const int m = ty + i * (BM / TM);
                    a[i] = KIND == F32 ? As[buf][m][k] : tile_elem<KIND>(As[buf][m], k);
                }
#pragma unroll
                for (int jj = 0; jj < TN; ++jj) {
                    const float v = Xs[buf][k][tx + jj * TX];
                    b[jj] = ROUND_X ? bf16_round(v) : v;
                }
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int jj = 0; jj < TN; ++jj) acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
            }
            __syncthreads();                      // buffer free for step s + 2
        }
    }
    const size_t base = ((size_t)r * block + m0) * d;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int n = n0 + tx + j * TX;
            if (n < d) store_out<OUT_BF16>(y, base + (size_t)(ty + i * (BM / TM)) * d + n,
                                           acc[i][j]);
        }
}

}  // namespace

extern "C" {

// y[n_row_blocks * block, d] = A @ x.
int spmm_bcsr(const void* tiles, int tile_kind, const void* col_blk, const void* row_ptr,
              const void* x, int x_bf16, void* y, int out_bf16, int n_row_blocks, int block,
              int d, void* stream) {
    const dim3 grid(n_row_blocks * (block / BM), (d + BN - 1) / BN);
    const bool known = dispatch(tile_kind, x_bf16, out_bf16, [&](auto k, auto xb, auto ob) {
        spmm_bcsr_kernel<decltype(k)::value, decltype(xb)::value, decltype(ob)::value>
            <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
                tiles, (const int32_t*)col_blk, (const int32_t*)row_ptr, x, y, block, d);
    });
    return known ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// out[num_tiles, block, block] = per-tile (dy @ x^T) * (tiles != 0), all f32 but
// the tiles; +0.0 off the support.  A 64x64 sub-tile with at most `crossover`
// nonzeros takes the sparse branch (-1: always dense; 4096: always sparse).
int sddmm_bcsr(const void* tiles, int tile_kind, const void* row_of, const void* col_blk,
               const void* dy, const void* x, void* out, int num_tiles, int block, int d,
               int crossover, void* stream) {
    const dim3 grid(num_tiles * (block / BM) * (block / BN));
    const bool vec = d % 4 == 0 && (((uintptr_t)dy | (uintptr_t)x) & 15) == 0;
    const bool known = dispatch(tile_kind, vec, false, [&](auto k, auto v, auto) {
        sddmm_bcsr_kernel<decltype(k)::value, decltype(v)::value>
            <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
                tiles, (const int32_t*)row_of, (const int32_t*)col_blk, (const float*)dy,
                (const float*)x, (float*)out, block, d, crossover);
    });
    return known ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// y[n_row_blocks * block, d] = A @ x over a layout padded to k_pack tiles per
// row block.
int spmm_bcsr_packed(const void* tiles, int tile_kind, const void* col_blk,
                     const void* row_ptr, const void* x, int x_bf16, void* y, int out_bf16,
                     int n_row_blocks, int block, int d, int k_pack, void* stream) {
    const dim3 grid(n_row_blocks * (block / BM), (d + BN - 1) / BN);
    const bool known = dispatch(tile_kind, x_bf16, out_bf16, [&](auto k, auto xb, auto ob) {
        spmm_bcsr_packed_kernel<decltype(k)::value, decltype(xb)::value, decltype(ob)::value>
            <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
                tiles, (const int32_t*)col_blk, (const int32_t*)row_ptr, x, y, block, d,
                k_pack);
    });
    return known ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // extern "C"
