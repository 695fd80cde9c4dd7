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
// spmm_bcsr replaces the Pallas kernels tpugraph/ops/pallas_spmm.py:98 spmm_bcsr
// (_spmm_kernel and its out_dtype twin _spmm_kernel_cast_factory) and :312
// spmm_bcsr_packed (_spmm_packed_kernel_factory and its cast twin): y[R*B, D] =
// A @ x.  B3 is the same product on a layout whose row blocks each hold a multiple
// of k_pack tiles, padded with dead (all-zero) tiles.  The TPU took k_pack tiles a
// grid step to spread its per-step overhead; a CTA here has no such overhead, so
// B3 launches this kernel on its padded layout: the dead tiles are read (their
// bytes stay in B3's bound) and add nothing.  B3's former kernel, a dense
// double-buffered product, is gone.
//   Bound on the H100: bytes.  Every tile byte once (T*B*B*itemsize), x and y once;
//   the useful work is 2*nnz*D flops.  The power-law graph's 256^2 tiles are 0.15%
//   full: their dense product would be 352 GFLOP of scalar f32 FMA a call, 99.85%
//   of it on zeros, and a grid that splits D at 64 columns reads every tile twice.
//   Design: a CTA owns a slab (row block, 64 tile rows, 128 columns of D: D <= 128
//   never splits, a wider D takes more slabs along y).  Where some row block's list
//   is over twice the mean (a hub) or the grid would hold under two slabs an SM, a
//   cluster of 8 CTAs shares each slab (the wrapper's cluster_size, launched with a
//   run-time cluster dimension): rank r walks tiles r, r + 8, ... of the row block's
//   list, so the hub's long list is no tail and the cluster's CTAs (and the other
//   slabs of the row block) read neighbouring tiles at the same time, which the tile
//   stream needs (a CTA a contiguous part of the list ran slower on the card); the
//   8 partial slabs meet in shared memory at the end, rank r summing rows
//   [8r, 8r + 8) of the eight in rank order over distributed shared memory.
//   Otherwise a CTA walks its list alone and writes its slab from its registers.
//   Each of the CTA's 8 warps owns 8 tile rows and streams their strips on its own:
//   a strip is 8 rows x 256 bytes of one tile (64 f32, 128 bf16 or 256 int8 k), or
//   128 or 64 bytes where 256 does not divide a tile row's B * itemsize bytes (bf16
//   at B = 64, 192, ...; int8 at B = 64, 128, 192, 320, ...), so that every B with
//   B % 64 == 0 splits into whole strips.  A strip is copied in its stored type with
//   16-byte cp.async (a warp's copy covers whole rows) and an L2 evict-first hint
//   into a 4-stage ring of the warp's own, three strips ahead, so no warp waits on
//   another (__syncwarp only).  Each copied piece lands in the slot of the lane that
//   tests it: lane l holds a quarter of row l / 4 (64, 32 or 16 contiguous bytes).
//   For each strip the lanes test their bytes (nonzero_bits, after a test of the
//   whole 16 bytes), and an empty strip costs only its read and that test.  In a
//   nonempty one a warp scan of the lanes' popcounts gives every nonzero its place
//   in (row, k) order, and each row's first and last place go to shared memory.  Up
//   to a crossover count of nonzeros (the wrapper's spmm_crossover, measured on the
//   card) the sparse branch lists the (k, value) pairs in that order in the warp's
//   shared memory (ordered compaction, no atomics; in windows of 256) and walks them:
//   lane groups of G = 4..32 lanes, G the power of two that covers the slab's
//   columns at 4 (f32 x) or 8 (bf16 x) columns a lane, each hold G / 4 of the warp's
//   rows in f32 registers, and a group adds w * x[col_blk * B + k, its columns] for
//   each listed nonzero of its rows, row by row, four x rows in flight.  x comes
//   through L2 and L1 with 16-byte loads (f32 D % 4, bf16 D % 8, 16-byte-aligned x)
//   or scalar loads otherwise; for bf16 and int8 tiles the wrapper hands the kernel
//   x rounded to bf16 once a call (as x_operand rounds it), half the bytes of an f32
//   x.  A lane whose columns lie at or beyond D does nothing.  Above the crossover
//   the dense branch multiplies the strip as a block: for each k a lane loads its x
//   columns once (four k in flight) and adds w[row][k] * x into each of its rows,
//   the tile values read from the staged strip and widened once a k.  Both branches
//   add into the same registers in ascending k, so a row block may mix them and,
//   for finite x, the two give the same bits.  Every output row is written once,
//   without atomics, in a fixed summation order (for a given cluster size), zeros
//   where a row block has no tiles.
//   Arithmetic: int8 widens exactly, x is rounded to bf16 for bf16/int8 tiles, the
//   products are IEEE f32 FMAs (no TF32; exact for bf16 and int8 tiles) and the sums
//   f32: only the order of the f32 sum differs from the plain version.  Skipping
//   zero products changes no sum for finite x; an inf or NaN in x that meets only
//   zero tile entries (or only empty strips) does not reach the output, where the
//   dense product gives NaN.
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
// All kernels need B % 64 == 0 and launch on the caller's stream; each entry
// point returns cudaGetLastError() right after its launch, or
// cudaErrorInvalidValue for an unknown tile_kind.

#include <cooperative_groups.h>

#include "tile_dtypes.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tpg;

// B2's dense branch: 64 x 64 outputs a CTA, 4 x 4 a thread
constexpr int BM = 64;   // output rows per CTA
constexpr int BN = 64;   // output columns per CTA
constexpr int BK = 32;   // reduction chunk staged in shared memory
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int TX = BN / TN;            // 16 threads across columns
constexpr int THREADS = (BM / TM) * TX;  // 256

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

// ------------------------------------------------------------------ B1 / B3



constexpr unsigned FULL = 0xffffffffu;
constexpr int SROWS = 64;        // tile rows a CTA owns: 8 warps x 8 rows
constexpr int SCOLS = 128;       // columns of D a CTA owns
constexpr int MAX_CL = 8;        // CTAs of a cluster at most, sharing one slab's list
constexpr int NST = 4;           // ring stages of a warp
constexpr int STRIP = 2048;      // bytes of a strip at most: 8 rows x 256 bytes
constexpr int LIST_CAP = 256;    // listed nonzeros a warp holds at once
constexpr int PSTR = SCOLS + 4;  // floats of a partial-slab row in shared memory
// a warp's ring, its list of nonzeros, the column block of each stage and the
// list's bounds of each of its 8 rows
constexpr int WARP_BYTES = NST * STRIP + LIST_CAP * 8 + 16 + 64;
static_assert(NST >= 2 && NST <= 4, "cbs holds at most 4 stages");
constexpr int SPMM_SMEM = (THREADS / 32) * WARP_BYTES > SROWS * PSTR * 4
                              ? (THREADS / 32) * WARP_BYTES : SROWS * PSTR * 4;

// 4-byte asynchronous copy
__device__ __forceinline__ void cp4(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

// v = the CPL x entries at x[i .. i + CPL) (columns c .. c + CPL) as they enter a
// product with tiles of KIND; columns at or beyond d are not read
template <int KIND, bool X_BF16, bool VEC, int CPL>
__device__ __forceinline__ void load_x(const void* __restrict__ x, size_t i, int c, int d,
                                       float (&v)[CPL]) {
    if (VEC && X_BF16) {
        const uint4 q = __ldg((const uint4*)((const uint16_t*)x + i));
        const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
            v[2 * h] = __uint_as_float(w[h] << 16);
            v[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
        }
    } else if (VEC) {
        const float4 q = __ldg((const float4*)((const float*)x + i));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        if (KIND != F32)
#pragma unroll
            for (int h = 0; h < 4; ++h) v[h] = bf16_round(v[h]);
    } else {
#pragma unroll
        for (int h = 0; h < CPL; ++h)
            v[h] = c + h < d ? x_operand<KIND, X_BF16>(x, i + h) : 0.f;
    }
}

// a[h] += w * v[h] for this lane's columns inside D
template <bool VEC, int CPL>
__device__ __forceinline__ void fma_cols(float (&a)[CPL], float w, const float (&v)[CPL],
                                         int c, int d) {
#pragma unroll
    for (int h = 0; h < CPL; ++h)
        if (VEC || c + h < d) a[h] = fmaf(w, v[h], a[h]);
}

// request the next strip of a warp (strip ikc of tile it) into ring stage ist with
// 16-byte cp.async (evict-first), and its tile's column block into cbs[ist]; one
// commit group a call, empty once no strip is left.  Copy j of lane l moves piece
// q = 32 j + l of the strip (row q / (4 nl), piece p = q % (4 nl) of the row), so a
// warp's copy covers whole rows; the piece lands in the slot of the lane that reads
// it, (p % nl) * 32 + row * 4 + p / nl.
template <int NSTAGES>
__device__ __forceinline__ void request(const unsigned char* src0, size_t row_stride,
                                        size_t tile_bytes, int row_bytes, int nl, int nl_sh,
                                        int kc_n, uint32_t ring_s, uint32_t cbs_s,
                                        const int32_t* col_blk, uint64_t policy, int lane,
                                        int step, int& it, int& ikc, int& ist, int& left) {
    if (left > 0) {
        const unsigned char* src = src0 + it * tile_bytes + ikc * row_bytes;
        const uint32_t dst = ring_s + ist * STRIP;
        for (int j = 0; j < nl; ++j) {
            const int q = j * 32 + lane, row = q >> (nl_sh + 2), p = q & (4 * nl - 1);
            cp16_evict_first(dst + (((p & (nl - 1)) << 5) + row * 4 + (p >> nl_sh)) * 16,
                             src + row * row_stride + p * 16, policy);
        }
        if (lane == 0) cp4(cbs_s + ist * 4, col_blk + it);
        if (++ikc == kc_n) ikc = 0, it += step;
        if (++ist == NSTAGES) ist = 0;
        --left;
    }
    cp_commit();
}

template <int KIND, bool X_BF16, bool OUT_BF16, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
spmm_bcsr_kernel(const void* __restrict__ tiles, const int32_t* __restrict__ col_blk,
                 const int32_t* __restrict__ row_ptr, const void* __restrict__ x,
                 void* __restrict__ y, int block, int d, int crossover) {
    using T = tile_t<KIND>;
    constexpr int ISZ = sizeof(T);
    constexpr int EPL = 16 / ISZ;        // tile entries of a 16-byte piece
    constexpr int CPL = X_BF16 ? 8 : 4;  // columns of D a lane covers
    constexpr int MAXR = 32 / CPL;       // rows a lane holds at most (at G = 128 / CPL)
    extern __shared__ __align__(16) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int subs = block / SROWS;
    const int cl = (int)cluster.num_blocks();  // 1, 2, 4 or 8 (the launch's cluster size)
    const int slab = blockIdx.x / cl;
    const int rank = (int)cluster.block_rank();
    const int rb = slab / subs;
    const int s0 = (slab % subs) * SROWS;  // the slab's first tile row
    const int n0 = blockIdx.y * SCOLS;
    const int cols = min(d - n0, SCOLS);

    // lane groups of G lanes, CPL columns a lane: group gi holds the warp's rows
    // gi + i * ng, i < G / 4
    int G = 4;
    while (G * CPL < cols) G <<= 1;
    const int ng = 32 / G, ng_sh = __ffs(ng) - 1, gi = lane / G, rpg = G / 4;
    const int c0 = n0 + (lane % G) * CPL;  // this lane's first column
    const bool live = c0 < d;

    // strips: 8 rows x row_bytes of one tile, row_bytes the largest of 256, 128
    // and 64 that divides a tile row's B * ISZ bytes (B % 64 == 0: 64 always does),
    // so a tile row is kc_n whole strips for any such B; lane l copies nl 16-byte
    // pieces of row l / 4 (64, 32 or 16 contiguous bytes)
    const int tile_row_bytes = block * ISZ;
    const int row_bytes = tile_row_bytes % 256 == 0 ? 256 : tile_row_bytes % 128 == 0 ? 128 : 64;
    const int nl = row_bytes / 64, nl_sh = __ffs(nl) - 1;  // 1, 2 or 4
    const int kc_n = tile_row_bytes / row_bytes;           // strips of a tile row, exact
    const int kw = row_bytes / ISZ;                        // k of a strip
    const int e_lo = row_ptr[rb], len = row_ptr[rb + 1] - e_lo;
    // rank r takes tiles r, r + cl, r + 2 cl, ... of the list: the cluster's CTAs
    // read neighbouring tiles at the same time
    const int t_lo = e_lo + rank, step = cl;
    const int n_strips = (len > rank ? (len - rank + cl - 1) / cl : 0) * kc_n;

    unsigned char* ring = smem + warp * WARP_BYTES;
    int* list = (int*)(ring + NST * STRIP);  // (value bits, k) pairs
    int* cbs = list + 2 * LIST_CAP;
    int* bounds = cbs + 4;  // [2 * r, 2 * r + 1]: row r's first and last + 1 entry
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
    const size_t tile_bytes = (size_t)block * block * ISZ;
    const size_t row_stride = (size_t)block * ISZ;  // bytes of a tile row
    const unsigned char* src0 = (const unsigned char*)tiles + (s0 + warp * 8) * row_stride;
    const uint32_t ring_s = smem_u32(ring), cbs_s = smem_u32(cbs);

    float acc[MAXR][CPL];
#pragma unroll
    for (int i = 0; i < MAXR; ++i)
#pragma unroll
        for (int h = 0; h < CPL; ++h) acc[i][h] = 0.f;

    // the strips in order: the next requested is strip ikc of tile it, into stage
    // ist (and the tile's column block into cbs[ist]), NST - 1 ahead of the one in use
    int it = t_lo, ikc = 0, ist = 0, left = n_strips;
    for (int j = 0; j < NST - 1; ++j)
        request<NST>(src0, row_stride, tile_bytes, row_bytes, nl, nl_sh, kc_n, ring_s, cbs_s,
                     col_blk, policy, lane, step, it, ikc, ist, left);
    // cst: the stage of strip s; ck: its strip column (strip ck of its tile's row)
    for (int s = 0, cst = 0, ck = 0; s < n_strips;
         ++s, cst = cst == NST - 1 ? 0 : cst + 1, ck = ck == kc_n - 1 ? 0 : ck + 1) {
        cp_wait<NST - 2>();  // strip s has landed (in stage cst)
        __syncwarp();        // and every lane has left strip s - 1's stage
        request<NST>(src0, row_stride, tile_bytes, row_bytes, nl, nl_sh, kc_n, ring_s, cbs_s,
                     col_blk, policy, lane, step, it, ikc, ist, left);
        const unsigned char* st = ring + cst * STRIP;
        uint64_t bits = 0;  // bit j * EPL + e: entry e of this lane's piece j
        for (int j = 0; j < nl; ++j) {
            const uint4 v = *(const uint4*)(st + (j * 32 + lane) * 16);
            if (v.x | v.y | v.z | v.w)
                bits |= (uint64_t)nonzero_bits<KIND>(v) << (j * EPL);
        }
        if (__any_sync(FULL, bits != 0)) {
            const int c = __popcll(bits);
            int incl = c;  // nonzeros of lanes 0..lane: (row, k) order is (lane, bit) order
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int v = __shfl_up_sync(FULL, incl, o);
                if (lane >= o) incl += v;
            }
            const int total = __shfl_sync(FULL, incl, 31);
            const int excl = incl - c;
            if ((lane & 3) == 0) bounds[(lane >> 2) * 2] = excl;
            if ((lane & 3) == 3) bounds[(lane >> 2) * 2 + 1] = incl;
            // the x row of the strip's k = 0
            const size_t xrow = (size_t)cbs[cst] * block + ck * kw;
            if (total > crossover) {
                // dense branch: the strip as a block, each x row loaded once for the
                // lane's rows, four x rows in flight
                if (live) {
                    for (int k = 0; k < kw; k += 4) {
                        float v[4][CPL];
#pragma unroll
                        for (int u = 0; u < 4; ++u)
                            load_x<KIND, X_BF16, VEC, CPL>(x, (xrow + k + u) * d + c0, c0, d,
                                                           v[u]);
                        const int kp = k / EPL;  // piece of k..k+3 in a row: lane row*4 + kp/nl
                        const int off = (k % EPL) * ISZ;
#pragma unroll
                        for (int i = 0; i < MAXR; ++i) {
                            if (i < rpg) {
                                const int r = gi + (i << ng_sh);
                                const unsigned char* w =
                                    st + (((kp & (nl - 1)) << 5) + r * 4 + (kp >> nl_sh)) * 16 +
                                    off;
#pragma unroll
                                for (int u = 0; u < 4; ++u)
                                    fma_cols<VEC, CPL>(acc[i], tile_elem<KIND>(w, u), v[u], c0,
                                                       d);
                            }
                        }
                    }
                }
            } else {
                // sparse branch: list the nonzeros in (row, k) order, then each group
                // walks the entries of its rows, four x rows in flight
                const int kb = (lane & 3) * nl * EPL;  // k of this lane's first entry
                for (int w0 = 0; w0 < total; w0 += LIST_CAP) {
                    int o = excl - w0;
                    for (uint64_t b = bits; b && o < LIST_CAP; b &= b - 1, ++o) {
                        if (o < 0) continue;
                        const int bit = __ffsll((long long)b) - 1;
                        list[2 * o] = __float_as_int(
                            tile_elem<KIND>(st + ((bit / EPL) * 32 + lane) * 16, bit % EPL));
                        list[2 * o + 1] = kb + bit;
                    }
                    __syncwarp();
#pragma unroll
                    for (int i = 0; i < MAXR; ++i) {
                        if (i < rpg) {
                            const int2 b2 = *(const int2*)(bounds + 2 * (gi + (i << ng_sh)));
                            const int lo = max(b2.x, w0) - w0;
                            const int hi = min(b2.y, w0 + LIST_CAP) - w0;
                            if (live) {
                                for (int e = lo; e < hi; e += 4) {
                                    float v[4][CPL], w[4];
#pragma unroll
                                    for (int u = 0; u < 4; ++u) {
                                        if (e + u < hi) {
                                            const int2 z = *(const int2*)(list + 2 * (e + u));
                                            w[u] = __int_as_float(z.x);
                                            load_x<KIND, X_BF16, VEC, CPL>(
                                                x, (xrow + z.y) * d + c0, c0, d, v[u]);
                                        }
                                    }
#pragma unroll
                                    for (int u = 0; u < 4; ++u)
                                        if (e + u < hi)
                                            fma_cols<VEC, CPL>(acc[i], w[u], v[u], c0, d);
                                }
                            }
                        }
                    }
                    __syncwarp();  // the list is free for the next window
                }
            }
        }
    }
    cp_wait<0>();
    const size_t ybase = (size_t)rb * block + s0;
    if (cl == 1) {  // the slab is this CTA's alone: write it from the registers
        if (live) {
#pragma unroll
            for (int i = 0; i < MAXR; ++i) {
                if (i < rpg) {
                    const size_t yi = (ybase + warp * 8 + gi + (i << ng_sh)) * d + c0;
#pragma unroll
                    for (int h = 0; h < CPL; ++h)
                        if (c0 + h < d) store_out<OUT_BF16>(y, yi + h, acc[i][h]);
                }
            }
        }
        return;
    }
    __syncthreads();  // every warp has left its ring: it holds the partial slab now
    float* part = (float*)smem;
    if (live) {
#pragma unroll
        for (int i = 0; i < MAXR; ++i) {
            if (i < rpg) {
                float* p = part + (warp * 8 + gi + (i << ng_sh)) * PSTR + (c0 - n0);
#pragma unroll
                for (int h = 0; h < CPL; ++h) p[h] = acc[i][h];
            }
        }
    }
    cluster.sync();
    // rank r sums rows [r * 64 / cl, (r + 1) * 64 / cl) of the cl partial slabs, in
    // rank order
    const float* parts[MAX_CL];
#pragma unroll
    for (int q = 0; q < MAX_CL; ++q) parts[q] = cluster.map_shared_rank(part, q < cl ? q : 0);
    const int rows = SROWS / cl;
    for (int i = tid; i < rows * SCOLS; i += THREADS) {
        const int row = rows * rank + i / SCOLS, col = i % SCOLS;
        if (col < cols) {
            float sum = parts[0][row * PSTR + col];
#pragma unroll
            for (int q = 1; q < MAX_CL; ++q)
                if (q < cl) sum += parts[q][row * PSTR + col];
            store_out<OUT_BF16>(y, (ybase + row) * d + n0 + col, sum);
        }
    }
    cluster.sync();  // no CTA leaves while another reads its slab
}

template <int KIND, bool X_BF16, bool OUT_BF16, bool VEC>
int launch_spmm(const void* tiles, const void* col_blk, const void* row_ptr, const void* x,
                void* y, int n_row_blocks, int block, int d, int crossover, int cl,
                cudaStream_t st) {
    auto kern = spmm_bcsr_kernel<KIND, X_BF16, OUT_BF16, VEC>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SPMM_SMEM);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_row_blocks * (block / SROWS) * cl, (d + SCOLS - 1) / SCOLS);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SPMM_SMEM;
    cfg.stream = st;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cl;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kern, tiles, (const int32_t*)col_blk,
                             (const int32_t*)row_ptr, x, y, block, d, crossover);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y[n_row_blocks * block, d] = A @ x, for B1 and for B3's padded layout.  A warp's
// strip with more than `crossover` nonzeros takes the dense branch (-1: every
// nonempty strip dense; 2048 or more: every strip sparse).  `cluster` CTAs (1, 2,
// 4 or 8) share each slab's tile list.
int spmm_bcsr(const void* tiles, int tile_kind, const void* col_blk, const void* row_ptr,
              const void* x, int x_bf16, void* y, int out_bf16, int n_row_blocks, int block,
              int d, int crossover, int cluster, void* stream) {
    if (n_row_blocks == 0 || d == 0) return (int)cudaSuccess;
    if (block % SROWS || (uintptr_t)tiles % 16 || cluster < 1 || cluster > MAX_CL ||
        (cluster & (cluster - 1)))
        return (int)cudaErrorInvalidValue;
    const bool vec = (uintptr_t)x % 16 == 0 && d % (x_bf16 ? 8 : 4) == 0;
    int err = (int)cudaSuccess;
    const bool known = dispatch(tile_kind, x_bf16, out_bf16, [&](auto k, auto xb, auto ob) {
        constexpr int K = decltype(k)::value;
        constexpr bool XB = decltype(xb)::value, OB = decltype(ob)::value;
        err = vec ? launch_spmm<K, XB, OB, true>(tiles, col_blk, row_ptr, x, y, n_row_blocks,
                                                 block, d, crossover, cluster,
                                                 (cudaStream_t)stream)
                  : launch_spmm<K, XB, OB, false>(tiles, col_blk, row_ptr, x, y,
                                                  n_row_blocks, block, d, crossover, cluster,
                                                  (cudaStream_t)stream);
    });
    return known ? err : (int)cudaErrorInvalidValue;
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

}  // extern "C"
