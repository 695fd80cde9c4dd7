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
// One phase does all the work: y[R*B, D] = scale * (A @ src) over one inverse
// index, with the dtype rules of tile_dtypes.cuh (src is f32 or bf16).  The TPU
// kernels keep x and the whole output resident in ~110 MB of VMEM and let every
// stack read-modify-write its rows in any order.  Hopper has no such memory, so
// ownership is inverted: a CTA owns a slab of y and walks the inverse-index list
// of (stack, lane) slices that land in its row block.  No atomics: the summation
// order is fixed, and every output row is written, zeros where no slice lands.
// The epilogue multiplies by scale in f32 and rounds once if the output is bf16.
// The phase kernel is chosen by tile kind:
//
//   bf16, int8 and int4 tiles: tensor cores (spmm_phase_mma).  The TPU kernel
//   widens these tiles to bf16, rounds x to bf16 and runs an f32-accumulating dot
//   (pallas_resident.py:255-268); mma.sync.m16n8k16 bf16 x bf16 -> f32 forms the
//   same products exactly, and only the order of the f32 sum differs.  x arrives
//   as bf16 (the wrapper rounds an f32 x once a call, nearest even, as x_operand
//   does).  A slab of y is (row block, 128 rows, 128 columns of D), and a cluster
//   of 4 CTAs shares it: CTA r walks the r-th quarter of the slab's inverse-index
//   list, so a hub row block's long list (311 entries against a mean of 82 on the
//   65,536-node power-law graph) is no tail.  A CTA's 8 warps hold 32 x 64 each
//   of its f32 partial in registers; at the end the 4 partials meet in shared
//   memory and CTA r sums rows [32r, 32r + 32) of all four, in rank order, over
//   distributed shared memory, scales, rounds once and writes them.  The work of
//   a CTA is chunks (entry, 64 columns of the tile): cp.async (16-byte loads, 4
//   stages; 3 for bf16 tiles) brings the tile strip [128, 64] in its stored type
//   (8 KB for int8; with an evict-first L2 hint, since every tile byte is read
//   once) and the matching 64 rows of x.  Each lane widens its tile bytes to bf16
//   in registers (int8: bf16(128 + (b & 127)) - (128 or 256), exact; int4:
//   bf16(128 + nibble) - 128), and the x fragments come from ldmatrix.trans.  The
//   k of each 32-column half are permuted so that a lane's 8 k-values of a row are
//   8 adjacent bytes (one 64-bit load for int8), and the x rows follow by their
//   ldmatrix addresses; the x rows are XOR-swizzled in shared memory so those
//   addresses hit distinct banks.  A ragged D or an x that is not 16-byte aligned
//   takes scalar loads into a double buffer.  A warp skips the MMAs of a 16 x 16
//   tile fragment that is all zero in every lane (the tiles are ~0.15% full);
//   skipping exact zero products leaves the f32 sums as they are for finite x (an
//   inf or NaN in x that meets only zero tile entries does not reach the output,
//   where the dense product would give NaN).
//   Bound on the H100: bytes at these densities.  Every tile byte is read once
//   (1.38 GB of int8 tiles on the 65,536-node power-law graph, 0.41 ms at 3.35
//   TB/s), x and y once; the useful work is 2*nnz*D operations.  The dense MMAs
//   the tiles imply (2*T*B^2*D = 353 GFLOP there, ~0.36 ms at the dense bf16 rate)
//   sit below the byte time, so the design streams the tiles in their stored
//   type, keeps x in the 50 MB L2 (tiles bypass it as far as the hint does), and
//   drops the MMAs of all-zero fragments.  Needs B % 128 == 0.
//
//   f32 tiles: scalar IEEE f32 FMA (spmm_phase_f32), the TPU's f32 jnp.dot
//   semantics; tensor cores would round the tiles (TF32, or 3xTF32 later).  A CTA
//   owns (row block, 64 rows, 64 columns of D) and stages 64x32 of the tile and
//   32x64 of src in shared memory per step, 4x4 outputs a thread.  Needs
//   B % 64 == 0.  No path of the port's smoke reaches it; it is the f32 contract.
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
// spmm_stacked_ablation runs the tensor-core phase (int8 tiles, f32 output) in a
// diagnostic mode, the counterpart of bench_resident_diag2.py's variants: 1
// dmaonly (the tile strips stream in, no x, no MMA; the output is written with a
// token), 2 nodot (tile strips and x stream in, no fragments and no MMA), 3
// noconvert (the same bytes and MMAs, the tile bytes go into the MMA
// as they are, masked to finite bf16 patterns, without the int8 widening).
//
// Launches on the caller's stream and returns cudaGetLastError() after the
// launches (the first error stops the sequence), or cudaErrorInvalidValue for an
// unknown tile kind, mode or block size.

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "tile_dtypes.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tpg;

// ------------------------------------------------------------ f32 tiles (scalar)

constexpr int SBM = 64;
constexpr int SBN = 64;
constexpr int SBK = 32;
constexpr int STM = 4;
constexpr int STN = 4;
constexpr int STX = SBN / STN;
constexpr int STHREADS = (SBM / STM) * STX;  // 256

template <bool X_BF16, bool OUT_BF16>
__global__ void __launch_bounds__(STHREADS)
spmm_phase_f32(const float* __restrict__ tiles, const int32_t* __restrict__ col_blk,
               const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ slots,
               const void* __restrict__ src, void* __restrict__ y, float scale, int block,
               int stack, int d) {
    __shared__ float As[SBK][SBM + 1];
    __shared__ float Xs[SBK][SBN];
    const int subs = block / SBM;
    const int rb = blockIdx.x / subs;
    const int m0 = (blockIdx.x % subs) * SBM;
    const int n0 = blockIdx.y * SBN;
    const int tid = threadIdx.x;
    const int tx = tid % STX, ty = tid / STX;

    float acc[STM][STN];
#pragma unroll
    for (int i = 0; i < STM; ++i)
#pragma unroll
        for (int j = 0; j < STN; ++j) acc[i][j] = 0.f;

    for (int e = row_ptr[rb]; e < row_ptr[rb + 1]; ++e) {
        const int flat = slots[e];
        const size_t row0 = (size_t)flat * block + m0;  // first tile row
        const size_t xrow0 = (size_t)col_blk[flat / stack] * block;
        for (int k0 = 0; k0 < block; k0 += SBK) {
            for (int i = tid; i < SBM * SBK; i += STHREADS) {
                const int m = i / SBK, k = i % SBK;
                As[k][m] = tiles[(row0 + m) * block + k0 + k];
            }
            for (int i = tid; i < SBK * SBN; i += STHREADS) {
                const int k = i / SBN, n = i % SBN;
                Xs[k][n] = (n0 + n < d)
                    ? x_operand<F32, X_BF16>(src, (xrow0 + k0 + k) * d + n0 + n) : 0.f;
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < SBK; ++k) {
                float a[STM], b[STN];
#pragma unroll
                for (int i = 0; i < STM; ++i) a[i] = As[k][ty + i * (SBM / STM)];
#pragma unroll
                for (int j = 0; j < STN; ++j) b[j] = Xs[k][tx + j * STX];
#pragma unroll
                for (int i = 0; i < STM; ++i)
#pragma unroll
                    for (int j = 0; j < STN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
            __syncthreads();
        }
    }
    const size_t base = ((size_t)rb * block + m0) * d;
#pragma unroll
    for (int i = 0; i < STM; ++i)
#pragma unroll
        for (int j = 0; j < STN; ++j) {
            const int n = n0 + tx + j * STX;
            if (n < d)
                store_out<OUT_BF16>(y, base + (size_t)(ty + i * (SBM / STM)) * d + n,
                                    acc[i][j] * scale);
        }
}

// ----------------------------------------------- bf16 / int8 / int4 tiles (MMA)

constexpr int BM = 128;      // tile rows a CTA owns
constexpr int BN = 128;      // columns of D a CTA owns
constexpr int BK = 32;       // tile columns (k) of a sub-chunk; a chunk is two
constexpr int CL = 4;        // CTAs of a cluster, sharing one slab's list
constexpr int THREADS = 256; // 8 warps: 4 along the rows x 2 along D, 32 x 64 each
constexpr int XROW = BN * 2;          // bytes of one bf16 x row in shared memory
constexpr int X_SUB = BK * XROW;      // one sub-chunk of bf16 x (8 KB)
constexpr int PSTRIDE = BN + 8;       // floats of a partial-slab row in shared memory
constexpr int PART_BYTES = BM * PSTRIDE * 4;
constexpr int MAX_ENTRIES = 1024;     // entries of a CTA's list kept in shared memory

enum Mode { FULL = 0, DMAONLY = 1, NODOT = 2, NOCONVERT = 3 };

template <int KIND, bool XV>
struct Geometry {
    // shared-memory bytes of one row of a sub-chunk's tile strip (32 k)
    static constexpr int AROW = KIND == BF16 ? 64 : KIND == INT8 ? 32 : 16;
    static constexpr int A_SUB = BM * AROW;
    static constexpr int A_STAGE = 2 * A_SUB;
    static constexpr int X_STAGE = 2 * X_SUB;
    // cp.async stages: 4, or 3 where a stage of bf16 tiles is larger
    static constexpr int NST = A_STAGE + X_STAGE <= 24 * 1024 ? 4 : 3;
    // the ring (x in it when XV, else in a double buffer of scalar loads)
    static constexpr int RING = NST * (A_STAGE + (XV ? X_STAGE : 0)) + (XV ? 0 : 2 * X_STAGE);
    // the CTA's entries (slot, column block) follow the ring or the partial slab
    static constexpr int IDX_OFF = RING > PART_BYTES ? RING : PART_BYTES;
    static constexpr int SMEM = IDX_OFF + MAX_ENTRIES * 8;
};

// XOR swizzle of the 16-byte segments of x row p: the 8 rows one ldmatrix
// matrix reads ({0,1,8,9,16,17,24,25} + 2q) land on 8 distinct bank groups
__device__ __forceinline__ int swz(int p) { return (p & 1) | ((p >> 2) & 6); }

// x row (within the column block) of shared-memory x row p of sub-chunk kc: p =
// 8c + s is k-slot s of lane group c.  int8/bf16: tile column 32kc + p.  int4: byte
// column 16kc + 4c + (s & 3), its low nibble for s < 4, its high (B/2 on) else
template <int KIND>
__device__ __forceinline__ int xrow_off(int p, int kc, int block) {
    if (KIND == INT4) {
        const int c = p >> 3, s = p & 7;
        return kc * 16 + 4 * c + (s & 3) + (s >= 4 ? block / 2 : 0);
    }
    return kc * BK + p;
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
                 : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
    __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                               *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<uint32_t*>(&r);
}

// two int8 bytes of w (sel 0x4140: bytes 0, 1; 0x4342: bytes 2, 3) as bf16x2,
// exactly: bf16 bits 0x43 | (b & 127) are 128 + (b & 127); subtracting 128, or 256
// when b's sign bit is set (bits 0x4380), leaves b
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w, uint32_t sel) {
    const uint32_t t = __byte_perm(w, 0x43434343u, sel);
    return bf16x2_sub(t & 0xFF7FFF7Fu, t & 0xFF80FF80u);
}

// two nibbles (bytes of nib in [0, 15]) as bf16x2: bf16(128 + u) - 128, exactly
__device__ __forceinline__ uint32_t u4x2_bf16(uint32_t nib, uint32_t sel) {
    return bf16x2_sub(__byte_perm(nib, 0x43434343u, sel), 0x43004300u);
}

// a lane's stored tile bytes of one sub-chunk: k-slots 8c..8c+7 of rows g (w) and
// g + 8 (v) of each of its warp's two 16-row tiles
template <int KIND>
struct Raw {
    using T = std::conditional_t<KIND == BF16, uint4, std::conditional_t<KIND == INT8, uint2,
                                                                              uint32_t>>;
    T w[2], v[2];
};

template <int KIND, bool XV, bool OUT_BF16, int MODE>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS, 2)
spmm_phase_mma(const unsigned char* __restrict__ tiles, const int32_t* __restrict__ col_blk,
               const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ slots,
               const uint16_t* __restrict__ src, void* __restrict__ y, float scale,
               int block, int stack, int d) {
    using G = Geometry<KIND, XV>;
    constexpr int NST = G::NST;
    constexpr bool STAGE_X = MODE != DMAONLY;
    constexpr bool DOT = MODE == FULL || MODE == NOCONVERT;
    extern __shared__ __align__(128) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    unsigned char* As = smem;
    unsigned char* Xs = smem + NST * G::A_STAGE;  // x ring (XV) or double buffer

    const int subs = block / BM;
    const int slab = blockIdx.x / CL;
    const int rank = (int)cluster.block_rank();
    const int rb = slab / subs;
    const int m0 = (slab % subs) * BM;
    const int n0 = blockIdx.y * BN;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp & 3, wn = warp >> 2;
    const int g = lane >> 2, c = lane & 3;
    const int kcs = block / (2 * BK);  // chunks of an entry
    // this CTA's piece of the slab's list: rank r of CL takes [len*r/CL, len*(r+1)/CL)
    const int e_lo = row_ptr[rb], len = row_ptr[rb + 1] - e_lo;
    const int e0 = e_lo + len * rank / CL;
    const int n_chunks = (e_lo + len * (rank + 1) / CL - e0) * kcs;
    const size_t grow = (size_t)block * G::AROW / BK;  // bytes of one stored tile row
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));

    // this lane's ldmatrix row: matrix q = lane / 8 holds B's k-slots 2q, 2q + 1
    // of each lane group (b0, b1 of the first k16 step, then of the second)
    const int lq = lane >> 3, lr = lane & 7;
    const int xp = 8 * (lr >> 1) + 2 * lq + (lr & 1);
    const uint32_t xp_off = xp * XROW;
    const int xp_sw = swz(xp);

    // the CTA's entries as (flat slot, column block): in shared memory up to
    // MAX_ENTRIES, so that a chunk's loads wait on no index load
    int2* ent = (int2*)(smem + G::IDX_OFF);
    for (int i = tid; i < min(n_chunks / kcs, MAX_ENTRIES); i += THREADS) {
        const int f = slots[e0 + i];
        ent[i] = make_int2(f, col_blk[f / stack]);
    }
    __syncthreads();
    auto entry = [&](int i) {
        if (i < MAX_ENTRIES) return ent[i];
        const int f = slots[e0 + i];
        return make_int2(f, col_blk[f / stack]);
    };

    // x rows a sub-chunk advances by: xrow_off(p, 2 kc + h) = xrow_off(p, h) + 2 kc * KROWS
    constexpr int KROWS = KIND == INT4 ? 16 : BK;
    // issue() requests the chunks in order: its next is chunk ikc of entry ie,
    // into ring stage ist
    int ie = 0, ikc = 0, ist = 0;
    auto issue = [&](int j) {
        if (j < n_chunks) {
            const int2 en = entry(ie);
            const unsigned char* a_src =
                tiles + ((size_t)en.x * block + m0) * grow + 2 * ikc * G::AROW;
            const uint32_t a_dst = smem_u32(As + ist * G::A_STAGE);
            constexpr unsigned APR = G::AROW / 16;  // 16-byte pieces of a sub-chunk's row
#pragma unroll
            for (unsigned i = tid; i < G::A_STAGE / 16; i += THREADS) {
                const unsigned r = i / (2 * APR), h = (i / APR) & 1, q = i % APR;
                cp16_evict_first(a_dst + h * G::A_SUB + r * G::AROW + q * 16,
                                 a_src + r * grow + h * G::AROW + q * 16, policy);
            }
            if (XV && STAGE_X) {
                const uint16_t* xb = src + ((size_t)en.y * block + 2 * ikc * KROWS) * d;
                const uint32_t x_dst = smem_u32(Xs + ist * G::X_STAGE);
                const unsigned q = tid & 15;  // 16-byte piece q of rows p of each half
                const int col = n0 + 8 * q;
                const bool in = col < d;
#pragma unroll
                for (unsigned t = 0; t < 2 * BK * 16 / THREADS; ++t) {
                    const unsigned h = t >> 1, p = (tid >> 4) + 16 * (t & 1);
                    cp16(x_dst + h * X_SUB + p * XROW + ((q ^ swz(p)) << 4),
                         in ? xb + (size_t)xrow_off<KIND>(p, h, block) * d + col : src,
                         in ? 16 : 0);
                }
            }
            if (++ikc == kcs) ikc = 0, ++ie;
            if (++ist == NST) ist = 0;
        }
        cp_commit();
    };

    // x of the next chunk by scalar loads (a ragged D or an unaligned x) into
    // buffer j & 1; in chunk order, like issue()
    int le = 0, lkc = 0;
    auto load_scalar = [&](int j) {
        const uint16_t* xb = src + ((size_t)entry(le).y * block + 2 * lkc * KROWS) * d;
        unsigned char* b = Xs + (j & 1) * G::X_STAGE;
        for (unsigned i = tid; i < 2 * BK * BN; i += THREADS) {
            const unsigned h = i / (BK * BN), p = (i / BN) % BK, col = i % BN;
            const int n = n0 + col;
            const uint16_t v = n < d ? xb[(size_t)xrow_off<KIND>(p, h, block) * d + n] : 0;
            *(uint16_t*)(b + h * X_SUB + p * XROW + (((col >> 3) ^ swz(p)) << 4) +
                         (col & 7) * 2) = v;
        }
        if (++lkc == kcs) lkc = 0, ++le;
    };

    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[mi][nt][v] = 0.f;

    // this warp's 8-column tiles of D that hold columns below d
    const int live_nt = min(8, max(0, (d - n0 - wn * 64 + 7) / 8));

    // this lane's bytes of one sub-chunk's tile strip a [128, 32 k]
    auto load_raw = [&](const unsigned char* a) {
        Raw<KIND> raw;
        using T = typename Raw<KIND>::T;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
            const int r = wm * 32 + mi * 16 + g;
            raw.w[mi] = *(const T*)(a + r * G::AROW + c * sizeof(T));
            raw.v[mi] = *(const T*)(a + (r + 8) * G::AROW + c * sizeof(T));
        }
        return raw;
    };

    // one sub-chunk's MMAs: the tile bytes raw, x at shared address xs [32 k, 128]
    auto compute_sub = [&](const Raw<KIND>& raw, uint32_t xs) {
        // A fragments [mi][k16 step][reg]: lane (g, c) holds k-slots 8c..8c+7 of
        // rows g and g + 8 of the warp's two 16-row tiles; live[mi][s]: fragment
        // (mi, s) is nonzero in some lane of the warp
        uint32_t af[2][2][4];
        bool live[2][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
            const auto w = raw.w[mi], v = raw.v[mi];
            if constexpr (KIND == INT8) {
                if (MODE == NOCONVERT) {  // the bytes as they are, finite patterns
                    const uint32_t m = 0x3F3F3F3Fu;
                    live[mi][0] = live[mi][1] = true;
                    af[mi][0][0] = af[mi][1][0] = w.x & m;
                    af[mi][0][1] = af[mi][1][1] = v.x & m;
                    af[mi][0][2] = af[mi][1][2] = w.y & m;
                    af[mi][0][3] = af[mi][1][3] = v.y & m;
                } else {
                    live[mi][0] = __any_sync(0xFFFFFFFFu, (w.x | v.x) != 0);
                    live[mi][1] = __any_sync(0xFFFFFFFFu, (w.y | v.y) != 0);
                    if (live[mi][0]) {
                        af[mi][0][0] = i8x2_bf16(w.x, 0x4140);
                        af[mi][0][1] = i8x2_bf16(v.x, 0x4140);
                        af[mi][0][2] = i8x2_bf16(w.x, 0x4342);
                        af[mi][0][3] = i8x2_bf16(v.x, 0x4342);
                    }
                    if (live[mi][1]) {
                        af[mi][1][0] = i8x2_bf16(w.y, 0x4140);
                        af[mi][1][1] = i8x2_bf16(v.y, 0x4140);
                        af[mi][1][2] = i8x2_bf16(w.y, 0x4342);
                        af[mi][1][3] = i8x2_bf16(v.y, 0x4342);
                    }
                }
            } else if constexpr (KIND == BF16) {
                live[mi][0] = __any_sync(0xFFFFFFFFu, (w.x | w.y | v.x | v.y) != 0);
                live[mi][1] = __any_sync(0xFFFFFFFFu, (w.z | w.w | v.z | v.w) != 0);
                af[mi][0][0] = w.x; af[mi][0][1] = v.x; af[mi][0][2] = w.y; af[mi][0][3] = v.y;
                af[mi][1][0] = w.z; af[mi][1][1] = v.z; af[mi][1][2] = w.w; af[mi][1][3] = v.w;
            } else {  // INT4: low nibbles are k-slots 0-3, high nibbles 4-7
                const uint32_t wl = w & 0x0F0F0F0Fu, vl = v & 0x0F0F0F0Fu;
                const uint32_t wh = (w >> 4) & 0x0F0F0F0Fu, vh = (v >> 4) & 0x0F0F0F0Fu;
                live[mi][0] = __any_sync(0xFFFFFFFFu, (wl | vl) != 0);
                live[mi][1] = __any_sync(0xFFFFFFFFu, (wh | vh) != 0);
                if (live[mi][0]) {
                    af[mi][0][0] = u4x2_bf16(wl, 0x4140);
                    af[mi][0][1] = u4x2_bf16(vl, 0x4140);
                    af[mi][0][2] = u4x2_bf16(wl, 0x4342);
                    af[mi][0][3] = u4x2_bf16(vl, 0x4342);
                }
                if (live[mi][1]) {
                    af[mi][1][0] = u4x2_bf16(wh, 0x4140);
                    af[mi][1][1] = u4x2_bf16(vh, 0x4140);
                    af[mi][1][2] = u4x2_bf16(wh, 0x4342);
                    af[mi][1][3] = u4x2_bf16(vh, 0x4342);
                }
            }
        }
        if (!(live[0][0] || live[0][1] || live[1][0] || live[1][1])) return;  // warp-uniform
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            if (nt >= live_nt) break;
            uint32_t b0, b1, b2, b3;
            ldsm_x4_trans(xs + xp_off + (((wn * 8 + nt) ^ xp_sw) << 4), b0, b1, b2, b3);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                if (live[mi][0]) mma_bf16(acc[mi][nt], af[mi][0], b0, b1);
                if (live[mi][1]) mma_bf16(acc[mi][nt], af[mi][1], b2, b3);
            }
        }
    };

    // NST-stage pipeline over the chunks: chunk i + NST - 1 is requested while
    // chunk i is multiplied (scalar x: chunk i + 1 loaded before it)
#pragma unroll
    for (int j = 0; j < NST - 1; ++j) issue(j);
    if (!XV && STAGE_X && n_chunks > 0) load_scalar(0);
    for (int i = 0, cst = 0; i < n_chunks; ++i, cst = cst == NST - 1 ? 0 : cst + 1) {
        cp_wait<NST - 2>();  // chunk i has landed (in stage cst)
        __syncthreads();
        issue(i + NST - 1);
        if (!XV && STAGE_X && i + 1 < n_chunks) load_scalar(i + 1);
        if (DOT) {
            const unsigned char* a = As + cst * G::A_STAGE;
            const uint32_t xs = smem_u32(Xs + (XV ? cst : i & 1) * G::X_STAGE);
            compute_sub(load_raw(a), xs);
            compute_sub(load_raw(a + G::A_SUB), xs + X_SUB);
        }
    }
    cp_wait<0>();
    __syncthreads();  // the ring is free: it holds this CTA's partial slab now
    if (!DOT && n_chunks > 0)  // the token: one byte of the last strip
        acc[0][0][0] += (float)((const int8_t*)As)[((n_chunks - 1) % NST) * G::A_STAGE + tid];

    float* part = (float*)smem;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                *(float2*)(part + (wm * 32 + mi * 16 + g + 8 * h) * PSTRIDE + wn * 64 +
                           nt * 8 + 2 * c) =
                    make_float2(acc[mi][nt][2 * h], acc[mi][nt][2 * h + 1]);
    cluster.sync();
    // rank r sums rows [32r, 32r + 32) of the CL partial slabs, in rank order
    const float* parts[CL];
#pragma unroll
    for (int q = 0; q < CL; ++q) parts[q] = cluster.map_shared_rank(part, q);
    const size_t ybase = (size_t)rb * block + m0;
    for (int i = tid; i < (BM / CL) * (BN / 4); i += THREADS) {
        const int row = (BM / CL) * rank + i / (BN / 4), c4 = i % (BN / 4);
        float4 s = *(const float4*)(parts[0] + row * PSTRIDE + 4 * c4);
#pragma unroll
        for (int q = 1; q < CL; ++q) {
            const float4 v = *(const float4*)(parts[q] + row * PSTRIDE + 4 * c4);
            s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
        }
        const float o[4] = {s.x, s.y, s.z, s.w};
        const int col = n0 + 4 * c4;
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (col + e < d) store_out<OUT_BF16>(y, (ybase + row) * d + col + e, o[e] * scale);
    }
    cluster.sync();  // no CTA leaves while another reads its slab
}

template <int KIND, bool XV, bool OUT_BF16, int MODE>
int launch_mma(const void* tiles, const void* col_blk, const void* row_ptr, const void* slots,
               const void* src, void* y, float scale, int n_row_blocks, int block, int stack,
               int d, cudaStream_t st) {
    constexpr int smem = Geometry<KIND, XV>::SMEM;
    auto kern = spmm_phase_mma<KIND, XV, OUT_BF16, MODE>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n_row_blocks * (block / BM) * CL, (d + BN - 1) / BN);
    kern<<<grid, THREADS, smem, st>>>((const unsigned char*)tiles, (const int32_t*)col_blk,
                                      (const int32_t*)row_ptr, (const int32_t*)slots,
                                      (const uint16_t*)src, y, scale, block, stack, d);
    return (int)cudaGetLastError();
}

// x (bf16) is staged by cp.async where its rows are 16-byte aligned
bool x_vec(const void* src, int d) { return (uintptr_t)src % 16 == 0 && d % 8 == 0; }

// One phase: y[n_row_blocks * block, d] = scale * (A @ src) over (row_ptr, slots).
int run_phase(int kind, bool src_bf16, bool out_bf16, const void* tiles, const void* col_blk,
              const void* row_ptr, const void* slots, const void* src, void* y, float scale,
              int n_row_blocks, int block, int stack, int d, cudaStream_t st) {
    if (n_row_blocks == 0 || d == 0) return (int)cudaSuccess;
    if (kind == F32) {
        if (block % SBM) return (int)cudaErrorInvalidValue;
        const dim3 grid(n_row_blocks * (block / SBM), (d + SBN - 1) / SBN);
        auto go = [&](auto kern) {
            kern<<<grid, STHREADS, 0, st>>>((const float*)tiles, (const int32_t*)col_blk,
                                            (const int32_t*)row_ptr, (const int32_t*)slots,
                                            src, y, scale, block, stack, d);
        };
        if (src_bf16)
            out_bf16 ? go(spmm_phase_f32<true, true>) : go(spmm_phase_f32<true, false>);
        else
            out_bf16 ? go(spmm_phase_f32<false, true>) : go(spmm_phase_f32<false, false>);
        return (int)cudaGetLastError();
    }
    if (block % BM || !src_bf16 || (kind != BF16 && kind != INT8 && kind != INT4))
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)tiles % 16) return (int)cudaErrorMisalignedAddress;
    const bool vec = x_vec(src, d);
    int err = (int)cudaSuccess;
    auto go = [&](auto k) {
        constexpr int K = decltype(k)::value;
        auto one = [&](auto v, auto ob) {
            err = launch_mma<K, decltype(v)::value, decltype(ob)::value, FULL>(
                tiles, col_blk, row_ptr, slots, src, y, scale, n_row_blocks, block, stack, d,
                st);
        };
        using T = std::true_type;
        using N = std::false_type;
        if (vec)
            out_bf16 ? one(T{}, T{}) : one(T{}, N{});
        else
            out_bf16 ? one(N{}, T{}) : one(N{}, N{});
    };
    if (kind == BF16) go(std::integral_constant<int, BF16>{});
    else if (kind == INT8) go(std::integral_constant<int, INT8>{});
    else go(std::integral_constant<int, INT4>{});
    return err;
}

}  // namespace

extern "C" {

// y[n_row_blocks * block, d] (f32, or bf16 bits when out_bf16) = A @ x.
// tile_kind: 0 f32, 1 bf16, 2 int8, 3 int4 (packed4).  x is f32 or bf16 bits
// (x_bf16) for f32 tiles and bf16 bits for the others (the caller rounds f32 x).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unknown tile_kind, a block or an x the kernel does not take.
int spmm_stacked_resident(const void* tiles, int tile_kind, const void* col_blk,
                          const void* row_ptr, const void* slots, const void* x, int x_bf16,
                          void* y, int out_bf16, int n_row_blocks, int block, int stack, int d,
                          void* stream) {
    return run_phase(tile_kind, x_bf16, out_bf16, tiles, col_blk, row_ptr, slots, x, y, 1.f,
                     n_row_blocks, block, stack, d, (cudaStream_t)stream);
}

// The int8 tensor-core phase in diagnostic mode `mode` (0 full, 1 dmaonly, 2 nodot,
// 3 noconvert), f32 output, x bf16 bits with 16-byte rows; arguments as
// spmm_stacked_resident.
int spmm_stacked_ablation(const void* tiles, const void* col_blk, const void* row_ptr,
                          const void* slots, const void* x, void* y, int n_row_blocks,
                          int block, int stack, int d, int mode, void* stream) {
    if (n_row_blocks == 0 || d == 0) return (int)cudaSuccess;
    if (block % BM || (uintptr_t)tiles % 16 || !x_vec(x, d) || mode < 0 || mode > 3)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (mode) {
        case FULL:
            return launch_mma<INT8, true, false, FULL>(tiles, col_blk, row_ptr, slots, x, y,
                                                       1.f, n_row_blocks, block, stack, d, st);
        case DMAONLY:
            return launch_mma<INT8, true, false, DMAONLY>(tiles, col_blk, row_ptr, slots, x, y,
                                                          1.f, n_row_blocks, block, stack, d,
                                                          st);
        case NODOT:
            return launch_mma<INT8, true, false, NODOT>(tiles, col_blk, row_ptr, slots, x, y,
                                                        1.f, n_row_blocks, block, stack, d, st);
        default:
            return launch_mma<INT8, true, false, NOCONVERT>(tiles, col_blk, row_ptr, slots, x,
                                                            y, 1.f, n_row_blocks, block, stack,
                                                            d, st);
    }
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
