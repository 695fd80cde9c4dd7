// Element types shared by the tile kernels of bcsr_kernels.cu and
// resident_kernels.cu, and their cp.async helpers: how a tile entry, an x entry
// and an output entry are read, rounded and written, following JAX's conversion
// rule for the Pallas kernels (tpugraph/ops/pallas_spmm.py:55-61,
// pallas_resident.py:263-267):
//   * int8 (and int4) tiles widen exactly and multiply as bf16 values would;
//   * the tile compute type is f32 for f32 tiles and bf16 otherwise, and x is cast
//     to it: f32 x is rounded to bf16 (nearest even) for bf16/int8/int4 tiles, and
//     bf16 x widens exactly for f32 tiles;
//   * products and sums are f32; a bf16 output is rounded once, at the write.
// bf16 values travel as their 16 raw bits (uint16_t).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tpg {

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

__device__ __forceinline__ float bf16_widen(uint16_t b) {
    return __uint_as_float((uint32_t)b << 16);
}

// storage type of an f32, bf16 or int8 tile entry
template <int KIND>
using tile_t = std::conditional_t<KIND == F32, float,
                                  std::conditional_t<KIND == BF16, uint16_t, int8_t>>;

// entry i of f32, bf16 or int8 tile values at `base`, widened to float
template <int KIND>
__device__ __forceinline__ float tile_elem(const void* base, size_t i) {
    if (KIND == F32) return ((const float*)base)[i];
    if (KIND == BF16) return bf16_widen(((const uint16_t*)base)[i]);
    return (float)((const int8_t*)base)[i];
}

// x entry i as it enters a product with tiles of KIND
template <int KIND, bool X_BF16>
__device__ __forceinline__ float x_operand(const void* x, size_t i) {
    if (X_BF16) return bf16_widen(((const uint16_t*)x)[i]);
    const float v = ((const float*)x)[i];
    return KIND == F32 ? v : bf16_round(v);
}

template <bool OUT_BF16>
__device__ __forceinline__ void store_out(void* y, size_t i, float v) {
    if (OUT_BF16)
        ((uint16_t*)y)[i] = bf16_bits(v);
    else
        ((float*)y)[i] = v;
}

// ---- asynchronous copies into shared memory (cp.async), shared by the tile kernels

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes with an L2 evict-first hint: tile bytes are read once
__device__ __forceinline__ void cp16_evict_first(uint32_t dst, const void* src,
                                                 uint64_t policy) {
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "l"(policy));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Calls f(kind, x_bf16, out_bf16) with each argument as a std::integral_constant,
// so that f can instantiate a kernel template for this run-time combination.
// Returns false for any tile kind but F32, BF16 and INT8.
template <typename F>
bool dispatch(int kind, bool x_bf16, bool out_bf16, F&& f) {
    auto with_x_out = [&](auto k) {
        using T = std::true_type;
        using N = std::false_type;
        if (x_bf16) {
            if (out_bf16) f(k, T{}, T{}); else f(k, T{}, N{});
        } else {
            if (out_bf16) f(k, N{}, T{}); else f(k, N{}, N{});
        }
    };
    switch (kind) {
        case F32: with_x_out(std::integral_constant<int, F32>{}); return true;
        case BF16: with_x_out(std::integral_constant<int, BF16>{}); return true;
        case INT8: with_x_out(std::integral_constant<int, INT8>{}); return true;
        default: return false;
    }
}

}  // namespace tpg
