// The row epilogue of each GraphConv in ConvStack (tpugraph_torch/nn/encoders.py), for
// Hopper (sm_90a), forward and backward, per row of y_lin [N, F] f32 (the layer's GEMM
// output before its bias):
//   y = y_lin + b;  q = rsqrt(sum y^2 + 1e-24);  n = y q          (normalize_embedding)
//   r = max(n, 0)                                                  (ReLU, hidden layers)
//   mu = mean r;  s = rsqrt(mean (r - mu)^2 + 1e-5);  out = (r - mu) s   (fresh_batch_norm)
// Plain C interface, loaded with ctypes by tpugraph_torch/ops/epilogue_kernels.py, which
// checks every argument first.
//
// It replaces no pallas_call: in the JAX package XLA fuses this chain (the bias add and
// normalize_embedding of tpugraph/nn/layers.py:623-631, the relu and fresh_batch_norm of
// tpugraph/nn/encoders.py's ConvStack) into the layer's own fusion.  In the port torch
// ran it as some 7 passes over the [N, F] tensor forward and 14 backward, several of
// them broadcasting an [N, 1] tensor.
//
// Variants (MODE): NORM (conv_last: y, q, n), RELU (+ r), RELU_BN (+ the standardisation).
// bias may be null (use_bias=False).  Forward writes out and the row's (q, mu, s) for the
// backward (mu = 0, s = 1 without bn).  Backward reads g, y_lin
// and the row's stats, recomputes n, r and o = (r - mu) s, and writes
//   dr = s (g - mean g - o mean(g o))           (RELU_BN; else dr = g)
//   dn = dr where r > 0, else 0                  (RELU, RELU_BN: threshold_backward's test)
//   dy = q dn - y q^3 sum(dn y)
// The bias gradient is the caller's (a column sum of dy).
//
// Bound on the H100: bytes.  Forward reads y_lin and writes out, 8 N F bytes (plus 12 N
// of stats); backward reads g and y_lin and writes dy, 12 N F bytes (plus 12 N).  At
// ogbn-arxiv's N = 169,343, F = 256: 0.104 ms and 0.155 ms at 3.35 TB/s.
//
// Design: one warp a row, rows in a grid-stride loop over as many CTAs as fit on the card
// at once.  Each lane owns 4 columns of each 128-column group (row_spmm.cuh's load4 /
// store4: one 16-byte load where F % 4 == 0 and every pointer is 16-byte aligned, else 4
// scalar loads); for F <= 1024 the row's NC groups (1, 2, 4 or 8) stay in registers from
// their one load to the store, for wider rows (NC = 0) each pass reads the row again
// (from L1 / L2).  Every row sum is a lane's sum of its columns, then a butterfly over
// the warp (__shfl_xor_sync), so every lane holds the same bits and the result is the
// same from launch to launch.  The arithmetic is torch's, in f32: the sums in the warp's
// order, the variance in two passes as torch.var(correction=0), rsqrtf as torch's CUDA
// rsqrt; the products that feed the ReLU's test (y q) are rounded alike forward and
// backward (__fmul_rn), so both see the same sign.  A NaN passes the ReLU and its test
// as in torch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "row_spmm.cuh"

namespace {

using row_spmm::FULL_MASK;
using row_spmm::GROUP;
using row_spmm::THREADS;
using row_spmm::WARPS;
using row_spmm::load4;
using row_spmm::store4;

enum Mode { NORM = 0, RELU = 1, RELU_BN = 2 };

constexpr float NORM_EPS = 1e-24f;
constexpr float BN_EPS = 1e-5f;
constexpr int MAX_HELD = 8;  // groups a row may keep in registers

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    return v;
}

// whether the lane's column m of group gi lies in the row
template <bool VEC>
__device__ __forceinline__ bool in_row(int gi, int lane, int m, int f) {
    return (VEC ? gi * GROUP + 4 * lane + m : gi * GROUP + lane + 32 * m) < f;
}

// ReLU with torch's NaN: max(n, 0), NaN kept
__device__ __forceinline__ float relu(float n) { return n < 0.f ? 0.f : n; }

// the lane's 4 values of group gi of y = y_lin + b on row `row`, 0 past the row
template <bool VEC>
__device__ __forceinline__ void load_y(const float* __restrict__ ylin,
                                       const float* __restrict__ bias, size_t row, int gi,
                                       int lane, int f, float v[4]) {
    load4<false, VEC>(ylin, row, gi * GROUP, lane, f, v);
    if (bias != nullptr) {
        float b[4];
        load4<false, VEC>(bias, 0, gi * GROUP, lane, f, b);
#pragma unroll
        for (int m = 0; m < 4; ++m) v[m] = __fadd_rn(v[m], b[m]);
    }
}

template <int NC, bool VEC, int MODE>
__global__ void __launch_bounds__(THREADS)
epilogue_fwd_kernel(const float* __restrict__ ylin, const float* __restrict__ bias,
                    float* __restrict__ out, float* __restrict__ stats, int n, int f) {
    constexpr int R = NC > 0 ? NC : 1;
    const int lane = threadIdx.x & 31;
    const int groups = NC > 0 ? NC : (f + GROUP - 1) / GROUP;
    const float fn = (float)f;
    for (int row = blockIdx.x * WARPS + (threadIdx.x >> 5); row < n;
         row += gridDim.x * WARPS) {
        float held[R][4];
        if (NC > 0) {
#pragma unroll
            for (int gi = 0; gi < R; ++gi) load_y<VEC>(ylin, bias, row, gi, lane, f, held[gi]);
        }
        auto y_of = [&](int gi, float v[4]) {  // held, or read again
            if (NC > 0) {
#pragma unroll
                for (int m = 0; m < 4; ++m) v[m] = held[gi][m];
            } else {
                load_y<VEC>(ylin, bias, row, gi, lane, f, v);
            }
        };
        float ss = 0.f;
#pragma unroll
        for (int gi = 0; gi < groups; ++gi) {
            float v[4];
            y_of(gi, v);
#pragma unroll
            for (int m = 0; m < 4; ++m) ss = fmaf(v[m], v[m], ss);
        }
        const float q = rsqrtf(warp_sum(ss) + NORM_EPS);
        float mu = 0.f, s = 1.f;
        if (MODE == RELU_BN) {
            float sr = 0.f;
#pragma unroll
            for (int gi = 0; gi < groups; ++gi) {
                float v[4];
                y_of(gi, v);
#pragma unroll
                for (int m = 0; m < 4; ++m) sr += relu(__fmul_rn(v[m], q));
            }
            mu = warp_sum(sr) / fn;
            float sd = 0.f;
#pragma unroll
            for (int gi = 0; gi < groups; ++gi) {
                float v[4];
                y_of(gi, v);
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    const float d = in_row<VEC>(gi, lane, m, f) ? relu(__fmul_rn(v[m], q)) - mu
                                                                : 0.f;
                    sd = fmaf(d, d, sd);
                }
            }
            s = rsqrtf(warp_sum(sd) / fn + BN_EPS);
        }
#pragma unroll
        for (int gi = 0; gi < groups; ++gi) {
            float v[4];
            y_of(gi, v);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const float nv = __fmul_rn(v[m], q);
                v[m] = MODE == NORM ? nv : MODE == RELU ? relu(nv) : __fmul_rn(relu(nv) - mu, s);
            }
            store4<false, VEC>(out, row, gi * GROUP, lane, f, v);
        }
        if (lane == 0) {
            stats[3 * (size_t)row] = q;
            stats[3 * (size_t)row + 1] = mu;
            stats[3 * (size_t)row + 2] = s;
        }
    }
}

template <int NC, bool VEC, int MODE>
__global__ void __launch_bounds__(THREADS)
epilogue_bwd_kernel(const float* __restrict__ g, int ldg, const float* __restrict__ ylin,
                    const float* __restrict__ bias, const float* __restrict__ stats,
                    float* __restrict__ dy, int n, int f) {
    constexpr int R = NC > 0 ? NC : 1;
    const int lane = threadIdx.x & 31;
    const int groups = NC > 0 ? NC : (f + GROUP - 1) / GROUP;
    const float fn = (float)f;
    for (int row = blockIdx.x * WARPS + (threadIdx.x >> 5); row < n;
         row += gridDim.x * WARPS) {
        const float q = stats[3 * (size_t)row], mu = stats[3 * (size_t)row + 1],
                    s = stats[3 * (size_t)row + 2];
        const float* grow = g + (size_t)row * ldg;
        float held_y[R][4], held_g[R][4];
        if (NC > 0) {
#pragma unroll
            for (int gi = 0; gi < R; ++gi) {
                load_y<VEC>(ylin, bias, row, gi, lane, f, held_y[gi]);
                load4<false, VEC>(grow, 0, gi * GROUP, lane, f, held_g[gi]);
            }
        }
        auto at = [&](int gi, float y[4], float gg[4]) {  // held, or read again
            if (NC > 0) {
#pragma unroll
                for (int m = 0; m < 4; ++m) y[m] = held_y[gi][m], gg[m] = held_g[gi][m];
            } else {
                load_y<VEC>(ylin, bias, row, gi, lane, f, y);
                load4<false, VEC>(grow, 0, gi * GROUP, lane, f, gg);
            }
        };
        float mg = 0.f, mgo = 0.f;
        if (MODE == RELU_BN) {
            float sg = 0.f, sgo = 0.f;
#pragma unroll
            for (int gi = 0; gi < groups; ++gi) {
                float y[4], gg[4];
                at(gi, y, gg);
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    sg += gg[m];
                    sgo = fmaf(gg[m], __fmul_rn(relu(__fmul_rn(y[m], q)) - mu, s), sgo);
                }
            }
            mg = warp_sum(sg) / fn;
            mgo = warp_sum(sgo) / fn;
        }
        // dn of one column; 0 past the row, where y = g = 0
        auto dn_of = [&](float y, float gg) {
            if (MODE == NORM) return gg;
            const float nv = __fmul_rn(y, q);
            if (nv <= 0.f) return 0.f;
            if (MODE == RELU) return gg;
            return s * (gg - mg - __fmul_rn(nv - mu, s) * mgo);
        };
        float t = 0.f;
#pragma unroll
        for (int gi = 0; gi < groups; ++gi) {
            float y[4], gg[4];
            at(gi, y, gg);
#pragma unroll
            for (int m = 0; m < 4; ++m) t = fmaf(dn_of(y[m], gg[m]), y[m], t);
        }
        const float q3t = q * q * q * warp_sum(t);
#pragma unroll
        for (int gi = 0; gi < groups; ++gi) {
            float y[4], gg[4];
            at(gi, y, gg);
#pragma unroll
            for (int m = 0; m < 4; ++m) y[m] = q * dn_of(y[m], gg[m]) - y[m] * q3t;
            store4<false, VEC>(dy, row, gi * GROUP, lane, f, y);
        }
    }
}

// Groups held in registers for a row of f columns: 1, 2, 4 or 8, or 0 (read again).
int held_groups(int f) {
    const int need = (f + GROUP - 1) / GROUP;
    if (need > MAX_HELD) return 0;
    int nc = 1;
    while (nc < need) nc *= 2;
    return nc;
}

template <int V>
using IC = std::integral_constant<int, V>;

// Calls fn(IC<NC>, bool_constant<VEC>, IC<MODE>) for the run-time choices.
template <typename Fn>
int dispatch(int nc, int vec, int mode, Fn&& fn) {
    auto by_nc = [&](auto v, auto md) {
        switch (nc) {
            case 1: return fn(IC<1>{}, v, md);
            case 2: return fn(IC<2>{}, v, md);
            case 4: return fn(IC<4>{}, v, md);
            case 8: return fn(IC<8>{}, v, md);
            default: return fn(IC<0>{}, v, md);
        }
    };
    auto by_vec = [&](auto md) {
        return vec ? by_nc(std::true_type{}, md) : by_nc(std::false_type{}, md);
    };
    switch (mode) {
        case NORM: return by_vec(IC<NORM>{});
        case RELU: return by_vec(IC<RELU>{});
        default: return by_vec(IC<RELU_BN>{});
    }
}

// Launches k over n rows, a warp each, on as many CTAs as are resident at once (at
// most one warp a row); returns the first CUDA error.
template <typename... P, typename... A>
int launch(void (*k)(P...), int n, cudaStream_t st, A... args) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    const int rows_ctas = (n + WARPS - 1) / WARPS;
    const int resident = (per_sm > 0 ? per_sm : 1) * sms;
    k<<<rows_ctas < resident ? rows_ctas : resident, THREADS, 0, st>>>(args...);
    return (int)cudaGetLastError();
}

bool aligned(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" {

// out[n, f] = the epilogue (mode 0 NORM, 1 RELU, 2 RELU_BN) of y_lin[n, f] (+ bias[f]
// unless null) and stats[n, 3] = (q, mu, s).  All f32, rows contiguous.
int epilogue_fwd(const void* ylin, const void* bias, void* out, void* stats, int n, int f,
                 int mode, void* stream) {
    const int vec = f % 4 == 0 && aligned(ylin) && aligned(bias) && aligned(out);
    return dispatch(held_groups(f), vec, mode, [&](auto nc, auto ve, auto md) {
        return launch(epilogue_fwd_kernel<decltype(nc)::value, decltype(ve)::value,
                                          decltype(md)::value>,
                      n, (cudaStream_t)stream, (const float*)ylin, (const float*)bias,
                      (float*)out, (float*)stats, n, f);
    });
}

// dy[n, f] = the gradient to y_lin of the epilogue's output gradient g (rows ldg floats
// apart), from y_lin, bias (or null) and the forward's stats[n, 3].
int epilogue_bwd(const void* g, int ldg, const void* ylin, const void* bias, const void* stats,
                 void* dy, int n, int f, int mode, void* stream) {
    const int vec = f % 4 == 0 && ldg % 4 == 0 && aligned(g) && aligned(ylin) &&
                    aligned(bias) && aligned(dy);
    return dispatch(held_groups(f), vec, mode, [&](auto nc, auto ve, auto md) {
        return launch(epilogue_bwd_kernel<decltype(nc)::value, decltype(ve)::value,
                                          decltype(md)::value>,
                      n, (cudaStream_t)stream, (const float*)g, ldg, (const float*)ylin,
                      (const float*)bias, (const float*)stats, (float*)dy, n, f);
    });
}

}  // extern "C"
