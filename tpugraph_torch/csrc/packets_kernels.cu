// SpMM over the edge-packet layout of tpugraph_torch/ops/packets.py (B7), for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// tpugraph_torch/ops/packets_kernels.py, which checks every argument first.
//
// spmm_packets replaces tpugraph/ops/pallas_packets.py:spmm_packets
// (_packet_kernel_factory): y[N, D] = A @ x.  The TPU kernel turns gather and scatter
// into one-hot matmuls for its matrix unit; Hopper gathers rows directly, and a row's
// sum is best kept in registers.  So the kernel walks receiver rows, not packets: the
// wrapper lists every live slot (w != 0) in order of (global receiver row, packet,
// slot) once per EdgePackets, on their device (ops/packets_kernels.py:packet_schedule,
// a CSR of ops/csr.py: col = col_blk * block_c + cols, eid = the slot p * K + k), and
// the kernels here are the row walk of row_spmm.cuh over it with B7's compute and
// output dtypes.  Only live slots are read: a packet's dead slots (91% of the arxiv
// stand-in's 27.3M) cost nothing a product.  row_spmm.cuh states the semantics, the
// bound and the design.
//
// spmm_packets_ablation runs the same kernel in a diagnostic mode (the counterpart of
// bench_packets_diag.py's variants), with bf16 compute, f32 output and D % 4 == 0:
// 1 slots_only, 2 no_gather, 3 gather_only (row_spmm.cuh's MODE; gather_only writes no
// partials, so the reduce pass does not run).
//
// Each entry point launches on the caller's stream and returns cudaGetLastError()
// after its launch, or cudaErrorInvalidValue for an unknown mode or vec == 0 in an
// ablation.

#include "row_spmm.cuh"

using namespace row_spmm;

namespace {

template <bool BF16, bool OUT_BF16, bool VEC, int V, int MODE>
__global__ void __launch_bounds__(THREADS)
spmm_packets_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ slot,
                    const float* __restrict__ w, const int4* __restrict__ work, int n_items,
                    const void* __restrict__ x, void* __restrict__ y,
                    float* __restrict__ partial, int d) {
    walk<BF16, OUT_BF16, VEC, V, MODE>(src, slot, w, work, n_items, x, y, partial, d);
}

template <bool OUT_BF16, bool VEC, int V>
__global__ void __launch_bounds__(THREADS)
spmm_packets_reduce_kernel(const int4* __restrict__ splits, int n_split,
                           const float* __restrict__ partial, void* __restrict__ y, int d) {
    reduce<OUT_BF16, VEC, V>(splits, n_split, partial, y, d);
}

template <bool BF16, bool OUT_BF16, bool VEC, int MODE>
int launch(const void* src, const void* slot, const void* w, const void* work, int n_items,
           const void* x, void* y, void* partial, int d, cudaStream_t st) {
    return launch_rows(spmm_packets_kernel<BF16, OUT_BF16, VEC, 1, MODE>,
                       spmm_packets_kernel<BF16, OUT_BF16, VEC, 2, MODE>, n_items, d, st,
                       (const int32_t*)src, (const int32_t*)slot, (const float*)w,
                       (const int4*)work, n_items, x, y, (float*)partial, d);
}

}  // namespace

extern "C" {

// Main pass: y[N, d] (f32, or bf16 bits when out_bf16) for the rows that are one
// chunk, f32 partials[n_parts, d] for the chunks of split rows.  compute_bf16
// selects the bf16 roundings of w and g and takes x as bf16 bits (already
// rounded); otherwise x is f32.  vec: d % 4 == 0 and x 16-byte aligned.
int spmm_packets(const void* src, const void* slot, const void* w, const void* work,
                 int n_items, const void* x, void* y, void* partial, int d, int vec,
                 int compute_bf16, int out_bf16, void* stream) {
    return with_flag(compute_bf16, [&](auto bf) {
        return with_flag(out_bf16, [&](auto ob) {
            return with_flag(vec, [&](auto ve) {
                return launch<decltype(bf)::value, decltype(ob)::value, decltype(ve)::value,
                              FULL>(src, slot, w, work, n_items, x, y, partial, d,
                                    (cudaStream_t)stream);
            });
        });
    });
}

// Second pass: the rows of the n_split split rows, summed from their partials in
// chunk order, rounded once to the output dtype.
int spmm_packets_reduce(const void* splits, int n_split, const void* partial, void* y,
                        int d, int vec, int out_bf16, void* stream) {
    return with_flag(out_bf16, [&](auto ob) {
        return with_flag(vec, [&](auto ve) {
            constexpr bool OB = decltype(ob)::value, VE = decltype(ve)::value;
            return launch_rows(spmm_packets_reduce_kernel<OB, VE, 1>,
                               spmm_packets_reduce_kernel<OB, VE, 2>, n_split, d,
                               (cudaStream_t)stream, (const int4*)splits, n_split,
                               (const float*)partial, y, d);
        });
    });
}

// The main pass in a diagnostic mode (1 slots_only, 2 no_gather, 3 gather_only;
// 0 is the full kernel): bf16 compute on bf16-bits x, f32 output, vec.
int spmm_packets_ablation(const void* src, const void* slot, const void* w, const void* work,
                          int n_items, const void* x, void* y, void* partial, int d, int vec,
                          int mode, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (!vec) return (int)cudaErrorInvalidValue;
    switch (mode) {
        case FULL:
            return launch<true, false, true, FULL>(src, slot, w, work, n_items, x, y, partial,
                                                   d, st);
        case SLOTS_ONLY:
            return launch<true, false, true, SLOTS_ONLY>(src, slot, w, work, n_items, x, y,
                                                         partial, d, st);
        case NO_GATHER:
            return launch<true, false, true, NO_GATHER>(src, slot, w, work, n_items, x, y,
                                                        partial, d, st);
        case GATHER_ONLY:
            return launch<true, false, true, GATHER_ONLY>(src, slot, w, work, n_items, x, y,
                                                          partial, d, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
