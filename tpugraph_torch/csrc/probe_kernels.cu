// Launch-cost probes for Hopper (sm_90a), the counterparts of the per-call probes of
// bench_palcall_diag.py (tiny_call, res_call).  Plain C interface, loaded with
// ctypes by tpugraph_torch/ops/probe_kernels.py, which checks every argument first.
//
// probe_tiny replaces bench_palcall_diag.py:71 tiny_call: o[8, 128] = x * 0.999 in
// f32, over a grid of 1 or 2 CTAs (the TPU probe's grid of 1 or 2 steps); CTA b
// takes rows b, b + grid, ...  It measures what one launch costs when the kernel
// does nearly nothing.
//
// probe_resident replaces bench_palcall_diag.py:104 res_call: out[n, 128] f32 is
// zeroed and its first 8 rows are tok[8, 128] + x[0:8] (x bf16 bits, [n, 128]).
// The TPU probe holds x and out whole in VMEM, so its time grows with n through
// the resident buffers' staging; on Hopper nothing is staged, and the time grows
// with n only through the 4 * 128 * n bytes of out the kernel writes (one 16-byte
// store a thread-iteration, grid-stride).
//
// Each launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;

__global__ void probe_tiny_kernel(const float* __restrict__ x, float* __restrict__ o) {
    for (int r = blockIdx.x; r < 8; r += gridDim.x)
        o[r * D + threadIdx.x] = x[r * D + threadIdx.x] * 0.999f;
}

__global__ void probe_resident_kernel(const float* __restrict__ tok,
                                      const uint16_t* __restrict__ x, float* __restrict__ out,
                                      size_t n4) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
         i += (size_t)gridDim.x * blockDim.x) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < 8 * D / 4) {
            const float4 t = ((const float4*)tok)[i];
            const uint2 b = ((const uint2*)x)[i];
            v = make_float4(t.x + __uint_as_float(b.x << 16),
                            t.y + __uint_as_float(b.x & 0xFFFF0000u),
                            t.z + __uint_as_float(b.y << 16),
                            t.w + __uint_as_float(b.y & 0xFFFF0000u));
        }
        ((float4*)out)[i] = v;
    }
}

}  // namespace

extern "C" {

// o[8, 128] = x[8, 128] * 0.999 (f32) over `grid` CTAs of 128 threads.
int probe_tiny(const void* x, void* o, int grid, void* stream) {
    probe_tiny_kernel<<<grid, D, 0, (cudaStream_t)stream>>>((const float*)x, (float*)o);
    return (int)cudaGetLastError();
}

// out[n, 128] f32 = 0, then out[0:8] = tok[8, 128] + x[0:8] (x bf16 bits, [n, 128]).
int probe_resident(const void* tok, const void* x, void* out, int n, void* stream) {
    const size_t n4 = (size_t)n * D / 4;
    const int blocks = (int)((n4 + 255) / 256 < 1056 ? (n4 + 255) / 256 : 1056);
    probe_resident_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const float*)tok, (const uint16_t*)x, (float*)out, n4);
    return (int)cudaGetLastError();
}

}  // extern "C"
