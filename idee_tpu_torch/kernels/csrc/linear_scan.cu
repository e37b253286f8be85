// ------------------------------------------------------------------
// Linear recurrence (linear scan) along the leading axis, for Hopper
// (sm_90a), forward or reverse in time.
//
// Replaces the TPU kernel idee_tpu/kernels/selective_scan.py::
// _scan_kernel_unrolled (launched by _scan_pallas_small, and chunk by chunk
// by the two-level _scan_pallas_2d for L > 64; public op linear_scan). Over
// [L, M] float32 a, b (row-major, M contiguous):
//
//     forward:  h_t = a_t * h_{t-1} + b_t,   t = 0 .. L-1,   h_{-1} = 0
//     reverse:  h_t = a_t * h_{t+1} + b_t,   t = L-1 .. 0,   h_L = 0
//
// The reverse form is the backward of both scans (the fused selective
// scan's and linear_scan's own): the TPU code flips its inputs and output
// to get it; here the loop runs the other way and no flipped copy is made.
//
// What bounds it: bytes. Each launch reads 2*L*M floats and writes L*M
// against 2 flops per element. At the Mamba encoder's bench width the
// backward's reverse scans at (L=32, M=960,000) and (L=8, M=3,840,000)
// move 369 MB each: ~0.110 ms at the H100's published 3.35 TB/s.
//
// What the design does about it: one pass, nothing kept but h. One thread
// owns one column m and walks t in a register-resident loop: no
// cross-thread communication, and at every step neighbouring threads touch
// neighbouring addresses (coalesced 128-byte warp transactions). The loop
// is unrolled so the loads of several steps are in flight at once. It takes
// any L: the TPU's chunking for L > 64, which answered a Mosaic hang, has
// no counterpart, and the ragged tail of M is masked.
// ------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ h_out, int64_t L, int64_t M,
                   int reverse) {
  const int64_t m = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  // walk t forward (t = 0 .. L-1) or backward (t = L-1 .. 0) with one
  // signed row stride
  const int64_t stride = reverse ? -M : M;
  int64_t i = (reverse ? (L - 1) * M : 0) + m;
  float h = 0.0f;
  // the product and the sum are rounded on their own (never contracted
  // into an FMA), as the plain version's two PyTorch ops round them, so the
  // two agree bit for bit
#pragma unroll 8
  for (int64_t t = 0; t < L; ++t, i += stride) {
    h = __fadd_rn(__fmul_rn(a[i], h), b[i]);
    h_out[i] = h;
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t passed as a pointer); reverse != 0
// runs t = L-1 .. 0. Returns cudaGetLastError() so the caller sees a
// refused launch.
extern "C" int idee_linear_scan(const float* a, const float* b, float* h,
                                int64_t L, int64_t M, int reverse,
                                void* stream) {
  if (L <= 0 || M <= 0) return (int)cudaSuccess;
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  linear_scan_kernel<<<(unsigned int)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(a, b, h, L, M, reverse);
  return (int)cudaGetLastError();
}
