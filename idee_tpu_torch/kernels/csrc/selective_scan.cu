// ------------------------------------------------------------------
// Fused d_state=1 selective scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel idee_tpu/kernels/selective_scan.py::
// _fused_kernel_unrolled (launched by _fused_pallas, public op
// fused_selective_scan_n1). Over [L, M] float32 inputs delta, u, B, C, z
// (row-major, M contiguous) and A, D of shape [M]:
//
//     h_t = exp(delta_t * A) * h_{t-1} + delta_t * u_t * B_t,   h_{-1} = 0
//     y_t = (C_t * h_t + D * u_t) * silu(z_t)
//
// What bounds it: bytes. Each launch reads 5*L*M + 2*M floats and writes
// L*M (2*L*M when h is kept) against ~12 flops and 2 exponentials per
// element, far below the card's operations-per-byte balance. At the Mamba
// encoder's bench width (batch 1, 200x200, 6 variables x 16 channels) the
// stage-0 launch (L=32, M=960,000) moves ~745 MB and the stage-1 launch
// (L=8, M=3,840,000) ~768 MB: ~0.22-0.23 ms each at the H100's published
// 3.35 TB/s, ~0.67 ms for the three launches of one forward.
//
// What the design does about it: one pass over the inputs with nothing
// written back but y (and h on request). One thread owns one column m and
// walks t in a register-resident loop, so the recurrence needs no
// cross-thread communication, and at every step neighbouring threads touch
// neighbouring addresses (fully coalesced 128-byte warp transactions).
// The t loop is unrolled so the loads of several steps are in flight at
// once. The TPU version's [L, G, 8, 128] tiling and pad-to-1024 answer the
// TPU's vreg shape; here the ragged tail of M is simply masked.
// ------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_scan_n1_fwd_kernel(const float* __restrict__ delta,
                         const float* __restrict__ u,
                         const float* __restrict__ B,
                         const float* __restrict__ C,
                         const float* __restrict__ z,
                         const float* __restrict__ A,
                         const float* __restrict__ D,
                         float* __restrict__ y,
                         float* __restrict__ h_out,
                         int64_t L, int64_t M) {
  const int64_t m = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const float a = A[m];
  const float d = D[m];
  float h = 0.0f;
  // Every product and sum is rounded on its own (__fmul_rn/__fadd_rn are
  // never contracted into an FMA), in the order of the plain version, so
  // the two agree to the rounding of expf; the kernel is bound by bytes,
  // not by these few instructions.
#pragma unroll 8
  for (int64_t t = 0; t < L; ++t) {
    const int64_t i = t * M + m;
    const float dl = delta[i];
    const float uu = u[i];
    h = __fadd_rn(__fmul_rn(expf(__fmul_rn(dl, a)), h),
                  __fmul_rn(__fmul_rn(dl, uu), B[i]));
    if (h_out != nullptr) h_out[i] = h;
    const float zz = z[i];
    const float sz = zz / __fadd_rn(1.0f, expf(-zz));  // silu(z)
    y[i] = __fmul_rn(__fadd_rn(__fmul_rn(C[i], h), __fmul_rn(d, uu)), sz);
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t passed as a pointer); h may be null.
// Returns cudaGetLastError() so the caller sees a refused launch.
extern "C" int idee_fused_scan_n1_fwd(const float* delta, const float* u,
                                      const float* B, const float* C,
                                      const float* z, const float* A,
                                      const float* D, float* y, float* h,
                                      int64_t L, int64_t M, void* stream) {
  if (L <= 0 || M <= 0) return (int)cudaSuccess;
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  fused_scan_n1_fwd_kernel<<<(unsigned int)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      delta, u, B, C, z, A, D, y, h, L, M);
  return (int)cudaGetLastError();
}
