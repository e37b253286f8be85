// ------------------------------------------------------------------
// Fused d_state=1 selective scan, forward and backward, for Hopper
// (sm_90a).
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
//
// The backward (fused_scan_n1_bwd_kernel) is the JAX package's custom VJP
// of the same op (idee_tpu/kernels/selective_scan.py::_fused_bwd), which
// on the TPU is XLA around the Pallas linear scan. From the saved inputs,
// the saved h and the output gradient g, with a_t = exp(delta_t A),
// dy_t = g_t silu(z_t) and the reverse recurrence
//
//     G_t = a_{t+1} G_{t+1} + dy_t C_t,   G_{L-1} = dy_{L-1} C_{L-1}
//
// it writes dz, dC, du, ddelta, dB [L, M] and dA = sum_t G_t h_{t-1} a_t
// delta_t, dD = sum_t dy_t u_t [M]. What bounds it: bytes, 7 [L, M] tensors
// read and 5 written (~0.45 ms per launch at either stage shape at
// 3.35 TB/s) against ~35 flops and 2 exponentials per element. The design:
// the forward's, walked from t = L-1 down. One thread owns column m and
// carries G, a_{t+1} (recomputed from delta, never read) and the row
// h_{t-1} it loaded for da_t, which is the next step's h_t; so every
// input is read once and no shifted copy is made. dA and dD are sums over
// t within the column (A and D are [M] here), kept in registers and
// written once: no atomics, no cross-thread reduction, the same bits on
// every run.
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

__global__ void __launch_bounds__(kThreads)
fused_scan_n1_bwd_kernel(const float* __restrict__ delta,
                         const float* __restrict__ u,
                         const float* __restrict__ B,
                         const float* __restrict__ C,
                         const float* __restrict__ z,
                         const float* __restrict__ A,
                         const float* __restrict__ D,
                         const float* __restrict__ h,
                         const float* __restrict__ g,
                         float* __restrict__ ddelta, float* __restrict__ du,
                         float* __restrict__ dB, float* __restrict__ dC,
                         float* __restrict__ dz, float* __restrict__ dA,
                         float* __restrict__ dD, int64_t L, int64_t M) {
  const int64_t m = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const float am = A[m];
  const float dm = D[m];
  float G = 0.0f, a_next = 0.0f, sum_a = 0.0f, sum_d = 0.0f;
  int64_t i = (L - 1) * M + m;
  float h_t = h[i];
  // Every term in the plain version's order (fused_selective_scan_n1_
  // bwd_plain), each product and sum rounded on its own, so the two differ
  // only in the order of the two column sums and the rounding of expf.
#pragma unroll 4
  for (int64_t t = L - 1; t >= 0; --t, i -= M) {
    const float dl = delta[i];
    const float uu = u[i];
    const float bb = B[i];
    const float cc = C[i];
    const float zz = z[i];
    const float gg = g[i];
    const float h_prev = t > 0 ? h[i - M] : 0.0f;
    const float sig = 1.0f / __fadd_rn(1.0f, expf(-zz));
    const float dy = __fmul_rn(gg, __fmul_rn(zz, sig));
    const float y_lin = __fadd_rn(__fmul_rn(cc, h_t), __fmul_rn(dm, uu));
    dz[i] = __fmul_rn(
        __fmul_rn(gg, y_lin),
        __fmul_rn(sig, __fadd_rn(1.0f, __fmul_rn(zz, __fsub_rn(1.0f, sig)))));
    dC[i] = __fmul_rn(dy, h_t);
    sum_d = __fadd_rn(sum_d, __fmul_rn(dy, uu));
    const float a = expf(__fmul_rn(dl, am));
    G = __fadd_rn(__fmul_rn(a_next, G), __fmul_rn(dy, cc));
    const float da_a = __fmul_rn(__fmul_rn(G, h_prev), a);
    ddelta[i] =
        __fadd_rn(__fmul_rn(da_a, am), __fmul_rn(__fmul_rn(G, uu), bb));
    const float g_dl = __fmul_rn(G, dl);
    du[i] = __fadd_rn(__fmul_rn(dy, dm), __fmul_rn(g_dl, bb));
    dB[i] = __fmul_rn(g_dl, uu);
    sum_a = __fadd_rn(sum_a, __fmul_rn(da_a, dl));
    a_next = a;
    h_t = h_prev;
  }
  dA[m] = sum_a;
  dD[m] = sum_d;
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

// The backward: [L, M] delta, u, B, C, z, h, g in; ddelta, du, dB, dC, dz
// [L, M] and dA, dD [M] out. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int idee_fused_scan_n1_bwd(const float* delta, const float* u,
                                      const float* B, const float* C,
                                      const float* z, const float* A,
                                      const float* D, const float* h,
                                      const float* g, float* ddelta,
                                      float* du, float* dB, float* dC,
                                      float* dz, float* dA, float* dD,
                                      int64_t L, int64_t M, void* stream) {
  if (L <= 0 || M <= 0) return (int)cudaSuccess;
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  fused_scan_n1_bwd_kernel<<<(unsigned int)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      delta, u, B, C, z, A, D, h, g, ddelta, du, dB, dC, dz, dA, dD, L, M);
  return (int)cudaGetLastError();
}
