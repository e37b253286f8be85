// ------------------------------------------------------------------
// Window attention of the Swin_3D encoder, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of idee_tpu/kernels/window_attention.py:
//   _fwd_kernel (via _fwd_pallas)  -> attn_fwd_kernel
//   _bwd_kernel (via _bwd_pallas)  -> attn_bwd_kernel + dbias_sum_kernel
// Per window w and head g of q, k, v [BW, n, G, HD] float32 (row-major, HD
// contiguous, window index batch-major then window-minor as
// window_partition emits it):
//
//   s_ij = (q_i * scale) . k_j + bias[g, i, j] + bank[idx[w % nW], i, j]
//   p_ij = softmax_j(s_ij),   o_i = sum_j p_ij v_j
//
// and for the backward, with the output gradient go and the saved output o:
//
//   D_i   = go_i . o_i          (= sum_j p_ij dp_ij, JAX's sum(dp * p))
//   dp_ij = go_i . v_j,  ds_ij = p_ij (dp_ij - D_i)
//   dq_i  = scale sum_j ds_ij k_j,   dk_j = scale sum_i ds_ij q_i
//   dv_j  = sum_i p_ij go_i,         dbias[g, i, j] = sum_w ds_ij
//
// What bounds it: bytes. At the Swin_3D bench width (G = 12 heads of
// HD = 8; 10,000 windows of 32 tokens, then 40,000 of 8) a forward reads q,
// k, v and writes o, 123 MB, 0.147 ms at the H100's published 3.35 TB/s,
// against 4 n^2 HD flops per window-head (0.047 ms at 67 TFLOP/s float32 at
// n = 32). The backward moves 7 such tensors, 0.257 ms.
//
// What the design does about it. The TPU kernels fold P = 128/n
// (window, head) pairs into one 128-row MXU tile with a -1e9 block-diagonal
// base, and sort the tiles into pattern groups at trace time; all of that
// answers the MXU and is not carried over: HD = 8 and n = 8 are below every
// tensor-core tile, so the products are float32 FMAs on the CUDA cores.
//   * A block takes one head g and wpb = 128 / n windows at a time; thread
//     (window slot wl, token r) owns one row. Its q/k/v row is HD contiguous
//     floats, so every 32-byte sector a warp fetches is used whole. Blocks
//     are numbered head-fastest, so the G blocks that share the windows'
//     384-byte rows (all heads of a token) run together and each row is
//     fetched from device memory about once.
//   * The additive term is staged in shared memory with rows padded to
//     n + 1 floats: bias[g] once per block, or with a mask bias[g] +
//     bank[idx[w % nW]] once per window slot. A thread reads its own score
//     row there; a row-per-thread walk through global memory would touch
//     one cache line per thread and per key.
//   * The forward stages the windows' K and V in shared memory and runs an
//     online softmax (running max and sum) over the n keys, accumulating
//     the HD outputs in registers: no score matrix leaves the SM.
//   * The backward stages Q, K, V and go, and runs two phases. Row phase:
//     thread i recomputes its row's max and sum, then p, dp and ds, and
//     sums dq_i. Column phase: thread j recomputes column j of s, p and ds
//     from the row statistics (bit-identical to the row phase: same
//     operands, same order) and sums dk_j, dv_j. No [n, n] matrix is stored
//     but the block's dbias accumulator.
//   * dbias is deterministic: no float atomics. Each block walks a fixed
//     set of window groups and adds ds into its own shared [wpb, n, n]
//     accumulator (each entry has one owning thread); at the end it sums
//     the window slots in order into its partial [G, n, n] slice, and
//     dbias_sum_kernel adds the partials of all blocks in block order.
// Windows of any n <= 128 run (the TPU path takes only n dividing 128).
// ------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block; also the largest n

__device__ __forceinline__ int64_t row_offset(int w, int i, int g, int n,
                                              int G, int hd) {
  return (((int64_t)w * n + i) * G + g) * hd;
}

// s_ij without the mask and bias: both phases of the backward and the
// forward compute it with this one function, so they agree bit for bit
template <int HD>
__device__ __forceinline__ float dot_scaled(const float (&qs)[HD],
                                            const float* k) {
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < HD; ++d) s = fmaf(qs[d], k[d], s);
  return s;
}

// Stage the additive term into add, rows padded to n + 1: without a mask
// bias[g] once ([n][n+1]); with one, bias[g] + bank[idx[w % nW]] for each
// window slot wl of windows w0 .. w0 + wpb - 1 ([wpb][n][n+1]).
__device__ __forceinline__ void stage_additive(
    const float* __restrict__ bias, const float* __restrict__ bank,
    const int* __restrict__ idx, float* add, int g, int w0, int BW, int n,
    int nW, int wpb) {
  const int nn = n * n, srow = n + 1;
  const float* bias_g = bias + (int64_t)g * nn;
  if (bank == nullptr) {
    for (int e = threadIdx.x; e < nn; e += blockDim.x)
      add[(e / n) * srow + e % n] = bias_g[e];
    return;
  }
  for (int e = threadIdx.x; e < wpb * nn; e += blockDim.x) {
    const int wl = e / nn, r = e % nn, w = w0 + wl;
    if (w < BW)
      add[wl * n * srow + (r / n) * srow + r % n] =
          bias_g[r] + bank[(int64_t)idx[w % nW] * nn + r];
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias,
                const float* __restrict__ bank, const int* __restrict__ idx,
                float* __restrict__ o, int BW, int n, int G, int nW, int wpb,
                float scale) {
  extern __shared__ float smem[];
  // per window slot: n rows of HD, then 4 floats of padding so that the
  // slots of one warp fall on different banks
  const int slot = n * HD + 4, srow = n + 1;
  float* ks = smem;
  float* vs = ks + wpb * slot;
  float* add = vs + wpb * slot;  // the additive term, see stage_additive
  const int add_slot = bank != nullptr ? n * srow : 0;

  const int g = blockIdx.x % G, w0 = (blockIdx.x / G) * wpb;
  const int wl = threadIdx.x / n, i = threadIdx.x % n;
  const int w = w0 + wl;
  const bool active = wl < wpb && w < BW;
  const int64_t row = row_offset(w, i, g, n, G, HD);

  stage_additive(bias, bank, idx, add, g, w0, BW, n, nW, wpb);
  if (active) {
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      ks[wl * slot + i * HD + d] = k[row + d];
      vs[wl * slot + i * HD + d] = v[row + d];
    }
  }
  __syncthreads();
  if (!active) return;

  float qs[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qs[d] = q[row + d] * scale;
    acc[d] = 0.0f;
  }
  const float* arow = add + wl * add_slot + i * srow;
  const float* kw = ks + wl * slot;
  const float* vw = vs + wl * slot;

  float m = -INFINITY, l = 0.0f;
  for (int j = 0; j < n; ++j) {
    const float s = dot_scaled<HD>(qs, kw + j * HD) + arow[j];
    if (s > m) {  // a new running max: rescale what was summed so far
      const float c = expf(m - s);
      l *= c;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= c;
      m = s;
    }
    const float p = expf(s - m);
    l += p;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vw[j * HD + d], acc[d]);
  }
  const float inv = 1.0f / l;
#pragma unroll
  for (int d = 0; d < HD; ++d) o[row + d] = acc[d] * inv;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias,
                const float* __restrict__ bank, const int* __restrict__ idx,
                const float* __restrict__ o, const float* __restrict__ go,
                float* __restrict__ dq, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ dbias_part,
                int BW, int n, int G, int nW, int wpb, int n_groups,
                float scale) {
  extern __shared__ float smem[];
  const int slot = n * HD + 4;     // as in the forward
  const int srow = n + 1;          // additive and dbias rows, padded
  const int db_slot = n * srow;
  float* Qs = smem;
  float* Ks = Qs + wpb * slot;
  float* Vs = Ks + wpb * slot;
  float* Gs = Vs + wpb * slot;
  float* Mx = Gs + wpb * slot;  // row max        [wpb, n]
  float* Il = Mx + wpb * n;     // 1 / row sum    [wpb, n]
  float* Dl = Il + wpb * n;     // D_i = go_i.o_i [wpb, n]
  float* DB = Dl + wpb * n;     // dbias accumulator [wpb][n][n+1]
  float* add = DB + wpb * db_slot;  // the additive term, see stage_additive
  const int add_slot = bank != nullptr ? db_slot : 0;

  const int g = blockIdx.x % G, bx = blockIdx.x / G, n_bx = gridDim.x / G;
  const int wl = threadIdx.x / n, r = threadIdx.x % n;

  for (int e = threadIdx.x; e < wpb * db_slot; e += blockDim.x) DB[e] = 0.0f;
  if (bank == nullptr)
    stage_additive(bias, bank, idx, add, g, 0, BW, n, nW, wpb);

  for (int c = bx; c < n_groups; c += n_bx) {
    const int w = c * wpb + wl;
    const bool active = wl < wpb && w < BW;
    if (bank != nullptr)
      stage_additive(bias, bank, idx, add, g, c * wpb, BW, n, nW, wpb);
    float* Qw = Qs + wl * slot;
    float* Kw = Ks + wl * slot;
    float* Vw = Vs + wl * slot;
    float* Gw = Gs + wl * slot;

    float qs[HD], gr[HD];
    if (active) {
      const int64_t row = row_offset(w, r, g, n, G, HD);
      float delta = 0.0f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        const float qd = q[row + d], gd = go[row + d];
        Qw[r * HD + d] = qd;
        Kw[r * HD + d] = k[row + d];
        Vw[r * HD + d] = v[row + d];
        Gw[r * HD + d] = gd;
        qs[d] = qd * scale;
        gr[d] = gd;
        delta = fmaf(gd, o[row + d], delta);
      }
      Dl[wl * n + r] = delta;
    }
    __syncthreads();

    // row phase: thread = query row i
    if (active) {
      const int i = r;
      const float* arow = add + wl * add_slot + i * srow;
      float m = -INFINITY, l = 0.0f;
      for (int j = 0; j < n; ++j) {
        const float s = dot_scaled<HD>(qs, Kw + j * HD) + arow[j];
        if (s > m) {
          l *= expf(m - s);
          m = s;
        }
        l += expf(s - m);
      }
      const float il = 1.0f / l;
      const float delta = Dl[wl * n + i];
      float dqa[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) dqa[d] = 0.0f;
      for (int j = 0; j < n; ++j) {
        const float s = dot_scaled<HD>(qs, Kw + j * HD) + arow[j];
        const float p = expf(s - m) * il;
        float dp = 0.0f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dp = fmaf(gr[d], Vw[j * HD + d], dp);
        const float ds = p * (dp - delta);
#pragma unroll
        for (int d = 0; d < HD; ++d) dqa[d] = fmaf(ds, Kw[j * HD + d], dqa[d]);
      }
      const int64_t row = row_offset(w, i, g, n, G, HD);
#pragma unroll
      for (int d = 0; d < HD; ++d) dq[row + d] = dqa[d] * scale;
      Mx[wl * n + i] = m;
      Il[wl * n + i] = il;
    }
    __syncthreads();

    // column phase: thread = key column j
    if (active) {
      const int j = r;
      float kj[HD], vj[HD], dka[HD], dva[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        kj[d] = Kw[j * HD + d];
        vj[d] = Vw[j * HD + d];
        dka[d] = 0.0f;
        dva[d] = 0.0f;
      }
      const float* acol = add + wl * add_slot + j;
      float* db = DB + wl * db_slot + j;
      for (int i = 0; i < n; ++i) {
        float qi[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) qi[d] = Qw[i * HD + d] * scale;
        const float s = dot_scaled<HD>(qi, kj) + acol[i * srow];
        const float p = expf(s - Mx[wl * n + i]) * Il[wl * n + i];
        float dp = 0.0f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dp = fmaf(Gw[i * HD + d], vj[d], dp);
        const float ds = p * (dp - Dl[wl * n + i]);
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          dva[d] = fmaf(p, Gw[i * HD + d], dva[d]);
          dka[d] = fmaf(ds, Qw[i * HD + d], dka[d]);
        }
        db[i * srow] += ds;
      }
      const int64_t row = row_offset(w, j, g, n, G, HD);
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dk[row + d] = dka[d] * scale;
        dv[row + d] = dva[d];
      }
    }
    __syncthreads();  // the next window group overwrites the staged rows
  }

  // this block's partial dbias: its window slots summed in slot order
  __syncthreads();
  float* part = dbias_part + ((int64_t)bx * G + g) * n * n;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int at = (e / n) * srow + e % n;
    float s = 0.0f;
    for (int s_ = 0; s_ < wpb; ++s_) s += DB[s_ * db_slot + at];
    part[e] = s;
  }
}

// dbias[e] = sum over blocks b (in order) of part[b, e], e over G*n*n
__global__ void __launch_bounds__(256)
dbias_sum_kernel(const float* __restrict__ part, float* __restrict__ dbias,
                 int n_blocks, int64_t E) {
  const int64_t e = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= E) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += part[(int64_t)b * E + e];
  dbias[e] = s;
}

int windows_per_block(int n) { return kThreads / n; }

size_t fwd_smem_bytes(int n, int hd, bool masked) {
  const size_t wpb = windows_per_block(n), add = (size_t)n * (n + 1);
  return sizeof(float) * (2 * wpb * (n * hd + 4) + (masked ? wpb : 1) * add);
}

size_t bwd_smem_bytes(int n, int hd, bool masked) {
  const size_t wpb = windows_per_block(n), add = (size_t)n * (n + 1);
  return sizeof(float) * (4 * wpb * (n * hd + 4) + 3 * wpb * n + wpb * add +
                          (masked ? wpb : 1) * add);
}

// above 48 KB a kernel takes dynamic shared memory only after opting in
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int HD>
int launch_fwd(const float* q, const float* k, const float* v,
               const float* bias, const float* bank, const int* idx, float* o,
               int BW, int n, int G, int nW, float scale,
               cudaStream_t stream) {
  const int wpb = windows_per_block(n);
  const size_t smem = fwd_smem_bytes(n, HD, bank != nullptr);
  const cudaError_t err = allow_smem(attn_fwd_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  // head-fastest block numbering (see the design note)
  const int64_t blocks = (int64_t)((BW + wpb - 1) / wpb) * G;
  attn_fwd_kernel<HD><<<(unsigned int)blocks, kThreads, smem, stream>>>(
      q, k, v, bias, bank, idx, o, BW, n, G, nW, wpb, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* bias, const float* bank, const int* idx,
               const float* o, const float* go, float* dq, float* dk,
               float* dv, float* dbias_part, int BW, int n, int G, int nW,
               int n_blocks, float scale, cudaStream_t stream) {
  const int wpb = windows_per_block(n);
  const size_t smem = bwd_smem_bytes(n, HD, bank != nullptr);
  const cudaError_t err = allow_smem(attn_bwd_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_groups = (BW + wpb - 1) / wpb;
  // head-fastest: block b takes head b % G and window groups b / G,
  // b / G + n_blocks, ...
  attn_bwd_kernel<HD><<<(unsigned int)((int64_t)n_blocks * G), kThreads,
                        smem, stream>>>(
      q, k, v, bias, bank, idx, o, go, dq, dk, dv, dbias_part, BW, n, G, nW,
      wpb, n_groups, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface. q, k, v, o, go, dq, dk, dv: [BW, n, G, hd] float32;
// bias: [G, n, n]; bank: [K, n, n] float32 and idx: [nW] int32, or both
// NULL for no mask; 1 <= n <= 128; hd in {4, 8, 16}. Launches on `stream`
// (a cudaStream_t passed as a pointer) and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernels do not take.

extern "C" int idee_window_attention_fwd(const float* q, const float* k,
                                         const float* v, const float* bias,
                                         const float* bank, const int* idx,
                                         float* o, int BW, int n, int G,
                                         int hd, int nW, float scale,
                                         void* stream) {
  if (BW <= 0 || G <= 0) return (int)cudaSuccess;
  if (n < 1 || n > kThreads || G > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 4:
      return launch_fwd<4>(q, k, v, bias, bank, idx, o, BW, n, G, nW, scale,
                           s);
    case 8:
      return launch_fwd<8>(q, k, v, bias, bank, idx, o, BW, n, G, nW, scale,
                           s);
    case 16:
      return launch_fwd<16>(q, k, v, bias, bank, idx, o, BW, n, G, nW,
                            scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dbias_part: [n_blocks, G, n, n] scratch; each of the n_blocks x G blocks
// writes its own slice (every slice is written, so it needs no zeroing).
// n_blocks * G must stay below 2^31.
extern "C" int idee_window_attention_bwd(
    const float* q, const float* k, const float* v, const float* bias,
    const float* bank, const int* idx, const float* o, const float* go,
    float* dq, float* dk, float* dv, float* dbias_part, int BW, int n, int G,
    int hd, int nW, int n_blocks, float scale, void* stream) {
  if (BW <= 0 || G <= 0) return (int)cudaSuccess;
  if (n < 1 || n > kThreads || G > 65535 || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 4:
      return launch_bwd<4>(q, k, v, bias, bank, idx, o, go, dq, dk, dv,
                           dbias_part, BW, n, G, nW, n_blocks, scale, s);
    case 8:
      return launch_bwd<8>(q, k, v, bias, bank, idx, o, go, dq, dk, dv,
                           dbias_part, BW, n, G, nW, n_blocks, scale, s);
    case 16:
      return launch_bwd<16>(q, k, v, bias, bank, idx, o, go, dq, dk, dv,
                            dbias_part, BW, n, G, nW, n_blocks, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dbias [E] = the sum of part [n_blocks, E] over its first axis, in order.
extern "C" int idee_window_attention_dbias_sum(const float* part,
                                               float* dbias, int n_blocks,
                                               int64_t E, void* stream) {
  if (E <= 0) return (int)cudaSuccess;
  const int64_t blocks = (E + 255) / 256;
  dbias_sum_kernel<<<(unsigned int)blocks, 256, 0, (cudaStream_t)stream>>>(
      part, dbias, n_blocks, E);
  return (int)cudaGetLastError();
}
