// ------------------------------------------------------------------
// Window attention of the Swin_3D encoder, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of idee_tpu/kernels/window_attention.py:
//   _fwd_kernel (via _fwd_pallas)  -> attn_fwd_kernel
//   _bwd_kernel (via _bwd_pallas)  -> attn_bwd_kernel + dbias_sum_kernel
// Per window w and head g of q, k, v [BW, n, G, HD] (row-major, HD
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
//   * The forward (attn_fwd_kernel) computes every score once, with one
//     expf per score, as the backward's row phase does. A block takes
//     wpb = 128 / n windows and walks all G heads in a loop; thread (window
//     slot wl, token i) owns query row i. The rows of the windows' shift
//     mask, bank[idx[w % nW]] ([wpb][n][n+1]), are staged once for all
//     heads; per head the block stages bias[g] ([n][n+1]) and K_g, V_g
//     (rows of HD floats moved as float4). Thread i writes s_ij into its
//     row of a shared score buffer P [wpb][n][n+1] with the row max m,
//     then one walk forms e = exp(s_ij - m), their sum l and
//     sum_j e v_j, and o_i is that over l. While a head computes, each
//     thread's q, k, v rows of the next head are already loading into
//     registers (without that prefetch the stage-0 launch took 40 % longer
//     on an H100, even at 56 instead of 80 registers). Shared memory
//     (fwd_smem_bytes): K, V 2 wpb (n HD + 4) floats, P wpb n (n+1), bias
//     n (n+1), mask (masked ? wpb : 0) n (n+1):
//       n=32, HD=8: 8,320 + 16,896 + 4,224 = 29,440 B unmasked; 80
//         registers a thread hold it to 6 blocks per SM (shared memory
//         would allow 7); with the mask 46,336 B, 4 blocks per SM;
//       n=8, HD=8 (wpb=16): 8,704 + 4,608 + 288 = 13,600 B unmasked, 6
//         blocks per SM (registers);
//       n=128, HD=16, masked (wpb=1): 16,416 + 3 x 66,048 = 214,560 B,
//         the largest, under the 232,448 B a block may take.
//     The grid is ceil(BW / wpb) blocks (2,500 at either stage shape).
//   * The backward computes every score once, as the TPU kernel does
//     (s, p and dp of a tile stay in VMEM there). It stages Q, K, V and go
//     (rows of HD floats moved as float4: HD is 4, 8 or 16 and every row
//     starts at a multiple of HD floats) and keeps a score buffer P
//     [wpb][n][n+1] in shared memory. Row phase, thread i: s_ij once into
//     P with the row max; a second walk turns P into exp(s - m) and the
//     sum; a third scales it to p_ij, forms dp_ij = go_i . v_j and ds_ij,
//     sums dq_i and leaves p_ij in P. Column phase, thread j: reads p_ij
//     from P (no score, no expf), recomputes dp_ij from the staged go row
//     and its own v_j (the same products in the same order, so the same
//     bits as the row phase), sums dk_j and dv_j, and writes ds_ij back
//     over p_ij; thread (wl, j) owns column j of its slot, so no other
//     thread touches those entries. Per (i, j): ~20 shared accesses (K, V,
//     Q, go as float4), one expf.
//   * dbias is deterministic: no float atomics. After each window group
//     every thread adds the ds of the group's window slots, in slot order,
//     into the n^2 / 128 entries it owns of one shared [n][n+1]
//     accumulator DB; at the end DB is the block's partial [G, n, n]
//     slice, and dbias_sum_kernel adds the partials of all blocks in a
//     fixed order.
//   * Shared memory of the backward (bwd_smem_bytes): Q, K, V, go 4 wpb
//     (n HD + 4) floats (the 4 keep each slot 16-byte aligned and the
//     slots of one warp on different banks), P wpb n (n+1), D 128, DB
//     n (n+1), the additive term (masked ? wpb : 1) n (n+1):
//       n=32, HD=8, masked (wpb=4): 16,640 + 16,896 + 512 + 4,224 + 16,896
//         = 55,168 B, 4 blocks per SM; unmasked 42,496 B, 5 per SM;
//       n=128, HD=16, masked (wpb=1): 32,832 + 66,048 + 512 + 66,048 +
//         66,048 = 231,488 B, the largest, under the 232,448 B a block
//         may take, so every shape the wrapper accepts launches.
// Windows of any n <= 128 run (the TPU path takes only n dividing 128).
//
// bf16 q, k, v (the compute dtype "bfloat16") have kernels of their own on
// the tensor cores, in csrc/window_attention_bf16.cu; their dbias partials
// go through dbias_sum_kernel here.
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

// Four consecutive floats as one 16-byte float4, and back. p must be
// aligned to 16 bytes: rows start at multiples of HD (4, 8 or 16) floats.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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

// a . b over HD, b a float4 row in shared memory, in d order
template <int HD>
__device__ __forceinline__ float dot_row(const float (&a)[HD],
                                         const float4* b) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < HD / 4; ++c) {
    const float4 x = b[c];
    s = fmaf(a[4 * c], x.x, s);
    s = fmaf(a[4 * c + 1], x.y, s);
    s = fmaf(a[4 * c + 2], x.z, s);
    s = fmaf(a[4 * c + 3], x.w, s);
  }
  return s;
}

// acc += a * b over HD, b a float4 row in shared memory
template <int HD>
__device__ __forceinline__ void axpy_row(float (&acc)[HD], float a,
                                         const float4* b) {
#pragma unroll
  for (int c = 0; c < HD / 4; ++c) {
    const float4 x = b[c];
    acc[4 * c] = fmaf(a, x.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(a, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(a, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(a, x.w, acc[4 * c + 3]);
  }
}

// dst[d] = a[d] * scale as HD / 4 float4 stores (dst aligned as load4 /
// store4 need)
template <int HD>
__device__ __forceinline__ void store_row(float* dst, const float (&a)[HD],
                                          float scale) {
#pragma unroll
  for (int c = 0; c < HD / 4; ++c)
    store4(dst + 4 * c, make_float4(a[4 * c] * scale, a[4 * c + 1] * scale,
                                    a[4 * c + 2] * scale,
                                    a[4 * c + 3] * scale));
}

// this thread's q, k, v rows at `row` (HD floats each) into registers
template <int R4>
__device__ __forceinline__ void load_qkv(const float* __restrict__ q,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         int64_t row, float4 (&qr)[R4],
                                         float4 (&kr)[R4], float4 (&vr)[R4]) {
#pragma unroll
  for (int c = 0; c < R4; ++c) {
    qr[c] = load4(q + row + 4 * c);
    kr[c] = load4(k + row + 4 * c);
    vr[c] = load4(v + row + 4 * c);
  }
}

template <int HD, bool MASKED>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias,
                const float* __restrict__ bank, const int* __restrict__ idx,
                float* __restrict__ o, int BW, int n, int G, int nW, int wpb,
                float scale) {
  extern __shared__ float4 smem4[];
  constexpr int R4 = HD / 4;       // float4s per row
  const int slot4 = (n * HD + 4) / 4;
  const int srow = n + 1;          // rows of P, the bias and the mask
  const int p_slot = n * srow;
  const int nn = n * n;
  float4* Ks = smem4;
  float4* Vs = Ks + wpb * slot4;
  float* P = reinterpret_cast<float*>(Vs + wpb * slot4);  // [wpb][n][n+1]
  float* Bs = P + wpb * p_slot;    // bias[g] [n][n+1]
  float* Ms = Bs + p_slot;         // mask rows [wpb][n][n+1] (MASKED)

  const int w0 = blockIdx.x * wpb;
  const int wl = threadIdx.x / n, i = threadIdx.x % n;
  const int w = w0 + wl;
  const bool active = wl < wpb && w < BW;
  int64_t row = active ? row_offset(w, i, 0, n, G, HD) : 0;

  if (MASKED) {  // the windows' mask rows, once for all heads
    for (int e = threadIdx.x; e < wpb * nn; e += blockDim.x) {
      const int sl = e / nn, r = e % nn, ws = w0 + sl;
      if (ws < BW)
        Ms[sl * p_slot + (r / n) * srow + r % n] =
            bank[(int64_t)idx[ws % nW] * nn + r];
    }
  }
  float4 qn[R4], kn[R4], vn[R4];  // this thread's rows of the next head
  if (active) load_qkv<R4>(q, k, v, row, qn, kn, vn);
  const float4* Kw = Ks + wl * slot4;
  const float4* Vw = Vs + wl * slot4;
  float* prow = P + wl * p_slot + i * srow;
  const float* brow = Bs + i * srow;
  const float* mrow = Ms + wl * p_slot + i * srow;

  for (int g = 0; g < G; ++g, row += HD) {
    if (g > 0) __syncthreads();  // the last head's readers are done
    float qs[HD];
    if (active) {
#pragma unroll
      for (int c = 0; c < R4; ++c) {
        Ks[wl * slot4 + i * R4 + c] = kn[c];
        Vs[wl * slot4 + i * R4 + c] = vn[c];
        qs[4 * c] = qn[c].x * scale;
        qs[4 * c + 1] = qn[c].y * scale;
        qs[4 * c + 2] = qn[c].z * scale;
        qs[4 * c + 3] = qn[c].w * scale;
      }
      if (g + 1 < G) load_qkv<R4>(q, k, v, row + HD, qn, kn, vn);
    }
    const float* bias_g = bias + (int64_t)g * nn;
    for (int e = threadIdx.x; e < nn; e += blockDim.x)
      Bs[(e / n) * srow + e % n] = bias_g[e];
    __syncthreads();
    if (!active) continue;

    // s_ij once into P, in the plain version's order (q k^T + bias) + mask
    float m = -INFINITY;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      float s = dot_row<HD>(qs, Kw + j * R4) + brow[j];
      if (MASKED) s += mrow[j];
      prow[j] = s;
      m = fmaxf(m, s);
    }
    // one expf per score: the weights, their sum and the weighted rows of V
    float l = 0.0f, acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float e = expf(prow[j] - m);
      l += e;
      axpy_row<HD>(acc, e, Vw + j * R4);
    }
    store_row<HD>(o + row, acc, 1.0f / l);
  }
}

// D_i = go_i . o_i from the saved output
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
  extern __shared__ float4 smem4[];
  constexpr int R4 = HD / 4;       // float4s per row
  const int slot = n * HD + 4;     // a window's rows (a multiple of 4)
  const int slot4 = slot / 4;
  const int srow = n + 1;          // rows of P, DB and the additive term
  const int p_slot = n * srow;
  float4* Qs = smem4;
  float4* Ks = Qs + wpb * slot4;
  float4* Vs = Ks + wpb * slot4;
  float4* Gs = Vs + wpb * slot4;
  float* P = reinterpret_cast<float*>(Gs + wpb * slot4);  // [wpb][n][n+1]
  float* Dl = P + wpb * p_slot;    // D_i by thread [kThreads]
  float* DB = Dl + kThreads;       // dbias accumulator [n][n+1]
  float* add = DB + p_slot;        // the additive term, see stage_additive
  const int add_slot = bank != nullptr ? p_slot : 0;

  const int g = blockIdx.x % G, bx = blockIdx.x / G, n_bx = gridDim.x / G;
  const int wl = threadIdx.x / n, r = threadIdx.x % n;
  const float4* Qw = Qs + wl * slot4;
  const float4* Kw = Ks + wl * slot4;
  const float4* Vw = Vs + wl * slot4;
  const float4* Gw = Gs + wl * slot4;
  float* Pw = P + wl * p_slot;

  for (int e = threadIdx.x; e < p_slot; e += blockDim.x) DB[e] = 0.0f;
  if (bank == nullptr)
    stage_additive(bias, bank, idx, add, g, 0, BW, n, nW, wpb);

  for (int c = bx; c < n_groups; c += n_bx) {
    const int w = c * wpb + wl;
    const bool active = wl < wpb && w < BW;
    if (bank != nullptr)
      stage_additive(bias, bank, idx, add, g, c * wpb, BW, n, nW, wpb);

    // stage this thread's row r of q, k, v, go; keep q * scale, go, v and
    // D_r in registers
    float qs[HD], gr[HD], vr[HD], delta = 0.0f;
    const int64_t row = row_offset(w, r, g, n, G, HD);
    if (active) {
#pragma unroll
      for (int c4 = 0; c4 < R4; ++c4) {
        const float4 qv = load4(q + row + 4 * c4),
                     kv = load4(k + row + 4 * c4),
                     vv = load4(v + row + 4 * c4),
                     gv = load4(go + row + 4 * c4),
                     ov = load4(o + row + 4 * c4);
        Qs[wl * slot4 + r * R4 + c4] = qv;
        Ks[wl * slot4 + r * R4 + c4] = kv;
        Vs[wl * slot4 + r * R4 + c4] = vv;
        Gs[wl * slot4 + r * R4 + c4] = gv;
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
        const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
        const float oa[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          qs[4 * c4 + u] = qa[u] * scale;
          gr[4 * c4 + u] = ga[u];
          vr[4 * c4 + u] = va[u];
          delta = fmaf(ga[u], oa[u], delta);
        }
      }
      Dl[threadIdx.x] = delta;
    }
    __syncthreads();

    // row phase: thread = query row i; P's row i is this thread's alone
    if (active) {
      const float* arow = add + wl * add_slot + r * srow;
      float* prow = Pw + r * srow;
      float m = -INFINITY;
      for (int j = 0; j < n; ++j) {
        const float s = dot_row<HD>(qs, Kw + j * R4) + arow[j];
        prow[j] = s;
        m = fmaxf(m, s);
      }
      float l = 0.0f;
      for (int j = 0; j < n; ++j) {
        const float e = expf(prow[j] - m);
        prow[j] = e;
        l += e;
      }
      const float il = 1.0f / l;
      float dqa[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) dqa[d] = 0.0f;
      for (int j = 0; j < n; ++j) {
        const float p = prow[j] * il;
        prow[j] = p;
        const float ds = p * (dot_row<HD>(gr, Vw + j * R4) - delta);
        axpy_row<HD>(dqa, ds, Kw + j * R4);
      }
      store_row<HD>(dq + row, dqa, scale);
    }
    __syncthreads();

    // column phase: thread = key column j; entry (i, j) of P is its alone
    if (active) {
      float dka[HD], dva[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dka[d] = 0.0f;
        dva[d] = 0.0f;
      }
      float* pcol = Pw + r;
      const float* Dw = Dl + wl * n;
      for (int i = 0; i < n; ++i) {
        const float p = pcol[i * srow];
        float gi[HD];
#pragma unroll
        for (int c4 = 0; c4 < R4; ++c4) {
          const float4 x = Gw[i * R4 + c4];
          gi[4 * c4] = x.x;
          gi[4 * c4 + 1] = x.y;
          gi[4 * c4 + 2] = x.z;
          gi[4 * c4 + 3] = x.w;
        }
        float dp = 0.0f;  // go_i . v_j, as the row phase formed it
#pragma unroll
        for (int d = 0; d < HD; ++d) dp = fmaf(gi[d], vr[d], dp);
        const float ds = p * (dp - Dw[i]);
        pcol[i * srow] = ds;
#pragma unroll
        for (int d = 0; d < HD; ++d) dva[d] = fmaf(p, gi[d], dva[d]);
        axpy_row<HD>(dka, ds, Qw + i * R4);
      }
      store_row<HD>(dk + row, dka, scale);
      store_row<HD>(dv + row, dva, 1.0f);
    }
    __syncthreads();

    // dbias: each thread adds the group's slots, in slot order, into the
    // DB entries it owns. The next group writes P only after its staging
    // barrier, so no barrier is needed here.
    const int n_act = min(wpb, BW - c * wpb);
    for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
      const int at = (e / n) * srow + e % n;
      float a = DB[at];
      for (int s_ = 0; s_ < n_act; ++s_) a += P[s_ * p_slot + at];
      DB[at] = a;
    }
  }

  // this block's partial dbias (each thread reads the entries it owns)
  float* part = dbias_part + ((int64_t)bx * G + g) * n * n;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x)
    part[e] = DB[(e / n) * srow + e % n];
}

// dbias[e] = the sum of part[b, e] over b, e over G*n*n, in a fixed order:
// the n_blocks partials split into `chunks` runs of ceil(n_blocks /
// chunks); thread (chunk c, output o) of a block of `out` consecutive
// outputs sums run c from 0 in partial order, and the run sums are added
// in run order in shared memory. A warp reads 32 / out runs of `out`
// consecutive floats per load. `out` and `chunks` depend only on
// (n_blocks, E) (kernels/window_attention.py::dbias_sum_shape, which also
// holds the plain version's order), so the same call gives the same bits.
constexpr int kSumUnroll = 8;  // loads in flight before their adds

__global__ void __launch_bounds__(1024)
dbias_sum_kernel(const float* __restrict__ part, float* __restrict__ dbias,
                 int n_blocks, int64_t E, int out, int chunks) {
  extern __shared__ float run_sums[];  // [chunks][out]
  const int o = threadIdx.x % out, c = threadIdx.x / out;
  const int64_t e = (int64_t)blockIdx.x * out + o;
  const int run = (n_blocks + chunks - 1) / chunks;
  const int b1 = min(n_blocks, (c + 1) * run);
  float s = 0.0f;
  if (e < E) {
    const float* p = part + e;
    int b = c * run;
    for (; b + kSumUnroll <= b1; b += kSumUnroll) {
      float x[kSumUnroll];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) x[u] = p[(int64_t)(b + u) * E];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) s += x[u];
    }
    for (; b < b1; ++b) s += p[(int64_t)b * E];
  }
  run_sums[threadIdx.x] = s;
  __syncthreads();
  if (c == 0 && e < E) {
    float t = run_sums[o];
    for (int k = 1; k < chunks; ++k) t += run_sums[k * out + o];
    dbias[e] = t;
  }
}

int windows_per_block(int n) { return kThreads / n; }

// the budget of the design note: K, V; P; the bias; the mask
size_t fwd_smem_bytes(int n, int hd, bool masked) {
  const size_t wpb = windows_per_block(n), nn1 = (size_t)n * (n + 1);
  return sizeof(float) *
         (2 * wpb * (n * hd + 4) + (wpb + 1 + (masked ? wpb : 0)) * nn1);
}

// the budget of the design note: Q, K, V, go; P; D; DB; the additive term
size_t bwd_smem_bytes(int n, int hd, bool masked) {
  const size_t wpb = windows_per_block(n), nn1 = (size_t)n * (n + 1);
  return sizeof(float) * (4 * wpb * (n * hd + 4) + wpb * nn1 + kThreads +
                          nn1 + (masked ? wpb : 1) * nn1);
}

// above 48 KB a kernel takes dynamic shared memory only after opting in
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int HD, bool MASKED>
int launch_fwd(const float* q, const float* k, const float* v,
               const float* bias, const float* bank, const int* idx, float* o, int BW, int n, int G,
               int nW, float scale, cudaStream_t stream) {
  const int wpb = windows_per_block(n);
  const size_t smem = fwd_smem_bytes(n, HD, MASKED);
  const cudaError_t err = allow_smem(attn_fwd_kernel<HD, MASKED>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (BW + wpb - 1) / wpb;  // each walks all G heads
  attn_fwd_kernel<HD, MASKED><<<(unsigned int)blocks, kThreads, smem,
                                   stream>>>(q, k, v, bias, bank, idx, o, BW,
                                             n, G, nW, wpb, scale);
  return (int)cudaGetLastError();
}

int launch_fwd(const float* q, const float* k, const float* v,
               const float* bias, const float* bank, const int* idx, float* o,
               int BW, int n, int G, int hd, int nW, float scale,
               cudaStream_t stream) {
  const bool m = bank != nullptr;
  switch (hd * 2 + (m ? 1 : 0)) {
#define IDEE_FWD(HD, MASKED)                                               \
  case HD * 2 + MASKED:                                                    \
    return launch_fwd<HD, (MASKED != 0)>(q, k, v, bias, bank, idx, o, BW, \
                                         n, G, nW, scale, stream);
    IDEE_FWD(4, 0) IDEE_FWD(4, 1) IDEE_FWD(8, 0) IDEE_FWD(8, 1)
    IDEE_FWD(16, 0) IDEE_FWD(16, 1)
#undef IDEE_FWD
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int HD>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* bias, const float* bank, const int* idx,
               const float* o, const float* go, float* dq, float* dk,
               float* dv, float* dbias_part, int BW, int n, int G,
               int nW, int n_blocks, float scale, cudaStream_t stream) {
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

int launch_bwd(const float* q, const float* k, const float* v,
               const float* bias, const float* bank, const int* idx,
               const float* o, const float* go, float* dq, float* dk,
               float* dv, float* dbias_part, int BW, int n, int G,
               int hd, int nW, int n_blocks, float scale,
               cudaStream_t stream) {
  switch (hd) {
#define IDEE_BWD(HD)                                                        \
  case HD:                                                                  \
    return launch_bwd<HD>(q, k, v, bias, bank, idx, o, go, dq, dk, dv,      \
                             dbias_part, BW, n, G, nW, n_blocks, scale,     \
                             stream);
    IDEE_BWD(4) IDEE_BWD(8) IDEE_BWD(16)
#undef IDEE_BWD
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int fwd_occupancy(int n, int hd, bool masked, int* smem_bytes,
                  int* blocks_per_sm) {
  if (n < 1 || n > kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(n, hd, masked);
  *smem_bytes = (int)smem;
  switch (hd * 2 + (masked ? 1 : 0)) {
#define IDEE_FWD_OCC(HD, MASKED)                                            \
  case HD * 2 + MASKED: {                                                   \
    const cudaError_t err =                                                 \
        allow_smem(attn_fwd_kernel<HD, (MASKED != 0)>, smem);            \
    if (err != cudaSuccess) return (int)err;                                \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(              \
        blocks_per_sm, attn_fwd_kernel<HD, (MASKED != 0)>, kThreads,     \
        smem);                                                              \
  }
    IDEE_FWD_OCC(4, 0) IDEE_FWD_OCC(4, 1) IDEE_FWD_OCC(8, 0)
    IDEE_FWD_OCC(8, 1) IDEE_FWD_OCC(16, 0) IDEE_FWD_OCC(16, 1)
#undef IDEE_FWD_OCC
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int bwd_occupancy(int n, int hd, bool masked, int* smem_bytes,
                  int* blocks_per_sm) {
  if (n < 1 || n > kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(n, hd, masked);
  *smem_bytes = (int)smem;
  switch (hd) {
#define IDEE_BWD_OCC(HD)                                                    \
  case HD: {                                                                \
    const cudaError_t err = allow_smem(attn_bwd_kernel<HD>, smem);       \
    if (err != cudaSuccess) return (int)err;                                \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(              \
        blocks_per_sm, attn_bwd_kernel<HD>, kThreads, smem);             \
  }
    IDEE_BWD_OCC(4) IDEE_BWD_OCC(8) IDEE_BWD_OCC(16)
#undef IDEE_BWD_OCC
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool fwd_shape_ok(int n, int G) { return n >= 1 && n <= kThreads && G <= 65535; }

}  // namespace

// The C interface. q, k, v, o, go, dq, dk, dv: [BW, n, G, hd] float32;
// bias: [G, n, n] float32; bank: [K, n, n] float32 and idx: [nW] int32,
// or both NULL for no mask; 1 <= n <= 128; hd in {4, 8, 16}; the kernels
// move q, k, v, o, go, dq, dk, dv as float4, so their pointers must be
// aligned to 16 bytes (the wrapper checks). Launches on `stream` (a
// cudaStream_t passed as a pointer) and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernels do not take.

extern "C" int idee_window_attention_fwd(const float* q, const float* k,
                                         const float* v, const float* bias,
                                         const float* bank, const int* idx,
                                         float* o, int BW, int n, int G,
                                         int hd, int nW, float scale,
                                         void* stream) {
  if (BW <= 0 || G <= 0) return (int)cudaSuccess;
  if (!fwd_shape_ok(n, G)) return (int)cudaErrorInvalidValue;
  return launch_fwd(q, k, v, bias, bank, idx, o, BW, n, G, hd, nW, scale,
                    (cudaStream_t)stream);
}

// dbias_part: [n_blocks, G, n, n] float32 scratch; each of the n_blocks x G
// blocks writes its own slice (every slice is written, so it needs no
// zeroing). n_blocks * G must stay below 2^31.
extern "C" int idee_window_attention_bwd(
    const float* q, const float* k, const float* v, const float* bias,
    const float* bank, const int* idx, const float* o, const float* go,
    float* dq, float* dk, float* dv, float* dbias_part, int BW, int n, int G,
    int hd, int nW, int n_blocks, float scale, void* stream) {
  if (BW <= 0 || G <= 0) return (int)cudaSuccess;
  if (!fwd_shape_ok(n, G) || n_blocks < 1) return (int)cudaErrorInvalidValue;
  return launch_bwd(q, k, v, bias, bank, idx, o, go, dq, dk, dv, dbias_part,
                    BW, n, G, hd, nW, n_blocks, scale, (cudaStream_t)stream);
}

// dbias [E] = the sum of part [n_blocks, E] over its first axis, in the
// order of dbias_sum_kernel: blocks of `out` outputs x `chunks` runs of the
// partials (out * chunks <= 1024 threads).
extern "C" int idee_window_attention_dbias_sum(const float* part,
                                               float* dbias, int n_blocks,
                                               int64_t E, int out, int chunks,
                                               void* stream) {
  if (E <= 0) return (int)cudaSuccess;
  if (n_blocks < 1 || out < 1 || chunks < 1 || out * chunks > 1024)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (E + out - 1) / out;
  const int threads = out * chunks;
  dbias_sum_kernel<<<(unsigned int)blocks, threads, threads * sizeof(float),
                     (cudaStream_t)stream>>>(part, dbias, n_blocks, E, out,
                                             chunks);
  return (int)cudaGetLastError();
}

// Each kernel's shared memory per block (fwd_smem_bytes, bwd_smem_bytes)
// and its resident blocks per SM on the current device, at window n, head
// width hd, with (masked != 0) or without a mask.
extern "C" int idee_window_attention_fwd_occupancy(int n, int hd, int masked,
                                                   int* smem_bytes,
                                                   int* blocks_per_sm) {
  return fwd_occupancy(n, hd, masked != 0, smem_bytes, blocks_per_sm);
}

extern "C" int idee_window_attention_bwd_occupancy(int n, int hd, int masked,
                                                   int* smem_bytes,
                                                   int* blocks_per_sm) {
  return bwd_occupancy(n, hd, masked != 0, smem_bytes, blocks_per_sm);
}

