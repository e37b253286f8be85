// ------------------------------------------------------------------
// Weight and bias gradients of the per-variable Dense layer
// (nn/layers.py::GroupedDense), for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA transposes the einsum's dot for
// the gradient (the JAX package's GroupedDense is a plain einsum). On the
// card, autograd turns that gradient into one cuBLAS batched product
// [V, I, M] @ [V, M, O] whose few 32x32 tiles (6 to 12 blocks on 132 SMs)
// each walk all M tokens alone; this kernel splits the tokens instead.
//
// For x [M, V*I] and dy [M, V*O] (row-major, the V variables packed in
// each row, as the layer's activations are):
//
//   dW[v, a, b] = sum_m x[m, v*I + a] dy[m, v*O + b]
//   db[v, b]    = sum_m dy[m, v*O + b]          (with a bias)
//
// What bounds it: bytes. Each x and dy element is read once: (I + O) V
// elements a token, against 2 I O V float32 operations. At the Mamba
// bench shapes (V = 6, M = 320,000 tokens, the six Dense layers of a
// block) that is 6,624 B against 34,560 operations a token: 2.12 GB and
// 0.633 ms a block at 3.35 TB/s, over the 0.165 ms that 67 TFLOP/s would
// take (kernels/bounds.py::grouped_wgrad).
//
// What the design does about it:
//   * Pass 1 (grouped_wgrad_kernel): block (c, y) takes the contiguous
//     token chunk [c chunk_len, (c + 1) chunk_len) and reads its x and dy
//     rows, all V variables, as tiles of `tile` tokens (chunks and tiles
//     start on multiples of 8 tokens): a tile's rows
//     are contiguous in device memory, so each tile moves as 16-byte
//     cp.async copies into shared memory, kStages tiles in flight. A
//     thread owns a 4 x 4 block of one variable's [I, O] outputs (or, for
//     the bias, 4 outputs of one variable's [O]) and accumulates the outer
//     products of its tokens in float32 registers with FFMA: per token two
//     16-byte (float32) or 8-byte (bf16) shared loads feed 16 FMAs. Where
//     a layer has few outputs, `groups` threads share one block of
//     outputs and take every groups-th token of a tile; their sums are
//     added in group order at the end. The block writes one float32
//     partial [V I O (+ V O)] of its chunk to a workspace; outputs beyond
//     512 threads' worth go to further blocks along y, which read the same
//     chunk.
//   * Pass 2 (wgrad_sum_kernel): the partials of all chunks added in a
//     fixed order, as dbias_sum_kernel (csrc/window_attention.cu) does:
//     `runs` ordered runs of the chunks, then the run sums in run order;
//     the sum rounded once to the output type (bf16 for bf16 inputs).
//   * Every split (tile, groups, chunk_len, runs) is a function of the
//     shape alone (kernels/grouped_dense.py::wgrad_plan), so one shape
//     always adds in one order: the result is the same bits run to run.
//     Nothing is allocated or synchronised here, so a CUDA graph may
//     capture both launches. float32 inputs run on FFMA only (no TF32);
//     bf16 inputs are widened exactly to float32 and run the same way.
// ------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;       // tiles in flight (kernels/grouped_dense.py)
constexpr int kMaxThreads = 512;
constexpr int kRedStride = 17;   // floats per thread in the group sum
constexpr int kSumUnroll = 8;    // loads in flight before their adds

struct Plan {
  int64_t M, chunk_len, E;  // tokens, tokens a chunk, floats a partial
  int V, I, O, has_bias;
  int tile, groups, units;  // tokens a tile, token groups, units a block
  int n_units;              // 4x4 output blocks, then bias quads
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as Tensor.to
}

// four consecutive elements as float32; p aligned to four elements
__device__ __forceinline__ void load4(const float* p, float (&r)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&r)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  r[0] = __uint_as_float(v.x << 16);
  r[1] = __uint_as_float(v.x & 0xffff0000u);
  r[2] = __uint_as_float(v.y << 16);
  r[3] = __uint_as_float(v.y & 0xffff0000u);
}

// n contiguous elements from src to dst (both 16-byte aligned) as 16-byte
// cp.async copies; the < 16-byte tail, which only the last tile of the
// arrays can have, as plain loads and stores
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int64_t n) {
  constexpr int kPer = 16 / sizeof(T);
  const int64_t nv = n / kPer;
  for (int64_t i = threadIdx.x; i < nv; i += blockDim.x)
    cp_async16(dst + i * kPer, src + i * kPer);
  for (int64_t i = nv * kPer + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__host__ __device__ __forceinline__ int64_t align16(int64_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// VEC: I and O are multiples of 4, so a thread's four x and four dy
// elements of a row are one aligned vector each; otherwise they are read
// one by one, with the offsets past I or O clamped (their sums are never
// written).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 2)
grouped_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     float* __restrict__ part, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int RX = p.V * p.I, RY = p.V * p.O;
  const int64_t xs_elems = align16((int64_t)p.tile * RX * sizeof(T)) /
                           sizeof(T);
  const int64_t stage_elems =
      xs_elems + align16((int64_t)p.tile * RY * sizeof(T)) / sizeof(T);
  T* stages = reinterpret_cast<T*>(smem);

  const int64_t t_begin = (int64_t)blockIdx.x * p.chunk_len;
  const int64_t t_end = min64(p.M, t_begin + p.chunk_len);
  const int n_tiles = (int)((t_end - t_begin + p.tile - 1) / p.tile);

  // this thread's unit: a 4 x 4 block (v, a0.., b0..) of dW, or the bias
  // quad (v, b0..) of db
  const int g = threadIdx.x / p.units, ul = threadIdx.x % p.units;
  const int u = blockIdx.y * p.units + ul;
  const bool active = g < p.groups && u < p.n_units;
  const int na = (p.I + 3) / 4, nb = (p.O + 3) / 4;
  const int n_gemm = p.V * na * nb;
  const bool is_bias = u >= n_gemm;
  int v, a0 = 0, b0;
  if (!is_bias) {
    v = u / (na * nb);
    const int r = u % (na * nb);
    a0 = 4 * (r / nb);
    b0 = 4 * (r % nb);  // neighbouring lanes: neighbouring dy vectors
  } else {
    v = (u - n_gemm) / nb;
    b0 = 4 * ((u - n_gemm) % nb);
  }
  int xo[4], yo[4];  // row offsets of the operands (VEC: only [0])
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    xo[k] = v * p.I + min(a0 + k, p.I - 1);
    yo[k] = v * p.O + min(b0 + k, p.O - 1);
  }

  float acc[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[k][l] = 0.0f;

  // every call commits one group (empty past the last tile), so that
  // wait_group<kStages - 1> always means "the tile of this iteration"
  auto issue = [&](int it) {
    if (it < n_tiles) {
      const int64_t t0 = t_begin + (int64_t)it * p.tile;
      const int64_t n = min64(p.tile, t_end - t0);
      T* st = stages + (it % kStages) * stage_elems;
      copy_tile(st, x + t0 * RX, n * RX);
      copy_tile(st + xs_elems, dy + t0 * RY, n * RY);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int it = 0; it < n_tiles; ++it) {
    issue(it + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (active) {
      const T* xs = stages + (it % kStages) * stage_elems;
      const T* ys = xs + xs_elems;
      const int n =
          (int)min64(p.tile, t_end - (t_begin + (int64_t)it * p.tile));
      if (is_bias) {
        for (int t = g; t < n; t += p.groups) {
          float yv[4];
          if (VEC) {
            load4(ys + t * RY + yo[0], yv);
          } else {
#pragma unroll
            for (int l = 0; l < 4; ++l) yv[l] = to_float(ys[t * RY + yo[l]]);
          }
#pragma unroll
          for (int l = 0; l < 4; ++l) acc[0][l] += yv[l];
        }
      } else {
#pragma unroll 4
        for (int t = g; t < n; t += p.groups) {
          float xv[4], yv[4];
          if (VEC) {
            load4(xs + t * RX + xo[0], xv);
            load4(ys + t * RY + yo[0], yv);
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              xv[k] = to_float(xs[t * RX + xo[k]]);
              yv[k] = to_float(ys[t * RY + yo[k]]);
            }
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int l = 0; l < 4; ++l)
              acc[k][l] = fmaf(xv[k], yv[l], acc[k][l]);
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next issue
  }

  if (p.groups > 1) {
    // the groups' sums in group order, through the idle stages
    float* red = reinterpret_cast<float*>(smem);
    if (active) {
      float* r = red + ((int64_t)g * p.units + ul) * kRedStride;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int l = 0; l < 4; ++l) r[4 * k + l] = acc[k][l];
    }
    __syncthreads();
    if (!active || g != 0) return;
    for (int g2 = 1; g2 < p.groups; ++g2) {
      const float* r = red + ((int64_t)g2 * p.units + ul) * kRedStride;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[k][l] += r[4 * k + l];
    }
  } else if (!active) {
    return;
  }

  float* pr = part + (int64_t)blockIdx.x * p.E;
  if (!is_bias) {
    pr += (int64_t)v * p.I * p.O;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int a = a0 + k;
      if (a >= p.I) break;
      float* row = pr + (int64_t)a * p.O + b0;
      if (VEC) {
        *reinterpret_cast<float4*>(row) =
            make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      } else {
#pragma unroll
        for (int l = 0; l < 4; ++l)
          if (b0 + l < p.O) row[l] = acc[k][l];
      }
    }
  } else {
    float* row = pr + (int64_t)p.V * p.I * p.O + (int64_t)v * p.O + b0;
    if (VEC) {
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    } else {
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (b0 + l < p.O) row[l] = acc[0][l];
    }
  }
}

// out[e] = the sum of part[:, e] over its n_chunks rows, e < E: run c of
// the `runs` runs of ceil(n_chunks / runs) rows summed from 0 in row order
// by thread (c, o) of a block of `out` consecutive outputs, then the run
// sums added in run order; e < Ew goes to dw[e], the rest to db[e - Ew],
// rounded once to OutT.
template <typename OutT>
__global__ void __launch_bounds__(1024)
wgrad_sum_kernel(const float* __restrict__ part, OutT* __restrict__ dw,
                 OutT* __restrict__ db, int n_chunks, int64_t E, int64_t Ew,
                 int out, int runs) {
  extern __shared__ float run_sums[];  // [runs][out]
  const int o = threadIdx.x % out, c = threadIdx.x / out;
  const int64_t e = (int64_t)blockIdx.x * out + o;
  const int run = (n_chunks + runs - 1) / runs;
  const int b1 = min(n_chunks, (c + 1) * run);
  float s = 0.0f;
  if (e < E) {
    const float* q = part + e;
    int b = c * run;
    for (; b + kSumUnroll <= b1; b += kSumUnroll) {
      float r[kSumUnroll];
#pragma unroll
      for (int k = 0; k < kSumUnroll; ++k) r[k] = q[(int64_t)(b + k) * E];
#pragma unroll
      for (int k = 0; k < kSumUnroll; ++k) s += r[k];
    }
    for (; b < b1; ++b) s += q[(int64_t)b * E];
  }
  run_sums[threadIdx.x] = s;
  __syncthreads();
  if (c == 0 && e < E) {
    float t = run_sums[o];
    for (int k = 1; k < runs; ++k) t += run_sums[k * out + o];
    if (e < Ew)
      dw[e] = from_float<OutT>(t);
    else
      db[e - Ew] = from_float<OutT>(t);
  }
}

size_t smem_bytes(const Plan& p, size_t elem) {
  const int64_t stage = align16((int64_t)p.tile * p.V * p.I * elem) +
                        align16((int64_t)p.tile * p.V * p.O * elem);
  const int64_t red = p.groups > 1
                          ? (int64_t)p.groups * p.units * kRedStride * 4
                          : 0;
  return (size_t)(kStages * stage > red ? kStages * stage : red);
}

int threads_of(const Plan& p) { return (p.units * p.groups + 31) / 32 * 32; }

bool plan_ok(const Plan& p) {
  // tiles start on multiples of 8 tokens: 16-byte aligned rows
  return p.M > 0 && p.chunk_len > 0 && p.chunk_len % 8 == 0 && p.V > 0 &&
         p.I > 0 && p.O > 0 &&
         p.tile > 0 && p.tile % 8 == 0 && p.groups > 0 && p.units > 0 &&
         threads_of(p) <= kMaxThreads && smem_bytes(p, 4) <= 232448;
}

Plan make_plan(int64_t M, int V, int I, int O, int has_bias, int tile,
               int groups, int units, int64_t chunk_len) {
  Plan p;
  p.M = M;
  p.chunk_len = chunk_len;
  p.V = V;
  p.I = I;
  p.O = O;
  p.has_bias = has_bias != 0;
  p.tile = tile;
  p.groups = groups;
  p.units = units;
  const int nb = (O + 3) / 4;
  p.n_units = V * ((I + 3) / 4) * nb + (p.has_bias ? V * nb : 0);
  p.E = (int64_t)V * I * O + (p.has_bias ? (int64_t)V * O : 0);
  return p;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, bool VEC>
int launch_wgrad(const void* x, const void* dy, float* part, const Plan& p,
                 int n_chunks, int y_groups, cudaStream_t stream) {
  const size_t smem = smem_bytes(p, sizeof(T));
  const cudaError_t err = allow_smem(grouped_wgrad_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  grouped_wgrad_kernel<T, VEC>
      <<<dim3((unsigned)n_chunks, (unsigned)y_groups), threads_of(p), smem,
         stream>>>(static_cast<const T*>(x), static_cast<const T*>(dy), part,
                   p);
  return (int)cudaGetLastError();
}

}  // namespace

// Pass 1. x [M, V*I], dy [M, V*O] (float32, or bf16 when bf16 != 0),
// contiguous and 16-byte aligned; part [n_chunks, E] float32 scratch, each
// block writing its own entries (all of them are written, so it needs no
// zeroing). Grid (n_chunks, y_groups), units * groups threads a block.
extern "C" int idee_grouped_wgrad(const void* x, const void* dy, float* part,
                                  int64_t M, int V, int I, int O,
                                  int has_bias, int tile, int groups,
                                  int units, int64_t chunk_len, int n_chunks,
                                  int y_groups, int bf16, void* stream) {
  const Plan p = make_plan(M, V, I, O, has_bias, tile, groups, units,
                           chunk_len);
  if (M <= 0) return (int)cudaSuccess;
  if (!plan_ok(p) || n_chunks < 1 || y_groups < 1 ||
      (int64_t)n_chunks * chunk_len < M ||
      (int64_t)y_groups * units < p.n_units)
    return (int)cudaErrorInvalidValue;
  const bool vec = I % 4 == 0 && O % 4 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return vec ? launch_wgrad<__nv_bfloat16, true>(x, dy, part, p, n_chunks,
                                                   y_groups, s)
               : launch_wgrad<__nv_bfloat16, false>(x, dy, part, p, n_chunks,
                                                    y_groups, s);
  return vec ? launch_wgrad<float, true>(x, dy, part, p, n_chunks, y_groups, s)
             : launch_wgrad<float, false>(x, dy, part, p, n_chunks, y_groups,
                                          s);
}

// Pass 2. dw [Ew] and db [E - Ew] (float32, or bf16 when bf16 != 0) = the
// ordered sum of part [n_chunks, E] over its rows; db may be NULL when
// E == Ew. out * runs <= 1024 threads a block.
extern "C" int idee_grouped_wgrad_sum(const float* part, void* dw, void* db,
                                      int n_chunks, int64_t E, int64_t Ew,
                                      int out, int runs, int bf16,
                                      void* stream) {
  if (E <= 0) return (int)cudaSuccess;
  if (n_chunks < 1 || out < 1 || runs < 1 || out * runs > 1024 || Ew > E ||
      (db == nullptr && Ew != E))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((E + out - 1) / out);
  const int threads = out * runs;
  const size_t smem = threads * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    wgrad_sum_kernel<__nv_bfloat16><<<blocks, threads, smem, s>>>(
        part, static_cast<__nv_bfloat16*>(dw),
        static_cast<__nv_bfloat16*>(db), n_chunks, E, Ew, out, runs);
  else
    wgrad_sum_kernel<float><<<blocks, threads, smem, s>>>(
        part, static_cast<float*>(dw), static_cast<float*>(db), n_chunks, E,
        Ew, out, runs);
  return (int)cudaGetLastError();
}
