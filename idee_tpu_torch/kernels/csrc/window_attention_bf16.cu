// ------------------------------------------------------------------
// Window attention of the Swin_3D encoder at bf16 (the compute dtype
// "bfloat16"), forward and backward, on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernels of idee_tpu/kernels/window_attention.py at bf16
// (bf16 q, k, v in, float32 inside, each output rounded once to bf16):
//   _fwd_kernel (via _fwd_pallas)  -> attn_fwd_bf16_kernel
//   _bwd_kernel (via _bwd_pallas)  -> attn_bwd_bf16_kernel, whose per-block
//                                     dbias partials dbias_sum_kernel
//                                     (csrc/window_attention.cu) adds
// Per window w and head g of q, k, v, go [BW, n, G, HD] bf16 (row-major, HD
// contiguous, window index batch-major then window-minor):
//
//   s_ij  = scale (q_i . k_j) + bias[g, i, j] + bank[idx[w % nW], i, j]
//   p_ij  = softmax_j(s_ij),        o_i = sum_j p_ij v_j
//   dp_ij = go_i . v_j,  D_i = sum_j p_ij dp_ij,  ds_ij = p_ij (dp_ij - D_i)
//   dq_i  = scale sum_j ds_ij k_j,  dk_j = scale sum_i ds_ij q_i
//   dv_j  = sum_i p_ij go_i,        dbias[g, i, j] = sum_w ds_ij
//
// D_i comes from the recomputed scores, as _bwd_kernel forms it, not from
// the rounded bf16 output. dbias stays float32.
//
// What bounds them: bytes. At the Swin_3D bench width (G = 12 heads of
// HD = 8; 10,000 windows of 32 tokens, then 40,000 of 8) a forward reads q,
// k, v and writes o, 246 MB of bf16: 0.0734 ms at the H100's 3.35 TB/s,
// against 4 n^2 HD BW G = 3.9 GFLOP (4 us at 989 TFLOP/s bf16). The
// backward moves 7 such tensors, 0.1284 ms (kernels/bounds.py).
//
// What the design does about it.
//   * Every product is an mma.sync of bf16 operands with float32
//     accumulators (m16n8k8 where the depth is 8: q k^T and go v^T at
//     HD <= 8, p v at n <= 8; m16n8k16 otherwise): q k^T, p v, go v^T,
//     ds k, ds^T q, p^T go. One warp takes a
//     16-row tile of one window-head against all its keys. Operands come
//     from shared memory by ldmatrix (.trans for v, k, q and go where they
//     are the B operand over tokens); p^T and ds^T as float32 pairs.
//   * Numerics. q, k, v, go enter as they are, so each product is exact and
//     each sum float32, as the TPU kernel's. The float32 intermediates
//     enter as sums of bf16 parts, each the rounding of what the parts
//     before leave (a single bf16 p would be 2^-9 off, outside the one-ulp
//     check against the float32 products). The forward's e: hi + lo, two
//     mma, about 16 significant bits. The backward's p and ds: hi + mid +
//     lo, three mma, all 24 bits of the float32 values the TPU kernel sums;
//     with hi + lo (the earlier design) a dq or dv that is a cancelling sum
//     missed one ulp + 1e-5 (1 entry in 15.36 M at 20,000 windows of 8).
//   * The softmax stays in registers, in base 2: the m16n8 score
//     accumulators take scale log2(e) and the additive term (bias[g] plus
//     the window's mask row, times log2(e), -inf past the window's keys),
//     which a warp loads once into registers and keeps while its windows
//     share a mask row; the row max and sum go over the four lanes of a row
//     by shuffles; e = ex2.approx(x - max) (relative error ~2^-22). In the
//     forward the accumulator layout of two key tiles is the A fragment of
//     e v, so p never goes through shared memory, and o = (e v) / sum.
//   * Tiles: rows pad to 16, keys to 16 with -inf scores (p = 0), HD = 4 to
//     8 with zeros (staged into the first half of a 16-byte row whose other
//     half stays 0), so every window n <= 128 and HD in {4, 8, 16} runs.
//     Rows read past the window are clamped to its last row: finite values
//     whose products are discarded or multiplied by p = 0. At n <= 8 the
//     forward packs two windows of a head into one 16-row tile (fwd_pair):
//     stage 1's tiles would otherwise be half padding.
//   * Staging. Shared memory holds each head's rows as 16-byte chunks
//     ([chunk][window slot, token][16 B]: a head of HD = 16 is two chunks,
//     one of HD = 4 half of one), so an ldmatrix of 8 rows reads 128
//     contiguous bytes; a chunk tile is one row longer than its tokens, so
//     consecutive chunks of one token land in different banks. Copies are
//     cp.async of 16 bytes (8 at HD = 4), double-buffered: a block loads its
//     next work item while it computes this one.
//   * The forward takes whole token rows of 64 bytes: an item is 4 heads (2
//     at HD = 16, 8 at HD = 4) of as many windows as a stage holds (6 of 32
//     tokens, 24 of 8), so a warp's copies use every byte of each 32-byte
//     sector. Persistent blocks (as many as fit on the card) walk the
//     items; an item's (head, row tile, window) units, windows fastest, are
//     cut into one run per warp, so a warp loads a head's bias rows once
//     for many windows. The output overwrites q's tile in shared memory and
//     leaves in 16-byte rows.
//   * The backward keeps the head-fastest grid of the float32 kernel:
//     block b takes head b % G and window groups b / G, b / G + n_blocks,
//     ... of W = 8 / ceil(n / 16) windows. A warp owns a 16-row tile of one
//     window slot: the scores, p (float32 into shared memory, transposed:
//     [key][row]), D, ds (the same) and dq = ds k from registers. After a
//     barrier the same warp owns a 16-key tile of that slot and reads p^T
//     and ds^T back as 8-byte pairs of rows for dk and dv, splitting each
//     into its three parts in registers. Each warp adds its
//     tile's ds into float32 registers over the block's windows in order;
//     at the end the block adds its warps' sums in slot order into its
//     [G, n, n] partial of dbias: deterministic, no float atomics.
//   * Occupancy (H100): the forward 3 blocks of 8 warps per SM (79
//     registers at n = 32, 58 at n = 8); the backward 3 at n <= 16 (80
//     registers) and 2 at n <= 64 (128 at n = 32, 8 bytes spilled at HD =
//     8; held to 3 blocks' 85 registers an earlier design spilled more and
//     ran slower), the launch bounds of each instantiation.
//   * Shared memory (fwd_smem_bytes, bwd_smem_bytes): the forward two
//     stages of q, k, v, 3 x 4 heads x 193 rows x 16 B each at both stage
//     shapes, 74,112 B; the backward two stages of q, k, v, go, p and ds as
//     float32 [W][16 m keys][16 m + 8] (m = ceil(n / 16); the 8 keep the
//     8-byte reads free of bank conflicts) and dq, dk, dv: 63,616 B at
//     stage 0, 35,968 at stage 1, 184,576 at n = 128, HD = 16.
// ------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTokens = 128;
constexpr int kChunk = 16;  // bytes of a staged row chunk: 8 bf16
// a forward stage: q, k, v of 64 bytes of each token row (4 heads of HD 8)
// for up to 194 tokens; two stages of three blocks fill an SM
constexpr int kFwdTokenBytes = 64;
constexpr int kFwdStageBytes = 37440;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ __forceinline__ int m_tiles(int n) {
  return (n + 15) / 16;
}
__host__ __device__ __forceinline__ int chunks_per_head(int hd) {
  return hd == 16 ? 2 : 1;
}

// the forward's heads per item (kFwdTokenBytes of each token's row) and
// windows per item (as many as a stage holds)
__host__ __device__ __forceinline__ int fwd_heads(int hd) {
  return kFwdTokenBytes / (2 * hd);
}
__host__ __device__ __forceinline__ int fwd_windows(int n, int hd) {
  const int rows =
      kFwdStageBytes / (3 * fwd_heads(hd) * chunks_per_head(hd) * kChunk);
  return (rows - 1) / n < 1 ? 1 : (rows - 1) / n;
}

// bytes of one staged tensor of a forward item, and of the whole kernel
__host__ __device__ __forceinline__ int fwd_tile_bytes(int n, int hd) {
  return fwd_heads(hd) * chunks_per_head(hd) * (fwd_windows(n, hd) * n + 1) *
         kChunk;
}
size_t fwd_smem_bytes(int n, int hd) {
  return (size_t)2 * 3 * fwd_tile_bytes(n, hd);
}

// the backward's shared memory: two stages of q, k, v, go; p and ds as hi
// and lo; dq, dk, dv
struct BwdLayout {
  int W, ct, R, RS, stage_bytes, pds_bytes, out_bytes;
  __host__ __device__ BwdLayout(int n, int hd) {
    const int kc = chunks_per_head(hd);
    W = kWarps / m_tiles(n);
    ct = W * n + 1;
    R = 16 * m_tiles(n);
    RS = R + 8;
    stage_bytes = 4 * kc * ct * kChunk;
    pds_bytes = W * R * RS * 4;
    out_bytes = kc * W * n * kChunk;
  }
  __host__ __device__ int total() const {
    return 2 * stage_bytes + 2 * pds_bytes + 3 * out_bytes;
  }
};

size_t bwd_smem_bytes(int n, int hd) { return BwdLayout(n, hd).total(); }

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the dynamic shared memory of either kernel; the device functions take
// 32-bit byte offsets into it
extern __shared__ __align__(16) unsigned char smem_buf[];

__device__ __forceinline__ unsigned sh_addr(int off) {
  return smem_u32(smem_buf) + (unsigned)off;
}

__device__ __forceinline__ void cp_async(unsigned dst, const void* src,
                                         bool half) {
  if (half)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ldmatrix .x2 / .x4 (.trans). No memory clobber, so global loads may be
// scheduled across it: every shared-memory write it reads is ordered before
// it by a barrier (cp.async waits, stores of another phase) or by a data
// dependency (a warp's output over its own q rows).
template <int N, bool TRANS>
__device__ __forceinline__ void ldsm(unsigned (&r)[N], unsigned addr) {
  static_assert(N == 2 || N == 4, "ldmatrix .x2 or .x4");
  if constexpr (N == 2 && !TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(addr));
  else if constexpr (N == 2)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(addr));
  else if constexpr (!TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// c += a b, a 16x16 (row), b 16x8 (col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma_k16(float (&c)[4], unsigned a0,
                                        unsigned a1, unsigned a2, unsigned a3,
                                        unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a b, a 16x8, b 8x8
__device__ __forceinline__ void mma_k8(float (&c)[4], unsigned a0,
                                       unsigned a1, unsigned b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// 2^x (ex2.approx: relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x, y) as a bf16x2 pair rounded once, and as hi + lo pairs (about 16
// significant bits): lo the bf16 rounding of x - hi, which is exact in
// float32 (pv_step3 takes a third part the same way: all 24 bits)
__device__ __forceinline__ unsigned pack(float x, float y) {
  return bits(__floats2bfloat162_rn(x, y));
}
__device__ __forceinline__ void split(float x, float y, unsigned& hi,
                                      unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack(x - hf.x, y - hf.y);
}

// ---------------------------------------------------------------- tiles

// ldmatrix of a 16-row tile of a staged tensor: rows r0 .. r0 + 15 of the
// window whose tokens start at row `base` of each chunk tile (rows past the
// window's n clamped to its last). Lanes 0-7, 8-15, 16-23, 24-31 address
// the matrices (rows 0-7, chunk 0), (rows 8-15, chunk 0), (rows 0-7, chunk
// 1), (rows 8-15, chunk 1), so
//   !TRANS, KC = 1: {a0, a1} of a m16n8k8 A (rows x dims), or {b0} of two
//     key tiles (rows = keys) of a B over dims;
//   !TRANS, KC = 2: {a0, a1, a2, a3} of a m16n8k16 A, or {b0 tile 0, b0
//     tile 1, b1 tile 0, b1 tile 1} of two key tiles;
//   TRANS: {b0, b1} of a m16n8k16 B over these 16 rows for dims 0-7, then
//     (KC = 2) {b0, b1} for dims 8-15.
template <int KC, bool TRANS>
__device__ __forceinline__ void ldsm_rows(unsigned (&x)[2 * KC],
                                          unsigned tile, int ct, int base,
                                          int r0, int n, int lane) {
  const int r = min(r0 + (lane & 7) + (lane & 8), n - 1);
  const int chunk = KC == 2 ? lane >> 4 : 0;
  ldsm<2 * KC, TRANS>(x, tile + (unsigned)((chunk * ct + base + r) * kChunk));
}

// s0, s1 += the scores of one 16-row A against two key tiles
template <int KC>
__device__ __forceinline__ void qk_step(float (&s0)[4], float (&s1)[4],
                                        const unsigned (&a)[2 * KC],
                                        const unsigned (&b)[2 * KC]) {
  if constexpr (KC == 1) {
    mma_k8(s0, a[0], a[1], b[0]);
    mma_k8(s1, a[0], a[1], b[1]);
  } else {
    mma_k16(s0, a[0], a[1], a[2], a[3], b[0], b[2]);
    mma_k16(s1, a[0], a[1], a[2], a[3], b[1], b[3]);
  }
}

// acc[c] += a b_c for the KC dims tiles of a transposed B
template <int KC>
__device__ __forceinline__ void pv_step(float (&acc)[KC][4],
                                        const unsigned (&a)[4],
                                        const unsigned (&b)[2 * KC]) {
  mma_k16(acc[0], a[0], a[1], a[2], a[3], b[0], b[1]);
  if constexpr (KC == 2) mma_k16(acc[1], a[0], a[1], a[2], a[3], b[2], b[3]);
}

// the hi and lo A fragments of key tiles 2 kk, 2 kk + 1 of accumulators x
template <int NT>
__device__ __forceinline__ void a_pair(const float (&x)[NT][4], int kk,
                                       unsigned (&hi)[4], unsigned (&lo)[4]) {
  split(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
  split(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
  split(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
  split(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
}

// acc[c] += x b_c for an A fragment x of float32 pairs {a0, a1, a2, a3}
// (m16n8k16 layout), split into hi, mid and lo bf16, each the rounding of
// what the parts before leave (x becomes that remainder): three mma each,
// hi first. Each part is made just before its mma, so only one part and
// the remainder are live.
template <int KC>
__device__ __forceinline__ void pv_step3(float (&acc)[KC][4], float2 (&x)[4],
                                         const unsigned (&b)[2 * KC]) {
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    unsigned a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[i].x, x[i].y);
      a[i] = bits(h);
      if (part < 2) {
        const float2 hf = __bfloat1622float2(h);
        x[i].x -= hf.x;
        x[i].y -= hf.y;
      }
    }
    pv_step<KC>(acc, a, b);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// This lane's entries (m16n8 layout: rows r0 + lane / 4 and + 8, clamped
// to the window, keys 8 j + 2 (lane % 4) and + 1) of bias[g] + the mask
// row mrow (or none) times log2(e), and -inf past the window's keys: the
// additive term of the scores in base 2. A warp loads it once for the
// windows of a row tile that share a mask row.
template <int NT>
__device__ __forceinline__ void load_add(float (&B)[NT][4],
                                         const float* __restrict__ bias_g,
                                         const float* __restrict__ mrow,
                                         int r0, int n, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  const int row[2] = {min(r0 + gq, n - 1) * n, min(r0 + gq + 8, n - 1) * n};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * tq + (e & 1), at = row[e >> 1] + c;
      B[j][e] = -INFINITY;
      if (c < n)
        B[j][e] = (mrow != nullptr ? __ldg(bias_g + at) + __ldg(mrow + at)
                                   : __ldg(bias_g + at)) *
                  kLog2e;
    }
}

// The scores of rows r0 .. r0 + 15 (accumulators S, m16n8 layout) into
// e = 2^(x - max x) with x = log2(e) (scale (q . k) + bias + mask), B the
// additive term (load_add), and the row sums l over the row's four lanes:
// softmax p = e / l.
template <int NT>
__device__ __forceinline__ void softmax_rows(float (&S)[NT][4],
                                             const float (&B)[NT][4],
                                             float scale2, float (&l)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      S[j][e] = fmaf(S[j][e], scale2, B[j][e]);
      mx[e >> 1] = fmaxf(mx[e >> 1], S[j][e]);
    }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  l[0] = l[1] = 0.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      S[j][e] = ex2(S[j][e] - mx[e >> 1]);
      l[e >> 1] += S[j][e];
    }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// acc (m16n8 layout, rows r0 + lane / 4 and + 8, dims 8 c + 2 (lane % 4))
// times mul, rounded to bf16, into rows < n of the chunk tiles at `tile`
// (chunk stride ct rows of 16 B, the window's tokens from row `base`). At
// HD = 4 the dims 4-7 are 0 and land in the zero half of each row.
template <int KC>
__device__ __forceinline__ void store_rows(int tile, int ct,
                                           int base, int r0, int n,
                                           const float (&acc)[KC][4],
                                           float mul, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + gq + 8 * h;
      if (r < n)
        *reinterpret_cast<unsigned*>(
            smem_buf + tile + (c * ct + base + r) * kChunk + 4 * tq) =
            pack(acc[c][2 * h] * mul, acc[c][2 * h + 1] * mul);
    }
}

// ---------------------------------------------------------------- forward

// One warp's unit: rows r0 .. r0 + 15 of one window-head, B its additive
// term (load_add). Qt, Kt, Vt: shared addresses of the head's first chunk
// tile in q, k, v; q_out: the byte offset of the same tile of q, which the
// output overwrites (only this warp reads these rows of q, and it has read
// them by then).
template <int MTB, int KC>
__device__ __forceinline__ void fwd_rows(unsigned Qt, unsigned Kt,
                                         unsigned Vt, int q_out,
                                         int ct, int base, int r0, int n,
                                         int mt, const float (&B)[2 * MTB][4],
                                         float scale2, int lane) {
  constexpr int NT = 2 * MTB;  // key tiles of 8
  unsigned a[2 * KC];
  ldsm_rows<KC, false>(a, Qt, ct, base, r0, n, lane);
  float S[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < MTB; ++kk)
    if (kk < mt) {
      unsigned b[2 * KC];
      ldsm_rows<KC, false>(b, Kt, ct, base, 16 * kk, n, lane);
      qk_step<KC>(S[2 * kk], S[2 * kk + 1], a, b);
    }
  float l[2];
  softmax_rows<NT>(S, B, scale2, l);

  // o = (sum_j e_j v_j) / l
  float O[KC][4];
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[c][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < MTB; ++kk)
    if (kk < mt) {
      unsigned hi[4], lo[4], b[2 * KC];
      a_pair<NT>(S, kk, hi, lo);
      ldsm_rows<KC, true>(b, Vt, ct, base, 16 * kk, n, lane);
      pv_step<KC>(O, hi, b);
      pv_step<KC>(O, lo, b);
    }
  const float il[2] = {1.0f / l[0], 1.0f / l[1]};
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[c][e] *= il[e >> 1];
  store_rows<KC>(q_out, ct, base, r0, n, O, 1.0f, lane);
}

// The additive term of a packed tile (windows a and b of n <= 8 tokens in
// one 16-row tile: rows 0-7 window a, rows 8-15 window b): this lane's row
// lane / 4 of bias[g] plus mask row ma (entries 0, 1) or mb (entries 2, 3),
// times log2(e); -inf past the window's keys.
__device__ __forceinline__ void load_add_pair(float (&B)[1][4],
                                              const float* __restrict__ bias_g,
                                              const float* __restrict__ ma,
                                              const float* __restrict__ mb,
                                              int n, int lane) {
  const int row = min(lane >> 2, n - 1) * n, tq = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = 2 * tq + (e & 1), at = row + c;
    const float* m = e < 2 ? ma : mb;
    B[0][e] = -INFINITY;
    if (c < n)
      B[0][e] = (m != nullptr ? __ldg(bias_g + at) + __ldg(m + at)
                              : __ldg(bias_g + at)) *
                kLog2e;
  }
}

// One warp's unit at n <= 8: windows s (rows 0-7) and s + 1 (rows 8-15) of
// one head in one 16-row tile, whose rows would otherwise be half padding.
// Each product takes the two windows' key (or value) tiles as two B
// operands, and each half of the result keeps its own window's rows. base:
// window s's first token row; `second` false when s is the item's last
// window (rows 8-15 then repeat window s and are not stored).
template <int KC>
__device__ __forceinline__ void fwd_pair(unsigned Qt, unsigned Kt,
                                         unsigned Vt, int q_out, int ct,
                                         int base, bool second, int n,
                                         const float (&B)[1][4], float scale2,
                                         int lane) {
  // lanes 8-15 (and 24-31) address window s + 1: the A operand's rows 8-15
  // and the second key or value tile
  const int r = base + ((lane & 8) && second ? n : 0) + min(lane & 7, n - 1);
  const unsigned at =
      (unsigned)(((KC == 2 ? lane >> 4 : 0) * ct + r) * kChunk);
  unsigned a[2 * KC], b[2 * KC];
  ldsm<2 * KC, false>(a, Qt + at);
  ldsm<2 * KC, false>(b, Kt + at);
  float sa[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  qk_step<KC>(sa, sb, a, b);
  float S[1][4] = {{sa[0], sa[1], sb[2], sb[3]}}, l[2];
  softmax_rows<1>(S, B, scale2, l);
  unsigned hi[2], lo[2];
  split(S[0][0], S[0][1], hi[0], lo[0]);
  split(S[0][2], S[0][3], hi[1], lo[1]);
  ldsm<2 * KC, true>(b, Vt + at);
  const float il[2] = {1.0f / l[0], 1.0f / l[1]};
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    float oa[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ob[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_k8(oa, hi[0], hi[1], b[2 * c]);
    mma_k8(oa, lo[0], lo[1], b[2 * c]);
    mma_k8(ob, hi[0], hi[1], b[2 * c + 1]);
    mma_k8(ob, lo[0], lo[1], b[2 * c + 1]);
    if (gq < n) {
      unsigned char* row = smem_buf + q_out + (c * ct + base + gq) * kChunk;
      *reinterpret_cast<unsigned*>(row + 4 * tq) =
          pack(oa[0] * il[0], oa[1] * il[0]);
      if (second)
        *reinterpret_cast<unsigned*>(row + n * kChunk + 4 * tq) =
            pack(ob[2] * il[1], ob[3] * il[1]);
    }
  }
}

// log2 of the power of two >= an item's chunks per token (at most 8): a
// thread's chunk is threadIdx.x mod 2^bits, its first token threadIdx.x >>
// bits
__device__ __forceinline__ int chunk_bits(int chunks) {
  return chunks <= 1 ? 0 : chunks <= 2 ? 1 : chunks <= 4 ? 2 : 3;
}

// Stage (or store) the rows of an item's windows w0 .. w0 + nw - 1 and
// heads g0 .. g0 + gh - 1: element (token, chunk) with the chunk fastest,
// so consecutive threads take consecutive 16-byte (HD = 4: 8-byte) pieces
// of memory.
template <int KC>
__device__ __forceinline__ void fwd_stage(const bf16* q, const bf16* k,
                                          const bf16* v, unsigned tiles,
                                          int tile_bytes,
                                          int ct, int w0, int nw, int g0,
                                          int gh, int n, int G, int hd) {
  const int chunks = gh * KC, bits = chunk_bits(chunks);
  const int cc = threadIdx.x & ((1 << bits) - 1);
  const bool half = hd == 4;
  if (cc >= chunks) return;
  for (int tok = threadIdx.x >> bits; tok < nw * n;
       tok += kThreads >> bits) {
    const int64_t off = ((int64_t)w0 * n + tok) * G * hd + (int64_t)g0 * hd +
                        cc * (half ? 4 : 8);
    const unsigned dst = tiles + (unsigned)((cc * ct + tok) * kChunk);
    cp_async(dst, q + off, half);
    cp_async(dst + (unsigned)tile_bytes, k + off, half);
    cp_async(dst + (unsigned)(2 * tile_bytes), v + off, half);
  }
}

template <int KC>
__device__ __forceinline__ void fwd_store(bf16* __restrict__ o, int tile,
                                          int ct,
                                          int w0, int nw, int g0, int gh,
                                          int n, int G, int hd) {
  const int chunks = gh * KC, bits = chunk_bits(chunks);
  const int cc = threadIdx.x & ((1 << bits) - 1);
  if (cc >= chunks) return;
  for (int tok = threadIdx.x >> bits; tok < nw * n;
       tok += kThreads >> bits) {
    bf16* dst = o + ((int64_t)w0 * n + tok) * G * hd + (int64_t)g0 * hd +
                cc * (hd == 4 ? 4 : 8);
    const unsigned char* s = smem_buf + tile + (cc * ct + tok) * kChunk;
    if (hd == 4)
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(s);
    else
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(s);
  }
}

// zero the staging buffers once: at HD = 4 the second half of every row
// stays 0 (copies fill only the first)
__device__ __forceinline__ void zero_smem(int bytes) {
  for (int e = threadIdx.x; e < bytes / 16; e += kThreads)
    reinterpret_cast<uint4*>(smem_buf)[e] = make_uint4(0, 0, 0, 0);
}

// Persistent blocks walk the items (window group of W windows, group of
// fwd_heads heads). An item's units (head, row tile, window), windows
// fastest, are cut into one run per warp, so a warp loads the bias of a
// (head, row tile) once for many windows. MTB = 0: n <= 8, units of two
// windows (fwd_pair).
template <int MTB, int KC>
__global__ void __launch_bounds__(kThreads, MTB <= 2 ? 3 : 1)
attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ bias,
                     const float* __restrict__ bank,
                     const int* __restrict__ idx, bf16* __restrict__ o,
                     int BW, int n, int G, int hd, int nW, float scale) {
  constexpr int NT = MTB == 0 ? 1 : 2 * MTB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = fwd_windows(n, hd), GH = fwd_heads(hd), mt = m_tiles(n);
  const int ct = W * n + 1, tile_bytes = fwd_tile_bytes(n, hd);
  const int buf_bytes = 3 * tile_bytes;
  const int n_hg = (G + GH - 1) / GH;
  const int n_items = ((BW + W - 1) / W) * n_hg;
  const unsigned base_u32 = sh_addr(0);
  const float scale2 = scale * kLog2e;

  if (hd == 4) {
    zero_smem(2 * buf_bytes);
    __syncthreads();
  }
  int item = blockIdx.x, buf = 0;
  if (item < n_items) {
    const int w0 = (item / n_hg) * W, g0 = (item % n_hg) * GH;
    fwd_stage<KC>(q, k, v, base_u32, tile_bytes, ct, w0, min(W, BW - w0), g0,
                  min(GH, G - g0), n, G, hd);
  }
  cp_async_commit();
  for (; item < n_items; item += gridDim.x, buf ^= 1) {
    const int next = item + gridDim.x;
    if (next < n_items) {
      const int w0 = (next / n_hg) * W, g0 = (next % n_hg) * GH;
      fwd_stage<KC>(q, k, v, base_u32 + (unsigned)((buf ^ 1) * buf_bytes),
                    tile_bytes, ct, w0, min(W, BW - w0), g0, min(GH, G - g0),
                    n, G, hd);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    const int w0 = (item / n_hg) * W, g0 = (item % n_hg) * GH;
    const int nw = min(W, BW - w0), gh = min(GH, G - g0);
    const int tiles = buf * buf_bytes;
    const unsigned tiles_u32 = base_u32 + (unsigned)tiles;
    // MTB = 0: a unit is windows 2 sp and 2 sp + 1 of one head
    const int nu = MTB == 0 ? (nw + 1) / 2 : nw;
    const int units = gh * mt * nu, run = (units + kWarps - 1) / kWarps;
    const int u1 = min(units, (warp + 1) * run);
    int pair = -1, row = -1;  // of the additive term in B
    float B[NT][4];
    if constexpr (MTB == 0) {
      int row_b = -1;
      for (int u = warp * run; u < u1; ++u) {
        const int s = 2 * (u % nu), gl = u / nu;
        const bool second = s + 1 < nw;
        const int ra = bank != nullptr ? idx[(w0 + s) % nW] : 0;
        const int rb = bank != nullptr && second ? idx[(w0 + s + 1) % nW]
                                                 : ra;
        if (gl != pair || ra != row || rb != row_b) {
          pair = gl;
          row = ra;
          row_b = rb;
          load_add_pair(B, bias + (int64_t)(g0 + gl) * n * n,
                        bank != nullptr ? bank + (int64_t)ra * n * n : nullptr,
                        bank != nullptr ? bank + (int64_t)rb * n * n : nullptr,
                        n, lane);
        }
        const int head = gl * KC * ct * kChunk;
        fwd_pair<KC>(tiles_u32 + head, tiles_u32 + tile_bytes + head,
                     tiles_u32 + 2 * tile_bytes + head, tiles + head, ct,
                     s * n, second, n, B, scale2, lane);
      }
    } else {
      for (int u = warp * run; u < u1; ++u) {
        const int s = u % nw;
        const int r = bank != nullptr ? idx[(w0 + s) % nW] : 0;
        if (u / nw != pair || r != row) {
          pair = u / nw;
          row = r;
          load_add<NT>(B, bias + (int64_t)(g0 + pair / mt) * n * n,
                       bank != nullptr ? bank + (int64_t)r * n * n : nullptr,
                       16 * (pair % mt), n, lane);
        }
        const int head = (pair / mt) * KC * ct * kChunk;
        fwd_rows<MTB, KC>(tiles_u32 + head, tiles_u32 + tile_bytes + head,
                          tiles_u32 + 2 * tile_bytes + head, tiles + head,
                          ct, s * n, 16 * (pair % mt), n, mt, B, scale2,
                          lane);
      }
    }
    __syncthreads();
    fwd_store<KC>(o, tiles, ct, w0, nw, g0, gh, n, G, hd);
    __syncthreads();  // the stores have read this buffer before it restages
  }
}

// ---------------------------------------------------------------- backward

// byte offsets in smem_buf of a stage's tiles (from st, the stage's
// offset) and of window slot `slot`'s p and ds tiles, and of the outputs;
// made where they are used, so the loop keeps none of them in registers
struct BwdTiles {
  int q, k, v, go;  // [KC][W n + 1][16 B] each
  int p, ds;        // [R keys][RS] float32 each, transposed
  int dq, dk, dv;   // [KC][W n][16 B] each
  __device__ __forceinline__ BwdTiles(const BwdLayout& L, int kc, int st,
                                      int slot) {
    const int tensor = kc * L.ct * kChunk, pds = 2 * L.stage_bytes;
    q = st;
    k = st + tensor;
    v = st + 2 * tensor;
    go = st + 3 * tensor;
    p = pds + slot * L.R * L.RS * 4;
    ds = p + L.pds_bytes;
    dq = pds + 2 * L.pds_bytes;
    dk = dq + L.out_bytes;
    dv = dq + 2 * L.out_bytes;
  }
};

// key tiles j < tiles of accumulators S (m16n8 layout: rows r and r + 8, r
// = r0 + lane / 4, keys 8 j + 2 (lane % 4) and + 1) as float32 into the
// transposed [R keys][RS] tile at byte offset `t`, entry (key, row) at
// (key RS + row) 4
template <int NT>
__device__ __forceinline__ void put_transposed(const float (&S)[NT][4],
                                               int tiles, int t, int RS,
                                               int r, int lane) {
  float* x = reinterpret_cast<float*>(smem_buf + t);
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < tiles)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[(8 * j + c + (e & 1)) * RS + r + 8 * (e >> 1)] = S[j][e];
}

// The A fragment {a0, a1, a2, a3} of keys k0 .. k0 + 15 x rows r0 .. r0 +
// 15 of a transposed [R keys][RS] float32 tile: each a float2 of two rows
// of one key (8-byte loads, RS = 8 mod 16 keeps each half-warp's free of
// bank conflicts)
__device__ __forceinline__ void load_transposed(float2 (&a)[4], int t,
                                                int RS, int k0, int r0,
                                                int lane) {
  const float* x = reinterpret_cast<const float*>(smem_buf + t);
  const int key = k0 + (lane >> 2), row = r0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = *reinterpret_cast<const float2*>(
        x + (key + 8 * (i & 1)) * RS + row + 8 * (i >> 1));
}

// Row phase of one warp: rows r0 .. r0 + 15 of window slot s. p and ds of
// these rows go to shared memory as float32, transposed (rows past n as
// 0), ds into DB (this warp's float32 sum over its windows), dq into its
// tile.
template <int MTB, int KC>
__device__ __forceinline__ void bwd_rows(const BwdLayout& L, int st, int slot,
                                         int r0, int n, int mt,
                                         const float (&B)[2 * MTB][4],
                                         float scale, float (&DB)[2 * MTB][4],
                                         int lane) {
  constexpr int NT = 2 * MTB;
  const BwdTiles t(L, KC, st, slot);
  const int gq = lane >> 2, base = slot * n;
  unsigned aq[2 * KC], ag[2 * KC];
  ldsm_rows<KC, false>(aq, sh_addr(t.q), L.ct, base, r0, n, lane);
  ldsm_rows<KC, false>(ag, sh_addr(t.go), L.ct, base, r0, n, lane);
  float S[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < MTB; ++kk)
    if (kk < mt) {
      unsigned b[2 * KC];
      ldsm_rows<KC, false>(b, sh_addr(t.k), L.ct, base, 16 * kk, n, lane);
      qk_step<KC>(S[2 * kk], S[2 * kk + 1], aq, b);
    }
  float l[2];
  softmax_rows<NT>(S, B, scale * kLog2e, l);
  // p = e / l; 0 on the rows past the window
  const float il[2] = {r0 + gq < n ? 1.0f / l[0] : 0.0f,
                       r0 + gq + 8 < n ? 1.0f / l[1] : 0.0f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[j][e] *= il[e >> 1];

  put_transposed<NT>(S, 2 * mt, t.p, L.RS, r0 + gq, lane);

  // D = rowsum(p dp), then ds = p (dp - D), dp recomputed (the same mma on
  // the same operands gives the same bits)
  float D[2] = {0.0f, 0.0f};
#pragma unroll
  for (int kk = 0; kk < MTB; ++kk)
    if (kk < mt) {
      unsigned b[2 * KC];
      float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      ldsm_rows<KC, false>(b, sh_addr(t.v), L.ct, base, 16 * kk, n, lane);
      qk_step<KC>(d0, d1, ag, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        D[e >> 1] = fmaf(S[2 * kk][e], d0[e], D[e >> 1]);
        D[e >> 1] = fmaf(S[2 * kk + 1][e], d1[e], D[e >> 1]);
      }
    }
  D[0] = quad_sum(D[0]);
  D[1] = quad_sum(D[1]);
#pragma unroll
  for (int kk = 0; kk < MTB; ++kk)
    if (kk < mt) {
      unsigned b[2 * KC];
      float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      ldsm_rows<KC, false>(b, sh_addr(t.v), L.ct, base, 16 * kk, n, lane);
      qk_step<KC>(d0, d1, ag, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        S[2 * kk][e] *= d0[e] - D[e >> 1];
        S[2 * kk + 1][e] *= d1[e] - D[e >> 1];
      }
    }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) DB[j][e] += S[j][e];
  put_transposed<NT>(S, 2 * mt, t.ds, L.RS, r0 + gq, lane);

  float acc[KC][4];
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < MTB; ++kk)
    if (kk < mt) {
      // ds of key tiles 2 kk, 2 kk + 1 as the A fragment {a0 .. a3}
      float2 x[4] = {{S[2 * kk][0], S[2 * kk][1]},
                           {S[2 * kk][2], S[2 * kk][3]},
                           {S[2 * kk + 1][0], S[2 * kk + 1][1]},
                           {S[2 * kk + 1][2], S[2 * kk + 1][3]}};
      unsigned b[2 * KC];
      ldsm_rows<KC, true>(b, sh_addr(t.k), L.ct, base, 16 * kk, n, lane);
      pv_step3<KC>(acc, x, b);
    }
  store_rows<KC>(t.dq, L.W * n, base, r0, n, acc, scale, lane);
}

// Column phase of one warp: keys k0 .. k0 + 15 of window slot s, with p^T
// and ds^T read back from their transposed float32 tiles: dk = scale ds^T
// q, dv = p^T go, each A split into hi + mid + lo bf16.
template <int MTB, int KC>
__device__ __forceinline__ void bwd_cols(const BwdLayout& L, int st, int slot,
                                         int k0, int n, int mt, float scale,
                                         int lane) {
  const BwdTiles t(L, KC, st, slot);
  const int base = slot * n;
  float dk[KC][4], dv[KC][4];
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[c][e] = 0.0f;
      dv[c][e] = 0.0f;
    }
#pragma unroll
  for (int rt = 0; rt < MTB; ++rt)
    if (rt < mt) {
      float2 x[4];
      unsigned b[2 * KC];
      load_transposed(x, t.p, L.RS, k0, 16 * rt, lane);
      ldsm_rows<KC, true>(b, sh_addr(t.go), L.ct, base, 16 * rt, n, lane);
      pv_step3<KC>(dv, x, b);
      load_transposed(x, t.ds, L.RS, k0, 16 * rt, lane);
      ldsm_rows<KC, true>(b, sh_addr(t.q), L.ct, base, 16 * rt, n, lane);
      pv_step3<KC>(dk, x, b);
    }
  store_rows<KC>(t.dk, L.W * n, base, k0, n, dk, scale, lane);
  store_rows<KC>(t.dv, L.W * n, base, k0, n, dv, 1.0f, lane);
}

template <int MTB, int KC>
__global__ void __launch_bounds__(kThreads, MTB == 1 ? 3 : MTB <= 4 ? 2 : 1)
attn_bwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ bias,
                     const float* __restrict__ bank,
                     const int* __restrict__ idx,
                     const bf16* __restrict__ go, bf16* __restrict__ dq,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     float* __restrict__ dbias_part, int BW, int n, int G,
                     int hd, int nW, int n_blocks, float scale) {
  constexpr int NT = 2 * MTB;
  const BwdLayout L(n, hd);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mt = m_tiles(n), W = L.W, n_groups = (BW + W - 1) / W;
  const int g = blockIdx.x % G, bx = blockIdx.x / G;
  // this warp's window slot and its row tile, then key tile
  const int slot = warp / mt, tile = warp % mt;
  const bool has_slot = warp < W * mt;
  const unsigned base_u32 = sh_addr(0);
  const int tensor_bytes = KC * L.ct * kChunk;
  const int pds = 2 * L.stage_bytes, outs = pds + 2 * L.pds_bytes;
  const bool half = hd == 4;

  // q, k, v, go of head g for windows w0 .. w0 + nw - 1 into stage buf:
  // element (chunk, token) of each tensor, the token fastest
  auto stage = [&](int c, int b) {
    const int w0 = c * W, rows = min(W, BW - w0) * n;
    const int64_t at = ((int64_t)w0 * n * G + g) * hd;
    for (int e = threadIdx.x; e < KC * rows; e += kThreads) {
      const int ch = KC == 2 && e >= rows, tok = e - ch * rows;
      const int64_t off = at + (int64_t)tok * G * hd + ch * 8;
      const unsigned dst = base_u32 + (unsigned)(b * L.stage_bytes +
                                                 (ch * L.ct + tok) * kChunk);
      cp_async(dst, q + off, half);
      cp_async(dst + tensor_bytes, k + off, half);
      cp_async(dst + 2 * tensor_bytes, v + off, half);
      cp_async(dst + 3 * tensor_bytes, go + off, half);
    }
  };

  // this warp's sum of ds over its windows, and the additive term of its
  // rows for mask row `row` (reloaded when a window takes another)
  float DB[NT][4], B[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) DB[j][e] = 0.0f;
  int row = -1;

  if (half) {
    zero_smem(2 * L.stage_bytes);
    __syncthreads();
  }
  int c = bx, buf = 0;
  if (c < n_groups) stage(c, 0);
  cp_async_commit();
  for (; c < n_groups; c += n_blocks, buf ^= 1) {
    if (c + n_blocks < n_groups) stage(c + n_blocks, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    const int w0 = c * W, nw = min(W, BW - w0);
    const int st = buf * L.stage_bytes;
    const bool active = has_slot && slot < nw;
    if (active) {
      const int r = bank != nullptr ? idx[(w0 + slot) % nW] : 0;
      if (r != row) {
        row = r;
        load_add<NT>(B, bias + (int64_t)g * n * n,
                     bank != nullptr ? bank + (int64_t)r * n * n : nullptr,
                     16 * tile, n, lane);
      }
      bwd_rows<MTB, KC>(L, st, slot, 16 * tile, n, mt, B, scale, DB, lane);
    }
    __syncthreads();
    if (active)
      bwd_cols<MTB, KC>(L, st, slot, 16 * tile, n, mt, scale, lane);
    __syncthreads();

    // dq, dk, dv of the group: element (chunk, token) of each
    const int rows = nw * n;
    const int64_t at = ((int64_t)w0 * n * G + g) * hd;
    for (int e = threadIdx.x; e < KC * rows; e += kThreads) {
      const int ch = KC == 2 && e >= rows, tok = e - ch * rows;
      const int64_t off = at + (int64_t)tok * G * hd + ch * 8;
      const unsigned char* s = smem_buf + outs + (ch * W * n + tok) * kChunk;
      if (half) {
        *reinterpret_cast<uint2*>(dq + off) =
            *reinterpret_cast<const uint2*>(s);
        *reinterpret_cast<uint2*>(dk + off) =
            *reinterpret_cast<const uint2*>(s + L.out_bytes);
        *reinterpret_cast<uint2*>(dv + off) =
            *reinterpret_cast<const uint2*>(s + 2 * L.out_bytes);
      } else {
        *reinterpret_cast<uint4*>(dq + off) =
            *reinterpret_cast<const uint4*>(s);
        *reinterpret_cast<uint4*>(dk + off) =
            *reinterpret_cast<const uint4*>(s + L.out_bytes);
        *reinterpret_cast<uint4*>(dv + off) =
            *reinterpret_cast<const uint4*>(s + 2 * L.out_bytes);
      }
    }
    __syncthreads();  // the stores have read the outputs, the cols p and ds
  }

  // the block's partial of dbias: each warp's sum of its row tile into
  // [W][R][R] float32 (over p and ds, which the loop no longer reads), then
  // the slots added in order
  float* dbs = reinterpret_cast<float*>(smem_buf + pds);
  if (has_slot) {
    const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < 2 * mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dbs[((size_t)slot * L.R + 16 * tile + gq + 8 * (e >> 1)) * L.R +
              8 * j + 2 * tq + (e & 1)] = DB[j][e];
  }
  __syncthreads();
  float* part = dbias_part + ((int64_t)bx * G + g) * n * n;
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int r = e / n, col = e % n;
    float a = 0.0f;
    for (int s = 0; s < W; ++s) a += dbs[((size_t)s * L.R + r) * L.R + col];
    part[e] = a;
  }
}

// ---------------------------------------------------------------- host

// above 48 KB a kernel takes dynamic shared memory only after opting in
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// kernels are instantiated for row tiles m = 1, 2, 4, 8 (n <= 16, 32, 64,
// 128), the forward also for m = 0 (n <= 8, two windows a tile), and KC
// chunks per head (1: HD 4 and 8, 2: HD 16)
int tiles_bucket(int n) {
  const int m = m_tiles(n);
  return m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : 8;
}
int fwd_bucket(int n) { return n <= 8 ? 0 : tiles_bucket(n); }

#define IDEE_BF16_CASES(X)                                                   \
  X(1, 1) X(1, 2) X(2, 1) X(2, 2) X(4, 1) X(4, 2) X(8, 1) X(8, 2)
#define IDEE_BF16_FWD_CASES(X) X(0, 1) X(0, 2) IDEE_BF16_CASES(X)

// The forward kernel's shared memory and resident blocks per SM, set up
// for launch; cached per device (the persistent grid reads it every launch)
template <int MTB, int KC>
cudaError_t fwd_setup(int n, int hd, size_t* smem, int* per_sm) {
  static int cached_device = -1, cached_n = -1, cached_hd = -1, cached_blocks;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  *smem = fwd_smem_bytes(n, hd);
  if (device == cached_device && n == cached_n && hd == cached_hd) {
    *per_sm = cached_blocks;
    return cudaSuccess;
  }
  err = allow_smem(attn_fwd_bf16_kernel<MTB, KC>, *smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, attn_fwd_bf16_kernel<MTB, KC>, kThreads, *smem);
  if (err != cudaSuccess) return err;
  cached_device = device;
  cached_n = n;
  cached_hd = hd;
  cached_blocks = *per_sm;
  return cudaSuccess;
}

template <int MTB, int KC>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, const float* bias,
               const float* bank, const int* idx, bf16* o, int BW, int n,
               int G, int hd, int nW, float scale, cudaStream_t stream) {
  size_t smem;
  int per_sm, device, sms;
  cudaError_t err = fwd_setup<MTB, KC>(n, hd, &smem, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  cudaGetDevice(&device);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int W = fwd_windows(n, hd), GH = fwd_heads(hd);
  const int64_t items =
      (int64_t)((BW + W - 1) / W) * ((G + GH - 1) / GH);
  const int64_t blocks = items < (int64_t)per_sm * sms
                             ? items
                             : (int64_t)per_sm * sms;
  attn_fwd_bf16_kernel<MTB, KC><<<(unsigned int)blocks, kThreads, smem,
                                  stream>>>(q, k, v, bias, bank, idx, o, BW,
                                            n, G, hd, nW, scale);
  return (int)cudaGetLastError();
}

template <int MTB, int KC>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const float* bias,
               const float* bank, const int* idx, const bf16* go, bf16* dq,
               bf16* dk, bf16* dv, float* dbias_part, int BW, int n, int G,
               int hd, int nW, int n_blocks, float scale,
               cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(n, hd);
  const cudaError_t err = allow_smem(attn_bwd_bf16_kernel<MTB, KC>, smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_bf16_kernel<MTB, KC>
      <<<(unsigned int)((int64_t)n_blocks * G), kThreads, smem, stream>>>(
          q, k, v, bias, bank, idx, go, dq, dk, dv, dbias_part, BW, n, G, hd,
          nW, n_blocks, scale);
  return (int)cudaGetLastError();
}

int case_of(int bucket, int hd) { return bucket * 4 + chunks_per_head(hd); }

bool shape_ok(int n, int G, int hd) {
  return n >= 1 && n <= kMaxTokens && G <= 65535 &&
         (hd == 4 || hd == 8 || hd == 16);
}

// (shared memory, resident blocks per SM, registers per thread) of one
// kernel at window n, head width hd
template <typename Kernel>
int report(Kernel kernel, size_t smem, int* smem_bytes, int* blocks_per_sm,
           int* registers) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (smem_bytes != nullptr) *smem_bytes = (int)smem;
  if (blocks_per_sm != nullptr) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (registers != nullptr) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    *registers = attr.numRegs;
  }
  return (int)cudaSuccess;
}

int fwd_report(int n, int hd, int* smem_bytes, int* blocks_per_sm,
               int* registers) {
  if (!shape_ok(n, 1, hd)) return (int)cudaErrorInvalidValue;
  switch (case_of(fwd_bucket(n), hd)) {
#define IDEE_FWD_REPORT(MTB, KC)                                            \
  case MTB * 4 + KC:                                                        \
    return report(attn_fwd_bf16_kernel<MTB, KC>, fwd_smem_bytes(n, hd),     \
                  smem_bytes, blocks_per_sm, registers);
    IDEE_BF16_FWD_CASES(IDEE_FWD_REPORT)
#undef IDEE_FWD_REPORT
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int bwd_report(int n, int hd, int* smem_bytes, int* blocks_per_sm,
               int* registers) {
  if (!shape_ok(n, 1, hd)) return (int)cudaErrorInvalidValue;
  switch (case_of(tiles_bucket(n), hd)) {
#define IDEE_BWD_REPORT(MTB, KC)                                            \
  case MTB * 4 + KC:                                                        \
    return report(attn_bwd_bf16_kernel<MTB, KC>, bwd_smem_bytes(n, hd),     \
                  smem_bytes, blocks_per_sm, registers);
    IDEE_BF16_CASES(IDEE_BWD_REPORT)
#undef IDEE_BWD_REPORT
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The C interface. q, k, v, o, go, dq, dk, dv: [BW, n, G, hd] bf16; bias:
// [G, n, n] float32; bank: [K, n, n] float32 and idx: [nW] int32, or both
// NULL for no mask; 1 <= n <= 128; hd in {4, 8, 16}; G <= 65535. Rows move
// in 16-byte pieces (8 at hd = 4), so the pointers must be aligned to 16
// bytes (the wrapper checks). Launches on `stream` (a cudaStream_t passed
// as a pointer) and returns cudaGetLastError(), or cudaErrorInvalidValue
// for a shape the kernels do not take.

extern "C" int idee_window_attention_fwd_bf16(
    const bf16* q, const bf16* k, const bf16* v, const float* bias,
    const float* bank, const int* idx, bf16* o, int BW, int n, int G, int hd,
    int nW, float scale, void* stream) {
  if (BW <= 0 || G <= 0) return (int)cudaSuccess;
  if (!shape_ok(n, G, hd)) return (int)cudaErrorInvalidValue;
  switch (case_of(fwd_bucket(n), hd)) {
#define IDEE_FWD(MTB, KC)                                                   \
  case MTB * 4 + KC:                                                        \
    return launch_fwd<MTB, KC>(q, k, v, bias, bank, idx, o, BW, n, G, hd,   \
                               nW, scale, (cudaStream_t)stream);
    IDEE_BF16_FWD_CASES(IDEE_FWD)
#undef IDEE_FWD
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dbias_part: [n_blocks, G, n, n] float32 scratch; each of the n_blocks x G
// blocks writes its own slice (every slice is written, so it needs no
// zeroing). n_blocks * G must stay below 2^31. No saved output: D_i comes
// from the recomputed scores.
extern "C" int idee_window_attention_bwd_bf16(
    const bf16* q, const bf16* k, const bf16* v, const float* bias,
    const float* bank, const int* idx, const bf16* go, bf16* dq, bf16* dk,
    bf16* dv, float* dbias_part, int BW, int n, int G, int hd, int nW,
    int n_blocks, float scale, void* stream) {
  if (BW <= 0 || G <= 0) return (int)cudaSuccess;
  if (!shape_ok(n, G, hd) || n_blocks < 1) return (int)cudaErrorInvalidValue;
  switch (case_of(tiles_bucket(n), hd)) {
#define IDEE_BWD(MTB, KC)                                                   \
  case MTB * 4 + KC:                                                        \
    return launch_bwd<MTB, KC>(q, k, v, bias, bank, idx, go, dq, dk, dv,    \
                               dbias_part, BW, n, G, hd, nW, n_blocks, scale, \
                               (cudaStream_t)stream);
    IDEE_BF16_CASES(IDEE_BWD)
#undef IDEE_BWD
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Each kernel's shared memory per block (fwd_smem_bytes, bwd_smem_bytes)
// and its resident blocks per SM on the current device at window n and head
// width hd; the mask changes neither (masked is read for the float32
// kernels' signature). The forward's figures hold for G >= its item's
// heads (fwd_heads: 12 at the stage shapes).
extern "C" int idee_window_attention_fwd_bf16_occupancy(int n, int hd,
                                                        int masked,
                                                        int* smem_bytes,
                                                        int* blocks_per_sm) {
  (void)masked;
  return fwd_report(n, hd, smem_bytes, blocks_per_sm, nullptr);
}

extern "C" int idee_window_attention_bwd_bf16_occupancy(int n, int hd,
                                                        int masked,
                                                        int* smem_bytes,
                                                        int* blocks_per_sm) {
  (void)masked;
  return bwd_report(n, hd, smem_bytes, blocks_per_sm, nullptr);
}

// registers per thread of each kernel at window n and head width hd, as
// cudaFuncGetAttributes reads them from the built library
extern "C" int idee_window_attention_fwd_bf16_registers(int n, int hd,
                                                        int* registers) {
  return fwd_report(n, hd, nullptr, nullptr, registers);
}

extern "C" int idee_window_attention_bwd_bf16_registers(int n, int hd,
                                                        int* registers) {
  return bwd_report(n, hd, nullptr, nullptr, registers);
}
