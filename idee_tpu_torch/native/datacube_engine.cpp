// ------------------------------------------------------------------
// Host batch engine of the port (its copy of
// idee_tpu/native/datacube_engine.cpp).
//
// The synthetic __getitem__ hot path -- time-window gather with time
// reversal, rot90/flip augmentation, and label-mask construction
// (reference dataset/Synthetic_dataset.py:310-385) -- fused into ONE pass
// that writes the collated batch buffers directly, parallelised with
// OpenMP over (sample, variable). The numpy path does the same work as a
// chain of np.flip/np.rot90 copies per item followed by an np.stack
// collate, all on one thread.
//
// The 180-degree rot90(k=2) plus optional H/W flip compose into two
// booleans (flip_h, flip_w) per sample, drawn by the Python wrapper with
// the dataset's random stream, so both paths produce bit-identical
// batches.
//
// Build: g++ -O3 -fopenmp -shared -fPIC -std=c++17 (native/__init__.py,
// at first use). Plain C ABI through ctypes.
// ------------------------------------------------------------------

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// dynamic:  [V, T, H, W] float32 (normalized at dataset init)
// extreme:  [T, H, W]    float32
// anomaly:  [V, T, H, W] float32
// base_idx: [B] int64 window start indices
// flip_h/flip_w: [B] uint8 composed augmentation flags
// outputs (pre-allocated, contiguous):
//   x                  [B, V, 1, dt, H, W]
//   mask_extreme       [B, H, W]
//   mask_extreme_loss  [B, H, W]
//   mask_extreme_loss_t[B, dt, H, W]
//   mask_anomaly       [B, V, dt, H, W]
void synth_batch(const float* dynamic, const float* extreme,
                 const float* anomaly,
                 int64_t V, int64_t T, int64_t H, int64_t W, int64_t dt,
                 const int64_t* base_idx, const uint8_t* flip_h,
                 const uint8_t* flip_w, int64_t B,
                 float* x, float* mask_extreme, float* mask_extreme_loss,
                 float* mask_extreme_loss_t, float* mask_anomaly) {
  const int64_t HW = H * W;

#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t b = 0; b < B; ++b) {
    for (int64_t v = 0; v < V; ++v) {
      const int64_t i0 = base_idx[b];
      const bool fh = flip_h[b] != 0;
      const bool fw = flip_w[b] != 0;
      for (int64_t t = 0; t < dt; ++t) {
        // time-reversed window: output step t reads source i0 + dt-1 - t
        const int64_t ts = i0 + dt - 1 - t;
        const float* src_d = dynamic + ((v * T + ts) * HW);
        const float* src_a = anomaly + ((v * T + ts) * HW);
        float* dst_d = x + ((((b * V + v) * dt) + t) * HW);
        float* dst_a = mask_anomaly + ((((b * V + v) * dt) + t) * HW);
        if (!fh && !fw) {
          std::memcpy(dst_d, src_d, sizeof(float) * HW);
          std::memcpy(dst_a, src_a, sizeof(float) * HW);
        } else {
          for (int64_t y = 0; y < H; ++y) {
            const int64_t sy = fh ? (H - 1 - y) : y;
            const float* row_d = src_d + sy * W;
            const float* row_a = src_a + sy * W;
            float* out_d = dst_d + y * W;
            float* out_a = dst_a + y * W;
            if (fw) {
              for (int64_t xx = 0; xx < W; ++xx) {
                out_d[xx] = row_d[W - 1 - xx];
                out_a[xx] = row_a[W - 1 - xx];
              }
            } else {
              std::memcpy(out_d, row_d, sizeof(float) * W);
              std::memcpy(out_a, row_a, sizeof(float) * W);
            }
          }
        }
      }
    }
  }

#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < B; ++b) {
    const int64_t i0 = base_idx[b];
    const bool fh = flip_h[b] != 0;
    const bool fw = flip_w[b] != 0;
    float* me = mask_extreme + b * HW;
    float* mel = mask_extreme_loss + b * HW;
    const float* last = extreme + (i0 + dt - 1) * HW;
    for (int64_t y = 0; y < H; ++y) {
      const int64_t sy = fh ? (H - 1 - y) : y;
      for (int64_t xx = 0; xx < W; ++xx) {
        const int64_t sx = fw ? (W - 1 - xx) : xx;
        const int64_t s = sy * W + sx;
        // mask_extreme: values > 1 zeroed (reference :342-343)
        const float e = last[s];
        me[y * W + xx] = (e > 1.0f) ? 0.0f : e;
        // union over the window, clamped to 1 (reference :346-349)
        float acc = 0.0f;
        for (int64_t t = 0; t < dt; ++t) {
          acc += extreme[(i0 + t) * HW + s];
        }
        mel[y * W + xx] = acc > 1.0f ? 1.0f : acc;
      }
    }
    // time-reversed per-timestep extremes
    for (int64_t t = 0; t < dt; ++t) {
      const float* src = extreme + (i0 + dt - 1 - t) * HW;
      float* dst = mask_extreme_loss_t + (b * dt + t) * HW;
      for (int64_t y = 0; y < H; ++y) {
        const int64_t sy = fh ? (H - 1 - y) : y;
        for (int64_t xx = 0; xx < W; ++xx) {
          dst[y * W + xx] = src[sy * W + (fw ? (W - 1 - xx) : xx)];
        }
      }
    }
  }
}

// VHI label engine (reference dataset/CERRA_dataset.py:452-518):
// vhi = alpha * vci + (1 - alpha) * tci; extreme where vhi < threshold,
// excluding cold-surface pixels. vci/tci/cold: [H, W] float32.
void vhi_mask(const float* vci, const float* tci, const float* cold,
              int64_t HW, float alpha, float threshold, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < HW; ++i) {
    const float vhi = alpha * vci[i] + (1.0f - alpha) * tci[i];
    out[i] = (vhi < threshold && cold[i] == 0.0f) ? 1.0f : 0.0f;
  }
}

int engine_version() { return 1; }

int engine_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
