// The four forecaster fits for Hopper (sm_90a).
//
// Replaces the jitted XLA program wva_tpu/forecast/forecasters.py:_fit_grid
// (an XLA program on the TPU, not a Pallas kernel). For each of M model rows
// it reads two 160-column history grids, newest value last, and writes the
// four forecasts at the row's horizon, clamped at >= 0, in FORECASTERS order:
//   linear          masked least squares over the fine grid's index axis;
//   holt            double exponential smoothing over the fine grid;
//   seasonal_naive  the long-grid value one season before the target;
//   holt_winters    additive triple smoothing over the long grid, with one
//                   seasonal term per phase (i mod season).
// A row with fewer than min_valid samples in a grid gets that grid's last
// value (persistence) for the grid's two forecasters.
//
// Design. One thread per row walks the 160 columns oldest to newest once,
// carrying the five least-squares sums, the Holt state and the Holt-Winters
// state together. The row's 160 seasonal terms sit in a per-thread local
// array indexed by phase: the counterpart of the reference's
// seas.at[rows, phase].set scatter. Rows are independent, so no thread
// cooperates with another: there is no shared memory and no barrier, and a
// row's result depends on nothing but the row, at any M and in any row order.
// The whole fit is one launch; the PyTorch form of the same recurrences is
// some twelve thousand small ops.
//
// Bound on the H100. The bytes are two [M, 160] float32 grids, five [M]
// inputs and the [4, M] output: ~1.35 MB at M=1024, 0.4 us at 3.35 TB/s. The
// 160 steps of each recurrence depend on each other, so the floor is the
// serial chain: per Holt-Winters step, trend -> level + trend -> * (1-a) ->
// + a*(x-s) -> new level -> - level -> * b -> + (1-b)*trend -> two selects
// -> trend, 8 dependent operations, ~4 cycles each on Hopper. 160 steps x 32
// cycles at 1.98 GHz is ~2.6 us, which binds. Nothing here spends it better
// than one thread a row; the local-memory round trip of the seasonal term
// (a load that may alias the previous step's store) lengthens the chain, and
// shortening it is later work.
//
// Rounding. Built with -fmad=false, so no multiply and add are contracted
// into one FFMA: every operation rounds once, in the order the reference and
// the plain PyTorch version (forecasters.fit_grid_plain) write it. rintf
// rounds half to even, as jnp.round and torch.round do; a float-to-int
// conversion truncates, as astype(int32) does; phases are non-negative
// remainders, as jnp.mod gives them.

#include <cuda_runtime.h>

namespace {

constexpr int kGrid = 160;
constexpr int kThreads = 32;

// Smoothing weights, each with its complement, rounded to float32 by the
// caller, and the minimum valid count.
struct Weights {
  float holt_a, holt_1ma, holt_b, holt_1mb;
  float hw_a, hw_1ma, hw_b, hw_1mb, hw_g, hw_1mg;
  float min_valid;
};

__device__ __forceinline__ float clamp_at_zero(float v) {
  return v < 0.f ? 0.f : v;  // a NaN stays NaN, as in jnp.maximum(v, 0)
}

__device__ __forceinline__ int nonneg_mod(int v, int s) {
  const int r = v % s;
  return r < 0 ? r + s : r;
}

__global__ void __launch_bounds__(kThreads)
    fit_grid_kernel(const float* __restrict__ fine,
                    const float* __restrict__ fine_valid,
                    const float* __restrict__ lng,
                    const float* __restrict__ long_valid,
                    const float* __restrict__ h_fine,
                    const float* __restrict__ h_long,
                    const int* __restrict__ season, float* __restrict__ out,
                    int m, Weights w) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= m) return;
  const float* f = fine + static_cast<size_t>(r) * kGrid;
  const float* l = lng + static_cast<size_t>(r) * kGrid;
  const float fv = fine_valid[r];
  const float lv = long_valid[r];
  const float hf = h_fine[r];
  const float hl = h_long[r];
  const int sea = max(season[r], 1);  // callers pass 1..160
  const float fine_start = static_cast<float>(kGrid) - fv;
  const float long_start = static_cast<float>(kGrid) - lv;

  float n = 0.f, sx = 0.f, sy = 0.f, sxx = 0.f, sxy = 0.f;
  float h_level = 0.f, h_trend = 0.f, h_started = 0.f;
  float w_level = 0.f, w_trend = 0.f, w_started = 0.f;
  float seas[kGrid];
  for (int i = 0; i < kGrid; ++i) seas[i] = 0.f;

  for (int i = 0; i < kGrid; ++i) {
    const float xi = static_cast<float>(i);
    // -- linear: the five masked sums, in column order --
    const float y = f[i];
    const float wf = xi >= fine_start ? 1.f : 0.f;
    const float wx = wf * xi;
    n = n + wf;
    sx = sx + wx;
    sy = sy + wf * y;
    sxx = sxx + wx * xi;
    sxy = sxy + wx * y;
    // -- holt --
    {
      const float nl = w.holt_a * y + w.holt_1ma * (h_level + h_trend);
      const float nt = w.holt_b * (nl - h_level) + w.holt_1mb * h_trend;
      const float l2 = h_started > 0.f ? nl : y;
      const float t2 = h_started > 0.f ? nt : 0.f;
      if (wf > 0.f) {
        h_level = l2;
        h_trend = t2;
      }
      h_started = h_started > wf ? h_started : wf;
    }
    // -- holt_winters --
    {
      const float x = l[i];
      const float wl = xi >= long_start ? 1.f : 0.f;
      const int phase = nonneg_mod(i, sea);
      const float s = seas[phase];
      const float nl = w.hw_a * (x - s) + w.hw_1ma * (w_level + w_trend);
      const float nt = w.hw_b * (nl - w_level) + w.hw_1mb * w_trend;
      const float ns = w.hw_g * (x - nl) + w.hw_1mg * s;
      const float l2 = w_started > 0.f ? nl : x;
      const float t2 = w_started > 0.f ? nt : 0.f;
      const float s2 = w_started > 0.f ? ns : s;
      if (wl > 0.f) {
        w_level = l2;
        w_trend = t2;
        seas[phase] = s2;
      }
      w_started = w_started > wl ? w_started : wl;
    }
  }

  const float horizon_fine = static_cast<float>(kGrid - 1) + hf;
  const float denom = n * sxx - sx * sx;
  const float slope = denom > 0.f ? (n * sxy - sx * sy) / denom : 0.f;
  const float intercept = n > 0.f ? (sy - slope * sx) / n : 0.f;
  const float linear = intercept + slope * horizon_fine;
  const float holt = h_level + h_trend * hf;

  const float target = static_cast<float>(kGrid - 1) + hl;
  const float j = rintf(target - static_cast<float>(sea));
  const int ji = min(max(static_cast<int>(j), 0), kGrid - 1);
  const bool j_valid = j >= long_start && j <= static_cast<float>(kGrid - 1);
  const float last_long = l[kGrid - 1];
  const float seasonal_naive = j_valid ? l[ji] : last_long;
  const int f_phase = nonneg_mod(static_cast<int>(rintf(target)), sea);
  const float holt_winters = w_level + w_trend * hl + seas[f_phase];

  const float last_fine = f[kGrid - 1];
  const bool enough_fine = fv >= w.min_valid;
  const bool enough_long = lv >= w.min_valid;
  out[r] = clamp_at_zero(enough_fine ? linear : last_fine);
  out[m + r] = clamp_at_zero(enough_fine ? holt : last_fine);
  out[2 * m + r] = clamp_at_zero(enough_long ? seasonal_naive : last_long);
  out[3 * m + r] = clamp_at_zero(enough_long ? holt_winters : last_long);
}

}  // namespace

extern "C" {

// Launches the kernel on ``stream`` for M rows and returns
// cudaGetLastError() (0 on success). Device pointers to contiguous arrays:
// fine and lng [M, n_grid] float32; fine_valid, long_valid, h_fine, h_long
// [M] float32; season [M] int32; out [4, M] float32. ``weights`` is a host
// pointer to the 11 floats of Weights, in order. n_grid must be 160.
int fit_grid_launch(const float* fine, const float* fine_valid,
                    const float* lng, const float* long_valid,
                    const float* h_fine, const float* h_long,
                    const int* season, float* out, int m, int n_grid,
                    const float* weights, void* stream) {
  if (m <= 0) return 0;
  if (n_grid != kGrid || weights == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Weights w{weights[0], weights[1], weights[2], weights[3],
                  weights[4], weights[5], weights[6], weights[7],
                  weights[8], weights[9], weights[10]};
  fit_grid_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      fine, fine_valid, lng, long_valid, h_fine, h_long, season, out, m, w);
  return static_cast<int>(cudaGetLastError());
}

const char* fit_grid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
