// SLO sizing bisection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel wva_tpu/analyzers/queueing/pallas_kernel.py
// :_sizing_kernel (wrapped by sizing_bisection_pallas). For every candidate
// row c it runs a 48-iteration bisection on the arrival rate lambda in two
// lanes, TTFT (0) and ITL (1). Each evaluation at rate mid reads the
// cumulative log-service-rate chain clm[c, n]:
//   logp[n] = max(n*log(mid) - clm[n], -1e30),  m = max(max_n logp, 0),
//   w = exp(logp - m),  z = exp(-m) + sum w,
//   n_sys = sum n*w / z,  n_serv = sum min(n, B)*w / z,
// then p_block, throughput, wait, prefill, ITL and TTFT, and moves right
// while the lane's metric is strictly below its target.
//
// Bound on the H100. The work is 96 passes (48 iterations x 2 lanes) over
// each row's chain, each pass one exp and about 11 float32 operations per
// state. At C=8192 and k_cols=2048 that is ~1.6e9 exps and ~1.8e10
// operations: ~0.26 ms at the card's 67 TFLOP/s float32 peak, and nearer
// 0.4 ms if the exps are counted on the special-function units alone
// (16 per SM per clock). The chain itself is 64 MiB, read once: ~0.02 ms at
// 3.35 TB/s. The kernel is bound by operations, not bytes.
//
// Design. One 256-thread block per candidate. Thread t holds the chain
// values clm[c, t + 256*i] for i < k_cols/256 (at most 8) in registers, so
// the row is read from device memory once, coalesced, and reused for all
// 96 passes. Both lanes are evaluated in the same pass, so each iteration
// costs two block reductions: the two maxima, then the six sums.
//
// Reduction order is fixed by the source: each thread folds its values in
// ascending i, a warp combines by an xor-shuffle butterfly (every lane ends
// with the same value, since each step combines a pair commutatively), and
// every thread folds the 8 warp partials from shared memory in ascending
// warp order. So a row's result depends on nothing but the row: it is
// bitwise the same at any C, in any row order, and at any larger k_cols,
// because states past the row's bound k hold clm ~ +1e30*j and contribute
// exactly -1e30 to the maxima and exact zeros to the sums.
//
// Numerics follow the Pallas kernel: expf/logf without fast-math, and the
// clamps max(mid, 1e-30), max(logp, -1e30), max(x, 1e-30), max(wait, 0).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxValues = 8;  // k_cols <= kThreads * kMaxValues = 2048
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

// Block-wide reduction of N values per thread in a fixed order; every
// thread returns the block's result. ``slot`` must not be reused until a
// later __syncthreads (the caller keeps one slot for the maxima and one
// for the sums, so each is rewritten only after the other's barrier).
template <int N, bool kIsMax>
__device__ __forceinline__ void block_reduce(float (&v)[N],
                                             float (&slot)[kWarps][N]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float o = __shfl_xor_sync(kFullMask, v[j], off);
      v[j] = kIsMax ? fmaxf(v[j], o) : v[j] + o;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) slot[warp][j] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float acc = slot[0][j];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      acc = kIsMax ? fmaxf(acc, slot[w][j]) : acc + slot[w][j];
    v[j] = acc;
  }
}

// coef rows ([8, C]): clm_at_k, k, max_batch, alpha, bc, prefill_extra,
// has_prompt, inv_avg_out. targets, lo0, hi0, out: [2, C].
__global__ void __launch_bounds__(kThreads)
sizing_bisection_kernel(const float* __restrict__ clm,
                        const float* __restrict__ coef,
                        const float* __restrict__ targets,
                        const float* __restrict__ lo0,
                        const float* __restrict__ hi0,
                        float* __restrict__ out, int c, int k_cols,
                        int iters) {
  __shared__ float red_max[kWarps][2];
  __shared__ float red_sum[kWarps][6];

  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int nv = k_cols / kThreads;
  const float* crow = clm + static_cast<size_t>(row) * k_cols;

  const float clm_at_k = coef[row];
  const float kf = coef[c + row];
  const float max_batch = coef[2 * c + row];
  const float alpha_eff = coef[3 * c + row];
  const float bc = coef[4 * c + row];
  const float prefill_extra = coef[5 * c + row];
  const float has_prompt = coef[6 * c + row];
  const float inv_avg_out = coef[7 * c + row];

  float v[kMaxValues], nf[kMaxValues], minb[kMaxValues];
#pragma unroll
  for (int i = 0; i < kMaxValues; ++i) {
    v[i] = 0.f;
    nf[i] = 0.f;
    minb[i] = 0.f;
    if (i < nv) {
      const int n = t + kThreads * i;
      v[i] = crow[n];
      nf[i] = static_cast<float>(n + 1);
      minb[i] = fminf(nf[i], max_batch);
    }
  }

  const float tgt[2] = {targets[row], targets[c + row]};
  float lo[2] = {lo0[row], lo0[c + row]};
  float hi[2] = {hi0[row], hi0[c + row]};

  for (int it = 0; it < iters; ++it) {
    float mid[2], ll[2], mx[2];
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      mid[l] = 0.5f * (lo[l] + hi[l]);
      ll[l] = logf(fmaxf(mid[l], 1e-30f));
      mx[l] = kNegInf;
    }
#pragma unroll
    for (int i = 0; i < kMaxValues; ++i) {
      if (i < nv) {
#pragma unroll
        for (int l = 0; l < 2; ++l)
          mx[l] = fmaxf(mx[l], fmaxf(nf[i] * ll[l] - v[i], kNegInf));
      }
    }
    block_reduce<2, true>(mx, red_max);

    float m[2];
    float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int l = 0; l < 2; ++l) m[l] = fmaxf(mx[l], 0.f);
#pragma unroll
    for (int i = 0; i < kMaxValues; ++i) {
      if (i < nv) {
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          const float lp = fmaxf(nf[i] * ll[l] - v[i], kNegInf);
          const float w = expf(lp - m[l]);
          s[3 * l] += w;
          s[3 * l + 1] += nf[i] * w;
          s[3 * l + 2] += minb[i] * w;
        }
      }
    }
    block_reduce<6, false>(s, red_sum);

#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const float z = expf(-m[l]) + s[3 * l];
      const float n_sys = s[3 * l + 1] / z;
      const float n_serv = s[3 * l + 2] / z;
      const float logp_k = kf * ll[l] - clm_at_k;
      const float p_block = expf(fmaxf(logp_k, kNegInf) - m[l]) / z;
      const float x = fmaxf(mid[l] * (1.f - p_block), 1e-30f);
      const float avg_resp = n_sys / x;
      const float avg_serv = n_serv / x;
      const float avg_wait = fmaxf(avg_resp - avg_serv, 0.f);
      const float prefill = (alpha_eff + n_serv * bc + prefill_extra) * has_prompt;
      const float itl = (avg_serv - prefill) * inv_avg_out;
      const float ttft = avg_wait + prefill + itl;
      const float y = l == 0 ? ttft : itl;
      if (y < tgt[l]) {
        lo[l] = mid[l];
      } else {
        hi[l] = mid[l];
      }
    }
  }
  if (t == 0) {
    out[row] = 0.5f * (lo[0] + hi[0]);
    out[c + row] = 0.5f * (lo[1] + hi[1]);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on ``stream`` for C rows and returns cudaGetLastError()
// (0 on success). Pointers are device pointers to contiguous float32 arrays.
int sizing_bisection_launch(const float* clm, const float* coef,
                            const float* targets, const float* lo0,
                            const float* hi0, float* out, int c, int k_cols,
                            int iters, void* stream) {
  if (c <= 0) return 0;
  if (k_cols <= 0 || k_cols % kThreads != 0 ||
      k_cols > kThreads * kMaxValues || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  sizing_bisection_kernel<<<c, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      clm, coef, targets, lo0, hi0, out, c, k_cols, iters);
  return static_cast<int>(cudaGetLastError());
}

const char* sizing_bisection_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
