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
// the states each row needs (its occupancy bound k), each pass one exp and
// about 11 float32 operations per state. The exps run on the
// special-function unit (MUFU.EX2, 16 per SM per clock: 4.18e12/s on 132
// SMs at 1.98 GHz), which is the larger operation term: at C=8192 with k
// drawn from 512-2048 (~1.05e7 states) it is ~0.24 ms, against ~0.17 ms
// for the float32 operations at 67 TFLOP/s. The chain is read once:
// ~0.01 ms at 3.35 TB/s. The kernel is bound by operations, not bytes. In
// practice precise expf issues ~8 instructions around its MUFU.EX2, so a
// state-pass issues ~17 warp instructions and the issue rate (4 per SM per
// clock) is the likelier floor: ~0.6 ms at that shape.
//
// Design. One warp per candidate row, R rows (warps) per block, R chosen by
// the caller. The kernel has no shared memory and no block barrier: every
// reduction is an xor-shuffle butterfly inside the warp, so the 96 passes
// pay no __syncthreads and the warps of a block never wait for each other.
// Lane l holds clm[c, l + 32 i] for i < NV in registers, NV (8, 16, 32 or
// 64, a template parameter) the smallest that covers k_cols. So each i is
// one coalesced 128-byte load per warp, and the row is read from device
// memory once for all 96 passes.
//   - Chunks with 32 i >= k are not loaded, and are computed only up to the
//     end of their group of 4 (one exit test per group, not per chunk).
//     States past k add exactly nothing: the chain holds clm ~ 1e30*j there,
//     and a skipped chunk's lanes hold a pad of 1e38, so logp is at most
//     -1e30, below the running max's start, and its exp is exactly 0.
//   - The state number n = l + 32 i + 1 and min(n, B) are recomputed in each
//     pass from the lane and the unrolled i, not held in 2*NV more
//     registers.
//   - The scalar tail (one logf, two expf, five divisions per lane) runs
//     once per warp, in lockstep on its 32 lanes, which all end each
//     iteration with the same lo and hi.
//   - Rows differ in k, and a warp left alone on its SM at the end of the
//     grid runs at a fraction of the issue rate. So the caller may pass an
//     order (rows by decreasing k) in which warps take their rows; the
//     wrapper does so for a batch of more states than one wave
//     (sizing_bisection_rows_per_wave) of the widest rows.
//   - Each warp derives its row's coefficients (token factors, prefill
//     terms) from the candidate's own fields, so a call needs no work on
//     the device besides this launch.
// TMA, wgmma and clusters are not used: there is no matrix product, and the
// chain is read once.
//
// Reduction order is fixed by the source: each lane folds its values in
// ascending i, then the warp combines by a butterfly over offsets 16..1
// (each step adds a pair commutatively, so every lane ends with the same
// value). A row's result depends on nothing but the row: it is bitwise the
// same at any C and R, in any row and launch order, at any k_cols that
// covers its k, and with or without the skip past k.
//
// Numerics follow the Pallas kernel: expf/logf without fast-math, the
// clamps max(mid, 1e-30), max(x, 1e-30), max(wait, 0), and the strict
// y < target. The clamp max(logp, -1e30) is implied in both passes: the
// running max starts at -1e30, and the exp of anything at or below -1e30 is
// exactly 0 either way. n*log(mid) - clm and the sums n*w and min(n, B)*w
// are each one fused multiply-add (fmaf), where the plain version rounds
// the product and the sum separately.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxRowsPerBlock = 8;
constexpr int kGroup = 4;  // chunks per exit test; divides every NV
constexpr float kNegInf = -1e30f;
constexpr float kPad = 1e38f;
constexpr unsigned kFullMask = 0xffffffffu;

// Butterfly over the warp in a fixed order; every lane returns the warp's
// result.
template <int N, bool kIsMax>
__device__ __forceinline__ void warp_reduce(float (&v)[N]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float o = __shfl_xor_sync(kFullMask, v[j], off);
      v[j] = kIsMax ? fmaxf(v[j], o) : v[j] + o;
    }
  }
}

// ``x`` unchanged, but opaque to the optimiser: state numbers derived from
// it are recomputed in each pass instead of hoisted out of the bisection
// loop into NV registers each.
__device__ __forceinline__ float opaque(float x) {
  asm volatile("" : "+f"(x));
  return x;
}

// The candidates' fields, each [C]: what CandidateBatch holds, and the chain
// gathered at k.
struct Candidates {
  const float* clm_at_k;
  const float* alpha;
  const float* beta;
  const float* gamma;
  const float* avg_in;
  const float* avg_out;
  const int* max_batch;
  const int* k;
};

// targets, lo0, hi0, out: [2, C]. Warp w takes row order[w], or row w where
// order is null.
template <int NV>
__global__ void __launch_bounds__(kWarp * kMaxRowsPerBlock, 2)
sizing_bisection_kernel(const float* __restrict__ clm, const Candidates cand,
                        const float* __restrict__ targets,
                        const float* __restrict__ lo0,
                        const float* __restrict__ hi0,
                        const long long* __restrict__ order,
                        float* __restrict__ out, int c, int k_cols,
                        int iters, int skip_past_k) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int w = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (w >= c) return;  // warp-uniform, and the kernel has no barrier
  const int row = order ? static_cast<int>(order[w]) : w;
  const float* crow = clm + static_cast<size_t>(row) * k_cols;

  // The coefficient rows of sizing_kernel.coefficients (the Pallas
  // wrapper's, pallas_kernel.py:154-168), one IEEE operation at a time as
  // PyTorch rounds them, with no contraction.
  const float clm_at_k = __ldg(cand.clm_at_k + row);
  const int k = __ldg(cand.k + row);
  const float kf = static_cast<float>(k);
  const float max_batch = static_cast<float>(__ldg(cand.max_batch + row));
  const float alpha_eff = __ldg(cand.alpha + row);
  const float beta = __ldg(cand.beta + row);
  const float gamma = __ldg(cand.gamma + row);
  const float avg_in = __ldg(cand.avg_in + row);
  const float avg_out = __ldg(cand.avg_out + row);
  const float tc = __fdiv_rn(__fadd_rn(avg_in, avg_out), __fadd_rn(avg_out, 1.f));
  const float tm = __fadd_rn(avg_in, __fmul_rn(avg_out, 0.5f));
  const float bc = __fadd_rn(__fmul_rn(beta, tc), __fmul_rn(gamma, tm));
  const float prefill_extra = __fmul_rn(__fadd_rn(beta, gamma), avg_in);
  const float has_prompt = avg_in > 0.f ? 1.f : 0.f;
  const float inv_avg_out = __fdiv_rn(1.f, fmaxf(avg_out, 1.f));

  // Chunks of 32 states this row needs (below k, within k_cols), and the
  // groups of kGroup chunks that cover them.
  const int col_chunks = k_cols / kWarp;
  const int chunks =
      skip_past_k ? min((k + kWarp - 1) / kWarp, col_chunks) : col_chunks;
  const int groups = (chunks + kGroup - 1) / kGroup;

  float v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    v[i] = i < chunks ? crow[lane + kWarp * i] : kPad;
  const float n0 = static_cast<float>(lane + 1);

  const float tgt[2] = {targets[row], targets[c + row]};
  float lo[2] = {lo0[row], lo0[c + row]};
  float hi[2] = {hi0[row], hi0[c + row]};

  for (int it = 0; it < iters; ++it) {
    float mid[2], ll[2];
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      mid[l] = 0.5f * (lo[l] + hi[l]);
      ll[l] = logf(fmaxf(mid[l], 1e-30f));
    }
    const float na = opaque(n0);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i % kGroup == 0 && i / kGroup >= groups) break;
      const float nf = na + static_cast<float>(kWarp * i);
#pragma unroll
      for (int l = 0; l < 2; ++l)
        mx[l] = fmaxf(mx[l], fmaf(nf, ll[l], -v[i]));
    }
    warp_reduce<2, true>(mx);

    float m[2];
    float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int l = 0; l < 2; ++l) m[l] = fmaxf(mx[l], 0.f);
    const float nb = opaque(n0);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i % kGroup == 0 && i / kGroup >= groups) break;
      const float nf = nb + static_cast<float>(kWarp * i);
      const float minb = fminf(nf, max_batch);
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        const float e = expf(fmaf(nf, ll[l], -v[i]) - m[l]);
        s[3 * l] += e;
        s[3 * l + 1] = fmaf(nf, e, s[3 * l + 1]);
        s[3 * l + 2] = fmaf(minb, e, s[3 * l + 2]);
      }
    }
    warp_reduce<6, false>(s);

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
  if (lane == 0) {
    out[row] = 0.5f * (lo[0] + hi[0]);
    out[c + row] = 0.5f * (lo[1] + hi[1]);
  }
}

using Kernel = decltype(&sizing_bisection_kernel<8>);

// The instantiation that holds ``values_per_lane`` (NV) chain values per
// lane, or null.
Kernel kernel_for(int values_per_lane) {
  switch (values_per_lane) {
    case 8: return sizing_bisection_kernel<8>;
    case 16: return sizing_bisection_kernel<16>;
    case 32: return sizing_bisection_kernel<32>;
    case 64: return sizing_bisection_kernel<64>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on ``stream`` for C rows, ``rows_per_block`` rows per
// block, holding ``values_per_lane`` (NV) chain values per lane, and returns
// cudaGetLastError() (0 on success). Pointers are device pointers to
// contiguous arrays of C values (float32; int32 for max_batch and k), [2, C]
// for targets, lo0, hi0 and out, and [C, k_cols] for clm. ``order`` is an
// int64 permutation of the C rows, or null. ``skip_past_k`` = 0 computes
// every chunk of k_cols, which gives the same bits; it exists to show that
// on the card.
int sizing_bisection_launch(const float* clm, const float* clm_at_k,
                            const float* alpha, const float* beta,
                            const float* gamma, const float* avg_in,
                            const float* avg_out, const int* max_batch,
                            const int* k, const float* targets,
                            const float* lo0, const float* hi0,
                            const long long* order, float* out, int c,
                            int k_cols, int iters, int values_per_lane,
                            int rows_per_block, int skip_past_k,
                            void* stream) {
  if (c <= 0) return 0;
  const Kernel kernel = kernel_for(values_per_lane);
  if (!kernel || k_cols <= 0 || k_cols % kWarp != 0 ||
      k_cols > kWarp * values_per_lane || iters < 0 || rows_per_block < 1 ||
      rows_per_block > kMaxRowsPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const Candidates cand{clm_at_k, alpha, beta, gamma,
                        avg_in,   avg_out, max_batch, k};
  kernel<<<(c + rows_per_block - 1) / rows_per_block, kWarp * rows_per_block,
           0, static_cast<cudaStream_t>(stream)>>>(
      clm, cand, targets, lo0, hi0, order, out, c, k_cols, iters,
      skip_past_k);
  return static_cast<int>(cudaGetLastError());
}

// The rows the current device runs at once (one wave): resident blocks per
// SM at this instantiation's registers, times rows per block, times SMs.
// A negative value is a cudaError, negated.
int sizing_bisection_rows_per_wave(int values_per_lane, int rows_per_block) {
  const Kernel kernel = kernel_for(values_per_lane);
  if (!kernel || rows_per_block < 1 || rows_per_block > kMaxRowsPerBlock)
    return -static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kWarp * rows_per_block, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return blocks * rows_per_block * sms;
}

const char* sizing_bisection_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
