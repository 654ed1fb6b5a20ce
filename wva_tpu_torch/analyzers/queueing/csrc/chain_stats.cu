// The queueing chain's statistics for Hopper (sm_90a), in two
// instantiations of one evaluation: the EKF tuner's h and jacobian (three
// tangents, one row) and the sizing path's and the fleet solve's chain
// statistics (no tangents, C rows).
//
// Replaces the reference's XLA programs (not Pallas kernels) that run
// rate_bounds_per_ms (wva_tpu/analyzers/queueing/queue_model.py:136),
// _masked_log_mu (:144), _chain_stats (:229) and _derived_latencies
// (:278): jax.jacfwd through them in _observe_and_jacobian
// (wva_tpu/analyzers/queueing/tuner.py:158), and the same functions at the
// binding rate in size_batch (queue_model.py:392) and at the requested rate
// in analyze_batch (:293). The plain versions are
// tuner.observe_and_jacobian_plain (torch.func.jacfwd) and the port's
// queue_model functions, which CPU tensors take.
//
// What it computes, per row at arrival rate lambda: log mu(n) per state,
// +1e30 past k; the inclusive prefix sum of log lambda - log mu(n) with
// state 0 a fixed 0, clamped at -1e30 (logp); logsumexp over the states,
// logz = log(sum exp(logp - m)) + m, m the largest logp (0 where it is
// infinite); p = exp(logp - logz); sum n p and sum min(n, B) p, and p_block
// = p[k]; then throughput, the response and wait times, prefill at the mean
// occupancy, itl and ttft (chain_common.cuh). States past k end at logp =
// -1e30 (the first lands on it, the rest below and clamped with no
// tangent), so their p is exp(-1e30 - logz) = 0 and they add exactly
// nothing to any sum. Every state n >= B has the same log mu (its eff is
// B), so a row evaluates it once for all of them.
//
// T = 3, the tuner's step (chain_jacobian_kernel): x [3] = (alpha, beta,
// gamma) and env [5] = (lambda per ms, avg input tokens, avg output tokens,
// max batch, k), float32; lambda clipped as minimum(maximum(env, lo), hi);
// out [2, 4]: row 0 TTFT, row 1 ITL, each the value then its derivatives by
// alpha, beta and gamma, at K_MAX = 2048 states. Every value carries three
// tangents with torch's forward rules, as torch.func.jacfwd computes them.
//
// T = 0, the chain statistics (chain_stats_kernel), in two modes:
//   - the sizing path's tail (mode 0): lam_star [2, C] from the sizing
//     kernel, the targets [3, C] (TTFT, ITL, TPS) and lambda_max [C]; the
//     rate is the lane merge of _size_batch_core, minimum(minimum(rate_ttft,
//     rate_itl), rate_tps), each rate lambda_max where its target is off;
//     out [9, C]: the TTFT, ITL and TPS rates and the binding rate (req/s),
//     achieved TTFT and ITL, achieved TPS, throughput (req/s) and rho;
//   - the fleet solve's analyze_batch (mode 1): the requested rates [C] in
//     req/s, clipped to [lambda_min, lambda_max] as minimum(maximum(.));
//     out [10, C]: throughput (req/s), response and wait times, the mean
//     number in service, prefill, itl, ttft, lambda_max and the rate
//     analyzed (req/s), rho; and valid [C] (bool): the rate was inside the
//     bounds.
//
// Design, T = 0. One warp a row, 8 rows a block, a segment's 256 floats a
// row in shared memory (8 KiB a block), no barrier but the warp's own. The
// row's states are held in registers in segments of 256: lane l holds
// states 256 s + 8 l + 1 .. + 8 of segment s. The row walks only the
// segments that hold its states 1 .. min(k, k_cols), at least one, and at
// most S (1, 2, 4 or 8, a template parameter, the fewest that cover
// k_cols): at analyze_batch's k_cols 2048 with k = 480, 2 of 8. In each
// segment, the states that need their own log mu (below B and within k: a
// division and a log each) are dealt across the warp, state 256 s + j + 1
// to lane j mod 32, and handed to their holders through the row's shared
// segment (3 a lane at B = 96, where lane l once evaluated its own 8). The
// prefix sum: each lane's 8 states in order, a Hillis-Steele scan of the
// lanes' sums (shfl_up, lower + upper), (carry + the lanes below) + the
// lane's own, the carry into the next segment the unclamped prefix at the
// segment's last state. Each reduction (the maximum, sum w, the two
// moments) runs over a lane's states in segment order (lane 0 takes state
// 0 first), then an xor butterfly (own + other; every lane ends with the
// same bits, as float addition commutes). Every lane then has the row's
// statistics, and lanes 0-8 (the tail) or 0-9 (analyze) store one output
// row each. So a row's bits depend on nothing but the row: not on C, its
// position, the other rows, or S and k_cols once they cover its k. The
// states past k that a wider walk would visit end at logp = -1e30 (below
// the maximum, at least state 0's 0) and add exact zeros to sums that are
// already +0 or more, so the walk's limit leaves every bit as it was
// (tests/chain_host.py keeps the full walk, with each lane evaluating its
// own states, as the oracle).
//
// Design, T = 3. One block of kThreads = 512 threads, kPer = 4 states a
// thread: thread g holds states kPer g + 1 .. kPer g + kPer, and thread 0
// state 0 as well.
//   - Only states below B need their own log mu (a division and a log on
//     four lanes, whose slow-path branches keep one thread's from
//     overlapping); every state at or above B takes mu(B)'s. Those few are
//     dealt out across the block, state tid + 1 + j kThreads to thread tid,
//     into shared memory, while two threads form mu(1) and mu(B); one
//     barrier, then every thread clips the rate and reads its states' own
//     log mu back.
//   - Each sum: sequential within a thread over its states in order (state
//     0 first), a warp shuffle tree (the scan Hillis-Steele, the reductions
//     an xor butterfly), then the block's warp totals in one warp's shuffle
//     tree (lane w holds warp w's total; every warp runs it, so each thread
//     has the result after one barrier).
// On an H100 this was faster than one block of 256 threads (8 states a
// thread, each evaluating all of its states' service rates), of 1024 (2
// states a thread), and a cluster of 4 blocks of 256 combining their sums
// over distributed shared memory (PERF.md).
//
// What bounds it on the H100. T = 3: the bytes are 64, the work ~0.2 MFLOP;
// the bound is the chain of dependent operations (the candidate's scalars,
// one state's log ratio, the scan, three reductions, the derived values:
// ~170 with the tangents, jacobian_kernel.CHAIN_OPS), ~0.34 us. T = 0 at
// C rows: the bytes (the inputs and the outputs once, ~80 bytes a row) and
// the operations (two exps and ~20 float operations a state, a division
// and a log a state below B) against the same chain without tangents. A
// row's own chain (ceil((min(B, k + 1) - 1) / 32) log mu on a lane, then
// per walked segment a 5-step scan and three 5-step butterflies) is what a
// launch of a few rows takes.
//
// Rounding. Built with -fmad=false: each operation rounds once, as the
// plain versions' do. Their sums take other orders (and on the CPU cumsum
// accumulates in double), so the kernel is held to them within a tolerance,
// not bit for bit. Everything from here to the line "---- the kernel" is
// host C++ as well (define __device__ and __forceinline__ away):
// tests/test_torch_chain_host.py and tests/test_torch_jacobian_host.py run
// it in the kernels' schedules on the CPU.

#include <cuda_runtime.h>
#include <math.h>

#include "chain_common.cuh"

namespace {

using namespace chain;

// ---------------------------------------------------------------- T = 3

using Dual = Num<3>;

// The block: kThreads threads, kPer states each.
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = kMaxStates / kThreads;
static_assert(kPer * kThreads == kMaxStates,
              "the block's threads must split the states evenly");

// The tuner's candidate (C = 1) from x and env; the derivatives' seeds.
__device__ __forceinline__ Cand<3> jacobian_candidate(const float* x,
                                                      const float* env) {
  Dual a = constant<3>(x[0]), b = constant<3>(x[1]), g = constant<3>(x[2]);
  a.t[0] = b.t[1] = g.t[2] = 1.0f;
  return make_candidate<3>(a, b, g, env[1], env[2],
                           static_cast<int>(env[3]), static_cast<int>(env[4]));
}

// lambda = minimum(maximum(env, eps mu(1)), (1 - eps) mu(B))
// (rate_bounds_per_ms and the clip).
__device__ __forceinline__ Dual clip_rate(float lam_env, Dual mu_1,
                                          Dual mu_b) {
  return minimum(maximum(constant<3>(lam_env), scale(mu_1, kEpsilon)),
                 scale(mu_b, kOneLessEpsilon));
}

// The run's prefix, in place of its own log mu: lp[i] the sum of the log
// ratios log lambda - log mu(n) (masked) up to and including state n0 + i,
// in order. Returns the run's total.
template <int T, int P>
__device__ __forceinline__ Num<T> run_prefix(const Cand<T>& c, Num<T> log_lam,
                                             Num<T> sat, int n0, int last,
                                             Num<T> (&lp)[P]) {
  Num<T> run = zero<T>();
#pragma unroll
  for (int i = 0; i < P; ++i) {
    run = add(run, sub(log_lam, masked(c, sat, lp[i], n0 + i, last)));
    lp[i] = run;
  }
  return run;
}

// logp of a run: the states before it (offset) plus its own prefix,
// clamped at -1e30. Returns the run's last unclamped prefix.
template <int T, int P>
__device__ __forceinline__ Num<T> finish_prefix(Num<T> offset,
                                                Num<T> (&lp)[P]) {
  Num<T> last;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    last = add(offset, lp[i]);
    lp[i] = clamp_min(last, kNegInf);
  }
  return last;
}

// The run's largest logp (state 0's 0 first where `first`).
template <int T, int P>
__device__ __forceinline__ float run_max(bool first, const Num<T> (&lp)[P]) {
  float m = first ? 0.0f : -INFINITY;
#pragma unroll
  for (int i = 0; i < P; ++i) m = max_nan(m, lp[i].v);
  return m;
}

// The run's sums of w and w logp' (state 0 first where `first`).
template <int T, int P>
__device__ __forceinline__ Num<T> run_weights(bool first,
                                              const Num<T> (&lp)[P], float m) {
  Num<T> s = first ? add(zero<T>(), weight(constant<T>(0.0f), m)) : zero<T>();
#pragma unroll
  for (int i = 0; i < P; ++i) s = add(s, weight(lp[i], m));
  return s;
}

// The run's moments (state 0 first where `first`): p = exp(logp - logz) at
// each of its states. The run that holds state k stores its p in *p_at_k.
template <int T, int P>
__device__ __forceinline__ Moments<T> run_moments(const Cand<T>& c, bool first,
                                                  int n0,
                                                  const Num<T> (&lp)[P],
                                                  Num<T> logz,
                                                  Num<T>* p_at_k) {
  Moments<T> s = moments_zero<T>();
  if (first) {
    const Num<T> p0 = dexp(sub(constant<T>(0.0f), logz));
    s = moments_at(s, p0, 0, c.batch);
    if (c.k == 0) *p_at_k = p0;
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const Num<T> p = dexp(sub(lp[i], logz));
    s = moments_at(s, p, n0 + i, c.batch);
    if (n0 + i == c.k) *p_at_k = p;
  }
  return s;
}

// h and H: out[0..4) TTFT, out[4..8) ITL, each the value and its three
// derivatives.
__device__ __forceinline__ void observation(const Cand<3>& c, Dual lam,
                                            Moments<3> sums, Dual p_block,
                                            float* out) {
  const Stats<3> s = chain_stats(c, lam, sums, p_block);
  const Dual rows[2] = {s.ttft, s.itl};
  for (int r = 0; r < 2; ++r) {
    out[4 * r] = rows[r].v;
    for (int j = 0; j < 3; ++j) out[4 * r + 1 + j] = rows[r].t[j];
  }
}

// ---------------------------------------------------------------- T = 0

constexpr int kTailRows = 9;
constexpr int kAnalyzeRows = 10;

// The sizing path's rates (_size_batch_core's lane merge), req/ms:
// rate_ttft, rate_itl, rate_tps and the binding rate.
struct TailRates {
  float ttft, itl, tps, best;
};

__device__ __forceinline__ TailRates tail_rates(float star_ttft,
                                                float star_itl, float t_ttft,
                                                float t_itl, float t_tps,
                                                float lam_max) {
  TailRates r;
  r.ttft = t_ttft > 0.0f ? star_ttft : lam_max;
  r.itl = t_itl > 0.0f ? star_itl : lam_max;
  r.tps = t_tps > 0.0f ? lam_max * kTpsFraction : lam_max;
  r.best = minimum(minimum(constant<0>(r.ttft), constant<0>(r.itl)),
                   constant<0>(r.tps)).v;
  return r;
}

// analyze_batch's rate: the request (req/s) in req/ms, whether it lies in
// [lo, hi], and the rate clipped into it.
struct AnalyzeRate {
  float lam;
  bool valid;
};

__device__ __forceinline__ AnalyzeRate analyze_rate(float rate_per_s,
                                                    Bounds<0> b) {
  const float req = rate_per_s / 1000.0f;
  return {minimum(maximum(constant<0>(req), b.lo), b.hi).v,
          req >= b.lo.v && req <= b.hi.v};
}

// The nine rows of the sizing path's result.
__device__ __forceinline__ void tail_rows(const Cand<0>& cand, TailRates r,
                                          const Stats<0>& s,
                                          float (&row)[kTailRows]) {
  const float x = s.throughput.v * 1000.0f;
  const float rows[kTailRows] = {
      r.ttft * 1000.0f, r.itl * 1000.0f, r.tps * 1000.0f, r.best * 1000.0f,
      s.ttft.v, s.itl.v, x * cand.out, x,
      clamp01(s.in_servers.v / static_cast<float>(cand.batch))};
  for (int i = 0; i < kTailRows; ++i) row[i] = rows[i];
}

// The ten rows of analyze_batch's result.
__device__ __forceinline__ void analyze_rows(const Cand<0>& cand, Bounds<0> b,
                                             float lam, const Stats<0>& s,
                                             float (&row)[kAnalyzeRows]) {
  const float rows[kAnalyzeRows] = {
      s.throughput.v * 1000.0f, s.resp.v, s.wait.v, s.in_servers.v,
      s.prefill.v, s.itl.v, s.ttft.v, b.hi.v * 1000.0f, lam * 1000.0f,
      clamp01(s.in_servers.v / static_cast<float>(cand.batch))};
  for (int i = 0; i < kAnalyzeRows; ++i) row[i] = rows[i];
}

// Output row `lane` of `row` (0 past it): the value lane `lane` stores.
template <int R>
__device__ __forceinline__ float row_of(const float (&row)[R], int lane) {
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < R; ++i) v = lane == i ? row[i] : v;
  return v;
}

// The lane that holds state k in the T = 0 layout (state 0: lane 0).
__device__ __forceinline__ int holder_lane(int k) {
  return k < 1 ? 0 : ((k - 1) % kSegment) / kPerLane;
}

// ---- the kernel: device code only from here on

constexpr unsigned kAll = 0xffffffffu;

template <int T>
__device__ __forceinline__ Num<T> shfl_up(Num<T> x, int off) {
  Num<T> r;
  r.v = __shfl_up_sync(kAll, x.v, off);
  for (int j = 0; j < T; ++j) r.t[j] = __shfl_up_sync(kAll, x.t[j], off);
  return r;
}

template <int T>
__device__ __forceinline__ Num<T> shfl_xor(Num<T> x, int off) {
  Num<T> r;
  r.v = __shfl_xor_sync(kAll, x.v, off);
  for (int j = 0; j < T; ++j) r.t[j] = __shfl_xor_sync(kAll, x.t[j], off);
  return r;
}

template <int T>
__device__ __forceinline__ Num<T> shfl(Num<T> x, int src) {
  Num<T> r;
  r.v = __shfl_sync(kAll, x.v, src);
  for (int j = 0; j < T; ++j) r.t[j] = __shfl_sync(kAll, x.t[j], src);
  return r;
}

// Hillis-Steele inclusive scan over the warp's lanes: lower + upper.
template <int T>
__device__ __forceinline__ Num<T> warp_scan(Num<T> x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Num<T> lower = shfl_up(x, off);
    if (lane >= off) x = add(lower, x);
  }
  return x;
}

template <int T>
__device__ __forceinline__ Num<T> warp_sum(Num<T> x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = add(x, shfl_xor(x, off));
  return x;
}

template <int T>
__device__ __forceinline__ Moments<T> warp_sum(Moments<T> x) {
  return {warp_sum(x.in_system), warp_sum(x.in_servers)};
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max_nan(m, __shfl_xor_sync(kAll, m, off));
  return m;
}

// ---- T = 0: one warp a row
// (At least one block an SM: with the thread count alone ptxas held the
// S = 4 instantiation to 64 registers and spilled 32 bytes.)

template <int S>
__global__ void __launch_bounds__(32 * kRowsPerBlock, 1)
    chain_stats_kernel(Rows rows, const float* __restrict__ rate,
                       const float* __restrict__ lam_star,
                       const float* __restrict__ targets,
                       const float* __restrict__ lam_max_in,
                       float* __restrict__ out, bool* __restrict__ valid,
                       int n_rows, int k_cols, int mode) {
  // Each row's segment of dealt own log mu.
  __shared__ __align__(16) float dealt_own[kRowsPerBlock][kSegment];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kRowsPerBlock + warp;
  if (c >= n_rows) return;
  float* seg = dealt_own[warp];
  const float4* seg4 = reinterpret_cast<const float4*>(seg);
  const Cand<0> cand = row_candidate(rows, c);
  Bounds<0> b;
  TailRates tail;
  float lam;
  if (mode == 0) {
    b.hi = constant<0>(lam_max_in[c]);
    tail = tail_rates(lam_star[c], lam_star[n_rows + c], targets[c],
                      targets[n_rows + c], targets[2 * n_rows + c], b.hi.v);
    lam = tail.best;
  } else {
    b = rate_bounds(cand);
    const AnalyzeRate a = analyze_rate(rate[c], b);
    lam = a.lam;
    if (lane == 0) valid[c] = a.valid;
  }
  const Num<0> log_lam = dlog(clamp_min(constant<0>(lam), 1e-30f));
  const Num<0> sat = saturated_log_mu(cand);
  const int walked = row_segments(cand.k, k_cols);

  // The prefix sum, segment by segment.
  Num<0> lp[S][kPerLane];
  Num<0> carry = zero<0>();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (s >= walked) break;
    const int n0 = kSegment * s + kPerLane * lane + 1;
    const int count = own_count(cand, s, k_cols);
    if (count > 0) {
      deal_own_log_mu(cand, s, lane, count, seg);
      __syncwarp();
      const float4 lo = seg4[2 * lane], hi = seg4[2 * lane + 1];
      const float dealt[kPerLane] = {lo.x, lo.y, lo.z, lo.w,
                                     hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) lp[s][i] = constant<0>(dealt[i]);
      __syncwarp();
    } else {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) lp[s][i] = constant<0>(0.0f);
    }
    const Num<0> incl =
        warp_scan(run_prefix(cand, log_lam, sat, n0, k_cols, lp[s]), lane);
    Num<0> below = shfl_up(incl, 1);
    if (lane == 0) below = zero<0>();
    carry = shfl(finish_prefix(add(carry, below), lp[s]), 31);
  }

  // logsumexp: the maximum, then the weights and logz.
  float m = -INFINITY;
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (s < walked) m = max_nan(m, run_max(lane == 0 && s == 0, lp[s]));
  m = warp_max(m);
  m = fabsf(m) == INFINITY ? 0.0f : m;
  Num<0> ws = zero<0>();
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (s < walked)
      ws = add(ws, run_weights(lane == 0 && s == 0, lp[s], m));
  const Num<0> logz = log_partition(warp_sum(ws), m);

  // The moments and p_block.
  Num<0> p_at_k = constant<0>(NAN);
  Moments<0> mo = moments_zero<0>();
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (s < walked)
      mo = add(mo, run_moments(cand, lane == 0 && s == 0,
                               kSegment * s + kPerLane * lane + 1, lp[s],
                               logz, &p_at_k));
  mo = warp_sum(mo);
  Num<0> p_block = shfl(p_at_k, holder_lane(cand.k));
  if (cand.k < 0 || cand.k > k_cols) p_block = constant<0>(NAN);

  // Every lane has the statistics; lane i stores output row i.
  const Stats<0> st = chain_stats(cand, constant<0>(lam), mo, p_block);
  if (mode == 0) {
    float row[kTailRows];
    tail_rows(cand, tail, st, row);
    if (lane < kTailRows) out[lane * n_rows + c] = row_of(row, lane);
  } else {
    float row[kAnalyzeRows];
    analyze_rows(cand, b, lam, st, row);
    if (lane < kAnalyzeRows) out[lane * n_rows + c] = row_of(row, lane);
  }
}

// ---- T = 3: one block

__global__ void __launch_bounds__(kThreads)
    chain_jacobian_kernel(const float* __restrict__ x,
                          const float* __restrict__ env,
                          float* __restrict__ out) {
  // The states' own log mu (own_log_mu), mu(1), and mu(B) with its log (the
  // saturated value).
  __shared__ Dual own[kMaxStates];
  __shared__ Dual mu_1, mu_b, sat;
  __shared__ Dual scan_totals[kWarps];
  __shared__ float maxima[kWarps];
  __shared__ Dual weight_sums[kWarps];
  __shared__ Moments<3> moment_sums[kWarps];
  __shared__ Dual p_block;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool first = tid == 0;

  // The states that need their own log mu (below B: a division and a log
  // on four lanes each, whose slow-path branches keep one thread's from
  // overlapping) are dealt out across the block's threads, state tid + 1 +
  // j kThreads to thread tid, so no thread takes more than ceil(B /
  // kThreads) of them. Two threads at the block's end form mu(1) and mu(B)
  // meanwhile.
  const Cand<3> c = jacobian_candidate(x, env);
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    own[tid + j * kThreads] = own_log_mu(c, tid + j * kThreads + 1);
  if (tid == kThreads - 1) {
    const Dual mu = service_rate(c, c.batch);
    mu_b = mu;
    sat = dlog(clamp_min(mu, 1e-30f));
  } else if (tid == kThreads - 2) {
    mu_1 = service_rate(c, 1);
  }
  // A k outside 0..kMaxStates has no state to store p_block: h is NaN.
  if (first) p_block = constant<3>(NAN);
  __syncthreads();

  // The rate (rate_bounds_per_ms and the clip) on every thread.
  const Dual lam = clip_rate(env[0], mu_1, mu_b);
  const Dual log_lam = dlog(clamp_min(lam, 1e-30f));
  Dual lp[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) lp[i] = own[kPer * tid + i];

  // The prefix sum: the thread's own, the warp's scan of the threads'
  // totals, then every warp's scan of the block's warp totals.
  const Dual incl = warp_scan(
      run_prefix(c, log_lam, sat, kPer * tid + 1, kMaxStates, lp), lane);
  Dual below = shfl_up(incl, 1);
  if (lane == 0) below = zero<3>();
  if (lane == 31) scan_totals[warp] = incl;
  __syncthreads();
  const Dual totals =
      warp_scan(lane < kWarps ? scan_totals[lane] : zero<3>(), lane);
  Dual offset = shfl(totals, warp == 0 ? 0 : warp - 1);
  if (warp == 0) offset = zero<3>();
  finish_prefix(add(offset, below), lp);

  // logsumexp: the maximum, then the weights and logz.
  float m = warp_max(run_max(first, lp));
  if (lane == 0) maxima[warp] = m;
  __syncthreads();
  m = warp_max(lane < kWarps ? maxima[lane] : -INFINITY);
  m = fabsf(m) == INFINITY ? 0.0f : m;
  const Dual ws = warp_sum(run_weights(first, lp, m));
  if (lane == 0) weight_sums[warp] = ws;
  __syncthreads();
  const Dual logz =
      log_partition(warp_sum(lane < kWarps ? weight_sums[lane] : zero<3>()),
                    m);

  // The moments and p_block, then the derived values on one thread.
  Moments<3> mo =
      warp_sum(run_moments(c, first, kPer * tid + 1, lp, logz, &p_block));
  if (lane == 0) moment_sums[warp] = mo;
  __syncthreads();
  if (warp == 0)
    mo = warp_sum(lane < kWarps ? moment_sums[lane] : moments_zero<3>());
  if (first) observation(c, lam, mo, p_block, out);
}

template <int S>
int launch_stats(const Rows& rows, const float* rate, const float* lam_star,
                 const float* targets, const float* lam_max, float* out,
                 bool* valid, int n_rows, int k_cols, int mode,
                 cudaStream_t stream) {
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  chain_stats_kernel<S><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      rows, rate, lam_star, targets, lam_max, out, valid, n_rows, k_cols,
      mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The chain statistics of n_rows rows at k_cols states (T = 0): mode 0 the
// sizing path's tail (lam_star, targets, lam_max; rate and valid unused),
// mode 1 analyze_batch (rate and valid; the others unused).
int chain_stats_launch(const float* alpha, const float* beta,
                       const float* gamma, const float* in,
                       const float* out_tokens, const int* batch, const int* k,
                       const float* rate, const float* lam_star,
                       const float* targets, const float* lam_max, float* out,
                       bool* valid, int n_rows, int k_cols, int mode,
                       cudaStream_t stream) {
  const Rows rows = {alpha, beta, gamma, in, out_tokens, batch, k};
  const int segments = (k_cols + kSegment - 1) / kSegment;
  if (k_cols < 1 || segments > 8 || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (segments == 1)
    return launch_stats<1>(rows, rate, lam_star, targets, lam_max, out, valid,
                           n_rows, k_cols, mode, stream);
  if (segments == 2)
    return launch_stats<2>(rows, rate, lam_star, targets, lam_max, out, valid,
                           n_rows, k_cols, mode, stream);
  if (segments <= 4)
    return launch_stats<4>(rows, rate, lam_star, targets, lam_max, out, valid,
                           n_rows, k_cols, mode, stream);
  return launch_stats<8>(rows, rate, lam_star, targets, lam_max, out, valid,
                         n_rows, k_cols, mode, stream);
}

// The tuner's h and H (T = 3).
int chain_jacobian_launch(const float* x, const float* env, float* out,
                          cudaStream_t stream) {
  chain_jacobian_kernel<<<1, kThreads, 0, stream>>>(x, env, out);
  return static_cast<int>(cudaGetLastError());
}

const char* chain_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
