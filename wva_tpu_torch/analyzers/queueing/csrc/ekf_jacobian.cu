// The EKF tuner's observation and its jacobian for Hopper (sm_90a): h =
// (TTFT, ITL) and the 2x3 H = dh/d(alpha, beta, gamma) in one launch.
//
// Replaces the reference's jitted program _observe_and_jacobian
// (wva_tpu/analyzers/queueing/tuner.py:158): jax.jacfwd through
// rate_bounds_per_ms (queue_model.py:136), _chain_stats (:229) and
// _derived_latencies (:278) at K_MAX = 2048 states. An XLA program on the
// TPU, not a Pallas kernel. The plain version is
// wva_tpu_torch/analyzers/queueing/tuner.py:observe_and_jacobian_plain,
// torch.func.jacfwd through the port's queue_model, which CPU tensors take.
//
// Inputs, float32, contiguous: x [3] = (alpha, beta, gamma) and env [5] =
// (lambda per ms, avg input tokens, avg output tokens, max batch, k). Output
// out [2, 4]: row 0 TTFT, row 1 ITL, each the value then its derivatives
// by alpha, beta and gamma (h in column 0, H in columns 1-3).
//
// What it computes: forward mode with dual numbers. Every value carries
// three tangents, one a parameter (struct Dual), and every operation
// applies torch's forward rule for the plain version's operation: a
// product's tangent is y' x + x' y, a quotient's (x' - y' (x/y)) / y, an
// exp's x' exp(x), a log's x' / x; clamp(min=) passes the tangent where x
// >= min, at equality too; maximum and minimum pass NaN and split a tie's
// tangent half and half. The chain of C = 1 candidate over its 2048
// states:
//   1. the candidate's scalars (every thread alike): the token factors,
//      mu(1) and mu(B) with tangents, lambda clipped as
//      minimum(maximum(env, lo), hi), and log lambda;
//   2. per state n: mu(n) at eff = min(n, B) (eff has no tangent), log
//      max(mu, 1e-30), +1e30 with no tangent past k, and the log ratio
//      log lambda - log mu(n);
//   3. the inclusive prefix sum of the ratios, value and tangents; state 0
//      is a fixed 0; clamp at -1e30;
//   4. logsumexp over the 2049 states: logz = log sum w + m with w =
//      exp(logp - m) and m the largest logp; logz' = (sum w logp') / sum w
//      (torch's jvp of logsumexp); then p = exp(logp - logz) and p' = p
//      (logp' - logz');
//   5. sum n p and sum min(n, B) p with tangents, and p_block = p[k];
//   6. on thread 0: throughput, the response, service and wait times (the
//      wait clamped at 0), prefill at the mean occupancy, itl and ttft.
// p0 feeds no output of the tuner, so it is not formed. The states past k
// end at logp = -1e30 (the first lands on it, the rest below and clamped
// with no tangent), so their p is exp(-1e30 - logz) = 0 and their p' is 0
// times a finite tangent: 0, with no 0 * inf. Their prefix sums reach
// about -2e33, finite in float32.
//
// Design. One block of 256 threads; thread t holds states 8t+1..8t+8
// (thread 0 state 0 as well) in registers, values and tangents, from the
// log ratios to the moments. Every sum has a fixed order: sequential
// within a thread over its states in order (state 0 first), then a warp
// shuffle tree (the scan a Hillis-Steele inclusive scan by shfl_up, lower
// + upper; the reductions an xor butterfly, own + other, which leaves
// every lane the same bits because float addition commutes), then across
// the 8 warps in warp order through shared memory. Empty sums start at
// -0.0, the identity of float addition. Four barriers: after the scan's
// warp totals, the maxima, the weights and the moments.
//
// What bounds it on the H100. The work is 2049 states of about 100 float
// operations each (a division, a log and an exp among them): 0.2 MFLOP,
// ~3 ns at the float32 rate. The bytes are 64. So the bound is the chain
// of dependent operations: the candidate's scalars, one state's ratio, the
// scan, three reductions and the derived values, about 170 operations
// with the tangents (jacobian_kernel.CHAIN_OPS), ~0.34 us at 4 cycles
// each. One block on one SM is what that chain needs: more blocks would
// add a second pass or atomics to a sum that one SM finishes in a few
// hundred cycles. The 8 states of a thread are independent up to their
// prefix sum, so their divisions, logs and exps overlap; the launch
// itself (a few us) is the larger cost, which is why the tuner step makes
// exactly one.
//
// Rounding. Built with -fmad=false, so each operation rounds once, as the
// plain version's. The plain version's sums take other orders (and its
// CPU cumsum accumulates in double), so the kernel is held to it within a
// tolerance (2e-3 of each row's largest entry), not bit for bit.
// Everything from here to the line "---- the kernel" is host C++ as well
// (define __device__ and __forceinline__ away):
// tests/test_torch_jacobian_host.py drives it in the kernel's reduction
// order on the CPU against the plain version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kStates = 2048;  // K_MAX: states 1..kStates, and state 0
constexpr int kThreads = 256;
constexpr int kPerThread = kStates / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // _NEG_INF, the floor of logp
constexpr float kMasked = 1e30f;   // -_NEG_INF: log mu past k
constexpr float kEpsilon = 1e-3f;  // EPSILON (rate_bounds_per_ms)
constexpr float kOneLessEpsilon = static_cast<float>(1.0 - 1e-3);

// A value and its derivatives by alpha (a), beta (b) and gamma (g).
struct Dual {
  float v, a, b, g;
};

__device__ __forceinline__ Dual constant(float v) {
  return {v, 0.0f, 0.0f, 0.0f};
}

// The start of every sum: -0.0 + x is x for every x.
__device__ __forceinline__ Dual zero() {
  return {-0.0f, -0.0f, -0.0f, -0.0f};
}

__device__ __forceinline__ Dual add(Dual x, Dual y) {
  return {x.v + y.v, x.a + y.a, x.b + y.b, x.g + y.g};
}

__device__ __forceinline__ Dual sub(Dual x, Dual y) {
  return {x.v - y.v, x.a - y.a, x.b - y.b, x.g - y.g};
}

// x * y: y' x + x' y.
__device__ __forceinline__ Dual mul(Dual x, Dual y) {
  return {x.v * y.v, y.a * x.v + x.a * y.v, y.b * x.v + x.b * y.v,
          y.g * x.v + x.g * y.v};
}

// x * c, c without a tangent.
__device__ __forceinline__ Dual scale(Dual x, float c) {
  return {x.v * c, x.a * c, x.b * c, x.g * c};
}

// x / y: (x' - y' r) / y, r = x / y.
__device__ __forceinline__ Dual div(Dual x, Dual y) {
  const float r = x.v / y.v;
  return {r, (x.a - y.a * r) / y.v, (x.b - y.b * r) / y.v,
          (x.g - y.g * r) / y.v};
}

// c / y, c without a tangent: (0 - y' r) / y.
__device__ __forceinline__ Dual rdiv(float c, Dual y) {
  const float r = c / y.v;
  return {r, (0.0f - y.a * r) / y.v, (0.0f - y.b * r) / y.v,
          (0.0f - y.g * r) / y.v};
}

// x / c, c without a tangent.
__device__ __forceinline__ Dual div_by(Dual x, float c) {
  return {x.v / c, x.a / c, x.b / c, x.g / c};
}

__device__ __forceinline__ Dual dlog(Dual x) {
  return {logf(x.v), x.a / x.v, x.b / x.v, x.g / x.v};
}

__device__ __forceinline__ Dual dexp(Dual x) {
  const float e = expf(x.v);
  return {e, x.a * e, x.b * e, x.g * e};
}

// clamp(x, min=lo): NaN passes; the tangent where x >= lo, at equality too.
__device__ __forceinline__ Dual clamp_min(Dual x, float lo) {
  const bool pass = x.v >= lo;
  return {x.v < lo ? lo : x.v, pass ? x.a : 0.0f, pass ? x.b : 0.0f,
          pass ? x.g : 0.0f};
}

// y' + w (x' - y'), w = 1 where x is taken, 0 where y is, 0.5 at a tie.
__device__ __forceinline__ Dual pick(float v, float w, Dual x, Dual y) {
  return {v, y.a + w * (x.a - y.a), y.b + w * (x.b - y.b),
          y.g + w * (x.g - y.g)};
}

// torch.maximum and torch.minimum: NaN passes, a tie splits the tangents.
__device__ __forceinline__ Dual maximum(Dual x, Dual y) {
  const float v = (x.v != x.v || x.v > y.v) ? x.v : y.v;
  return pick(v, x.v == y.v ? 0.5f : (x.v > y.v ? 1.0f : 0.0f), x, y);
}

__device__ __forceinline__ Dual minimum(Dual x, Dual y) {
  const float v = (x.v != x.v || x.v < y.v) ? x.v : y.v;
  return pick(v, x.v == y.v ? 0.5f : (x.v < y.v ? 1.0f : 0.0f), x, y);
}

// torch.max's NaN rule for a reduction's maximum.
__device__ __forceinline__ float max_nan(float x, float y) {
  return (x != x || x > y) ? x : y;
}

// The candidate (CandidateBatch with C = 1) and its token factors.
struct Cand {
  Dual alpha, beta, gamma;
  float in, out;  // avg input and output tokens
  float tc, tm;   // compute and memory tokens a request (_token_factors)
  int batch, k;   // max batch, occupancy bound (.to(int32) truncates)
};

__device__ __forceinline__ Cand candidate(const float* x, const float* env) {
  Cand c;
  c.alpha = {x[0], 1.0f, 0.0f, 0.0f};
  c.beta = {x[1], 0.0f, 1.0f, 0.0f};
  c.gamma = {x[2], 0.0f, 0.0f, 1.0f};
  c.in = env[1];
  c.out = env[2];
  c.tc = (c.in + c.out) / (c.out + 1.0f);
  c.tm = c.in + c.out / 2.0f;
  c.batch = static_cast<int>(env[3]);
  c.k = static_cast<int>(env[4]);
  return c;
}

// T(n) = alpha + n * (beta * tc + gamma * tm) (_iteration_time).
__device__ __forceinline__ Dual iteration_time(const Cand& c, Dual n) {
  return add(c.alpha, mul(n, add(scale(c.beta, c.tc), scale(c.gamma, c.tm))));
}

// T(n) + (beta + gamma) * in, or 0 with no prompt (_prefill_time).
__device__ __forceinline__ Dual prefill_time(const Cand& c, Dual n) {
  const Dual t = add(iteration_time(c, n), scale(add(c.beta, c.gamma), c.in));
  return c.in > 0.0f ? t : constant(0.0f);
}

// T(n) + beta + gamma * (in + out / 2) (_decode_time).
__device__ __forceinline__ Dual decode_time(const Cand& c, Dual n) {
  return add(add(iteration_time(c, n), c.beta), scale(c.gamma, c.tm));
}

// mu = eff / max(per_req, 1e-12), eff = min(occupancy, B) (_service_rate).
__device__ __forceinline__ Dual service_rate(const Cand& c, int occupancy) {
  const Dual eff = constant(
      static_cast<float>(occupancy < c.batch ? occupancy : c.batch));
  const Dual per_req =
      add(prefill_time(c, eff), scale(decode_time(c, eff), c.out));
  return rdiv(eff.v, clamp_min(per_req, 1e-12f));
}

// lambda = minimum(maximum(env, eps mu(1)), (1 - eps) mu(B))
// (rate_bounds_per_ms and the clip).
__device__ __forceinline__ Dual arrival_rate(const Cand& c, float lam_env) {
  const Dual lo = scale(service_rate(c, 1), kEpsilon);
  const Dual hi = scale(service_rate(c, c.batch), kOneLessEpsilon);
  return minimum(maximum(constant(lam_env), lo), hi);
}

// log lambda - log mu(n), mu masked to +1e30 past k (_masked_log_mu).
__device__ __forceinline__ Dual log_ratio(const Cand& c, Dual log_lam, int n) {
  const Dual log_mu = n <= c.k
      ? dlog(clamp_min(service_rate(c, n), 1e-30f))
      : constant(kMasked);
  return sub(log_lam, log_mu);
}

// The thread's states 8t+1..8t+8: lp[i] the sum of their log ratios up to
// and including state 8t+1+i, in order. Returns the thread's total.
__device__ __forceinline__ Dual thread_prefix(const Cand& c, Dual log_lam,
                                             int tid, Dual (&lp)[kPerThread]) {
  Dual run = zero();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    run = add(run, log_ratio(c, log_lam, kPerThread * tid + 1 + i));
    lp[i] = run;
  }
  return run;
}

// logp of the thread's states: the states before the thread's (offset)
// plus its own prefix, clamped at -1e30.
__device__ __forceinline__ void finish_prefix(Dual offset,
                                              Dual (&lp)[kPerThread]) {
#pragma unroll
  for (int i = 0; i < kPerThread; ++i)
    lp[i] = clamp_min(add(offset, lp[i]), kNegInf);
}

// The largest logp of the thread's states (state 0's 0 first on thread 0).
__device__ __forceinline__ float thread_max(int tid,
                                            const Dual (&lp)[kPerThread]) {
  float m = tid == 0 ? 0.0f : -INFINITY;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) m = max_nan(m, lp[i].v);
  return m;
}

// The block's largest logp from the warps' in warp order; +-inf becomes 0,
// as torch's logsumexp does.
__device__ __forceinline__ float block_max(const float* maxima) {
  float m = maxima[0];
  for (int w = 1; w < kWarps; ++w) m = max_nan(m, maxima[w]);
  return fabsf(m) == INFINITY ? 0.0f : m;
}

// w = exp(logp - m), and w * logp' as its tangents.
__device__ __forceinline__ Dual weight(Dual lp, float m) {
  const float w = expf(lp.v - m);
  return {w, w * lp.a, w * lp.b, w * lp.g};
}

// The thread's sums of w and w logp' (state 0 first on thread 0).
__device__ __forceinline__ Dual thread_weights(int tid,
                                              const Dual (&lp)[kPerThread],
                                              float m) {
  Dual s = tid == 0 ? add(zero(), weight(constant(0.0f), m)) : zero();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) s = add(s, weight(lp[i], m));
  return s;
}

// logz = log(sum w) + m, logz' = (sum w logp') / sum w.
__device__ __forceinline__ Dual log_partition(Dual sums, float m) {
  return {logf(sums.v) + m, sums.a / sums.v, sums.b / sums.v,
          sums.g / sums.v};
}

// sum n p and sum min(n, B) p, values and tangents.
struct Moments {
  Dual in_system, in_servers;
};

__device__ __forceinline__ Moments add(Moments x, Moments y) {
  return {add(x.in_system, y.in_system), add(x.in_servers, y.in_servers)};
}

__device__ __forceinline__ Moments moments_at(Moments s, Dual p, int n,
                                              int batch) {
  return {add(s.in_system, scale(p, static_cast<float>(n))),
          add(s.in_servers,
              scale(p, static_cast<float>(n < batch ? n : batch)))};
}

// The thread's moments (state 0 first on thread 0): p = exp(logp - logz)
// at each of its states. The thread that holds state k stores its p in
// *p_at_k.
__device__ __forceinline__ Moments thread_moments(const Cand& c, int tid,
                                                  const Dual (&lp)[kPerThread],
                                                  Dual logz, Dual* p_at_k) {
  Moments s = {zero(), zero()};
  if (tid == 0) {
    const Dual p0 = dexp(sub(constant(0.0f), logz));
    s = moments_at(s, p0, 0, c.batch);
    if (c.k == 0) *p_at_k = p0;
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int n = kPerThread * tid + 1 + i;
    const Dual p = dexp(sub(lp[i], logz));
    s = moments_at(s, p, n, c.batch);
    if (n == c.k) *p_at_k = p;
  }
  return s;
}

// h and H from the chain's moments: out[0..4) TTFT, out[4..8) ITL, each
// the value and its three derivatives (_chain_stats' tail and
// _derived_latencies).
__device__ __forceinline__ void observation(const Cand& c, Dual lam,
                                            Moments sums, Dual p_block,
                                            float* out) {
  const Dual throughput = mul(lam, sub(constant(1.0f), p_block));
  const Dual safe_x = clamp_min(throughput, 1e-30f);
  const Dual resp = div(sums.in_system, safe_x);
  const Dual serv = div(sums.in_servers, safe_x);
  const Dual wait = clamp_min(sub(resp, serv), 0.0f);
  const Dual prefill = prefill_time(c, sums.in_servers);
  const Dual itl = div_by(sub(serv, prefill), c.out < 1.0f ? 1.0f : c.out);
  const Dual ttft = add(add(wait, prefill), itl);
  const Dual rows[2] = {ttft, itl};
  for (int r = 0; r < 2; ++r) {
    out[4 * r + 0] = rows[r].v;
    out[4 * r + 1] = rows[r].a;
    out[4 * r + 2] = rows[r].b;
    out[4 * r + 3] = rows[r].g;
  }
}

// ---- the kernel: device code only from here on

constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ Dual shfl_up(Dual x, int off) {
  return {__shfl_up_sync(kAll, x.v, off), __shfl_up_sync(kAll, x.a, off),
          __shfl_up_sync(kAll, x.b, off), __shfl_up_sync(kAll, x.g, off)};
}

__device__ __forceinline__ Dual shfl_xor(Dual x, int off) {
  return {__shfl_xor_sync(kAll, x.v, off), __shfl_xor_sync(kAll, x.a, off),
          __shfl_xor_sync(kAll, x.b, off), __shfl_xor_sync(kAll, x.g, off)};
}

__device__ __forceinline__ Dual warp_sum(Dual x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = add(x, shfl_xor(x, off));
  return x;
}

__global__ void __launch_bounds__(kThreads)
    ekf_jacobian_kernel(const float* __restrict__ x,
                        const float* __restrict__ env,
                        float* __restrict__ out) {
  __shared__ Dual scan_totals[kWarps];
  __shared__ float maxima[kWarps];
  __shared__ Dual weight_sums[kWarps];
  __shared__ Moments moment_sums[kWarps];
  __shared__ Dual p_block;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const Cand c = candidate(x, env);
  const Dual lam = arrival_rate(c, env[0]);
  const Dual log_lam = dlog(clamp_min(lam, 1e-30f));
  // A k outside 0..kStates has no state to store p_block: h is NaN.
  if (tid == 0) p_block = constant(NAN);

  // 3. The prefix sum: the thread's own, a warp scan of the threads'
  // totals, then the warps' totals before this warp's.
  Dual lp[kPerThread];
  Dual incl = thread_prefix(c, log_lam, tid, lp);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Dual lower = shfl_up(incl, off);
    if (lane >= off) incl = add(lower, incl);
  }
  Dual excl = shfl_up(incl, 1);
  if (lane == 0) excl = zero();
  if (lane == 31) scan_totals[warp] = incl;
  __syncthreads();
  Dual offset = zero();
  for (int w = 0; w < warp; ++w) offset = add(offset, scan_totals[w]);
  finish_prefix(add(offset, excl), lp);

  // 4. logsumexp: the maximum, then the weights and logz.
  float m = thread_max(tid, lp);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max_nan(m, __shfl_xor_sync(kAll, m, off));
  if (lane == 0) maxima[warp] = m;
  __syncthreads();
  m = block_max(maxima);
  const Dual ws = warp_sum(thread_weights(tid, lp, m));
  if (lane == 0) weight_sums[warp] = ws;
  __syncthreads();
  Dual sums = zero();
  for (int w = 0; w < kWarps; ++w) sums = add(sums, weight_sums[w]);
  const Dual logz = log_partition(sums, m);

  // 5. The moments and p_block.
  Moments mo = thread_moments(c, tid, lp, logz, &p_block);
  mo = {warp_sum(mo.in_system), warp_sum(mo.in_servers)};
  if (lane == 0) moment_sums[warp] = mo;
  __syncthreads();

  // 6. The derived values on one thread.
  if (tid == 0) {
    Moments total = {zero(), zero()};
    for (int w = 0; w < kWarps; ++w) total = add(total, moment_sums[w]);
    observation(c, lam, total, p_block, out);
  }
}

}  // namespace

extern "C" {

int ekf_jacobian_launch(const float* x, const float* env, float* out,
                        cudaStream_t stream) {
  ekf_jacobian_kernel<<<1, kThreads, 0, stream>>>(x, env, out);
  return static_cast<int>(cudaGetLastError());
}

const char* ekf_jacobian_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
