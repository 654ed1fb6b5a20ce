// The queueing chain's arithmetic, shared by chain_setup.cu and
// chain_stats.cu: a number with T tangents (T = 0: a plain float; T = 3:
// the derivatives by alpha, beta and gamma), each operation with torch's
// forward rule for the plain version's operation, and the candidate's
// functions of queue_model.py (_token_factors, _iteration_time,
// _prefill_time, _decode_time, _service_rate, rate_bounds_per_ms,
// _masked_log_mu, the tail of _chain_stats and _derived_latencies).
//
// Forward rules: a product's tangent is y' x + x' y, a quotient's
// (x' - y' (x/y)) / y, an exp's x' exp(x), a log's x' / x; clamp(min=)
// passes the tangent where x >= min, at equality too; maximum and minimum
// pass NaN and split a tie's tangent half and half. At T = 0 every tangent
// loop is empty and each function is the plain float arithmetic.
//
// Every function here is host C++ as well (define __device__ and
// __forceinline__ away): tests/test_torch_chain_host.py and
// tests/test_torch_jacobian_host.py compile it with g++ and drive the
// kernels' schedules on the CPU.

#pragma once

#include <math.h>

namespace chain {

constexpr int kMaxStates = 2048;  // K_MAX: states 1..kMaxStates, and state 0
constexpr float kNegInf = -1e30f;  // _NEG_INF, the floor of logp
constexpr float kMasked = 1e30f;   // -_NEG_INF: log mu past k
constexpr float kEpsilon = 1e-3f;  // EPSILON (rate_bounds_per_ms)
constexpr float kOneLessEpsilon = static_cast<float>(1.0 - 1e-3);
// 1 - STABILITY_SAFETY_FRACTION, the TPS cap on the max service rate.
constexpr float kTpsFraction = static_cast<float>(1.0 - 0.1);

// A value and its T tangents.
template <int T>
struct Num {
  float v;
  float t[T > 0 ? T : 1];
};

template <int T>
__device__ __forceinline__ Num<T> constant(float v) {
  Num<T> r;
  r.v = v;
  for (int j = 0; j < T; ++j) r.t[j] = 0.0f;
  return r;
}

// The start of every sum: -0.0 + x is x for every x.
template <int T>
__device__ __forceinline__ Num<T> zero() {
  Num<T> r;
  r.v = -0.0f;
  for (int j = 0; j < T; ++j) r.t[j] = -0.0f;
  return r;
}

template <int T>
__device__ __forceinline__ Num<T> add(Num<T> x, Num<T> y) {
  Num<T> r;
  r.v = x.v + y.v;
  for (int j = 0; j < T; ++j) r.t[j] = x.t[j] + y.t[j];
  return r;
}

template <int T>
__device__ __forceinline__ Num<T> sub(Num<T> x, Num<T> y) {
  Num<T> r;
  r.v = x.v - y.v;
  for (int j = 0; j < T; ++j) r.t[j] = x.t[j] - y.t[j];
  return r;
}

// x * y: y' x + x' y.
template <int T>
__device__ __forceinline__ Num<T> mul(Num<T> x, Num<T> y) {
  Num<T> r;
  r.v = x.v * y.v;
  for (int j = 0; j < T; ++j) r.t[j] = y.t[j] * x.v + x.t[j] * y.v;
  return r;
}

// x * c, c without a tangent.
template <int T>
__device__ __forceinline__ Num<T> scale(Num<T> x, float c) {
  Num<T> r;
  r.v = x.v * c;
  for (int j = 0; j < T; ++j) r.t[j] = x.t[j] * c;
  return r;
}

// x / y: (x' - y' r) / y, r = x / y.
template <int T>
__device__ __forceinline__ Num<T> div(Num<T> x, Num<T> y) {
  Num<T> r;
  r.v = x.v / y.v;
  for (int j = 0; j < T; ++j) r.t[j] = (x.t[j] - y.t[j] * r.v) / y.v;
  return r;
}

// c / y, c without a tangent: (0 - y' r) / y.
template <int T>
__device__ __forceinline__ Num<T> rdiv(float c, Num<T> y) {
  Num<T> r;
  r.v = c / y.v;
  for (int j = 0; j < T; ++j) r.t[j] = (0.0f - y.t[j] * r.v) / y.v;
  return r;
}

// x / c, c without a tangent.
template <int T>
__device__ __forceinline__ Num<T> div_by(Num<T> x, float c) {
  Num<T> r;
  r.v = x.v / c;
  for (int j = 0; j < T; ++j) r.t[j] = x.t[j] / c;
  return r;
}

template <int T>
__device__ __forceinline__ Num<T> dlog(Num<T> x) {
  Num<T> r;
  r.v = logf(x.v);
  for (int j = 0; j < T; ++j) r.t[j] = x.t[j] / x.v;
  return r;
}

template <int T>
__device__ __forceinline__ Num<T> dexp(Num<T> x) {
  Num<T> r;
  r.v = expf(x.v);
  for (int j = 0; j < T; ++j) r.t[j] = x.t[j] * r.v;
  return r;
}

// clamp(x, min=lo): NaN passes; the tangent where x >= lo, at equality too.
template <int T>
__device__ __forceinline__ Num<T> clamp_min(Num<T> x, float lo) {
  const bool pass = x.v >= lo;
  Num<T> r;
  r.v = x.v < lo ? lo : x.v;
  for (int j = 0; j < T; ++j) r.t[j] = pass ? x.t[j] : 0.0f;
  return r;
}

// y' + w (x' - y'), w = 1 where x is taken, 0 where y is, 0.5 at a tie.
template <int T>
__device__ __forceinline__ Num<T> pick(float v, float w, Num<T> x, Num<T> y) {
  Num<T> r;
  r.v = v;
  for (int j = 0; j < T; ++j) r.t[j] = y.t[j] + w * (x.t[j] - y.t[j]);
  return r;
}

// torch.maximum and torch.minimum: NaN passes, a tie splits the tangents.
template <int T>
__device__ __forceinline__ Num<T> maximum(Num<T> x, Num<T> y) {
  const float v = (x.v != x.v || x.v > y.v) ? x.v : y.v;
  return pick(v, x.v == y.v ? 0.5f : (x.v > y.v ? 1.0f : 0.0f), x, y);
}

template <int T>
__device__ __forceinline__ Num<T> minimum(Num<T> x, Num<T> y) {
  const float v = (x.v != x.v || x.v < y.v) ? x.v : y.v;
  return pick(v, x.v == y.v ? 0.5f : (x.v < y.v ? 1.0f : 0.0f), x, y);
}

// torch.max's NaN rule for a reduction's maximum.
__device__ __forceinline__ float max_nan(float x, float y) {
  return (x != x || x > y) ? x : y;
}

// torch.clamp(x, 0, 1): NaN passes.
__device__ __forceinline__ float clamp01(float x) {
  return x != x ? x : (x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x));
}

// A candidate (one row of CandidateBatch) and its token factors.
template <int T>
struct Cand {
  Num<T> alpha, beta, gamma;
  float in, out;  // avg input and output tokens
  float tc, tm;   // compute and memory tokens a request (_token_factors)
  int batch, k;   // max batch, occupancy bound
};

template <int T>
__device__ __forceinline__ Cand<T> make_candidate(Num<T> alpha, Num<T> beta,
                                                  Num<T> gamma, float in,
                                                  float out, int batch,
                                                  int k) {
  Cand<T> c;
  c.alpha = alpha;
  c.beta = beta;
  c.gamma = gamma;
  c.in = in;
  c.out = out;
  c.tc = (in + out) / (out + 1.0f);
  c.tm = in + out / 2.0f;
  c.batch = batch;
  c.k = k;
  return c;
}

// T(n) = alpha + n * (beta * tc + gamma * tm) (_iteration_time).
template <int T>
__device__ __forceinline__ Num<T> iteration_time(const Cand<T>& c, Num<T> n) {
  return add(c.alpha, mul(n, add(scale(c.beta, c.tc), scale(c.gamma, c.tm))));
}

// T(n) + (beta + gamma) * in, or 0 with no prompt (_prefill_time).
template <int T>
__device__ __forceinline__ Num<T> prefill_time(const Cand<T>& c, Num<T> n) {
  const Num<T> t =
      add(iteration_time(c, n), scale(add(c.beta, c.gamma), c.in));
  return c.in > 0.0f ? t : constant<T>(0.0f);
}

// T(n) + beta + gamma * (in + out / 2) (_decode_time).
template <int T>
__device__ __forceinline__ Num<T> decode_time(const Cand<T>& c, Num<T> n) {
  return add(add(iteration_time(c, n), c.beta), scale(c.gamma, c.tm));
}

// mu = eff / max(per_req, 1e-12), eff = min(occupancy, B) (_service_rate).
template <int T>
__device__ __forceinline__ Num<T> service_rate(const Cand<T>& c,
                                               int occupancy) {
  const Num<T> eff = constant<T>(
      static_cast<float>(occupancy < c.batch ? occupancy : c.batch));
  const Num<T> per_req =
      add(prefill_time(c, eff), scale(decode_time(c, eff), c.out));
  return rdiv(eff.v, clamp_min(per_req, 1e-12f));
}

// [lambda_min, lambda_max] = [eps mu(1), (1 - eps) mu(B)]
// (rate_bounds_per_ms).
template <int T>
struct Bounds {
  Num<T> lo, hi;
};

template <int T>
__device__ __forceinline__ Bounds<T> rate_bounds(const Cand<T>& c) {
  return {scale(service_rate(c, 1), kEpsilon),
          scale(service_rate(c, c.batch), kOneLessEpsilon)};
}

// log max(mu(n), 1e-30) at n = B: every state n >= B has this value, as its
// eff is B (one evaluation a row stands for all of them, bit for bit).
template <int T>
__device__ __forceinline__ Num<T> saturated_log_mu(const Cand<T>& c) {
  return dlog(clamp_min(service_rate(c, c.batch), 1e-30f));
}

// log max(mu(n), 1e-30) of a state that needs its own: below B and within
// k. Every other state's is 0 here, and `masked` gives it.
template <int T>
__device__ __forceinline__ Num<T> own_log_mu(const Cand<T>& c, int n) {
  return n < c.batch && n <= c.k
             ? dlog(clamp_min(service_rate(c, n), 1e-30f))
             : constant<T>(0.0f);
}

// The masked log service rate of state n (_masked_log_mu) from its own:
// +1e30 past k (and past the chain's last state, `last`), the saturated
// value at n >= B.
template <int T>
__device__ __forceinline__ Num<T> masked(const Cand<T>& c, Num<T> sat,
                                         Num<T> own, int n, int last) {
  if (n > c.k || n > last) return constant<T>(kMasked);
  return n >= c.batch ? sat : own;
}

template <int T>
__device__ __forceinline__ Num<T> masked_log_mu(const Cand<T>& c, Num<T> sat,
                                                int n, int last) {
  return masked(c, sat, own_log_mu(c, n), n, last);
}

// w = exp(logp - m), and w * logp' as its tangents (logsumexp's terms).
template <int T>
__device__ __forceinline__ Num<T> weight(Num<T> lp, float m) {
  Num<T> r;
  r.v = expf(lp.v - m);
  for (int j = 0; j < T; ++j) r.t[j] = r.v * lp.t[j];
  return r;
}

// logz = log(sum w) + m, logz' = (sum w logp') / sum w.
template <int T>
__device__ __forceinline__ Num<T> log_partition(Num<T> sums, float m) {
  Num<T> r;
  r.v = logf(sums.v) + m;
  for (int j = 0; j < T; ++j) r.t[j] = sums.t[j] / sums.v;
  return r;
}

// sum n p and sum min(n, B) p.
template <int T>
struct Moments {
  Num<T> in_system, in_servers;
};

template <int T>
__device__ __forceinline__ Moments<T> add(Moments<T> x, Moments<T> y) {
  return {add(x.in_system, y.in_system), add(x.in_servers, y.in_servers)};
}

template <int T>
__device__ __forceinline__ Moments<T> moments_zero() {
  return {zero<T>(), zero<T>()};
}

template <int T>
__device__ __forceinline__ Moments<T> moments_at(Moments<T> s, Num<T> p, int n,
                                                 int batch) {
  return {add(s.in_system, scale(p, static_cast<float>(n))),
          add(s.in_servers,
              scale(p, static_cast<float>(n < batch ? n : batch)))};
}

// The chain's statistics at rate lam from its moments and p_block
// (_chain_stats' tail and _derived_latencies).
template <int T>
struct Stats {
  Num<T> throughput, resp, wait, in_servers, prefill, itl, ttft;
};

template <int T>
__device__ __forceinline__ Stats<T> chain_stats(const Cand<T>& c, Num<T> lam,
                                                Moments<T> sums,
                                                Num<T> p_block) {
  Stats<T> s;
  s.throughput = mul(lam, sub(constant<T>(1.0f), p_block));
  const Num<T> safe_x = clamp_min(s.throughput, 1e-30f);
  s.resp = div(sums.in_system, safe_x);
  const Num<T> serv = div(sums.in_servers, safe_x);
  s.wait = clamp_min(sub(s.resp, serv), 0.0f);
  s.in_servers = sums.in_servers;
  s.prefill = prefill_time(c, sums.in_servers);
  s.itl = div_by(sub(serv, s.prefill), c.out < 1.0f ? 1.0f : c.out);
  s.ttft = add(add(s.wait, s.prefill), s.itl);
  return s;
}

// The C-row kernels' layout (chain_setup.cu, and chain_stats.cu without
// tangents): one warp a row, kRowsPerBlock rows a block, the row's states in
// segments of kSegment, lane l holding the kPerLane consecutive states
// kSegment s + kPerLane l + 1 .. of segment s in every sum. The states that
// need their own log mu are dealt across the warp instead: state kSegment s
// + j + 1 to lane j mod 32, each value handed to its holder through shared
// memory (a segment's kSegment floats a row).
constexpr int kSegment = 256;  // states a segment: 32 lanes x kPerLane
constexpr int kPerLane = 8;
constexpr int kRowsPerBlock = 8;

// How many states of segment s need their own log mu: kSegment s + 1 ..
// min(B - 1, k, last), none past the segment.
__device__ __forceinline__ int own_count(const Cand<0>& c, int s, int last) {
  int hi = c.batch - 1;
  if (c.k < hi) hi = c.k;
  if (last < hi) hi = last;
  hi -= kSegment * s;
  return hi < 0 ? 0 : (hi > kSegment ? kSegment : hi);
}

// The lane's dealt share of segment s: own[j] = log mu of state kSegment s
// + j + 1 for j = lane, lane + 32, .. below `count` (own_log_mu, on another
// lane than the state's holder). From `count` on own[] holds stale values:
// those states are at or above B or past k or `last`, where `masked` takes
// the saturated value or +1e30 and never reads their own.
__device__ __forceinline__ void deal_own_log_mu(const Cand<0>& c, int s,
                                                int lane, int count,
                                                float* own) {
  for (int j = lane; j < count; j += 32)
    own[j] = own_log_mu(c, kSegment * s + j + 1).v;
}

// The segments a row walks: those that hold its states 1 .. min(k, last),
// at least one. The states past them add exact zeros to every sum.
__device__ __forceinline__ int row_segments(int k, int last) {
  const int n = k < last ? k : last;
  return n < 1 ? 1 : (n + kSegment - 1) / kSegment;
}

// The rows' candidate fields, each [C].
struct Rows {
  const float *alpha, *beta, *gamma, *in, *out;
  const int *batch, *k;
};

__device__ __forceinline__ Cand<0> row_candidate(const Rows& r, int c) {
  return make_candidate<0>(constant<0>(r.alpha[c]), constant<0>(r.beta[c]),
                           constant<0>(r.gamma[c]), r.in[c], r.out[c],
                           r.batch[c], r.k[c]);
}

}  // namespace chain
