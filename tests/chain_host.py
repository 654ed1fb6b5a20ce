"""The chain kernels' arithmetic as host C++, for the CPU tests.

``wva_tpu_torch/analyzers/queueing/csrc/chain_common.cuh`` and the parts of
``chain_setup.cu`` and ``chain_stats.cu`` above the line ``// ---- the
kernel`` compile as host C++ with ``__device__`` and ``__forceinline__``
defined away. :func:`build` compiles them with g++ ``-O2
-ffp-contract=off`` (no contraction, as nvcc's ``-fmad=false``) beside a
harness that runs each kernel's schedule on the CPU: every lane of a warp
and every thread of a block, each warp's shuffle scan and butterflies lane
by lane, the block's warp totals in one warp's tree.

- ``host_setup``: the chain-setup kernel, one warp a row;
- ``host_stats``: the chain-statistics kernel without tangents, one warp a
  row, in its two modes (0 the sizing path's tail, 1 ``analyze_batch``);
- both take a ``schedule``: 0 the kernels' (each segment's own log mu
  dealt across the lanes through a shared segment, the statistics walking
  only a row's segments), 1 the oracle, PR 12's (each lane its own 8
  states, every segment of the instantiation walked), which the kernels'
  must equal bit for bit;
- ``host_jacobian``: the three-tangent kernel, one block of 512 threads;
- ``host_rule``: one forward rule (maximum, minimum, clamp(min=)).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

CSRC = (Path(__file__).resolve().parents[1] / "wva_tpu_torch" / "analyzers"
        / "queueing" / "csrc")

HARNESS = r"""
#include <math.h>
#include <algorithm>
#define __device__
#define __forceinline__ inline
#include "chain_common.cuh"

// Lane l takes lower + own from lane l - off at off = 1 .. 16 (every lane
// reads before any writes), as the kernels' shfl_up scans do.
template <class T>
void hs_scan(T* v) {
  for (int off = 1; off < 32; off <<= 1) {
    T prev[32];
    for (int l = 0; l < 32; ++l) prev[l] = v[l];
    for (int l = off; l < 32; ++l) v[l] = chain::add(prev[l - off], prev[l]);
  }
}

// Lane l takes op(own, lane l ^ off's) at off = 16 .. 1, as the kernels'
// shfl_xor butterflies do; every lane ends with lane 0's value.
template <class T, class Op>
T butterfly(T* v, Op op) {
  for (int off = 16; off > 0; off >>= 1) {
    T prev[32];
    for (int l = 0; l < 32; ++l) prev[l] = v[l];
    for (int l = 0; l < 32; ++l) v[l] = op(prev[l], prev[l ^ off]);
  }
  return v[0];
}

template <class T>
T sum32(T* v) {
  return butterfly(v, [](T a, T b) { return chain::add(a, b); });
}

inline float max32(float* v) { return butterfly(v, chain::max_nan); }

namespace setup_h {
namespace {
@SETUP@
}  // namespace

// chain_setup_kernel's warp for row c, lane by lane: each segment's own log
// mu dealt across the lanes into the row's shared segment, the lanes' sums,
// the scan, the prefixes staged back and stored, clm_at_k from the stage.
void run_row(const Rows& rows, int c, int n_rows, int k_cols, float* bounds,
             float* clm, float* clm_at_k) {
  const Cand<0> cand = row_candidate(rows, c);
  const Bounds<0> b = rate_bounds(cand);
  bounds[c] = bounds[n_rows + c] = b.lo.v;
  bounds[2 * n_rows + c] = bounds[3 * n_rows + c] = b.hi.v;
  if (cand.k < 1 || cand.k > k_cols) clm_at_k[c] = NAN;
  const Num<0> sat = saturated_log_mu(cand);
  float* out = clm + static_cast<long long>(c) * k_cols;
  float seg[kSegment];
  for (int j = 0; j < kSegment; ++j) seg[j] = NAN;  // stale to every read
  float carry = -0.0f;
  const int segments = (k_cols + kSegment - 1) / kSegment;
  for (int s = 0; s < segments; ++s) {
    const int count = own_count(cand, s, k_cols);
    Num<0> own[32][kPerLane];
    for (int l = 0; l < 32; ++l) deal_own_log_mu(cand, s, l, count, seg);
    for (int l = 0; l < 32; ++l)
      for (int i = 0; i < kPerLane; ++i)
        own[l][i] = constant<0>(count > 0 ? seg[kPerLane * l + i] : 0.0f);
    float v[32][kPerLane];
    Num<0> incl[32];
    for (int l = 0; l < 32; ++l)
      incl[l] = constant<0>(lane_segment(cand, sat, s, l, k_cols, own[l],
                                         v[l]));
    hs_scan(incl);
    for (int l = 0; l < 32; ++l) {
      const float below = l == 0 ? -0.0f : incl[l - 1].v;
      const float base = carry + below;
      for (int i = 0; i < kPerLane; ++i)
        seg[kPerLane * l + i] = base + v[l][i];
    }
    const int width = std::min(kSegment, k_cols - kSegment * s);
    for (int q = 0; q < width; ++q) out[kSegment * s + q] = seg[q];
    const int at = cand.k - 1 - kSegment * s;
    if (at >= 0 && at < kSegment) clm_at_k[c] = seg[at];
    carry = seg[kSegment - 1];
  }
}

// The oracle: PR 12's schedule, each lane evaluating its own 8 states' log
// mu in order and storing its prefixes itself.
float own_lane_segment(const Cand<0>& c, Num<0> sat, int s, int lane,
                       int k_cols, float (&v)[kPerLane]) {
  Num<0> run = zero<0>();
  for (int i = 0; i < kPerLane; ++i) {
    const int n = kSegment * s + kPerLane * lane + 1 + i;
    run = add(run, masked_log_mu(c, sat, n, k_cols));
    v[i] = run.v;
  }
  return run.v;
}

void run_row_oracle(const Rows& rows, int c, int n_rows, int k_cols,
                    float* bounds, float* clm, float* clm_at_k) {
  const Cand<0> cand = row_candidate(rows, c);
  const Bounds<0> b = rate_bounds(cand);
  bounds[c] = bounds[n_rows + c] = b.lo.v;
  bounds[2 * n_rows + c] = bounds[3 * n_rows + c] = b.hi.v;
  if (cand.k < 1 || cand.k > k_cols) clm_at_k[c] = NAN;
  const Num<0> sat = saturated_log_mu(cand);
  float* out = clm + static_cast<long long>(c) * k_cols;
  float carry = -0.0f;
  const int segments = (k_cols + kSegment - 1) / kSegment;
  for (int s = 0; s < segments; ++s) {
    float v[32][kPerLane];
    Num<0> incl[32];
    for (int l = 0; l < 32; ++l)
      incl[l] = constant<0>(own_lane_segment(cand, sat, s, l, k_cols, v[l]));
    hs_scan(incl);
    for (int l = 0; l < 32; ++l) {
      const float below = l == 0 ? -0.0f : incl[l - 1].v;
      const float base = carry + below;
      for (int i = 0; i < kPerLane; ++i) {
        v[l][i] = base + v[l][i];
        const int n = kSegment * s + kPerLane * l + 1 + i;
        if (n <= k_cols) out[n - 1] = v[l][i];
        if (n == cand.k) clm_at_k[c] = v[l][i];
      }
    }
    carry = v[31][kPerLane - 1];
  }
}
}  // namespace setup_h

namespace stats_h {
namespace {
@STATS@
}  // namespace

// Each lane's 8 states of segment s: their own log mu, dealt (the kernel)
// or each lane's own (the oracle).
void own_states(const Cand<0>& cand, int s, int k_cols, bool dealt,
                Num<0> (&lp)[32][kPerLane]) {
  if (!dealt) {
    for (int l = 0; l < 32; ++l)
      for (int i = 0; i < kPerLane; ++i)
        lp[l][i] = own_log_mu(cand, kSegment * s + kPerLane * l + 1 + i);
    return;
  }
  const int count = own_count(cand, s, k_cols);
  float seg[kSegment];
  for (int j = 0; j < kSegment; ++j) seg[j] = NAN;  // stale to every read
  for (int l = 0; l < 32; ++l) deal_own_log_mu(cand, s, l, count, seg);
  for (int l = 0; l < 32; ++l)
    for (int i = 0; i < kPerLane; ++i)
      lp[l][i] = constant<0>(count > 0 ? seg[kPerLane * l + i] : 0.0f);
}

// chain_stats_kernel<S>'s warp for row c, lane by lane: the kernel's
// schedule (the own log mu dealt, the walk limited to the row's segments),
// or with `oracle` PR 12's (each lane its own states, all S segments).
template <int S>
void run_row(const Rows& rows, const float* rate, const float* lam_star,
             const float* targets, const float* lam_max_in, float* out,
             unsigned char* valid, int c, int n_rows, int k_cols, int mode,
             bool oracle) {
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
    valid[c] = a.valid;
  }
  const Num<0> log_lam = dlog(clamp_min(constant<0>(lam), 1e-30f));
  const Num<0> sat = saturated_log_mu(cand);
  const int walked = oracle ? S : std::min(S, row_segments(cand.k, k_cols));

  static Num<0> lp[S][32][kPerLane];
  Num<0> carry = zero<0>();
  for (int s = 0; s < walked; ++s) {
    own_states(cand, s, k_cols, !oracle, lp[s]);
    Num<0> incl[32];
    for (int l = 0; l < 32; ++l)
      incl[l] = run_prefix(cand, log_lam, sat, kSegment * s + kPerLane * l + 1,
                           k_cols, lp[s][l]);
    hs_scan(incl);
    Num<0> last[32];
    for (int l = 0; l < 32; ++l)
      last[l] = finish_prefix(add(carry, l == 0 ? zero<0>() : incl[l - 1]),
                              lp[s][l]);
    carry = last[31];
  }

  float m_of[32];
  Num<0> ws[32];
  for (int l = 0; l < 32; ++l) {
    m_of[l] = -INFINITY;
    for (int s = 0; s < walked; ++s)
      m_of[l] = max_nan(m_of[l], run_max(l == 0 && s == 0, lp[s][l]));
  }
  float m = max32(m_of);
  m = fabsf(m) == INFINITY ? 0.0f : m;
  for (int l = 0; l < 32; ++l) {
    ws[l] = zero<0>();
    for (int s = 0; s < walked; ++s)
      ws[l] = add(ws[l], run_weights(l == 0 && s == 0, lp[s][l], m));
  }
  const Num<0> logz = log_partition(sum32(ws), m);

  Num<0> p_at_k[32];
  Moments<0> mo[32];
  for (int l = 0; l < 32; ++l) {
    p_at_k[l] = constant<0>(NAN);
    mo[l] = moments_zero<0>();
    for (int s = 0; s < walked; ++s)
      mo[l] = add(mo[l], run_moments(cand, l == 0 && s == 0,
                                     kSegment * s + kPerLane * l + 1,
                                     lp[s][l], logz, &p_at_k[l]));
  }
  const Moments<0> total = sum32(mo);
  Num<0> p_block = p_at_k[holder_lane(cand.k)];
  if (cand.k < 0 || cand.k > k_cols) p_block = constant<0>(NAN);
  const Stats<0> st = chain_stats(cand, constant<0>(lam), total, p_block);
  if (mode == 0) {
    float row[kTailRows];
    tail_rows(cand, tail, st, row);
    for (int l = 0; l < kTailRows; ++l) out[l * n_rows + c] = row_of(row, l);
  } else {
    float row[kAnalyzeRows];
    analyze_rows(cand, b, lam, st, row);
    for (int l = 0; l < kAnalyzeRows; ++l)
      out[l * n_rows + c] = row_of(row, l);
  }
}

// chain_jacobian_kernel's block, thread by thread between its barriers.
void run_block(const float* x, const float* env, float* out) {
  const Cand<3> c = jacobian_candidate(x, env);
  const Dual mu_b = service_rate(c, c.batch);
  const Dual sat = dlog(clamp_min(mu_b, 1e-30f));
  const Dual lam = clip_rate(env[0], service_rate(c, 1), mu_b);
  const Dual log_lam = dlog(clamp_min(lam, 1e-30f));
  Dual p_block = constant<3>(NAN);
  static Dual lp[kThreads][kPer];

  // The prefix sum.
  static Dual incl[kThreads];
  for (int g = 0; g < kThreads; ++g) {
    for (int i = 0; i < kPer; ++i) lp[g][i] = own_log_mu(c, kPer * g + 1 + i);
    incl[g] = run_prefix(c, log_lam, sat, kPer * g + 1, kMaxStates, lp[g]);
  }
  for (int w = 0; w < kWarps; ++w) hs_scan(incl + 32 * w);
  Dual totals[32];
  for (int l = 0; l < 32; ++l)
    totals[l] = l < kWarps ? incl[32 * l + 31] : zero<3>();
  hs_scan(totals);
  for (int g = 0; g < kThreads; ++g) {
    const int lane = g % 32, warp = g / 32;
    const Dual below = lane == 0 ? zero<3>() : incl[g - 1];
    const Dual offset = warp == 0 ? zero<3>() : totals[warp - 1];
    finish_prefix(add(offset, below), lp[g]);
  }

  // The maximum.
  float maxima[32];
  for (int w = 0; w < 32; ++w) {
    if (w >= kWarps) {
      maxima[w] = -INFINITY;
      continue;
    }
    float m_of[32];
    for (int l = 0; l < 32; ++l) m_of[l] = run_max(32 * w + l == 0, lp[32 * w + l]);
    maxima[w] = max32(m_of);
  }
  float m = max32(maxima);
  m = fabsf(m) == INFINITY ? 0.0f : m;

  // The weights and logz.
  Dual sums[32];
  for (int w = 0; w < 32; ++w) {
    if (w >= kWarps) {
      sums[w] = zero<3>();
      continue;
    }
    Dual ws[32];
    for (int l = 0; l < 32; ++l)
      ws[l] = run_weights(32 * w + l == 0, lp[32 * w + l], m);
    sums[w] = sum32(ws);
  }
  const Dual logz = log_partition(sum32(sums), m);

  // The moments, p_block and the derived values.
  Moments<3> per_warp[32];
  for (int w = 0; w < 32; ++w) {
    if (w >= kWarps) {
      per_warp[w] = moments_zero<3>();
      continue;
    }
    Moments<3> mo[32];
    for (int l = 0; l < 32; ++l) {
      const int g = 32 * w + l;
      mo[l] = run_moments(c, g == 0, kPer * g + 1, lp[g], logz, &p_block);
    }
    per_warp[w] = sum32(mo);
  }
  observation(c, lam, sum32(per_warp), p_block, out);
}

template <int S>
void run_rows(const Rows& rows, const float* rate, const float* lam_star,
              const float* targets, const float* lam_max, float* out,
              unsigned char* valid, int n_rows, int k_cols, int mode,
              bool oracle) {
  for (int c = 0; c < n_rows; ++c)
    run_row<S>(rows, rate, lam_star, targets, lam_max, out, valid, c,
               n_rows, k_cols, mode, oracle);
}
}  // namespace stats_h

extern "C" {

// schedule 0: the kernel's; 1: the oracle, PR 12's.
void host_setup(const float* alpha, const float* beta, const float* gamma,
                const float* in, const float* out_tokens, const int* batch,
                const int* k, float* bounds, float* clm, float* clm_at_k,
                int n_rows, int k_cols, int schedule) {
  const chain::Rows rows = {alpha, beta, gamma, in, out_tokens, batch, k};
  for (int c = 0; c < n_rows; ++c)
    (schedule ? setup_h::run_row_oracle : setup_h::run_row)(
        rows, c, n_rows, k_cols, bounds, clm, clm_at_k);
}

void host_stats(const float* alpha, const float* beta, const float* gamma,
                const float* in, const float* out_tokens, const int* batch,
                const int* k, const float* rate, const float* lam_star,
                const float* targets, const float* lam_max, float* out,
                unsigned char* valid, int n_rows, int k_cols, int mode,
                int segments, int schedule) {
  const chain::Rows rows = {alpha, beta, gamma, in, out_tokens, batch, k};
  const bool oracle = schedule != 0;
  if (segments == 1)
    stats_h::run_rows<1>(rows, rate, lam_star, targets, lam_max, out, valid,
                         n_rows, k_cols, mode, oracle);
  else if (segments == 2)
    stats_h::run_rows<2>(rows, rate, lam_star, targets, lam_max, out, valid,
                         n_rows, k_cols, mode, oracle);
  else if (segments == 4)
    stats_h::run_rows<4>(rows, rate, lam_star, targets, lam_max, out, valid,
                         n_rows, k_cols, mode, oracle);
  else
    stats_h::run_rows<8>(rows, rate, lam_star, targets, lam_max, out, valid,
                         n_rows, k_cols, mode, oracle);
}

void host_jacobian(const float* x, const float* env, float* out) {
  stats_h::run_block(x, env, out);
}

// One forward rule on duals x and y (value and three tangents each):
// 0 maximum, 1 minimum, 2 clamp(x, min=y's value).
void host_rule(int op, const float* x, const float* y, float* out) {
  using chain::Num;
  Num<3> a, b;
  a.v = x[0];
  b.v = y[0];
  for (int j = 0; j < 3; ++j) {
    a.t[j] = x[1 + j];
    b.t[j] = y[1 + j];
  }
  const Num<3> r = op == 0 ? chain::maximum(a, b)
                   : op == 1 ? chain::minimum(a, b)
                             : chain::clamp_min(a, b.v);
  out[0] = r.v;
  for (int j = 0; j < 3; ++j) out[1 + j] = r.t[j];
}

}  // extern "C"
"""


def host_body(name: str) -> str:
    """The host-C++ part of ``csrc/<name>.cu``: the text between its
    ``namespace {`` and ``// ---- the kernel``."""
    text = (CSRC / f"{name}.cu").read_text()
    return text[text.index("namespace {") + len("namespace {"):
                text.index("// ---- the kernel")]


def build(tmp: Path) -> ctypes.CDLL:
    """Compile the harness into ``tmp`` and load it; skip without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' arithmetic as host C++")
    src, lib = tmp / "chain_host.cc", tmp / "chain_host.so"
    src.write_text(HARNESS.replace("@SETUP@", host_body("chain_setup"))
                   .replace("@STATS@", host_body("chain_stats")))
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-I", str(CSRC), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    so.host_setup.argtypes = [ptr] * 10 + [i32] * 3
    so.host_stats.argtypes = [ptr] * 13 + [i32] * 5
    so.host_jacobian.argtypes = [ptr] * 3
    so.host_rule.argtypes = [i32, ptr, ptr, ptr]
    for fn in (so.host_setup, so.host_stats, so.host_jacobian, so.host_rule):
        fn.restype = None
    return so


def as_ptr(a):
    return ctypes.c_void_p(None if a is None else a.ctypes.data)


FIELDS = ("alpha", "beta", "gamma", "avg_input_tokens", "avg_output_tokens",
          "max_batch", "k")


def field_arrays(fields: dict) -> list:
    """The candidate fields as contiguous arrays of the kernels' types."""
    return [np.ascontiguousarray(fields[f], np.int32 if f in ("max_batch", "k")
                                 else np.float32) for f in FIELDS]


def segments_for(k_cols: int) -> int:
    """The kernel's instantiation: the fewest of 1, 2, 4, 8 segments of 256
    states that cover ``k_cols``."""
    return next(s for s in (1, 2, 4, 8) if 256 * s >= k_cols)
