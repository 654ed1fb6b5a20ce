// The sizing bisection's chain setup for Hopper (sm_90a): every input of
// the sizing kernel (sizing_bisection.cu) in one launch.
//
// Replaces, on the sizing path of queue_model.py (_size_batch_core), the
// PyTorch ops that ran before the sizing kernel: rate_bounds_per_ms, the
// masked log service rate (_masked_log_mu), its prefix sum (_cum_log_mu)
// and the gather of clm at each row's k. In the reference these are plain
// XLA ops inside the jitted size_batch (wva_tpu/analyzers/queueing/
// queue_model.py:136, :144, :155, :392), not a Pallas kernel. The plain
// version is chain_setup.chain_setup_plain, which CPU tensors take.
//
// Inputs, per candidate row c < C: alpha, beta, gamma, avg input and output
// tokens (float32), max batch B and occupancy bound k (int32). Outputs:
//   bounds [4, C]: lambda_min twice, then lambda_max twice (the bisection's
//     lo0 and hi0, one row a lane);
//   clm [C, k_cols]: clm[c, n - 1] = sum over i <= n of log mu(i), log mu
//     +1e30 past k;
//   clm_at_k [C]: clm[c, k - 1], NaN where k is outside 1..k_cols (the
//     plain version's gather raises there).
//
// Design. One warp a row, 8 rows a block, a segment's 256 floats a row in
// shared memory (8 KiB a block), no barrier but the warp's own. The row's
// chain is walked in segments of 256 states; in each:
//   - the states that need their own log mu (below B, within k and k_cols:
//     a division and a log each) are dealt across the warp, state 256 s + j
//     + 1 to lane j mod 32, into the row's shared segment. At B = 96 each
//     lane evaluates 3 of them, where lane l once evaluated its own 8 and
//     lanes 12-31 waited for lanes 0-11;
//   - lane l reads back its 8 consecutive states 256 s + 8 l + 1 .. + 8 (two
//     16-byte loads) and sums their masked log mu in order; every state n
//     >= B has the same mu (its eff is B), so the row evaluates log mu once
//     for all of them;
//   - a Hillis-Steele scan of the 32 lanes' sums (shfl_up, lower + upper)
//     gives each lane the sum of the lanes below it; a state's prefix is
//     (carry + the lanes below) + the lane's own running sum, and the carry
//     into the next segment is the prefix at the segment's last state;
//   - the 256 prefixes go back to the shared segment and out to clm with
//     neighbouring lanes on neighbouring addresses (128 contiguous bytes a
//     warp instruction, where each lane's 8 consecutive prefixes took 8
//     instructions of 32 sectors each; 16-byte stores measured no faster on
//     the H100, PERF.md), and clm_at_k from the same stage.
// Each sum's order is fixed by the source and by nothing else, and a
// state's log mu is the same operations on whichever lane: a row's bits do
// not depend on C, on its position, on the other rows, or on k_cols once
// k_cols covers its k, and equal those of the schedule in which each lane
// evaluated its own states (tests/chain_host.py keeps that one as the
// oracle).
//
// What bounds it on the H100. The bytes: clm is written once, C * k_cols *
// 4 bytes (4 MiB at the fleet tick's C=2048, k_cols=512: ~1.3 us at 3.35
// TB/s), and the inputs are read once. The operations: a division and a
// log a state below B, an add a state above it. The chain of one row: the
// candidate's scalars, ceil((min(B, k + 1) - 1) / 32) states' log mu on a
// lane, 8 adds, the 5-step scan and the carry through k_cols / 256
// segments; at a few rows (the headline world's C = 8) that chain and the
// launch are all there is.
//
// Rounding. Built with -fmad=false: each operation rounds once, as the
// plain version's do. The plain version's cumsum takes another order (and
// on the CPU accumulates in double), so the two agree within a tolerance,
// not bit for bit. Everything from here to the line "---- the kernel" is
// host C++ as well (define __device__ and __forceinline__ away):
// tests/test_torch_chain_host.py runs it in the kernel's order on the CPU.

#include <cuda_runtime.h>
#include <math.h>

#include "chain_common.cuh"

namespace {

using namespace chain;

// The lane's 8 states of segment s: v[i] the sum of their masked log mu up
// to and including state 256 s + 8 lane + 1 + i, in order, from their own
// log mu as dealt (deal_own_log_mu). Returns the lane's total.
__device__ __forceinline__ float lane_segment(const Cand<0>& c, Num<0> sat,
                                              int s, int lane, int k_cols,
                                              const Num<0> (&own)[kPerLane],
                                              float (&v)[kPerLane]) {
  Num<0> run = zero<0>();
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int n = kSegment * s + kPerLane * lane + 1 + i;
    run = add(run, masked(c, sat, own[i], n, k_cols));
    v[i] = run.v;
  }
  return run.v;
}

// ---- the kernel: device code only from here on

constexpr unsigned kAll = 0xffffffffu;

__global__ void __launch_bounds__(32 * kRowsPerBlock)
    chain_setup_kernel(Rows rows, float* __restrict__ bounds,
                       float* __restrict__ clm, float* __restrict__ clm_at_k,
                       int n_rows, int k_cols) {
  // Each row's segment: first its dealt own log mu, then its prefixes.
  __shared__ __align__(16) float stage[kRowsPerBlock][kSegment];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kRowsPerBlock + warp;
  if (c >= n_rows) return;
  float* seg = stage[warp];
  float4* seg4 = reinterpret_cast<float4*>(seg);
  const Cand<0> cand = row_candidate(rows, c);
  const Bounds<0> b = rate_bounds(cand);
  if (lane == 0) {
    bounds[c] = bounds[n_rows + c] = b.lo.v;
    bounds[2 * n_rows + c] = bounds[3 * n_rows + c] = b.hi.v;
    if (cand.k < 1 || cand.k > k_cols) clm_at_k[c] = NAN;
  }
  const Num<0> sat = saturated_log_mu(cand);
  float* out = clm + static_cast<long long>(c) * k_cols;
  float carry = -0.0f;
  const int segments = (k_cols + kSegment - 1) / kSegment;
  for (int s = 0; s < segments; ++s) {
    const int count = own_count(cand, s, k_cols);
    Num<0> own[kPerLane];
    if (count > 0) {
      deal_own_log_mu(cand, s, lane, count, seg);
      __syncwarp();
      const float4 lo = seg4[2 * lane], hi = seg4[2 * lane + 1];
      const float dealt[kPerLane] = {lo.x, lo.y, lo.z, lo.w,
                                     hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) own[i] = constant<0>(dealt[i]);
      __syncwarp();
    } else {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) own[i] = constant<0>(0.0f);
    }
    float v[kPerLane];
    float incl = lane_segment(cand, sat, s, lane, k_cols, own, v);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float lower = __shfl_up_sync(kAll, incl, off);
      if (lane >= off) incl = lower + incl;
    }
    float below = __shfl_up_sync(kAll, incl, 1);
    if (lane == 0) below = -0.0f;
    const float base = carry + below;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) v[i] = base + v[i];
    seg4[2 * lane] = make_float4(v[0], v[1], v[2], v[3]);
    seg4[2 * lane + 1] = make_float4(v[4], v[5], v[6], v[7]);
    __syncwarp();
    const int width = min(kSegment, k_cols - kSegment * s);
    for (int q = lane; q < width; q += 32) out[kSegment * s + q] = seg[q];
    const int at = cand.k - 1 - kSegment * s;
    if (lane == 0 && at >= 0 && at < kSegment) clm_at_k[c] = seg[at];
    carry = __shfl_sync(kAll, v[kPerLane - 1], 31);
    __syncwarp();
  }
}

}  // namespace

extern "C" {

int chain_setup_launch(const float* alpha, const float* beta,
                       const float* gamma, const float* in, const float* out,
                       const int* batch, const int* k, float* bounds,
                       float* clm, float* clm_at_k, int n_rows, int k_cols,
                       cudaStream_t stream) {
  const Rows rows = {alpha, beta, gamma, in, out, batch, k};
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  chain_setup_kernel<<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      rows, bounds, clm, clm_at_k, n_rows, k_cols);
  return static_cast<int>(cudaGetLastError());
}

const char* chain_setup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
