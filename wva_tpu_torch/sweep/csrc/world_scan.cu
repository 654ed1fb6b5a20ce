// The policy sweep's horizon scan for Hopper (sm_90a): one chunk of fluid
// worlds advanced through every step of the horizon in one launch.
//
// Replaces the reference's jitted program wva_tpu/sweep/world.py:_build_scan
// (line 177; the step is make_step at :189, the program jit(lax.scan) at
// :302): an XLA program on the TPU, not a Pallas kernel. Each (world, model)
// lane carries its state through T steps in order; the plain version is
// wva_tpu_torch/sweep/world.py:run_chunk_plain, T steps of PyTorch ops over
// [W, M] tensors, and this kernel computes what it computes, bit for bit.
//
// Inputs, float32, contiguous: knob_rows [W, K] (K = 13, KNOB_FIELDS
// order), lam_t [T, M], arrivals and faults [T, W, M]. Output out [4, W, M]:
// attainment, chip-seconds, wrong-direction events and arrivals in total.
//
// What bounds it on the H100. A chunk of 256 worlds reads ~0.5 MB and
// writes 4 KB: 0.15 us at 3.35 TB/s. The steps of a lane are a recurrence,
// so the floor is the longest chain of dependent operations that one step
// hands to the next: the Holt level and trend,
//   trend -> level + trend -> * (1-ga) -> + ga*obs -> select = level'
//         -> - level -> * gb -> + (1-gb)*trend -> select = trend',
// 8 operations a step, ~4 cycles each: 240 x 32 cycles at 1.98 GHz is
// ~3.9 us. The five IEEE divisions a step (a reciprocal estimate, two
// Newton steps and a correction: ~9 dependent instructions, ~40 cycles,
// with a slower path for denormal and huge operands) feed the TTFT, the
// smoothed error and the raw desired count, which no carry reads back
// through itself, so none lies on that chain; neither does the pipeline's
// fold of L lanes (a chain of L - 1 adds that no later fold waits on but
// for its last two lanes). Lanes share nothing, so every lane's chain runs
// at once, up to 132 SMs x 2048 threads of them.
//
// Design: one thread a lane, its whole state in registers.
//   - Blocks of 64 threads, one lane each (lane = world * M + model), so at
//     every step neighbouring threads read neighbouring addresses of the
//     arrival and fault tables. A chunk of 256 worlds is 4 blocks; the
//     steps are serial, and more threads per lane would only add barriers.
//   - The 16 scalar carries live in registers. The provisioning pipeline
//     (L = lead_steps lanes) is a ring in dynamic shared memory laid out
//     [lane][thread], so thread i of a block touches only column i (no
//     bank conflict, no barrier). The head index moves one slot a step; the
//     slot it leaves becomes the tail, zeroed, as the plain version shifts
//     its tensor and appends a zero.
//   - The loop-invariant columns (occ_target, g_obs, ki, 1 - ga, 1 - gb,
//     lead_intervals, r_target, burst) are computed once from the knob row,
//     in the plain version's order. Every constant Python derives in
//     double (the iteration slope beta*tc + gamma*tm, (beta+gamma)*in, the
//     full-batch rate, ...) comes from the wrapper rounded to float32, as
//     PyTorch rounds a Python scalar; this file derives none.
// TMA, wgmma and clusters are not used: nothing is a matrix product, and
// each table is read once.
// What this simple design leaves: each IEEE division ends in a check and a
// branch to its slow path, which the compiler does not schedule across, so
// a step's instructions run mostly one after another, and the step's
// latency, not the chain above, sets the time: a chunk takes about as long
// at thousands of lanes as at 256 (PERF.md).
//
// Rounding. Built with -fmad=false, so no multiply and add are contracted
// into one FFMA, and every product stays two products in order (desired *
// chips * dt is never desired * 40). Divisions are IEEE '/', never a
// reciprocal. max and min pass NaN through, as torch.maximum/minimum and
// jnp.clip do (fmaxf/fminf alone would drop it), and a clip is
// min(max(x, lo), hi). rintf rounds half to even, as torch.round does; the
// float-to-int conversion truncates, as .to(torch.int32) does. The pipeline
// sum is a left fold from the head in lane order, its last lane the zeroed
// tail, and the new tail is written as 0 + short, as the plain version
// writes pipe[L-1] + short.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kKnobs = 13;
constexpr int kThreads = 64;
// The deepest pipeline the kernel takes: 128 lanes of 64 threads are 32 KB
// of shared memory a block, under the 48 KB a launch may ask for without an
// attribute (startup_s up to 128 steps, 640 s at 5 s steps).
constexpr int kMaxLead = 128;

// Knob columns, in KNOB_FIELDS order.
enum Knob {
  kEngineInterval = 0,
  kHeadroom = 1,
  kTargetUtilization = 2,
  kBurstSlope = 3,
  kForecaster = 4,  // not read by the fluid world
  kGridStep = 5,
  kLevelGain = 6,
  kTrendGain = 7,
  kMinTrustEvals = 8,
  kDemoteError = 9,
  kDegradedAfter = 10,
  kFreezeAfter = 11,
  kRecoveryTicks = 12,
};

// The step's constants, each the Python value the plain version hands a
// PyTorch op, rounded to float32 by the caller (scan_kernel.CONSTANT_NAMES
// is this order).
struct Consts {
  float eps;            // the floor of every divisor, 1e-6
  float dt;             // step seconds
  float ms;             // 1000: ms a second
  float max_batch;
  float max_replicas;
  float steps;          // T, ki's upper clip
  float lead;           // L, as a float
  float iter_slope;     // beta*tc + gamma*tm: ms an iteration per request
  float alpha;          // ms an iteration at no load
  float prefill_extra;  // (beta + gamma) * input tokens
  float out_tokens;
  float rate_full;      // a replica's req/s at the full batch
  float slo_ttft;
  float queue_bound;
  float startup;        // seconds of burst anticipation
  float stab_steps;     // scale-down stabilization, in steps
  float chips_per_replica;
  float init_replicas;
  float err_gain;       // 0.2, the walk-forward error's EWMA gain
  float two;
};

constexpr int kConsts = sizeof(Consts) / sizeof(float);

__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}

// ms of one decode iteration at batch occupancy n: alpha + n * slope.
__device__ __forceinline__ float iteration_ms(const Consts& c, float n) {
  return n * c.iter_slope + c.alpha;
}

// One lane's walk through the horizon. ``ring`` is the lane's pipeline,
// element i at ring[i * stride]; ``out`` gets the four results at
// out[j * out_stride].
__device__ __forceinline__ void scan_lane(
    const float* __restrict__ k, const float* __restrict__ lam_t,
    const float* __restrict__ arrivals, const float* __restrict__ faults,
    float* __restrict__ out, float* ring, int stride, int model, int m,
    int lanes, int steps, int lead, const Consts& c) {
  // Loop-invariant columns, in the plain version's order.
  const float occ_target =
      clip(k[kTargetUtilization] * c.max_batch, 1.0f, c.max_batch);
  const float g_obs =
      clip(c.dt / max_nan(k[kGridStep], c.dt), 0.0f, 1.0f);
  const float ki_f = k[kEngineInterval] / c.dt;
  const int ki = static_cast<int>(
      clip(isfinite(ki_f) ? rintf(ki_f) : 1.0f, 1.0f, c.steps));
  const float ga = k[kLevelGain], gb = k[kTrendGain];
  const float one_ga = 1.0f - ga, one_gb = 1.0f - gb;
  const float lead_intervals =
      c.lead / max_nan(static_cast<float>(ki), 1.0f) + 1.0f;
  const float it_target = iteration_ms(c, occ_target);
  const float r_target =
      occ_target * c.ms /
      ((it_target + c.prefill_extra) + it_target * c.out_tokens);
  const float r_target_floor = max_nan(r_target, c.eps);
  const float burst = k[kBurstSlope] * c.startup;

  float q = 0.0f, obs = 0.0f, level = 0.0f, trend = 0.0f, err = 0.0f;
  float evals = 0.0f, fault_run = 0.0f, recovery = 0.0f, last_lam = 0.0f;
  float attained = 0.0f, total = 0.0f, chip_s = 0.0f, wd = 0.0f;
  float ready = 0.0f + c.init_replicas;
  float desired = 0.0f + c.init_replicas;
  float since_up = 0.0f + c.stab_steps;
  for (int i = 0; i < lead; ++i) ring[i * stride] = 0.0f;
  int head = 0;

  for (int t = 0; t < steps; ++t) {
    const float lam_now = lam_t[static_cast<size_t>(t) * m + model];
    const float a = arrivals[static_cast<size_t>(t) * lanes];
    const float f = faults[static_cast<size_t>(t) * lanes];

    // Provisioning pipeline head matures into ready replicas; its slot
    // becomes the zeroed tail.
    const int tail = head;
    ready = ready + ring[head * stride];
    ring[tail * stride] = 0.0f;
    head = head + 1 == lead ? 0 : head + 1;

    // Serving at full-batch throughput; queue-wait + prefill TTFT.
    const float cap_rps = ready * c.rate_full;
    const float wait_s = q / max_nan(cap_rps, c.eps);
    const float occ = clip(
        (q + a) / max_nan(cap_rps * c.dt, c.eps) * c.max_batch, 1.0f,
        c.max_batch);
    const float ttft =
        wait_s + (iteration_ms(c, occ) + c.prefill_extra) / c.ms;
    const float ok = ttft <= c.slo_ttft ? 1.0f : 0.0f;
    const float backlog = q + a;
    const float served = min_nan(backlog, cap_rps * c.dt);
    float q_next = backlog - served;
    const float drop = max_nan(q_next - c.queue_bound * ready, 0.0f);
    q_next = q_next - drop;
    attained = attained + max_nan(a * ok - drop, 0.0f);
    q = q_next;
    total = total + a;

    // Observation: EWMA of measured rate, stale-held through faults.
    const bool faulted = f > 0.0f;
    const float measured = a / c.dt;
    obs = faulted ? obs : obs + g_obs * (measured - obs);
    fault_run = faulted ? fault_run + 1.0f : 0.0f;
    recovery = faulted ? k[kRecoveryTicks] : max_nan(recovery - 1.0f, 0.0f);

    // Engine cadence; the Holt state updates at act steps from clean
    // observations, with walk-forward trust.
    const bool act = t % ki == 0;
    const bool upd = act && f <= 0.0f;
    const float pred_now = level + trend;
    const float sm_err =
        fabsf(pred_now - obs) /
        max_nan((fabsf(pred_now) + fabsf(obs)) / c.two, c.eps);
    err = upd ? err + c.err_gain * (sm_err - err) : err;
    evals = upd ? evals + 1.0f : evals;
    const float new_level =
        upd ? ga * obs + one_ga * (level + trend) : level;
    trend = upd ? gb * (new_level - level) + one_gb * trend : trend;
    level = new_level;
    const bool trusted = evals >= k[kMinTrustEvals] && err <= k[kDemoteError];
    const float forecast = level + trend * lead_intervals;

    // Sizing: cover max(observed + burst insurance, trusted forecast) at
    // the target-occupancy service rate, plus headroom.
    const float reactive = obs + burst;
    const float target_rate = max_nan(reactive, trusted ? forecast : 0.0f);
    const float desired_raw =
        clip(ceilf(target_rate / r_target_floor) + k[kHeadroom], 1.0f,
             c.max_replicas);

    // Health gating + down-stabilization.
    const float fault_s = fault_run * c.dt;
    const bool degraded = fault_s >= k[kDegradedAfter];
    const bool frozen = fault_s >= k[kFreezeAfter];
    const bool can_down =
        since_up >= c.stab_steps && !degraded && recovery <= 0.0f;
    const bool up = desired_raw > desired;
    float desired_new = up ? desired_raw : (can_down ? desired_raw : desired);
    desired_new = frozen ? desired : desired_new;
    desired_new = act ? desired_new : desired;
    const bool wd_event =
        act && desired_new < desired && lam_now > last_lam + c.eps;
    wd = wd + (wd_event ? 1.0f : 0.0f);
    last_lam = act ? 0.0f + lam_now : last_lam;
    since_up = act && desired_new > desired ? 0.0f : since_up + 1.0f;
    desired = desired_new;

    // Actuation: downs immediate, ups through the pipeline tail. The
    // pending sum is a left fold from the head, in lane order.
    float pending = ring[head * stride];
    for (int i = 1, j = head; i < lead; ++i) {
      j = j + 1 == lead ? 0 : j + 1;
      pending = pending + ring[j * stride];
    }
    const float excess = max_nan(ready - desired, 0.0f);
    ready = ready - excess;
    const float short_by = max_nan(desired - (ready + pending), 0.0f);
    ring[tail * stride] = 0.0f + short_by;

    chip_s = chip_s + desired * c.chips_per_replica * c.dt;
  }
  out[0] = attained / max_nan(total, 1.0f);
  out[lanes] = chip_s;
  out[2 * static_cast<size_t>(lanes)] = wd;
  out[3 * static_cast<size_t>(lanes)] = total;
}

__global__ void __launch_bounds__(kThreads)
    world_scan_kernel(const float* __restrict__ knob_rows,
                      const float* __restrict__ lam_t,
                      const float* __restrict__ arrivals,
                      const float* __restrict__ faults,
                      float* __restrict__ out, int w, int m, int steps,
                      int lead, Consts c) {
  extern __shared__ float ring[];  // [lead][kThreads]
  const int lanes = w * m;
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;  // no barrier follows
  const int world = lane / m;
  scan_lane(knob_rows + static_cast<size_t>(world) * kKnobs, lam_t,
            arrivals + lane, faults + lane, out + lane, ring + threadIdx.x,
            kThreads, lane - world * m, m, lanes, steps, lead, c);
}

}  // namespace

extern "C" {

// Launches the kernel on ``stream`` for a chunk of W worlds x M models over
// ``steps`` steps with a pipeline of ``lead`` lanes, and returns
// cudaGetLastError() (0 on success). Device pointers to contiguous float32
// arrays: knob_rows [W, n_knobs], lam_t [steps, M], arrivals and faults
// [steps, W, M], out [4, W, M]. ``consts`` is a host pointer to the
// n_consts floats of Consts, in order. n_knobs must be 13, n_consts 20,
// lead 1..kMaxLead.
int world_scan_launch(const float* knob_rows, const float* lam_t,
                      const float* arrivals, const float* faults, float* out,
                      int w, int m, int steps, int lead, int n_knobs,
                      const float* consts, int n_consts, void* stream) {
  if (w < 0 || m < 0 || steps < 0 || lead < 1 || lead > kMaxLead ||
      n_knobs != kKnobs || n_consts != kConsts || consts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = w * m;
  if (lanes == 0) return 0;
  Consts c;
  float* dst = reinterpret_cast<float*>(&c);
  for (int i = 0; i < kConsts; ++i) dst[i] = consts[i];
  const int blocks = (lanes + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(lead) * kThreads * sizeof(float);
  world_scan_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      knob_rows, lam_t, arrivals, faults, out, w, m, steps, lead, c);
  return static_cast<int>(cudaGetLastError());
}

const char* world_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
