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
// ~3.9 us. Lanes share nothing, so every lane's chain runs at once.
//
// The three stages, and why splitting them is exact. A step is three
// stages with no edge from a later one back to an earlier one:
//   1. forecast and sizing: reads the arrivals a and faults f, the knob row
//      and the cadence t % ki; carries obs, fault_run, recovery, level,
//      trend, err and evals; hands on desired_raw and the flags act,
//      frozen and "may scale down" (not degraded, recovery <= 0);
//   2. control: carries since_up, desired, last_lam, wd, ready, the
//      pipeline and chip_s; reads stage 1's hand-off and lam_t; hands on
//      ready after maturation;
//   3. serving: carries q, attained and total; reads a and stage 2's ready.
// So each stage can run its steps ahead of the next. Every float32
// operation of a step is the plain version's, on the same operands in the
// same order; only which thread issues it, and when, changes. The six IEEE
// divisions (a / dt, the smoothed error, the raw desired count, the wait,
// the occupancy and the TTFT) each feed an accumulator or a later stage
// through a select, never their own divisor, so each is computed in
// parallel across steps once its operands are stored.
//
// Design: a block is a group of 32 lanes (lane = world * M + model) and
// a warp for each role; thread i of a role's warp works on lane i.
//   - The steps go in tiles of kTile = 8. In round r each role works on
//     its own tile, r less its offset (enum Offset), then the block meets
//     at one named barrier (bar.sync 1 over every thread; no thread
//     returns before the last). In tile order: the loader copies a tile's
//     arrivals, faults and rates to shared memory, coalesced, having
//     fetched them into registers the round before; the pool divides
//     a / dt; stage 1's walk (obs, the fault run, recovery, the cadence as
//     a counter, Holt) hands on its flags and forecast; the pool computes
//     the smoothed errors; the error walk (err, evals, trust); the pool
//     sizes the raw desired counts while the error walk's warp folds the
//     pending sums' heads; stage 2's walk (the health gate, the
//     stabilized desired count, wrong-direction events, the pipeline,
//     chip-seconds); serving's queue walk; the pool's TTFT and attained
//     arrivals; serving's sums. T / 8 + 9 rounds in all. Each hand-off
//     lives in a ring of tiles in shared memory, [slot][step][lane], as
//     deep as the rounds from its writer to its last reader; a warp reads
//     a row of 32 lanes, one bank each.
//   - The pool takes one step of a tile a thread, so the divisions leave
//     the walks, whose steps are adds, products, selects and the
//     NaN-passing max and min. Two groups of 8 warps split a step's six
//     divisions (the smoothed error and desired count; a / dt and the
//     TTFT's three): 21 warps a block, one block an SM.
//   - A full tile (every tile but a horizon's last) is unrolled with no
//     branch between its steps, so a walk issues one step's work in the
//     gaps of another's.
//   - The pipeline. Step t's pending sum is the left fold s[t-L+1] + ... +
//     s[t-1] + 0, s[tau] being step tau's new tail (0 + short) and s of a
//     step before 0 being 0. Stage 2 keeps the folds of its tile's 8 steps
//     in flight in registers: each starts as its head, the fold of the
//     elements at least two tiles back (built for all 8 steps in one pass
//     over the ring of s in shared memory, [step mod R][lane], R a power
//     of two >= L), takes the previous tile's eight s in order, then each
//     s of the tile as it is made. An empty fold starts as -0.0, which
//     adding leaves every value unchanged (-0 + x = x for every x, +0 and
//     -0 too), so a fold is the same additions in the same order as the
//     plain version's; the step's sum is its fold + 0. One add a step is
//     on the chain. With L >= 2 kTile every element of those two tiles is
//     in every window; a shorter lead selects -0.0 for the elements
//     outside a step's window, and reads its matured lane from the ring
//     each step, after the step before has stored its s: a shared load
//     on ready's chain. ready + s[t-L] reads the matured lane. The
//     long-lead path is a second instantiation of stage 2's tile because
//     it is faster (chip_smoke.py times the general path at the bench
//     lead; PERF.md).
// TMA, wgmma and clusters are not used: nothing is a matrix product, and
// the chunk reads 0.5 MB once.
// What this design leaves: a round ends at a block-wide barrier, so it
// lasts as long as its slowest role's tile, and longer, since 21 warps
// share an SM's four schedulers, the pool's issuing most of the
// instructions (each IEEE division is a dozen of them and a convergence
// region the scheduler does not cross). Each walk alone is bound by the
// latency of its step's instructions, not by its loop-carried chain.
// chip_smoke.py's probe times a round with every role and with each
// alone (PERF.md).
//
// Rounding. Built with -fmad=false, so no multiply and add are contracted
// into one FFMA, and every product stays two products in order (desired *
// chips * dt is never desired * 40). Divisions are IEEE '/', never a
// reciprocal. max and min pass NaN through, as torch.maximum/minimum and
// jnp.clip do (fmaxf/fminf alone would drop it), and a clip is
// min(max(x, lo), hi); on the card each is one max.NaN or min.NaN
// instruction. rintf rounds half to even, as torch.round does; the
// float-to-int conversion truncates, as .to(torch.int32) does; the cadence
// t % ki == 0 is a counter that wraps at ki. Everything from here to the
// line "---- the kernel" is host C++ as well (define __device__ and
// __forceinline__ away): tests/test_torch_scan_host.py runs the stages in
// the kernel's round order on the CPU and holds them to the plain
// version's bits.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kKnobs = 13;
// The deepest pipeline the kernel takes (startup_s up to 128 steps, 640 s
// at 5 s steps).
constexpr int kMaxLead = 128;
constexpr int kLanes = 32;  // lanes a block, one a thread of a serial warp
constexpr int kTile = 8;    // steps a tile

// Warps, one role each; then the pool, two groups of kTile warps.
enum Warp { kLoadWarp = 0, kStage1Warp, kErrWarp, kStage2Warp, kServeWarp,
            kPoolWarp };
constexpr int kPoolGroups = 2;
constexpr int kThreads = (kPoolWarp + kPoolGroups * kTile) * 32;

// The round in which each role works on tile k is k + its offset.
enum Offset { kOffLoad = 0, kOffMeasure, kOffStage1, kOffSmErr, kOffErr,
              kOffSize, kOffStage2, kOffQueue, kOffServe, kOffSum };

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

// Stage 1's flags a step.
enum Flag : unsigned { kAct = 1u, kUpd = 2u, kFrozen = 4u, kDownOk = 8u };

// A ring of tiles, [slot][step][lane]: tile k's step u of lane i.
template <typename T, int Slots>
struct Ring {
  T v[Slots][kTile][kLanes];
  __device__ __forceinline__ T& operator()(int k, int u, int i) {
    return v[k % Slots][u][i];
  }
};

// The hand-offs, each as many tiles deep as the rounds from its writer to
// its last reader, plus one.
struct Tiles {
  Ring<float, 10> a;           // arrivals: loader -> pool, serving
  Ring<float, 3> f;            // faults: loader -> stage 1
  Ring<float, 7> lam;          // the lane model's true rate: loader -> 2
  Ring<float, 2> measured;     // a / dt: pool -> stage 1
  Ring<float, 2> pred;         // level + trend before the update: 1 -> pool
  Ring<float, 4> obs;          // 1 -> pool (error, sizing)
  Ring<float, 4> forecast;     // 1 -> pool (sizing)
  Ring<unsigned, 5> flags;     // 1 -> error walk, stage 2
  Ring<float, 2> sm_err;       // pool -> error walk
  Ring<unsigned, 2> trusted;   // error walk -> pool (sizing)
  Ring<float, 2> desired_raw;  // pool -> stage 2
  Ring<float, 2> head;         // pending folds' older part: error walk -> 2
  Ring<float, 3> ready;        // after maturation: stage 2 -> queue, pool
  Ring<float, 2> q;            // the queue before the step: queue -> pool
  Ring<float, 2> drop;         // queue -> pool
  Ring<float, 2> gain;         // attained arrivals: pool -> sums
};

// The launch's arguments.
struct Chunk {
  const float* knob_rows;
  const float* lam_t;
  const float* arrivals;
  const float* faults;
  float* out;
  int m, lanes, steps, lead;
  int ring_mask;  // R - 1: the ring of s has R slots, a power of two >= L
  Consts c;
  long long* probe;  // a probe build's clock marks, else unused
};

// A block's shared memory: the tiles, then the ring of s, [step mod R]
// [lane].
struct Shared {
  Tiles* t;
  float* ring;
};

// What a thread knows of its lane.
struct Lane {
  int i;           // in the block, 0..31
  size_t g;        // in the chunk, clamped to the last lane
  bool valid;      // g is this thread's own lane (not past the chunk's end)
  int model;
  const float* k;  // the world's knob row
};

__device__ __forceinline__ Lane lane_of(const Chunk& ch, int block, int i) {
  const int want = block * kLanes + i;
  const bool valid = want < ch.lanes;
  const int g = valid ? want : ch.lanes - 1;
  const int world = g / ch.m;
  return Lane{i, static_cast<size_t>(g), valid, g - world * ch.m,
              ch.knob_rows + static_cast<size_t>(world) * kKnobs};
}

__device__ __forceinline__ int tile_count(int steps) {
  return (steps + kTile - 1) / kTile;
}

// Rounds a block runs: the last tile reaches the last role.
__device__ __forceinline__ int round_count(int steps) {
  return tile_count(steps) + kOffSum;
}

// The tile the role at ``offset`` works on in round r, or -1.
__device__ __forceinline__ int tile_at(int r, int offset, int steps) {
  const int k = r - offset;
  return k >= 0 && k < tile_count(steps) ? k : -1;
}

__device__ __forceinline__ int tile_len(int k, int steps) {
  const int n = steps - k * kTile;
  return n < kTile ? n : kTile;
}

// max and min that pass NaN through. On the card one instruction each
// (max.NaN: NaN if either input is, else max), which the compiler cannot
// split into a branch around the evaluation of b; its NaN is canonical,
// where the host's is an input's, and no result reads a NaN's bits.
__device__ __forceinline__ float max_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : (b != b ? b : fmaxf(a, b));
#endif
}

__device__ __forceinline__ float min_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : (b != b ? b : fminf(a, b));
#endif
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}

// ms of one decode iteration at batch occupancy n: alpha + n * slope.
__device__ __forceinline__ float iteration_ms(const Consts& c, float n) {
  return n * c.iter_slope + c.alpha;
}

// ki, the engine cadence in steps, from the knob row.
__device__ __forceinline__ int cadence(const Consts& c, const float* k) {
  const float ki_f = k[kEngineInterval] / c.dt;
  return static_cast<int>(
      clip(isfinite(ki_f) ? rintf(ki_f) : 1.0f, 1.0f, c.steps));
}

// ---- the pending folds

// The older parts of the folds of tile k's steps: step u's (t = ts + u)
// is the fold of s[t-L+1 .. ts-kTile-1], its elements at least two tiles
// back, -0.0 when empty, written to head[u * kLanes]. Every step's ends at
// the same element and starts one element after the step before's, so one
// pass over the ring in step order feeds all kTile folds: element j (from
// step 0's first) starts step j's fold and joins the folds of the steps
// before it. The ring is read kTile elements at a time, the last batch
// padded with -0.0, which adding leaves every value unchanged.
__device__ __forceinline__ void head_folds(const float* ring, int mask,
                                           int lane, int lead, int k,
                                           float* head) {
  const int first = k * kTile - lead + 1;  // step 0's first element
  const int count = lead - kTile - 1;      // step 0's elements
  float acc[kTile], x[kTile];
#pragma unroll
  for (int u = 0; u < kTile; ++u) acc[u] = -0.0f;
  for (int base = 0; base < count; base += kTile) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      // Every masked index is a slot of the ring: load, then select.
      const float v = ring[((first + base + j) & mask) * kLanes + lane];
      x[j] = base + j < count ? v : -0.0f;
    }
    if (base == 0) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
#pragma unroll
        for (int u = 0; u <= j; ++u) acc[u] = acc[u] + x[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
#pragma unroll
        for (int u = 0; u < kTile; ++u) acc[u] = acc[u] + x[j];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kTile; ++u) head[u * kLanes] = acc[u];
}

// s, or -0.0 where s is d steps older than the fold's step and outside its
// window of L - 1.
template <bool kLong>
__device__ __forceinline__ float within(float s, int d, int lead) {
  return kLong || d <= lead - 1 ? s : -0.0f;
}

// A lane's pending folds for the steps of one tile, in registers.
// kLong: L >= 2 kTile, every element of this tile and the last in every
// window.
struct Folds {
  float part[kTile];  // step u's fold so far
  float prev[kTile];  // the last tile's s, then this tile's

  // Start tile k from its heads, then take the last tile's s in order.
  template <bool kLong>
  __device__ __forceinline__ void begin(const float* head, int lead) {
#pragma unroll
    for (int u = 0; u < kTile; ++u) part[u] = head[u * kLanes];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
#pragma unroll
      for (int u = 0; u < kTile; ++u)
        part[u] = part[u] + within<kLong>(prev[j], kTile + u - j, lead);
    }
  }

  // The pending sum at step u: the fold, then the zeroed tail.
  __device__ __forceinline__ float pending(int u) const {
    return part[u] + 0.0f;
  }

  // Step u's new tail s joins the folds of the tile's later steps.
  template <bool kLong>
  __device__ __forceinline__ void push(int u, float s, int lead) {
#pragma unroll
    for (int v = 0; v < kTile; ++v)
      if (v > u) part[v] = part[v] + within<kLong>(s, v - u, lead);
    prev[u] = s;
  }
};

// ---- the roles, each a thread's state and its work in one round

// step(u) for the n steps of a tile, unrolled. A full tile (every tile
// but a horizon's last) has no branch between its steps, so the compiler
// can issue one step's work in the gaps of another's.
template <typename Step>
__device__ __forceinline__ void for_steps(int n, Step step) {
  if (n == kTile) {
#pragma unroll
    for (int u = 0; u < kTile; ++u) step(u);
  } else {
#pragma unroll
    for (int u = 0; u < kTile; ++u)
      if (u < n) step(u);
  }
}

// Copies a tile's inputs to shared memory, fetched a round ahead.
struct Loader {
  float a[kTile], f[kTile], lam[kTile];

  // Tile k's inputs of the lane into registers, zeros past the horizon.
  __device__ __forceinline__ void fetch(const Chunk& ch, const Lane& ln,
                                        int k) {
    const int n = k < tile_count(ch.steps) ? tile_len(k, ch.steps) : 0;
    const size_t ts = static_cast<size_t>(k) * kTile;
    const float* arrivals = ch.arrivals + ts * ch.lanes + ln.g;
    const float* faults = ch.faults + ts * ch.lanes + ln.g;
    const float* lam_t = ch.lam_t + ts * ch.m + ln.model;
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      a[u] = f[u] = lam[u] = 0.0f;
    }
    for_steps(n, [&](int u) {
      a[u] = arrivals[static_cast<size_t>(u) * ch.lanes];
      f[u] = faults[static_cast<size_t>(u) * ch.lanes];
      lam[u] = lam_t[static_cast<size_t>(u) * ch.m];
    });
  }

  __device__ __forceinline__ void init(const Chunk& ch, const Lane& ln) {
    fetch(ch, ln, 0);
  }

  __device__ __forceinline__ void round(const Chunk& ch, const Lane& ln,
                                        const Shared& sh, int r) {
    const int k = tile_at(r, kOffLoad, ch.steps);
    if (k < 0) return;
    Tiles& tl = *sh.t;
    const int i = ln.i;
    for_steps(tile_len(k, ch.steps), [&](int u) {
      tl.a(k, u, i) = a[u];
      tl.f(k, u, i) = f[u];
      tl.lam(k, u, i) = lam[u];
    });
    fetch(ch, ln, k + 1);
  }

  __device__ __forceinline__ void finish(const Chunk&, const Lane&) {}
};

// Stage 1's serial walk: the observation, the fault run, recovery, the
// cadence and the Holt state.
struct Stage1 {
  float g_obs, ga, gb, one_ga, one_gb, lead_intervals;
  float recovery_ticks, degraded_after, freeze_after;
  int ki, phase;  // phase = t % ki
  float obs, fault_run, recovery, level, trend;

  __device__ __forceinline__ void init(const Chunk& ch, const Lane& ln) {
    const Consts& c = ch.c;
    const float* k = ln.k;
    g_obs = clip(c.dt / max_nan(k[kGridStep], c.dt), 0.0f, 1.0f);
    ki = cadence(c, k);
    ga = k[kLevelGain];
    gb = k[kTrendGain];
    one_ga = 1.0f - ga;
    one_gb = 1.0f - gb;
    lead_intervals = c.lead / max_nan(static_cast<float>(ki), 1.0f) + 1.0f;
    recovery_ticks = k[kRecoveryTicks];
    degraded_after = k[kDegradedAfter];
    freeze_after = k[kFreezeAfter];
    phase = 0;
    obs = fault_run = recovery = level = trend = 0.0f;
  }

  __device__ __forceinline__ void round(const Chunk& ch, const Lane& ln,
                                        const Shared& sh, int r) {
    const int k = tile_at(r, kOffStage1, ch.steps);
    if (k < 0) return;
    Tiles& tl = *sh.t;
    const Consts& c = ch.c;
    const int i = ln.i;
    const int n = tile_len(k, ch.steps);
    float f[kTile], measured[kTile];
    for_steps(n, [&](int u) {
      f[u] = tl.f(k, u, i);
      measured[u] = tl.measured(k, u, i);
    });
    for_steps(n, [&](int u) {
      // Observation: EWMA of measured rate, stale-held through faults.
      const bool faulted = f[u] > 0.0f;
      obs = faulted ? obs : obs + g_obs * (measured[u] - obs);
      fault_run = faulted ? fault_run + 1.0f : 0.0f;
      recovery =
          faulted ? recovery_ticks : max_nan(recovery - 1.0f, 0.0f);
      // Engine cadence; the Holt state updates at act steps from clean
      // observations.
      const bool act = phase == 0;
      phase = phase + 1 == ki ? 0 : phase + 1;
      const bool upd = act && f[u] <= 0.0f;
      const float pred_now = level + trend;
      const float new_level =
          upd ? ga * obs + one_ga * (level + trend) : level;
      trend = upd ? gb * (new_level - level) + one_gb * trend : trend;
      level = new_level;
      // Health gating's inputs.
      const float fault_s = fault_run * c.dt;
      const bool degraded = fault_s >= degraded_after;
      const bool frozen = fault_s >= freeze_after;
      const bool down_ok = !degraded && recovery <= 0.0f;
      tl.pred(k, u, i) = pred_now;
      tl.obs(k, u, i) = obs;
      tl.forecast(k, u, i) = level + trend * lead_intervals;
      tl.flags(k, u, i) = (act ? kAct : 0u) | (upd ? kUpd : 0u) |
                          (frozen ? kFrozen : 0u) | (down_ok ? kDownOk : 0u);
    });
  }

  __device__ __forceinline__ void finish(const Chunk&, const Lane&) {}
};

// Stage 1's walk-forward error and trust; and, for the tile stage 2 takes
// next, the older parts of its pending folds.
struct ErrWalk {
  float min_trust, demote, err, evals;

  __device__ __forceinline__ void init(const Chunk&, const Lane& ln) {
    min_trust = ln.k[kMinTrustEvals];
    demote = ln.k[kDemoteError];
    err = evals = 0.0f;
  }

  __device__ __forceinline__ void round(const Chunk& ch, const Lane& ln,
                                        const Shared& sh, int r) {
    Tiles& tl = *sh.t;
    const int i = ln.i;
    int k = tile_at(r, kOffSize, ch.steps);
    if (k >= 0)
      head_folds(sh.ring, ch.ring_mask, i, ch.lead, k, &tl.head(k, 0, i));
    k = tile_at(r, kOffErr, ch.steps);
    if (k < 0) return;
    const int n = tile_len(k, ch.steps);
    float sm_err[kTile];
    unsigned flags[kTile];
    for_steps(n, [&](int u) {
      sm_err[u] = tl.sm_err(k, u, i);
      flags[u] = tl.flags(k, u, i);
    });
    for_steps(n, [&](int u) {
      const bool upd = flags[u] & kUpd;
      err = upd ? err + ch.c.err_gain * (sm_err[u] - err) : err;
      evals = upd ? evals + 1.0f : evals;
      tl.trusted(k, u, i) = evals >= min_trust && err <= demote;
    });
  }

  __device__ __forceinline__ void finish(const Chunk&, const Lane&) {}
};

// Stage 2, the control walk: the health gate, the stabilized desired
// count, wrong-direction events, the pipeline and chip-seconds.
template <bool kLong>
__device__ __forceinline__ void stage2_tile(
    const Chunk& ch, const Lane& ln, const Shared& sh, int k, Folds& folds,
    float& since_up, float& desired, float& last_lam, float& wd,
    float& ready, float& chip_s) {
  Tiles& tl = *sh.t;
  const Consts& c = ch.c;
  const int i = ln.i;
  const int n = tile_len(k, ch.steps);
  const int ts = k * kTile;
  const int lead = ch.lead;
  float raw[kTile], lam[kTile], matured[kTile];
  unsigned flags[kTile];
  for_steps(n, [&](int u) {
    raw[u] = tl.desired_raw(k, u, i);
    lam[u] = tl.lam(k, u, i);
    flags[u] = tl.flags(k, u, i);
    // With L >= kTile every matured lane is from an earlier tile.
    if (kLong)
      matured[u] = sh.ring[((ts + u - lead) & ch.ring_mask) * kLanes + i];
  });
  folds.begin<kLong>(&tl.head(k, 0, i), lead);
  for_steps(n, [&](int u) {
    const int t = ts + u;
    // The pipeline's head matures into ready replicas.
    ready = ready +
            (kLong ? matured[u]
                   : sh.ring[((t - lead) & ch.ring_mask) * kLanes + i]);
    tl.ready(k, u, i) = ready;
    // Health gating + down-stabilization.
    const bool act = flags[u] & kAct;
    const bool frozen = flags[u] & kFrozen;
    const bool can_down = since_up >= c.stab_steps && (flags[u] & kDownOk);
    const bool up = raw[u] > desired;
    float desired_new = up ? raw[u] : (can_down ? raw[u] : desired);
    desired_new = frozen ? desired : desired_new;
    desired_new = act ? desired_new : desired;
    const bool wd_event =
        act && desired_new < desired && lam[u] > last_lam + c.eps;
    wd = wd + (wd_event ? 1.0f : 0.0f);
    last_lam = act ? 0.0f + lam[u] : last_lam;
    since_up = act && desired_new > desired ? 0.0f : since_up + 1.0f;
    desired = desired_new;
    // Actuation: downs immediate, ups through the pipeline's tail.
    const float pending = folds.pending(u);
    const float excess = max_nan(ready - desired, 0.0f);
    ready = ready - excess;
    const float short_by = max_nan(desired - (ready + pending), 0.0f);
    const float s = 0.0f + short_by;
    sh.ring[(t & ch.ring_mask) * kLanes + i] = s;
    folds.push<kLong>(u, s, lead);
    chip_s = chip_s + desired * c.chips_per_replica * c.dt;
  });
}

struct Stage2 {
  Folds folds;
  float since_up, desired, last_lam, wd, ready, chip_s;

  __device__ __forceinline__ void init(const Chunk& ch, const Lane&) {
    const Consts& c = ch.c;
#pragma unroll
    for (int u = 0; u < kTile; ++u) folds.prev[u] = 0.0f;
    last_lam = wd = chip_s = 0.0f;
    ready = 0.0f + c.init_replicas;
    desired = 0.0f + c.init_replicas;
    since_up = 0.0f + c.stab_steps;
  }

  __device__ __forceinline__ void round(const Chunk& ch, const Lane& ln,
                                        const Shared& sh, int r) {
    const int k = tile_at(r, kOffStage2, ch.steps);
    if (k < 0) return;
#ifdef WORLD_SCAN_GENERAL_FOLDS
    // A build that takes the general path at every lead, which chip_smoke.py
    // times against the long-lead path.
    constexpr bool kLongPath = false;
#else
    constexpr bool kLongPath = true;
#endif
    if (kLongPath && ch.lead >= 2 * kTile)
      stage2_tile<true>(ch, ln, sh, k, folds, since_up, desired, last_lam,
                        wd, ready, chip_s);
    else
      stage2_tile<false>(ch, ln, sh, k, folds, since_up, desired, last_lam,
                         wd, ready, chip_s);
  }

  __device__ __forceinline__ void finish(const Chunk& ch, const Lane& ln) {
    if (!ln.valid) return;
    ch.out[ch.lanes + ln.g] = chip_s;
    ch.out[2 * static_cast<size_t>(ch.lanes) + ln.g] = wd;
  }
};

// Serving's serial walks: the queue, at full-batch throughput on stage 2's
// ready replicas, and, two rounds behind it, the sums of attained and of
// all arrivals.
struct Serving {
  float q, attained, total;

  __device__ __forceinline__ void init(const Chunk&, const Lane&) {
    q = attained = total = 0.0f;
  }

  __device__ __forceinline__ void round(const Chunk& ch, const Lane& ln,
                                        const Shared& sh, int r) {
    Tiles& tl = *sh.t;
    const Consts& c = ch.c;
    const int i = ln.i;
    int k = tile_at(r, kOffQueue, ch.steps);
    if (k >= 0) {
      float ready[kTile], a[kTile];
      const int n = tile_len(k, ch.steps);
      for_steps(n, [&](int u) {
        ready[u] = tl.ready(k, u, i);
        a[u] = tl.a(k, u, i);
      });
      for_steps(n, [&](int u) {
        const float cap_rps = ready[u] * c.rate_full;
        const float backlog = q + a[u];
        const float served = min_nan(backlog, cap_rps * c.dt);
        float q_next = backlog - served;
        const float drop = max_nan(q_next - c.queue_bound * ready[u], 0.0f);
        q_next = q_next - drop;
        tl.q(k, u, i) = q;
        tl.drop(k, u, i) = drop;
        q = q_next;
      });
    }
    k = tile_at(r, kOffSum, ch.steps);
    if (k >= 0) {
      float gain[kTile], a[kTile];
      const int n = tile_len(k, ch.steps);
      for_steps(n, [&](int u) {
        gain[u] = tl.gain(k, u, i);
        a[u] = tl.a(k, u, i);
      });
      for_steps(n, [&](int u) {
        attained = attained + gain[u];
        total = total + a[u];
      });
    }
  }

  __device__ __forceinline__ void finish(const Chunk& ch, const Lane& ln) {
    if (!ln.valid) return;
    ch.out[ln.g] = attained / max_nan(total, 1.0f);
    ch.out[3 * static_cast<size_t>(ch.lanes) + ln.g] = total;
  }
};

// The pool: one step of a tile a thread, for the work of a step that reads
// no carry of its own. Group 0 takes the smoothed error and the raw desired
// count, group 1 the measured rate and serving's TTFT and attained
// arrivals. Warp w of a group takes step w of each tile.
struct Pool {
  int w, group;
  float r_target_floor, burst, headroom;

  __device__ __forceinline__ void init(const Chunk& ch, const Lane& ln) {
    const Consts& c = ch.c;
    const float* k = ln.k;
    const float occ_target =
        clip(k[kTargetUtilization] * c.max_batch, 1.0f, c.max_batch);
    const float it_target = iteration_ms(c, occ_target);
    const float r_target =
        occ_target * c.ms /
        ((it_target + c.prefill_extra) + it_target * c.out_tokens);
    r_target_floor = max_nan(r_target, c.eps);
    burst = k[kBurstSlope] * c.startup;
    headroom = k[kHeadroom];
  }

  // Tile k of the role at ``offset`` if this round has one with a step w.
  __device__ __forceinline__ int tile(const Chunk& ch, int r,
                                      int offset) const {
    const int k = tile_at(r, offset, ch.steps);
    return k >= 0 && w < tile_len(k, ch.steps) ? k : -1;
  }

  __device__ __forceinline__ void round(const Chunk& ch, const Lane& ln,
                                        const Shared& sh, int r) {
    if (group == 0)
      size(ch, sh, ln.i, r);
    else
      serve(ch, sh, ln.i, r);
  }

  __device__ __forceinline__ void size(const Chunk& ch, const Shared& sh,
                                       int i, int r) {
    Tiles& tl = *sh.t;
    const Consts& c = ch.c;
    const int u = w;
    int k = tile(ch, r, kOffSmErr);
    if (k >= 0) {
      const float pred = tl.pred(k, u, i);
      const float obs = tl.obs(k, u, i);
      tl.sm_err(k, u, i) =
          fabsf(pred - obs) /
          max_nan((fabsf(pred) + fabsf(obs)) / c.two, c.eps);
    }
    k = tile(ch, r, kOffSize);
    if (k >= 0) {
      // Sizing: cover max(observed + burst insurance, trusted forecast)
      // at the target-occupancy service rate, plus headroom.
      const float reactive = tl.obs(k, u, i) + burst;
      const float target_rate = max_nan(
          reactive, tl.trusted(k, u, i) ? tl.forecast(k, u, i) : 0.0f);
      tl.desired_raw(k, u, i) =
          clip(ceilf(target_rate / r_target_floor) + headroom, 1.0f,
               c.max_replicas);
    }
  }

  __device__ __forceinline__ void serve(const Chunk& ch, const Shared& sh,
                                        int i, int r) {
    Tiles& tl = *sh.t;
    const Consts& c = ch.c;
    const int u = w;
    int k = tile(ch, r, kOffMeasure);
    if (k >= 0) tl.measured(k, u, i) = tl.a(k, u, i) / c.dt;
    k = tile(ch, r, kOffServe);
    if (k >= 0) {
      // Serving at full-batch throughput; queue-wait + prefill TTFT.
      const float ready = tl.ready(k, u, i);
      const float q = tl.q(k, u, i);
      const float a = tl.a(k, u, i);
      const float cap_rps = ready * c.rate_full;
      const float wait_s = q / max_nan(cap_rps, c.eps);
      const float occ = clip(
          (q + a) / max_nan(cap_rps * c.dt, c.eps) * c.max_batch, 1.0f,
          c.max_batch);
      const float ttft =
          wait_s + (iteration_ms(c, occ) + c.prefill_extra) / c.ms;
      const float ok = ttft <= c.slo_ttft ? 1.0f : 0.0f;
      tl.gain(k, u, i) = max_nan(a * ok - tl.drop(k, u, i), 0.0f);
    }
  }

  __device__ __forceinline__ void finish(const Chunk&, const Lane&) {}
};

// One role's thread: its state through every round, a barrier after each
// (a probe build may leave out a role's work, never its barriers).
template <typename Role, typename Barrier>
__device__ __forceinline__ void run_role(Role& role, const Chunk& ch,
                                         const Lane& ln, const Shared& sh,
                                         Barrier barrier, bool works) {
  role.init(ch, ln);
  const int rounds = round_count(ch.steps);
  for (int r = 0; r < rounds; ++r) {
    if (works) role.round(ch, ln, sh, r);
    barrier();
  }
  role.finish(ch, ln);
}

// Calls fn(role) with a new role for warp ``warp`` of a block: the walks'
// warps in enum Warp order, then the pool's, group by group.
template <typename Fn>
__device__ __forceinline__ void with_role(int warp, Fn fn) {
  switch (warp) {
    case kLoadWarp: {
      Loader role;
      fn(role);
      break;
    }
    case kStage1Warp: {
      Stage1 role;
      fn(role);
      break;
    }
    case kErrWarp: {
      ErrWalk role;
      fn(role);
      break;
    }
    case kStage2Warp: {
      Stage2 role;
      fn(role);
      break;
    }
    case kServeWarp: {
      Serving role;
      fn(role);
      break;
    }
    default: {
      Pool role;
      role.w = (warp - kPoolWarp) % kTile;
      role.group = (warp - kPoolWarp) / kTile;
      fn(role);
    }
  }
}

// The ring of s: R slots, the least power of two >= L.
int ring_slots(int lead) {
  int slots = 1;
  while (slots < lead) slots *= 2;
  return slots;
}

// A block's dynamic shared memory: the tiles, then the ring of s.
size_t shared_bytes_at(int lead) {
  return sizeof(Tiles) + sizeof(float) * ring_slots(lead) * kLanes;
}

// ---- the kernel: device code only from here on

// A block: 32 lanes, a warp a role.
__global__ void __launch_bounds__(kThreads) world_scan_kernel(Chunk ch) {
  extern __shared__ float smem[];
  const Shared sh{reinterpret_cast<Tiles*>(smem),
                  smem + sizeof(Tiles) / sizeof(float)};
  const int warp = threadIdx.x / 32;
  // bar.sync 1 over every thread of the block: each thread runs the same
  // number of rounds and none returns before the last.
#ifdef WORLD_SCAN_PROBE
  // A probe build (chip_smoke.py): block 0's thread 0 marks clock64() as
  // it leaves barrier n, at probe[n]; barrier 0 follows the ring's zeroing,
  // barrier r + 1 ends round r. WORLD_SCAN_PROBE >= 0 names the one role
  // (enum Warp; kPoolWarp for the whole pool) whose rounds do their work;
  // the others only meet the barriers, and the tiles start as 1.0, so the
  // role reads ordinary operands.
  constexpr int kAlone = WORLD_SCAN_PROBE;
  int n = 0;
  const auto barrier = [&] {
    asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
    if (blockIdx.x == 0 && threadIdx.x == 0) ch.probe[n] = clock64();
    ++n;
  };
#else
  constexpr int kAlone = -1;
  const auto barrier = [] {
    asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
  };
#endif
  if (kAlone >= 0)
    for (int i = threadIdx.x; i < int(sizeof(Tiles) / sizeof(float));
         i += kThreads)
      smem[i] = 1.0f;
  for (int i = threadIdx.x; i < (ch.ring_mask + 1) * kLanes; i += kThreads)
    sh.ring[i] = 0.0f;
  barrier();
  const bool works =
      kAlone < 0 || kAlone == (warp < kPoolWarp ? warp : kPoolWarp);
  const Lane ln = lane_of(ch, blockIdx.x, threadIdx.x % 32);
  with_role(warp, [&](auto& role) {
    run_role(role, ch, ln, sh, barrier, works);
  });
}

#ifdef WORLD_SCAN_PROBE
long long* probe_marks = nullptr;
#endif

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
  Chunk ch;
  ch.knob_rows = knob_rows;
  ch.lam_t = lam_t;
  ch.arrivals = arrivals;
  ch.faults = faults;
  ch.out = out;
  ch.m = m;
  ch.lanes = lanes;
  ch.steps = steps;
  ch.lead = lead;
  ch.ring_mask = ring_slots(lead) - 1;
  float* dst = reinterpret_cast<float*>(&ch.c);
  for (int i = 0; i < kConsts; ++i) dst[i] = consts[i];
  ch.probe = nullptr;
#ifdef WORLD_SCAN_PROBE
  ch.probe = probe_marks;
#endif
  const size_t smem = shared_bytes_at(lead);
  const cudaError_t err = cudaFuncSetAttribute(
      world_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (lanes + kLanes - 1) / kLanes;
  world_scan_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(ch);
  return static_cast<int>(cudaGetLastError());
}

// A block's threads and dynamic shared memory at a pipeline of ``lead``
// lanes (1..kMaxLead).
void world_scan_block(int lead, int* threads, int* shared_bytes) {
  *threads = kThreads;
  *shared_bytes = static_cast<int>(shared_bytes_at(lead));
}

#ifdef WORLD_SCAN_PROBE
// A probe build's marks: device memory for a mark a barrier (rounds + 1)
// that the next launches fill.
void world_scan_set_probe(long long* marks) { probe_marks = marks; }
#endif

const char* world_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
