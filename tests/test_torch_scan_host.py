"""The sweep's horizon-scan kernel's schedule, run as host C++ on the CPU.

``wva_tpu_torch/sweep/csrc/world_scan.cu`` keeps everything a thread does
(its role's state, its work in a round) in functions that compile as host
C++ as well: the text between ``namespace {`` and ``// ---- the kernel``,
with ``__device__`` and ``__forceinline__`` defined away. This file
compiles that text with ``g++ -O2 -ffp-contract=off`` into a temporary
directory, drives it the way the kernel's block does (every role's thread,
round by round, the rounds' barriers as the boundaries between them, each
thread the role the kernel's own ``with_role`` gives its warp), and holds
every output bit for bit, NaN where NaN, against ``run_chunk_plain`` on CPU
tensors. Within a round it runs the threads once in the block's order and
once in reverse: a role that read what another writes in the same round
would give different bits one way. A second
harness function holds the running partial folds of the pipeline against
the plain version's shift-and-fold on non-integer, infinite, NaN and -0.0
entries. Needs ``g++``, no card:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_scan_host.py -q
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from wva_tpu_torch.emulator import loadgen
from wva_tpu_torch.sweep import knobs as kb
from wva_tpu_torch.sweep import world

SOURCE = (Path(__file__).resolve().parents[1] / "wva_tpu_torch" / "sweep"
          / "csrc" / "world_scan.cu")
TILE = int(re.search(r"kTile = (\d+);", SOURCE.read_text()).group(1))
NON_FINITE = (kb.PolicyKnobs(target_utilization=float("nan")),
              kb.PolicyKnobs(level_gain=float("nan"),
                             grid_step_s=float("nan")),
              kb.PolicyKnobs(engine_interval_s=float("inf")),
              kb.PolicyKnobs(burst_slope_rps=float("inf"),
                             grid_step_s=float("-inf")))

HARNESS = r"""
#include <math.h>
#include <cmath>
#include <cstddef>
#include <functional>
#include <limits>
#include <memory>
#include <type_traits>
#include <vector>
#define __device__
#define __forceinline__ inline

namespace {
@BODY@

// A thread of the block: its role's work in a round, and its finish.
struct Thread {
  std::function<void(int)> round;
  std::function<void()> finish;
};

// Every thread of one block, round by round; within a round the threads in
// the block's order (reverse = 0) or in reverse.
void run_block(const Chunk& ch, int block, bool reverse) {
  const float nan = std::numeric_limits<float>::quiet_NaN();
  std::vector<float> smem(shared_bytes_at(ch.lead) / sizeof(float), nan);
  const Shared sh{reinterpret_cast<Tiles*>(smem.data()),
                  smem.data() + sizeof(Tiles) / sizeof(float)};
  for (int i = 0; i < (ch.ring_mask + 1) * kLanes; ++i) sh.ring[i] = 0.0f;
  std::vector<Thread> threads;
  for (int x = 0; x < kThreads; ++x) {
    const Lane ln = lane_of(ch, block, x % 32);
    with_role(x / 32, [&](auto& placed) {
      auto role = std::make_shared<std::decay_t<decltype(placed)>>(placed);
      role->init(ch, ln);
      threads.push_back({[role, &ch, &sh, ln](int r) {
                           role->round(ch, ln, sh, r);
                         },
                         [role, &ch, ln] { role->finish(ch, ln); }});
    });
  }
  for (int r = 0; r < round_count(ch.steps); ++r)
    for (int x = 0; x < kThreads; ++x)
      threads[reverse ? kThreads - 1 - x : x].round(r);
  for (Thread& t : threads) t.finish();
}
}  // namespace

extern "C" {

int scan_consts() { return kConsts; }

void host_scan(const float* knob_rows, const float* lam_t,
               const float* arrivals, const float* faults, float* out, int w,
               int m, int steps, int lead, const float* consts, int reverse) {
  Chunk ch;
  ch.knob_rows = knob_rows;
  ch.lam_t = lam_t;
  ch.arrivals = arrivals;
  ch.faults = faults;
  ch.out = out;
  ch.m = m;
  ch.lanes = w * m;
  ch.steps = steps;
  ch.lead = lead;
  ch.ring_mask = ring_slots(lead) - 1;
  float* dst = reinterpret_cast<float*>(&ch.c);
  for (int i = 0; i < kConsts; ++i) dst[i] = consts[i];
  for (int b = 0; b * kLanes < ch.lanes; ++b)
    run_block(ch, b, reverse);
}

// One lane's pipeline folds over the steps' new tails s[0..steps): each
// step's fold before the zeroed tail, its pending sum and its matured lane,
// as stage 2 reads them, with each tile's heads taken while the tile before
// it runs.
void host_folds(const float* s, int steps, int lead, float* fold,
                float* pending, float* matured) {
  const int mask = ring_slots(lead) - 1;
  std::vector<float> ring((mask + 1) * kLanes, 0.0f);
  std::vector<float> head(2 * kTile * kLanes,
                          std::numeric_limits<float>::quiet_NaN());
  Folds folds;
  for (int u = 0; u < kTile; ++u) folds.prev[u] = 0.0f;
  const bool full = lead >= 2 * kTile;
  for (int k = 0; k < tile_count(steps); ++k) {
    // tile k's heads read tiles <= k - 2
    head_folds(ring.data(), mask, 0, lead, k, &head[(k % 2) * kTile * kLanes]);
    const float* h = &head[(k % 2) * kTile * kLanes];
    if (full) folds.begin<true>(h, lead); else folds.begin<false>(h, lead);
    for (int u = 0; u < tile_len(k, steps); ++u) {
      const int t = k * kTile + u;
      matured[t] = ring[((t - lead) & mask) * kLanes];
      fold[t] = folds.part[u];
      pending[t] = folds.pending(u);
      ring[(t & mask) * kLanes] = s[t];
      if (full) folds.push<true>(u, s[t], lead);
      else folds.push<false>(u, s[t], lead);
    }
  }
}

}  // extern "C"
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The stages compiled as host C++ and loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's stages as host C++")
    text = SOURCE.read_text()
    body = text[text.index("namespace {") + len("namespace {"):
                text.index("// ---- the kernel")]
    tmp = tmp_path_factory.mktemp("scan_host")
    src, lib = tmp / "scan_host.cc", tmp / "scan_host.so"
    src.write_text(HARNESS.replace("@BODY@", body))
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    ptr = ctypes.c_void_p
    so.host_scan.argtypes = [ptr] * 5 + [ctypes.c_int] * 4 + [
        ptr, ctypes.c_int]
    so.host_scan.restype = None
    so.host_folds.argtypes = [ptr, ctypes.c_int, ctypes.c_int, ptr, ptr,
                              ptr]
    so.host_folds.restype = None
    return so


def as_ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def assert_bits(got, want):
    """Equal values and signs of zero, NaN where the other is NaN."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), np.argwhere(
        np.isnan(got) != nan)[:8]
    differ = (got.view(np.int32) != want.view(np.int32)) & ~nan
    assert not differ.any(), (int(differ.sum()), np.argwhere(differ)[:8],
                              got[differ][:4], want[differ][:4])


def chunk(params, knobs, n_models, seed):
    """A chunk's CPU tensors: ``n_models`` trapezoids of different heights,
    the knob points given, seeded arrival and fault tables."""
    profiles = [loadgen.trapezoid(4.0 + 3.0 * i, 40.0 - 6.0 * i, 300.0,
                                  420.0, 180.0, tail=120.0, delay=180.0)
                for i in range(n_models)]
    lam = world.rate_table(profiles, params)
    seeds = [1000 * seed + i for i in range(len(knobs))]
    rows = np.asarray([kb.to_vector(k) for k in knobs], dtype=np.float32)
    return world.chunk_tensors(rows, lam, world.arrivals_table(
        seeds, lam, params), world.fault_table(seeds, n_models, params),
        "cpu")


def default_knobs(n, seed=0, non_finite=False):
    points = kb.grid_points("default")
    knobs = [points[(seed + i) % len(points)] for i in range(n)]
    if non_finite:
        knobs[:len(NON_FINITE)] = NON_FINITE[:n]
    return knobs


def host_and_plain(so, params, inputs, init=1.0):
    """The host schedule's ``[4, W, M]`` outputs (the threads of a round in
    order and in reverse) and the plain version's, on the same CPU
    tensors."""
    rows, lam_t, arr, flt = (t.numpy() for t in inputs)
    w, m = rows.shape[0], lam_t.shape[1]
    consts = np.asarray(list(world.scan_constants(params, init).values()),
                        dtype=np.float32)
    assert so.scan_consts() == consts.size
    outs = []
    for reverse in (0, 1):
        out = np.full((4, w, m), np.nan, dtype=np.float32)
        so.host_scan(as_ptr(rows), as_ptr(lam_t), as_ptr(arr), as_ptr(flt),
                     as_ptr(out), w, m, params.steps, params.lead_steps,
                     as_ptr(consts), reverse)
        outs.append(out)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = torch.stack(world.run_chunk_plain(params, *inputs, init))
    finally:
        torch.set_num_threads(threads)
    return outs, want.numpy()


def check(so, params, knobs, n_models, seed=0, init=1.0):
    inputs = chunk(params, knobs, n_models, seed)
    outs, want = host_and_plain(so, params, inputs, init)
    for got in outs:
        assert_bits(got, want)
    return want


def test_the_smoke_grids_chunk(host):
    params = world.WorldParams(horizon_s=1200.0)
    want = check(host, params, kb.grid_points("smoke"), 1, seed=1)
    assert np.isfinite(want).all()


@pytest.mark.parametrize("n_models", [1, 3])
def test_non_finite_knob_rows(host, n_models):
    params = world.WorldParams(horizon_s=1200.0)
    want = check(host, params, default_knobs(40, 11, non_finite=True),
                 n_models, seed=11)
    assert np.isnan(want[:, :2]).any(), "no NaN world in the chunk"


@pytest.mark.parametrize("lead", [1, 24, 60, 128])
def test_every_lead(host, lead):
    params = world.WorldParams(horizon_s=1200.0, startup_s=5.0 * lead)
    assert params.lead_steps == lead
    check(host, params, default_knobs(40, 3), 1, seed=3)


@pytest.mark.parametrize("n_models", [1, 3])
@pytest.mark.parametrize("fault_gap_s", [0.0, 600.0],
                         ids=["faults-off", "faults-on"])
def test_faults_and_models(host, fault_gap_s, n_models):
    params = world.WorldParams(horizon_s=1200.0,
                               fault_mean_gap_s=fault_gap_s)
    check(host, params, default_knobs(24, 5), n_models, seed=5, init=4.0)


@pytest.mark.parametrize("n_models", [1, 3])
@pytest.mark.parametrize("steps", [1, TILE - 1, TILE, TILE + 1, 240])
def test_ragged_tiles(host, steps, n_models):
    params = world.WorldParams(horizon_s=5.0 * steps, startup_s=60.0)
    assert params.steps == steps
    check(host, params, default_knobs(20, steps), n_models, seed=steps)


@pytest.mark.parametrize("worlds,n_models", [(37, 1), (13, 3), (1, 1)])
def test_ragged_lane_groups(host, worlds, n_models):
    """W x M not a multiple of a block's 32 lanes: the last block's spare
    threads run on a copy of the chunk's last lane and write nothing."""
    params = world.WorldParams(horizon_s=600.0)
    check(host, params, default_knobs(worlds, 7), n_models, seed=7)


def fold_entries(kind, steps, seed):
    """``steps`` new tails: ``mixed`` (uniform values with a third replaced
    by infinities, NaN, signed zeros and huge values) or ``-0.0`` alone."""
    if kind == "-0.0":
        return np.full(steps, -0.0, dtype=np.float32)
    rng = np.random.default_rng(seed)
    s = rng.uniform(-3.0, 3.0, steps).astype(np.float32)
    special = np.asarray([np.inf, -np.inf, np.nan, -0.0, 0.0, 1e30, -1e30],
                         dtype=np.float32)
    at = rng.choice(steps, steps // 3, replace=False)
    s[at] = special[rng.integers(0, special.size, at.size)]
    return s


@pytest.mark.parametrize("kind", ["mixed", "-0.0"])
@pytest.mark.parametrize("lead", [1, 2, 7, 8, 9, 15, 16, 17, 24, 60, 128])
def test_running_folds_are_the_left_fold(host, lead, kind):
    """The running partial folds, the pending sums and the matured lanes,
    against the plain version's pipeline (shift, zero the tail, left fold,
    take the new tail) on entries that are not integers, infinite, NaN or
    -0.0. A fold before the zeroed tail is the left fold of the pipeline's
    other L - 1 lanes (an empty one, L = 1, is -0.0): its sign of zero shows
    where every entry is -0.0, which the pending sum's + 0 would hide."""
    steps = 3 * 128 + 5
    s = fold_entries(kind, steps, lead)
    fold, pending, matured = (np.empty(steps, np.float32) for _ in range(3))
    host.host_folds(as_ptr(s), steps, lead, as_ptr(fold), as_ptr(pending),
                    as_ptr(matured))

    pipe = np.zeros(lead, np.float32)
    want = {name: np.empty(steps, np.float32)
            for name in ("fold", "pending", "matured")}
    with np.errstate(invalid="ignore", over="ignore"):
        for t in range(steps):
            want["matured"][t] = pipe[0]
            pipe = np.concatenate([pipe[1:], np.zeros(1, np.float32)])
            acc = np.float32(-0.0) if lead == 1 else pipe[0]
            for x in pipe[1:-1]:
                acc = np.float32(acc + x)
            want["fold"][t] = acc
            want["pending"][t] = np.float32(acc + pipe[-1]) if lead > 1 \
                else pipe[0]
            pipe[-1] = s[t]
    assert_bits(matured, want["matured"])
    assert_bits(fold, want["fold"])
    assert_bits(pending, want["pending"])
