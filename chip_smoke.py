#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``wva_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Build the five kernel libraries, one ``nvcc`` each, started together:
   the sizing bisection from ``wva_tpu_torch/analyzers/queueing/csrc/
   sizing_bisection.cu``, the forecaster fits from ``wva_tpu_torch/
   forecast/csrc/fit_grid.cu``, the sweep's horizon scan from
   ``wva_tpu_torch/sweep/csrc/world_scan.cu``, the chain statistics (the
   EKF tuner's h and jacobian, and the sizing path's and
   the fleet solve's statistics) from ``wva_tpu_torch/analyzers/queueing/
   csrc/chain_stats.cu`` and the chain setup from ``chain_setup.cu``. Print
   the build time, each sizing instantiation's registers, spills and shared
   memory (it fails on a spill), the SASS instructions per 32-state chunk,
   the fit, scan and chain kernels' registers, spills and local memory a
   thread, the scan kernel's threads and shared memory a block, the scan
   and chain kernels' SASS instructions, and the card's name and power
   limit.
2. Hold the kernel against its plain PyTorch version on the card: seeded
   populations at C in {1, 77, 1024, 8192} and k_cols in {256, 512, 1024,
   2048} (every NV instantiation) at rtol 2e-3, disabled targets at 1e-5
   through ``size_batch``, and bitwise checks: a row is unchanged by batch
   padding, by row order, by a wider k_cols (256 -> 1024, 512 -> 2048, and
   256 -> 2048 for rows of small k), by computing the states past k, by
   the rows per block, and by the order in which warps take rows. Time,
   with CUDA events, the wrapper as the sizing path calls it, the launch
   alone at 4 and 8 rows per block, the row order, and the plain version,
   at C=1024 and C=8192 with k_cols=2048, beside the bound the card
   allows for the same work. Time the row order's rule at half a wave to
   four waves, at k_cols 512 and 2048.
3. Drive the fleet tick through the Manager at full width: bench.py's
   ``_build_tick_world`` (``make bench-tick``) restated for the port at
   1000 models x 2 variants (v5e-8, v5p-8), each a Deployment, a Pod and
   a VariantAutoscaling on a FakeCluster, telemetry in a TimeSeriesDB
   (each pod's request counter at its model's demand, the KV and queue
   gauges, the token histograms at its prompt and output lengths), the SLO
   classes and profiles through ``update_slo_config``, a quarter of the
   models routed to the fleet solve by namespace, forecasting on with the
   planner's history pre-filled, incremental ticks off; 3 warm ticks, then
   12 measured ticks 5 s apart through the engine's executor. Four ways:
   fused with the solve memo (the main path, run alone, both kernels'
   counts set to 0 just before its measured ticks and read just after),
   ``WVA_SOLVE_MEMO`` off, ``WVA_FUSED`` off, and the fused tick with the
   kernels forced to their plain versions (these three in parallel
   processes). The decisions (desired and target replicas, action,
   accelerator, ``set_by``) must be equal across the four in every tick; a
   solve tick launches the chain setup, the sizing kernel, the chain
   statistics and the fit kernel once each, a memo-hit tick the fit kernel
   alone, and the plain way none. ``analyze_batch`` must make one chain-
   statistics launch a call (none in the plain way), and the staged way's
   fleet solve must call it. The fleet solve with and without the fused
   sizing (``presized``) must give equal replicas and accelerators. Print each way's tick mean,
   p50 and p99, the main path's split by the span recorder, its gc time
   (``gc.callbacks``), one tick's device-to-host copies and device busy
   share (``torch.profiler``). Then time the sizing kernel on the first
   tick's candidates (C=2048, k_cols=512); the wrapper's time there is its
   ``ms``.
3b. Hold the chain setup and the chain statistics (the sizing path's tail,
   ``analyze_batch``, and the tuner's h and H) against their plain versions
   on the card, at C in {1, 7, 64,
   2048} and k_cols in {256, 512, 1024, 2048} with edge rows (k = 1, k =
   k_cols, no prompt, disabled targets, rates outside the bounds): rtol
   2e-3, the prefix sums at 2e-3 of the sum of their terms' magnitudes.
   ``size_batch`` must make 3 launches (setup, sizing, statistics) and
   ``analyze_batch`` 1, and a row's bits must be the same alone, in
   reversed order and at a wider k_cols. Time each (the wrapper by CUDA
   events, the device by torch.profiler, the plain version, its ops) at the
   fleet tick's first sizing call and at the inputs the fleet solve passes
   ``analyze_batch`` when it sizes that tick's pairs itself, beside the
   bound.
4. Hold the forecaster-fit kernel (``wva_tpu_torch/forecast/csrc/
   fit_grid.cu``) against its plain version on the card at M in {1, 7,
   1024, 4096} rows, with valid counts 0-160, seasons 1-160 and the
   horizons of tests/test_fused_plane.py: rtol 2e-3 with an absolute floor
   of 1e-4 x (1 + the row's largest forecast); seasonal_naive and every
   persistence fallback bitwise; a row bitwise unchanged by padding 1 ->
   1024 and by row order. Time, with CUDA events at M=1024, the kernel
   through its wrapper, the launch alone and the plain version (with the
   count of PyTorch ops it dispatches), beside the bound.
5. Run the graft entry points (``wva_tpu_torch/entry.py``) on the card:
   ``entry()``'s forward step against its plain version on the CPU, and
   ``dryrun_multichip(n)`` for n in {1, 2, 4, 8}, logical shards on the one
   card unless the process has n cards (its chunked edge rows bitwise equal
   to an unsharded solve, as ``dryrun_multichip`` itself requires), the
   cheapest row and the rates against the CPU.
6. Hold the EKF jacobian kernel against its plain version (``jacfwd``)
   on CUDA tensors at the tuner's first state and ``JACOBIAN_EDGES`` (the
   rate clipped high and low and unclipped, k = 1, B and 2048, no prompt,
   under one output token): every entry of h and H at rtol 2e-3, and each
   entry of H within 2e-3 of its row's largest. Then drive this slice's main path, the emulated
   control loop, on the headline world: bench.py's
   ``run_policy("ours-realistic")`` (restated below) through the port's
   ``EmulationHarness`` -> ``build_manager`` -> ``SaturationEngine`` with
   the engine on the card: one Llama-3.1-8B variant on v5e-8 slices,
   profiles 2x off and the EKF tuner live, forecasting and the fused
   program on, 5 s engine ticks over 2280 emulated seconds. The sizing,
   fit, jacobian, chain-setup and chain-statistics kernels' counts are set
   to 0 just before it and read just after. It must reach attainment 1.0,
   a peak of 8 slices, 4 at the end and chip-seconds in 121,160-121,800,
   launch the sizing and fit kernels, the chain setup and statistics once
   a sizing launch, take more than 300 tuner steps ending within 10% of
   the true alpha, and launch the jacobian kernel once a tuner step. Then
   split the fused program on the world's last solve tick's grids by part
   (the setup, the sizing launch, the tail, the fits, the transfer): host
   ms, PyTorch ops, the card's kernels and their device ms, before (the
   chain kernels' plain versions) and after (the kernels). Print its wall
   time, the engine tick's host-clock ms (mean, p50, p99) and a per-tick
   breakdown (tuner step, grids, fused program, the rest), the tuner's
   steps, NIS rejections, parameters and step time, and one step's h and
   H: the kernel through the wrapper and its launch alone (CUDA events),
   on the device (profiler), the plain ``jacfwd``'s
   time, PyTorch ops and device busy time, and the bound. Then run its first 600 emulated
   seconds with ``device="cpu"`` (the plain versions): desired and target
   replicas, action and ``set_by`` must be equal in every engine cycle;
   the first tuner step whose accept flag differs, if one does, is
   printed with both NIS.
7. Drive the policy sweep on the card at ``make bench-sweep``'s full
   shape (bench.py's ``sweep_plane_bench``, restated below): the default
   knob grid (48 points) x 32 train seeds, 8 holdout seeds, chunks of 256,
   a 1200 s horizon at 5 s steps over the bench trapezoid 4 -> 40 req/s,
   each chunk one launch of the scan kernel. With the scan kernel's count
   set to 0 just before the search and read just after, it must evaluate
   at least 1024 worlds in at most one noted dispatch a step, launch the
   kernel once a chunk, and recommend trusted knobs after at least 3
   holdout evaluations. A 256-world batch, as bench.py times it, must
   launch the kernel once and run at least 20x faster a world than the
   per-world Python loop on the host clock (bench.py's gate; the median
   of 5 runs, the CUDA-event time printed beside it). The kernel must
   equal ``run_chunk_plain`` on the batch's CUDA tensors bit for bit on
   all four outputs, NaN where NaN; the kernel's wrapper (CUDA events) and
   device (profiler) times are printed beside its bound and the plain
   version's time, with the SM clock sampled by nvidia-smi while it runs,
   the cycles a step that gives, its registers, spills and shared memory,
   and both times at 256, 4096 and 16384 worlds; probe builds of the
   kernel time a round in clock cycles with every role at work and with
   each role alone, and a build that takes stage 2's general path at every
   lead is held to the plain version's bits and timed against the shipped
   one. 24 worlds run at chunk 3 must equal the same worlds
   inside a chunk of 256 bit for bit; the batch on the card must agree
   with the same batch on the CPU, and 8 of its worlds with the scalar
   oracle ``run_world_python``, at rel 5e-3, abs 1e-3. Then the fidelity
   gate (the event-driven harness against the fluid world) must hold at
   its tolerances, with every kernel's count set to 0 just before it and
   read just after, the sizing kernel launched by the event run and the
   scan kernel once by the fluid run. Print, without gating on them: the
   PyTorch ops and CUDA kernels a chunk, the device's busy share of a
   chunk, and the phase's wall time.
8. Run the golden worlds with more than one engine on the card, then on
   the CPU: tests/goldens/make_shard_trace.py's (a 3-shard plane, one shard
   crashed) and make_federation_trace.py's (three regions, one dark),
   restated below. Every cycle's decisions must be equal.
9. Install the port as a user would and run it outside the repository:
   build a wheel from a copy of ``pyproject.toml``, ``README.md`` and both
   packages (``pip wheel --no-deps --no-build-isolation --no-index``),
   install it with ``pip install --target`` into a temporary directory,
   and start a copy of this script there with only that install on
   ``PYTHONPATH`` and a fresh ``XDG_CACHE_HOME``. It builds the five
   libraries and runs every kernel entry on fixed seeded inputs
   (``size_batch`` at C=8, k_cols 512; ``analyze_batch`` at C=512, k_cols
   2048; the fits at M=1 and M=1024; ``run_chunk`` at the bench chunk; one
   tuner step's h and H). Every output must equal the same calls here bit
   for bit; the libraries must be built in that cache under this
   checkout's names and nothing inside the install; neither jax nor
   ``wva_tpu`` may be imported there. The installed ``wva-tpu-torch sweep
   --smoke`` must write the recommendation file the checkout's
   ``__main__.main`` writes.
10. Print one JSON line describing every kernel of the path.
11. Print ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""

import argparse
import collections
import ctypes
import dataclasses
import functools
import gc
import importlib
import importlib.util
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from wva_tpu_torch import cuda_build, fused, resolve_device
from wva_tpu_torch.analyzers.queueing import _build, sizing_kernel
from wva_tpu_torch.analyzers.queueing import tuner as ekf
from wva_tpu_torch.analyzers.queueing import queue_model as qm
from wva_tpu_torch.analyzers.queueing.analyzer import build_sizing_batch
from wva_tpu_torch.analyzers.queueing.params import (
    PerfProfile,
    ServiceParms,
    TargetPerf,
)
from wva_tpu_torch.blackbox.schema import encode as bb_encode
from wva_tpu_torch.config import ForecastConfig, TraceConfig, new_test_config
from wva_tpu_torch.config.slo import ServiceClass, SLOConfigData
from wva_tpu_torch.emulator import (
    EmulationHarness,
    HPAParams,
    ServingParams,
    VariantSpec,
    diurnal,
    trapezoid,
)
from wva_tpu_torch import entry as graft
from wva_tpu_torch.engines import common as engines_common
from wva_tpu_torch.fleet import SolverSpec, build_candidates, solve
from wva_tpu_torch.forecast import fit_kernel
from wva_tpu_torch.forecast.backtest import compare_to_golden, run_backtest
from wva_tpu_torch.forecast import forecasters as fc
from wva_tpu_torch.interfaces import SaturationScalingConfig
from wva_tpu_torch.obs.explain import explain_decision
from wva_tpu_torch.sweep import knobs as sweep_knobs
from wva_tpu_torch.sweep import scan_kernel
from wva_tpu_torch.sweep import search as sweep_search
from wva_tpu_torch.sweep import world as sweep_world
from wva_tpu_torch.sweep.fidelity import fidelity_check
from wva_tpu_torch.utils import dispatch

# Only so that the --only modes that time one part of the path (world-times,
# fused-split, jacobian-times) run in checkouts of the port older than its
# chain kernels (the script copied there, to time the parent in the same
# call); every other mode needs them and stops without them.
def _port_module(name):
    spec = f"wva_tpu_torch.analyzers.queueing.{name}"
    return importlib.import_module(spec) if importlib.util.find_spec(
        spec) else None


jacobian_kernel = _port_module("jacobian_kernel")
chain_setup = _port_module("chain_setup")
chain_stats = _port_module("chain_stats")

RTOL = 2e-3
RTOL_DISABLED = 1e-5
INSTANTIATIONS = {8, 16, 32, 64}  # values per lane (NV), k_cols 256..2048
ROWS_TRIED = (4, 8)  # rows per block timed; the sizing path runs 8

CUDA = torch.device("cuda")
REPO = os.path.dirname(os.path.abspath(__file__))


def log(*args):
    print(*args, flush=True)


def require(ok, what):
    """Fail the run (a bare assert would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# ---------------------------------------------------------------- phase 1


def phase_build():
    libraries = (_build.LIBRARY, fit_kernel.LIBRARY, scan_kernel.LIBRARY,
                 chain_stats.LIBRARY, chain_setup.LIBRARY)
    fresh = [not lib.path().exists() for lib in libraries]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        paths = list(pool.map(lambda lib: lib.build(), libraries))
    seconds = time.perf_counter() - t0
    log(f"[build] {', '.join(p.name for p in paths)}: {seconds:.2f} s"
        + ("" if all(fresh) else " (some already built)"))
    path = paths[0]
    resources = _build.resources(_build.LIBRARY.build_log())
    for r in resources:
        log(f"[build] NV={r['values_per_lane']}: {r['registers']} registers, "
            f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill "
            f"loads, {r['stack']} B stack, {r['smem']} B shared memory")
    require({r["values_per_lane"] for r in resources} == INSTANTIATIONS,
            f"instantiations in the compiler's report: {resources}")
    require(not any(r["spill_stores"] or r["spill_loads"] for r in resources),
            "an instantiation spills registers")
    layout = fit_kernel.smem_layout()
    fit_sass = dict(fit_sass_by_rows(paths[1]))
    for fit in cuda_build.resources(fit_kernel.LIBRARY.build_log()):
        rows = int(re.search(r"fit_grid_kernelILi(\d+)E",
                             fit["entry"]).group(1))
        ops = fit_sass[rows]
        log(f"[build] fit_grid R={rows}: {fit['registers']} registers, "
            f"{fit['spill_stores']} B spill stores, {fit['spill_loads']} B "
            f"spill loads, {fit['stack']} B local memory a thread, "
            f"{layout[f'R={rows} bytes']} B dynamic shared memory a block; "
            f"SASS {sum(ops.values())} instructions, {ops['LDL']} LDL, "
            f"{ops['STL']} STL: "
            + ", ".join(f"{op} {n}" for op, n in ops.most_common(10)))
        require(not (fit["stack"] or fit["spill_stores"] or fit["spill_loads"]
                     or ops["LDL"] or ops["STL"]),
                f"fit_grid R={rows} uses local memory: {fit}")
        resources.append(dict(kernel="fit_grid", rows_per_block=rows, **fit))
    require(set(fit_sass) == set(fit_kernel.ROWS_CHOICES)
            == {r.get("rows_per_block") for r in resources} - {None},
            f"fit_grid instantiations: {sorted(fit_sass)}")
    log(f"[build] fit_grid shared memory: grid rows of "
        f"{layout['grid_row_floats']} floats (fine, long), seasonal rows of "
        f"{layout['seasonal_row_floats']} (a doubled ring); {layout}")
    scan_ops = dict(sass_functions(paths[2]))
    lead = SWEEP_PARAMS.lead_steps
    for scan in cuda_build.resources(scan_kernel.LIBRARY.build_log()):
        ops = next(ops for name, ops in scan_ops.items()
                   if "world_scan_kernel" in name)
        block = scan_kernel.block(lead)
        log(f"[build] world_scan: {scan['registers']} registers, "
            f"{scan['spill_stores']} B spill stores, {scan['spill_loads']} B "
            f"spill loads, {scan['stack']} B local memory a thread; "
            f"{block['threads']} threads and {block['shared_bytes']} B "
            f"dynamic shared memory a block at L={lead}; SASS "
            f"{sum(ops.values())} instructions: "
            + ", ".join(f"{op} {n}" for op, n in ops.most_common(12)))
        resources.append(dict(kernel="world_scan", **scan, **block))
    for lib, built in zip(libraries[3:], paths[3:]):
        sass = dict(sass_functions(built))
        for r in cuda_build.resources(lib.build_log()):
            ops = sass.get(r["entry"], collections.Counter())
            name = next(v for k, v in CHAIN_ENTRIES.items()
                        if k in r["entry"])
            shape = re.search(r"ILi(\d+)E(?:Li(\d+)E)?", r["entry"])
            label = name + ("" if shape is None else
                            "<" + ", ".join(x for x in shape.groups() if x)
                            + ">")
            log(f"[build] {label}: {r['registers']} registers, "
                f"{r['spill_stores']} B spill stores, {r['spill_loads']} B "
                f"spill loads, {r['stack']} B local memory a thread, "
                f"{r['smem']} B shared memory a block; SASS "
                f"{sum(ops.values())} instructions: "
                + ", ".join(f"{op} {n}" for op, n in ops.most_common(12)))
            resources.append(dict(kernel=label, **r))
    per_chunk = sass_per_chunk(path)
    log(f"[build] SASS per chunk of 32 states (NV=64 less NV=32, over 32): "
        f"{sum(per_chunk.values()):.2f} instructions: "
        + ", ".join(f"{op} {n:g}" for op, n in per_chunk.items()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return card, resources


# The chain kernels' entry functions by name: the chain statistics (its
# template parameter S, segments of 256 states), the tuner's h and H (its
# template parameters: blocks a cluster, threads a block), the chain setup.
CHAIN_ENTRIES = {"chain_stats_kernel": "chain_stats",
                 "chain_jacobian_kernel": "chain_jacobian",
                 "chain_setup_kernel": "chain_setup"}


def sass_functions(library):
    """Each kernel function in ``library``'s SASS: its name and its
    instruction count by opcode."""
    sass = subprocess.run(
        [cuda_build.cuda_tool("cuobjdump"), "-sass", str(library)],
        capture_output=True, text=True, check=True, timeout=120).stdout
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        yield fn.split()[0], collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", ins.strip()).split()[0].split(".")[0]
            for ins in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", fn))


def fit_sass_by_rows(library):
    """The fit kernel's instantiations in ``library``'s SASS: (rows per
    block, instruction count by opcode)."""
    for name, ops in sass_functions(library):
        if rows := re.search(r"fit_grid_kernelILi(\d+)E", name):
            yield int(rows.group(1)), ops


def sass_per_chunk(library):
    """Instructions per 32-state chunk in the compiled kernel, by opcode:
    the NV=64 instantiation's code less the NV=32 one's, over the 32 chunks
    it adds. Each chunk's code runs in every iteration, except its load."""
    counts = {}
    for name, ops in sass_functions(library):
        nv = re.search(r"sizing_bisection_kernelILi(\d+)E", name)
        counts[int(nv.group(1))] = ops
    require({32, 64} <= set(counts), f"SASS functions: {sorted(counts)}")
    diff = counts[64] - counts[32]
    return {op: n / 32 for op, n in diff.most_common()}


# ---------------------------------------------------------------- phase 2


def population(n, seed, k_lo, k_hi, bench=False):
    """Seeded candidates and (ttft, itl) targets on the card: the
    tests/test_pallas_kernel.py ranges, or the bench.py solver-microbench
    ranges (fixed 1000 ms / 50 ms targets) with ``bench=True``."""
    rng = np.random.default_rng(seed)
    if bench:
        cand = qm.candidate_batch(
            rng.uniform(3.0, 30.0, n), rng.uniform(0.001, 0.05, n),
            rng.uniform(0.00001, 0.002, n), rng.uniform(128, 2048, n),
            rng.uniform(64, 1024, n), rng.integers(16, 256, n),
            rng.integers(k_lo, k_hi, n), device=CUDA)
        ttft, itl = np.full(n, 1000.0), np.full(n, 50.0)
    else:
        cand = qm.candidate_batch(
            rng.uniform(3.0, 30.0, n), rng.uniform(0.001, 0.05, n),
            rng.uniform(0.00001, 0.002, n), rng.uniform(64, 2048, n),
            rng.uniform(32, 1024, n), rng.integers(8, 128, n),
            rng.integers(k_lo, k_hi, n), device=CUDA)
        ttft, itl = rng.uniform(100, 3000, n), rng.uniform(5, 100, n)
    targets = torch.tensor(np.stack([ttft, itl]), dtype=torch.float32,
                           device=CUDA)
    return cand, targets


def bisection_args(cand, targets, k_cols, clm=None):
    """The arguments ``_size_batch_core`` hands the bisection."""
    lam_min, lam_max = qm.rate_bounds_per_ms(cand)
    if clm is None:
        clm = qm._cum_log_mu(cand, k_cols)
    clm_at_k = torch.gather(clm, 1, (cand.k[:, None] - 1).long())[:, 0]
    return (clm, clm_at_k, cand, targets.contiguous(),
            torch.stack([lam_min, lam_min]), torch.stack([lam_max, lam_max]))


def rows(cand, targets, idx):
    return (qm.CandidateBatch(*(f[idx] for f in cand)),
            targets[:, idx].contiguous())


class Errors:
    def __init__(self):
        self.max_abs = 0.0
        self.max_rel = 0.0

    def check(self, got, want, rtol, what):
        torch.cuda.synchronize()
        require(got.shape == want.shape, (what, got.shape, want.shape))
        require(torch.isfinite(got).all(), f"{what}: non-finite kernel output")
        diff = (got - want).abs()
        self.max_abs = max(self.max_abs, float(diff.max()))
        rel = float((diff / want.abs().clamp(min=1e-30)).max())
        self.max_rel = max(self.max_rel, rel)
        bad = diff > rtol * want.abs()
        require(not bad.any(),
                f"{what}: {int(bad.sum())} values differ beyond rtol {rtol} "
                f"(max rel {rel:.3g})")
        return rel


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_args(args):
    """The kernel's own arguments for ``args``, as the wrapper builds them:
    the output and the launch order made once, so that a timing holds the
    launch alone."""
    clm, _, cand, _, _, _ = args
    out = torch.empty((2, clm.shape[0]), dtype=torch.float32, device=CUDA)
    c, k_cols = clm.shape
    nv = sizing_kernel.launch_shape(c, k_cols).values_per_lane
    wave = sizing_kernel.rows_per_wave(CUDA, nv)
    return (*args, out), dict(
        order=sizing_kernel.launch_order(cand.k, k_cols, wave))


def time_kernel_and_plain(args, err):
    """Check the kernel against the plain version on ``args``, then time
    with CUDA events: the wrapper as the sizing path calls it (``ms``),
    the launch alone at each rows per block, without the
    skip past k, and with rows in place where the wrapper orders them, the
    order alone, and the plain version: plain first and last, the rest in
    turns between."""
    clm, _, cand, _, _, _ = args
    c, k_cols = clm.shape
    want = sizing_kernel.sizing_bisection_plain(*args)
    got = sizing_kernel.sizing_bisection(*args)
    err.check(got, want, RTOL, f"timed C={c} k_cols={k_cols}")
    largs, kw = launch_args(args)
    variants = {f"R={r}": dict(kw, rows_per_block=r) for r in ROWS_TRIED}
    variants["no skip"] = dict(kw, skip_past_k=False)
    if kw["order"] is not None:
        variants["rows in place"] = dict(kw, order=None)
    for name, options in variants.items():
        out = sizing_kernel.launch(*largs, **options).clone()
        require(torch.equal(out, got), f"{name} changed a row's bits")
    calls = {name: (lambda o=o: sizing_kernel.launch(*largs, **o))
             for name, o in variants.items()}
    calls["wrapper"] = lambda: sizing_kernel.sizing_bisection(*args)
    if kw["order"] is not None:
        calls["order"] = lambda: sizing_kernel.rows_by_k(cand.k)
    runs = {name: [] for name in calls}
    p1 = time_ms(lambda: sizing_kernel.sizing_bisection_plain(*args), 3)
    for turn in (list(calls), list(calls)[::-1]):
        for name in turn:
            runs[name].append(time_ms(calls[name], 20))
    p2 = time_ms(lambda: sizing_kernel.sizing_bisection_plain(*args), 3)
    ms = {name: sum(t) / len(t) for name, t in runs.items()}
    work = sizing_kernel.work(cand, k_cols)
    bound_ms, term = work.bound()
    terms = work.bound_terms_ms()
    launch_ms = ms[f"R={sizing_kernel.ROWS_PER_BLOCK}"]
    on_device = device_ms(calls[f"R={sizing_kernel.ROWS_PER_BLOCK}"], 20,
                          "sizing_bisection_kernel")
    log(f"[time] C={c} k_cols={k_cols}: "
        + ", ".join(f"{n} {'/'.join(f'{x:.4f}' for x in t)}"
                    for n, t in runs.items())
        + f" ms; plain {p1:.3f}/{p2:.3f} ms; bound {bound_ms:.4f} ms ({term}; "
        + ", ".join(f"{n} {x:.4f}" for n, x in terms.items())
        + f"); wrapper at {100 * bound_ms / ms['wrapper']:.1f}% and launch at "
        f"{100 * bound_ms / launch_ms:.1f}% of the bound; library: none; "
        + ("device time not measured" if on_device is None else
           f"device time {on_device:.4f} ms a launch (torch.profiler)"))
    return dict(kernel_ms=ms["wrapper"], launch_ms=launch_ms,
                device_ms=on_device,
                plain_ms=(p1 + p2) / 2, ordered=kw["order"] is not None,
                ms_by_variant=ms, bound_ms=bound_ms,
                bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term, bounds_ms=terms, states=work.states,
                exps=work.exps)


def phase_kernel_vs_plain():
    err = Errors()
    seed = 100
    for k_cols, k_lo in ((256, 128), (512, 128), (1024, 256), (2048, 512)):
        for n in (1, 77, 1024, 8192):
            seed += 1
            cand, targets = population(n, seed, k_lo, k_cols)
            args = bisection_args(cand, targets, k_cols)
            got = sizing_kernel.sizing_bisection(*args)
            want = sizing_kernel.sizing_bisection_plain(*args)
            rel = err.check(got, want, RTOL, f"C={n} k_cols={k_cols}")
            log(f"[kernel] C={n:5d} k_cols={k_cols:4d}: max rel err "
                f"{rel:.3g} vs plain")

    # Whole sizing calls, kernel against plain: enabled and disabled targets.
    cand, targets = population(1024, 200, 128, 512)
    zeros = torch.zeros(1024, device=CUDA)
    for what, (ttft, itl, tps), rtol in (
            ("targets", (targets[0], targets[1], zeros), RTOL),
            ("disabled targets", (zeros, zeros - 1.0, zeros), RTOL_DISABLED)):
        got = qm.size_batch(cand, ttft, itl, tps, k_cols=512)
        want = qm.size_batch(cand, ttft, itl, tps, k_cols=512, impl="plain")
        for key in ("max_rate_per_s", "rate_target_ttft_per_s",
                    "rate_target_itl_per_s", "rate_target_tps_per_s"):
            err.check(got[key], want[key], rtol, f"size_batch {what} {key}")
        log(f"[kernel] size_batch with {what}: rates agree at rtol {rtol}")

    # Bitwise: padding (77 rows inside 128), row order, wider k_cols.
    cand, targets = population(128, 300, 128, 512)
    full = sizing_kernel.sizing_bisection(*bisection_args(cand, targets, 512))
    c77, t77 = rows(cand, targets, slice(0, 77))
    part = sizing_kernel.sizing_bisection(*bisection_args(c77, t77, 512))
    require(torch.equal(part, full[:, :77]), "padding changed a row's bits")
    perm = torch.randperm(128, generator=torch.Generator().manual_seed(7))
    cp, tp = rows(cand, targets, perm.to(CUDA))
    permuted = sizing_kernel.sizing_bisection(*bisection_args(cp, tp, 512))
    require(torch.equal(permuted, full[:, perm.to(CUDA)]),
            "row order changed a row's bits")
    for (cand, targets), narrow_cols, wide_cols in (
            ((cand, targets), 512, 2048),
            (population(128, 301, 128, 256), 256, 1024),
            (population(128, 302, 8, 64), 256, 2048)):
        wide_clm = qm._cum_log_mu(cand, wide_cols)
        wide = sizing_kernel.sizing_bisection(
            *bisection_args(cand, targets, wide_cols, clm=wide_clm))
        narrow = sizing_kernel.sizing_bisection(*bisection_args(
            cand, targets, narrow_cols,
            clm=wide_clm[:, :narrow_cols].contiguous()))
        require(torch.equal(wide, narrow),
                f"k_cols {narrow_cols} -> {wide_cols} changed a row's bits")
    # The skip past k: the small-k rows, with every chunk of 2048 computed.
    largs, kw = launch_args(bisection_args(cand, targets, 2048, clm=wide_clm))
    full = sizing_kernel.launch(*largs, **kw, skip_past_k=False)
    require(torch.equal(full, wide), "the skip past k changed a row's bits")
    log("[kernel] bitwise: padding, permutation, k_cols 512->2048, "
        "256->1024 and 256->2048 (k < 64), and the skip past k hold")

    # Timing at the bench.py solver-microbench shapes, and one row past the
    # wave at k_cols=512 (NV=16), where the wrapper starts to order rows.
    timings = {}
    for n in (1024, 8192):
        cand, targets = population(n, 400 + n, 512, 2048, bench=True)
        timings[f"C={n} k_cols=2048"] = time_kernel_and_plain(
            bisection_args(cand, targets, 2048), err)
    timings["order rule"] = order_rule()
    return err, timings


def order_rule():
    """The wrapper orders rows by decreasing k once a batch's chain holds
    more states than one wave of 2048-state rows. Time, around that rule, the launch with rows in place against the sort and the ordered
    launch together (both with the host running ahead, as on the sizing
    path), at k_cols 512, 1024 and 2048 with k from a quarter of k_cols up
    (NV = 16, 32, 64)."""
    found = {}
    for k_cols, k_lo in ((512, 128), (1024, 256), (2048, 512)):
        nv = sizing_kernel.launch_shape(1, k_cols).values_per_lane
        wave = sizing_kernel.rows_per_wave(CUDA, nv)
        for n in (wave // 2, wave + 1, 2 * wave + 1, 4 * wave):
            cand, targets = population(n, 600 + n, k_lo, k_cols, bench=True)
            largs, kw = launch_args(bisection_args(cand, targets, k_cols))
            sorts = n * k_cols > wave * sizing_kernel.K_COLS_MAX
            require((kw["order"] is not None) == sorts,
                    f"C={n}, wave {wave}: the rule was not applied")
            calls = {
                "in place": lambda: sizing_kernel.launch(*largs),
                "sorted": lambda: sizing_kernel.launch(
                    *largs, order=sizing_kernel.rows_by_k(cand.k))}
            runs = {name: [] for name in calls}
            for turn in (list(calls), list(calls)[::-1]):
                for name in turn:
                    runs[name].append(time_ms(calls[name], 20))
            key = f"C={n} k_cols={k_cols}"
            found[key] = {name: sum(t) / len(t) for name, t in runs.items()}
            log(f"[order] {key} ({n / wave:.2f} waves of {wave}): "
                + ", ".join(f"{name} {'/'.join(f'{x:.4f}' for x in t)}"
                            for name, t in runs.items())
                + f" ms; the wrapper {'sorts' if sorts else 'does not'}")
    return found


# ---------------------------------------------------------------- phase 3

# The fleet tick through the Manager: bench.py's _build_tick_world (`make
# bench-tick`) restated in port terms and widened to a fleet. 1000 models x
# (v5e-8, v5p-8), each variant a Deployment, a Pod and a VariantAutoscaling
# on a FakeCluster, its telemetry in a TimeSeriesDB on a FakeClock, the SLO
# analyzer, forecasting on, incremental ticks off (every tick analyzes every
# model, as tick_scale_bench runs it). tests/test_torch_fleet_tick.py builds
# the same world, by this function, in both packages.
N_MODELS = 1000
ACCELERATORS = (("v5e-8", 10.0, 1.0), ("v5p-8", 30.0, 0.5))  # name, cost, speed
FLEET_WARM_TICKS = 3
FLEET_TICKS = 12
TICK_SECONDS = 5.0
T0 = 1_000_000.0
DAY = 86400.0
LEAD_SECONDS = 45.0
SHAPES = ("sine", "ramp", "growth", "step")
# Models live in ns-0..ns-7; the optimizer is chosen by namespace, and two
# namespaces of eight route to the fleet solve: a quarter of the models.
GLOBAL_NAMESPACES = ("ns-1", "ns-6")
# The four ways, by the reference's own levers (cfg.infrastructure); "plain"
# is the fused tick with the analyzer's kernels forced to their plain
# versions.
FLEET_WAYS = {"fused": {}, "memo off": {"solve_memo": False},
              "staged": {"fused": False}, "plain": {}}
# The collector's token means are 5-minute rates: the TSDB holds that much
# history, a scrape every tick, before the first tick.
FEED_HISTORY_SECONDS = 330.0
# The gauges and the request counter are read over 1-minute windows: the
# history holds that much of them.
GAUGE_HISTORY_SECONDS = 60.0
# The counters' values where the history starts. The token histograms
# observe one request a scrape, so their 5-minute means are exact and the
# same from tick to tick while a model's prompt length holds.
COUNTER_BASE = 10_000.0


def forecast_fleet(n_models=N_MODELS, seed=20261020):
    """Profiles and demand of the fleet: per model, base profile parameters
    (the v5p-8 variant twice as fast), prompt and output lengths (whole
    tokens), a base demand log-uniform in 0.5-150 req/s and a shape (daily
    sine; a ramp starting with the run; a daily sine growing 4x a day; a
    daily square wave), its namespace (a quarter in GLOBAL_NAMESPACES), and
    how much demand history is pre-filled (most 2.5 days; every 12th two
    samples, so the long grid stays under MIN_VALID; every 12th other
    none). Every 5th model's prompt length drifts at measured ticks 4 and
    8."""
    rng = np.random.default_rng(seed)
    records, models = [], []
    for m in range(n_models):
        model_id = f"model-{m:04d}"
        base = dict(alpha=rng.uniform(3.0, 20.0),
                    beta=rng.uniform(0.001, 0.02),
                    gamma=rng.uniform(1e-5, 5e-4))
        variants = []
        for acc, cost, speed in ACCELERATORS:
            records.append(dict(model_id=model_id, accelerator=acc,
                                max_batch_size=96, max_queue_size=384,
                                **{k: v * speed for k, v in base.items()}))
            variants.append(dict(name=f"{model_id}-{acc}", accelerator=acc,
                                 cost=cost))
        models.append(dict(
            model_id=model_id, namespace=f"ns-{m % 8}", variants=variants,
            avg_in=float(round(rng.uniform(128, 2048))),
            avg_out=float(round(rng.uniform(64, 1024))),
            base=float(np.exp(rng.uniform(np.log(0.5), np.log(150.0)))),
            shape=SHAPES[m % 4], phase=float(rng.uniform(0, 2 * np.pi)),
            noise_seed=int(rng.integers(1 << 30)), drifts=m % 5 == 0,
            history=("none" if m % 12 == 11 else
                     "short" if m % 12 == 7 else "full")))
    return records, models


_MASK64 = (1 << 64) - 1


def _unit(seed, t):
    """A uniform number in [0, 1) for (``seed``, whole second ``t``):
    splitmix64, cheap enough for the planner's half-million history
    samples."""
    z = (seed * 0x9E3779B97F4A7C15 + int(round(t))) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) / 2.0 ** 64


def demand(md, t):
    """A model's demand (req/s) at ``t``, with 3% seeded noise."""
    noise = 0.97 + 0.06 * _unit(md["noise_seed"], t)
    wave = math.sin(2 * math.pi * t / DAY + md["phase"])
    shape = {"sine": 1.0 + 0.5 * wave,
             "ramp": 1.0 + max(t - (T0 - 60.0), 0.0) / 600.0,
             "growth": (1.0 + 0.5 * wave) * (1.0 + 4.0 * (t - T0 + DAY) / DAY),
             "step": 2.0 if wave > 0 else 1.0}[md["shape"]]
    return md["base"] * shape * noise


def prompt_drift(md, now):
    """The factor on a drifting model's prompt length at ``now``: 1.0, then
    1.25 from measured tick 4, 1.5 from measured tick 8."""
    tick = round((now - T0) / TICK_SECONDS) - FLEET_WARM_TICKS
    return 1.0 + 0.25 * (tick // 4) if md["drifts"] and tick > 0 else 1.0


def prefill(planner, models):
    """The planner's demand history before the first tick: the long grid's
    2.5 days at half its step, then the fine grid's 160 steps at the tick
    interval."""
    long_step = DAY / 64
    for md in models:
        if md["history"] == "none":
            continue
        if md["history"] == "short":
            ts = [T0 - 2 * TICK_SECONDS, T0 - TICK_SECONDS]
        else:
            ts = [float(t) for t in np.arange(T0 - 160 * long_step,
                                              T0 - 160 * TICK_SECONDS,
                                              long_step / 2)]
            ts += [T0 - (160 - i) * TICK_SECONDS for i in range(160)]
        for t in ts:
            planner.observe_demand(md["namespace"], md["model_id"], t,
                                   demand(md, t))


class FleetFeed:
    """Every pod's telemetry at ``now``, as bench.py's ``feed`` writes it
    (KV usage 0.35, one waiting request, the cache config), with
    ``vllm:request_success_total`` advancing at half its model's demand
    (two pods a model) and the prompt and generation token histograms
    (``_sum``/``_count``) at its lengths; ``tokens_only`` writes the token
    histograms alone (the counters advance all the same)."""

    def __init__(self, tsdb, models):
        self.tsdb, self.models = tsdb, models
        self.last = None
        self.counters = {}

    def __call__(self, now, tokens_only=False):
        dt = 0.0 if self.last is None else now - self.last
        self.last = now
        add = self.tsdb.add_sample
        for md in self.models:
            share = demand(md, now) / len(md["variants"])
            prompt = md["avg_in"] * prompt_drift(md, now)
            for v in md["variants"]:
                pod = {"pod": f"{v['name']}-0", "namespace": md["namespace"],
                       "model_name": md["model_id"]}
                served, n, s_in, s_out = self.counters.get(pod["pod"], (
                    COUNTER_BASE, COUNTER_BASE, COUNTER_BASE * md["avg_in"],
                    COUNTER_BASE * md["avg_out"]))
                served += share * dt
                n, s_in, s_out = n + 1.0, s_in + prompt, s_out + md["avg_out"]
                self.counters[pod["pod"]] = (served, n, s_in, s_out)
                if not tokens_only:
                    add("vllm:kv_cache_usage_perc", pod, 0.35, timestamp=now)
                    add("vllm:num_requests_waiting", pod, 1, timestamp=now)
                    add("vllm:cache_config_info",
                        {**pod, "num_gpu_blocks": "4096", "block_size": "32"},
                        1.0, timestamp=now)
                    add("vllm:request_success_total", pod, served,
                        timestamp=now)
                add("vllm:request_prompt_tokens_count", pod, n, timestamp=now)
                add("vllm:request_prompt_tokens_sum", pod, s_in,
                    timestamp=now)
                add("vllm:request_generation_tokens_count", pod, n,
                    timestamp=now)
                add("vllm:request_generation_tokens_sum", pod, s_out,
                    timestamp=now)


def fleet_world(n_models=N_MODELS, device=None, way="fused", package=None):
    """The fleet-tick world in ``package`` (a package module with the port's
    layout; None: the port, its engine on ``device``): ``build_manager``
    over a FakeCluster and a TimeSeriesDB holding FEED_HISTORY_SECONDS of
    telemetry, the SLO classes and profiles through ``update_slo_config``,
    the planner's history pre-filled. Returns (manager, clock, feed,
    models)."""
    name = (package or sys.modules["wva_tpu_torch"]).__name__

    def mod(sub):
        return importlib.import_module(f"{name}.{sub}")

    q, api, k8s = mod("analyzers.queueing"), mod("api"), mod("k8s")
    config, slo = mod("config"), mod("config.slo")
    interfaces = mod("interfaces")
    records, models = forecast_fleet(n_models)
    drain_decision_bus(mod("engines.common"))
    clock = mod("utils.clock").FakeClock(T0 - FEED_HISTORY_SECONDS)
    cluster = k8s.FakeCluster(clock=clock)
    tsdb = mod("collector.source").TimeSeriesDB(clock=clock)
    cfg = config.new_test_config()
    cfg.infrastructure.incremental = False
    for lever, value in FLEET_WAYS[way].items():
        setattr(cfg.infrastructure, lever, value)
    cfg.set_forecast(config.ForecastConfig(
        enabled=True, grid_step_seconds=TICK_SECONDS,
        default_lead_time_seconds=LEAD_SECONDS))
    cfg.set_trace(config.TraceConfig(enabled=True, ring_size=64))
    for namespace, optimizer in (("", ""), *((ns, "global")
                                             for ns in GLOBAL_NAMESPACES)):
        sat = interfaces.SaturationScalingConfig(analyzer_name="slo",
                                                 optimizer_name=optimizer)
        sat.apply_defaults()
        cfg.update_saturation_config_for_namespace(namespace,
                                                   {"default": sat})
    classes, profiles = [], []
    for md, pair in zip(models, zip(records[::2], records[1::2])):
        classes.append(slo.ServiceClass(
            name=f"c-{md['model_id']}", priority=1,
            model_targets={md["model_id"]: q.TargetPerf(
                target_ttft_ms=1000.0, target_itl_ms=50.0)}))
        for i, (v, rec) in enumerate(zip(md["variants"], pair)):
            ns, va = md["namespace"], v["name"]
            profiles.append(q.PerfProfile(
                model_id=md["model_id"], accelerator=v["accelerator"],
                service_parms=q.ServiceParms(alpha=rec["alpha"],
                                             beta=rec["beta"],
                                             gamma=rec["gamma"]),
                max_batch_size=rec["max_batch_size"],
                max_queue_size=rec["max_queue_size"]))
            cluster.create(k8s.Deployment(
                metadata=api.ObjectMeta(name=va, namespace=ns),
                replicas=1, selector={"app": va},
                template=k8s.PodTemplateSpec(
                    labels={"app": va},
                    containers=[k8s.Container(
                        name="srv",
                        args=["--max-num-batched-tokens=8192",
                              "--max-num-seqs=256"],
                        resources=k8s.ResourceRequirements(
                            requests={"google.com/tpu": "8"}))]),
                status=k8s.DeploymentStatus(replicas=1, ready_replicas=1)))
            cluster.create(api.VariantAutoscaling(
                metadata=api.ObjectMeta(
                    name=va, namespace=ns,
                    labels={"inference.optimization/acceleratorName":
                            v["accelerator"]}),
                spec=api.VariantAutoscalingSpec(
                    scale_target_ref=mod("api.v1alpha1")
                    .CrossVersionObjectReference(name=va),
                    model_id=md["model_id"], variant_cost=str(v["cost"]))))
            cluster.create(k8s.Pod(
                metadata=api.ObjectMeta(
                    name=f"{va}-0", namespace=ns, labels={"app": va},
                    owner_references=[{"kind": "Deployment", "name": va}]),
                status=k8s.PodStatus(
                    phase="Running", ready=True,
                    pod_ip=f"10.{len(profiles) // 250}.{len(profiles) % 250}"
                    f".{i + 1}")))
    feed = FleetFeed(tsdb, models)
    while clock.now() < T0:
        feed(clock.now(), tokens_only=clock.now() < T0 - GAUGE_HISTORY_SECONDS)
        clock.advance(TICK_SECONDS)
    feed(clock.now())
    device_arg = {} if package is not None else {"device": device}
    mgr = mod("main").build_manager(cluster, cfg, clock=clock, tsdb=tsdb,
                                    **device_arg)
    mgr.setup()
    mgr.config.update_slo_config(slo.SLOConfigData(
        service_classes=classes, profiles=profiles))
    prefill(mgr.engine.forecast, models)
    return mgr, clock, feed, models


def fleet_decisions(record):
    """A cycle record's decisions: (variant, desired, target, action,
    accelerator, the stage that set the final number)."""
    return [[d["variant_name"], d["desired_replicas"], d["target_replicas"],
             d["action"], d["accelerator_name"],
             explain_decision(record, d)["set_by"]]
            for d in record.get("decisions", ())]


def drain_decision_bus(common=engines_common):
    """The decision bus is process-global; each world starts it empty."""
    common.DecisionCache.clear()
    while not common.DecisionTrigger.empty():
        common.DecisionTrigger.get_nowait()


class GcClock:
    """The interpreter's ``gc`` collections, through ``gc.callbacks``: each
    one's start and end on the host clock and its generation."""

    def __init__(self):
        self.events, self._t0 = [], None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.events.append((self._t0, time.perf_counter(),
                                info["generation"]))
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def within(self, t0, t1):
        """Milliseconds in collections that started in [t0, t1], and their
        count by generation."""
        inside = [(a, b, g) for a, b, g in self.events if t0 <= a <= t1]
        return (1e3 * sum(b - a for a, b, _ in inside),
                dict(collections.Counter(g for _, _, g in inside)))


class HostCopies(TorchDispatchMode):
    """Counts the device-to-host transfers dispatched inside it: copies of a
    CUDA tensor to the CPU and scalar reads (``.item()``)."""

    def __init__(self):
        super().__init__()
        self.copies = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.__name__
        src = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if name.startswith("_local_scalar_dense") and src is not None:
            self.copies += src.is_cuda
        elif name.startswith("_to_copy") and src is not None:
            self.copies += src.is_cuda and not out.is_cuda
        elif name.startswith("copy_") and len(args) > 1:
            self.copies += (isinstance(args[1], torch.Tensor)
                            and args[1].is_cuda and not args[0].is_cuda)
        return out


def span_split(tree):
    """One tick's span tree: the milliseconds of each phase under the tick
    root, and of every span below the phases summed by its path of names
    (per-model spans under their common name), with each phase's and each
    per-model span's time outside its children as "<path>/(self)"."""
    phases, stages = {}, collections.Counter()

    def walk(node, path):
        inside = 0.0
        for child in node.get("children", ()):
            here = f"{path}/{child['name']}"
            stages[here] += child.get("dur_ms", 0.0)
            inside += child.get("dur_ms", 0.0)
            walk(child, here)
        if node.get("children"):
            stages[f"{path}/(self)"] += node.get("dur_ms", 0.0) - inside

    for phase in tree.get("children", ()):
        phases[phase["name"]] = phases.get(phase["name"], 0.0) + phase.get(
            "dur_ms", 0.0)
        walk(phase, phase["name"])
    return phases, dict(stages)


def run_fleet_way(way="fused", n_models=N_MODELS, device=None, package=None,
                  probes=False):
    """The fleet world one way: FLEET_WARM_TICKS ticks, then FLEET_TICKS
    measured ticks TICK_SECONDS apart, each through the engine's executor
    (collection, the analyzer, the fused program or the staged calls, the
    fleet solve, the enforcer, the limiter, the planner's floors and
    actuation), with a scrape after each. Returns each measured tick's
    decisions and analyzer records, the planner's last plans and the
    host-clock tick times; for the port also each tick's kernel launches
    (both counts set to 0 just before the measured ticks and read just
    after), solve-memo ticks, span split and gc time, and the fleet solves'
    inputs. ``probes`` adds, after the measured ticks, one tick under a
    device-to-host copy counter and one under ``torch.profiler``."""
    port = package is None
    name = (package or sys.modules["wva_tpu_torch"]).__name__
    fused_pkg = importlib.import_module(f"{name}.fused")
    fleet_pkg = importlib.import_module(f"{name}.fleet")
    fused_pkg.clear_solve_memo()
    mgr, clock, feed, models = fleet_world(n_models, device, way, package)
    engine = mgr.engine
    on_card = port and resolve_device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    saved = [(fused_pkg, "run", fused_pkg.run),
             (fused_pkg, "build_candidate_axis",
              fused_pkg.build_candidate_axis),
             (fleet_pkg, "solve", fleet_pkg.solve)]
    fleet_solves, first_candidates = [], []

    def recorded_solve(system, spec=None, presized=None, **kw):
        fleet_solves.append((system, presized))
        return saved[2][2](system, spec, presized=presized, **kw)

    def recorded_axis(grids, plans, keys):
        if not first_candidates:
            first_candidates.extend(c for k in keys
                                    for c in plans[k].candidates)
        return saved[1][2](grids, plans, keys)

    alloc = importlib.import_module(f"{name}.fleet.allocation")
    saved.append((alloc, "analyze_batch", alloc.analyze_batch))
    if way == "plain":
        fused_pkg.run = functools.partial(saved[0][2], impl="plain")
        engine.slo_analyzer.impl = "plain"
        alloc.analyze_batch = functools.partial(alloc.analyze_batch,
                                                impl="plain")
    # The fleet solve's analyze_batch calls in the measured ticks: how many,
    # the chain-statistics launches made inside them, and their shapes
    # (C, k_cols).
    analyze = dict(calls=0, launches=0, shapes=[])
    inner_analyze = alloc.analyze_batch

    def recorded_analyze(rate, cand, k_cols=qm.K_MAX, **kw):
        before = chain_stats.launches
        try:
            return inner_analyze(rate, cand, k_cols, **kw)
        finally:
            analyze["calls"] += 1
            analyze["launches"] += chain_stats.launches - before
            analyze["shapes"].append((int(cand.alpha.shape[0]), k_cols))

    if port:
        fused_pkg.build_candidate_axis = recorded_axis
        fleet_pkg.solve = recorded_solve
        alloc.analyze_batch = recorded_analyze
    out = dict(decisions=[], models=[], tick_ms=[], launches=[],
               solve_ticks=[], phases=[], stages=[], gc_ms=[], gc_by_gen=[])
    try:
        with GcClock() as gc_clock:
            for tick in range(FLEET_WARM_TICKS + FLEET_TICKS):
                measured = tick >= FLEET_WARM_TICKS
                if tick == FLEET_WARM_TICKS:
                    sizing_kernel.launches = fit_kernel.launches = 0
                    chain_setup.launches = chain_stats.launches = 0
                    analyze.update(calls=0, launches=0, shapes=[])
                before = (*fleet_launches(),
                          fused_pkg.solve_memo_counters()["solve_ticks"])
                sync()
                t0 = time.perf_counter()
                engine.executor.tick()
                sync()
                t1 = time.perf_counter()
                ms = 1e3 * (t1 - t0)
                gc_ms, gc_by_gen = gc_clock.within(t0, t1)
                mgr.flight_recorder.flush()
                record = mgr.flight_recorder.snapshot()[-1]
                if measured:
                    out["decisions"].append(fleet_decisions(record))
                    out["models"].append(record.get("models"))
                    out["tick_ms"].append(ms)
                    out["launches"].append(tuple(
                        a - b for a, b in zip(fleet_launches(), before)))
                    out["solve_ticks"].append(
                        fused_pkg.solve_memo_counters()["solve_ticks"]
                        > before[-1])
                    out["gc_ms"].append(gc_ms)
                    out["gc_by_gen"].append(gc_by_gen)
                    if mgr.spans is not None:
                        phases, stages = span_split(mgr.spans.last_tree())
                        out["phases"].append(phases)
                        out["stages"].append(stages)
                clock.advance(TICK_SECONDS)
                feed(clock.now())
            out["total"] = fleet_launches()
        if probes:
            with HostCopies() as copies:
                engine.executor.tick()
            out["host_copies"] = copies.copies
            clock.advance(TICK_SECONDS)
            feed(clock.now())
            out["busy"] = device_busy_ms(engine.executor.tick, 1, warm=False)
            clock.advance(TICK_SECONDS)
            feed(clock.now())
            out["host_profile"] = tick_host_profile(engine.executor.tick)
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
        mgr.shutdown()
        drain_decision_bus(importlib.import_module(f"{name}.engines.common"))
    out["plans"] = {k: dataclasses.asdict(p)
                    for k, p in engine.forecast._last_plan.items()}
    out["fleet_solves"] = fleet_solves
    out["first_candidates"] = first_candidates
    out["analyze"] = analyze
    return out


# The fleet tick's kernels, in the order its launch counts are kept.
FLEET_KERNELS = ("sizing", "fit", "chain setup", "chain stats")


def fleet_launches():
    """The launch counts of FLEET_KERNELS."""
    return (sizing_kernel.launches, fit_kernel.launches,
            chain_setup.launches, chain_stats.launches)


def tick_host_profile(tick, top=14):
    """One tick under ``cProfile``: the functions with the most time of
    their own (the profiler slows the tick; the ranking is what counts)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    tick()
    prof.disable()
    stats = pstats.Stats(prof).stats
    total = sum(v[2] for v in stats.values())
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return dict(total_ms=1e3 * total, top=[
        dict(where=f"{os.path.relpath(f) if f.startswith('/') else f}:{line}"
             f"({name})", self_ms=1e3 * v[2], calls=v[1])
        for (f, line, name), v in rows])


def presized_check(system, presized, what):
    """The fleet solve's candidates with its own sizing against the fused
    sizing: replicas and accelerators equal; the rates' bit differences."""
    own = build_candidates(system, device=CUDA)
    reused = build_candidates(system, presized=presized, device=CUDA)
    require(sorted(own) == sorted(reused), f"{what}: servers differ")
    ulps, pairs = [], 0
    for name in own:
        a, b = own[name], reused[name]
        require([(x.accelerator, x.num_replicas) for x in a]
                == [(x.accelerator, x.num_replicas) for x in b],
                f"{what}: {name}'s candidates differ")
        for x, y in zip(a, b):
            pairs += 1
            ulps.append(abs(int(np.float32(x.max_rate_per_replica)
                                .view(np.int32))
                            - int(np.float32(y.max_rate_per_replica)
                                  .view(np.int32))))
    spec = SolverSpec(unlimited=True)
    sa = solve(system, spec, device=CUDA).allocations
    sb = solve(system, spec, presized=presized, device=CUDA).allocations
    require({k: (v.accelerator, v.num_replicas) for k, v in sa.items()}
            == {k: (v.accelerator, v.num_replicas) for k, v in sb.items()},
            f"{what}: allocations differ")
    differ = sum(u > 0 for u in ulps)
    require(not differ, f"{what}: the fused sizing's rates differ from the "
            f"fleet solve's own on {differ} pairs, max {max(ulps)} ulp")
    log(f"[presized] {what}: {len(own)} servers, {pairs} pairs: replicas, "
        f"accelerators and allocations equal; rate_star bits differ on "
        f"{differ} pairs, max {max(ulps)} ulp")
    return dict(pairs=pairs, differ=differ, max_ulp=max(ulps))


def fleet_analyze_inputs(system):
    """The inputs of the fleet solve's analyze_batch when it sizes
    ``system``'s pairs itself (as the staged way's solve does): (rates,
    candidates, k_cols) as build_candidates passes them."""
    alloc = sys.modules["wva_tpu_torch.fleet.allocation"]
    inner, seen = alloc.analyze_batch, []

    def recorded(rate, cand, k_cols=qm.K_MAX, **kw):
        seen.append((rate, cand, k_cols))
        return inner(rate, cand, k_cols, **kw)

    alloc.analyze_batch = recorded
    try:
        build_candidates(system, device=CUDA)
    finally:
        alloc.analyze_batch = inner
    require(len(seen) == 1, f"build_candidates called analyze_batch "
            f"{len(seen)} times")
    return seen[0]


def other_fleet_ways():
    """The fleet world's other ways, each in a process of its own, all
    started together: way -> its decisions, tick times and launches."""
    procs = {way: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--fleet-way", way],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for way in list(FLEET_WAYS)[1:]}
    runs = {}
    try:
        for way, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            require(proc.returncode == 0,
                    f"the {way} way failed: {err[-3000:]}")
            runs[way] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return runs


def _ms_summary(xs):
    return dict(mean=sum(xs) / len(xs), p50=_percentile(xs, 50),
                p99=_percentile(xs, 99), max=max(xs))


def _mean_by_name(rows):
    names = dict.fromkeys(k for row in rows for k in row)
    return {k: sum(row.get(k, 0.0) for row in rows) / len(rows)
            for k in names}


def phase_fleet_tick(err):
    """The fleet tick through the Manager at N_MODELS x 2 variants, four
    ways; the main path (fused, memo on) with both kernels' counts set to 0
    just before its measured ticks and read just after."""
    t0 = time.perf_counter()
    main = run_fleet_way("fused", probes=True)
    main_s = time.perf_counter() - t0
    runs = {"fused": main, **other_fleet_ways()}
    log(f"[fleet] the main path, {FLEET_WARM_TICKS} warm + {FLEET_TICKS} "
        f"ticks with its world's build, {main_s:.1f} s; the other "
        f"{len(FLEET_WAYS) - 1} ways in parallel processes, "
        f"{time.perf_counter() - t0 - main_s:.1f} s")
    for tick in range(FLEET_TICKS):
        want = main["decisions"][tick]
        require(len(want) == 2 * N_MODELS, (tick, len(want)))
        for way in list(FLEET_WAYS)[1:]:
            require(runs[way]["decisions"][tick] == want,
                    f"tick {tick}: {way} decisions differ from fused: "
                    + next((f"{a} != {b}" for a, b in zip(
                        runs[way]["decisions"][tick], want) if a != b), ""))
        got = tuple(main["launches"][tick])
        expected = (1, 1, 1, 1) if main["solve_ticks"][tick] else (0, 1, 0, 0)
        require(got == expected,
                f"tick {tick}: launches {dict(zip(FLEET_KERNELS, got))}; "
                f"expected {expected}")
    require(tuple(runs["plain"]["total"]) == (0, 0, 0, 0),
            f"the plain way launched {runs['plain']['total']}")
    solve_ticks = sum(main["solve_ticks"])
    require(0 < solve_ticks < FLEET_TICKS, f"{solve_ticks} solve ticks")
    flat = [d for tick in main["decisions"] for d in tick]
    actions = collections.Counter(d[3] for d in flat)
    set_by = collections.Counter(d[5] for d in flat)
    require(actions["scale-up"] and actions["scale-down"],
            f"actions {dict(actions)}")
    trusted = collections.Counter(p["forecaster"] for p in
                                  main["plans"].values() if p["trusted"])
    for way, r in runs.items():
        s = _ms_summary(r["tick_ms"])
        log(f"[fleet] {way}{' (alone)' if way == 'fused' else ''}: tick ms "
            f"mean {s['mean']:.1f}, p50 {s['p50']:.1f}, p99 {s['p99']:.1f}, "
            f"max {s['max']:.1f} (host clock; "
            + ", ".join(f"{x:.1f}" for x in r["tick_ms"]) + ")")
    phases = _mean_by_name(main["phases"])
    stages = _mean_by_name(main["stages"])
    mean_tick = sum(main["tick_ms"]) / FLEET_TICKS
    log(f"[fleet] fused tick split by the span recorder, mean ms: "
        + ", ".join(f"{k} {v:.1f}" for k, v in phases.items())
        + f", outside the phases {mean_tick - sum(phases.values()):.1f}")
    log("[fleet] spans under the phases by path, mean ms a tick: "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
            stages.items(), key=lambda kv: (kv[0].count("/"), -kv[1]))))
    gc_ms = sum(main["gc_ms"]) / FLEET_TICKS
    gens = collections.Counter()
    for g in main["gc_by_gen"]:
        gens.update(g)
    busy_ms, kernels = main["busy"]
    less_gc = [t - g for t, g in zip(main["tick_ms"], main["gc_ms"])]
    log(f"[fleet] gc: {gc_ms:.1f} ms a tick (max {max(main['gc_ms']):.1f}; "
        f"collections by generation {dict(sorted(gens.items()))} over "
        f"{FLEET_TICKS} ticks; per tick "
        + ", ".join(f"{x:.1f}/{g.get(2, 0)}" for x, g in zip(
            main["gc_ms"], main["gc_by_gen"]))
        + " as ms/generation-2 collections); the tick less its gc: mean "
        f"{sum(less_gc) / FLEET_TICKS:.1f}, p50 {_percentile(less_gc, 50):.1f}"
        f", p99 {_percentile(less_gc, 99):.1f} ms")
    prof = main["host_profile"]
    log(f"[fleet] one fused tick under cProfile ({prof['total_ms']:.0f} ms "
        f"of its own time in all), the most self time: " + "; ".join(
            f"{r['where']} {r['self_ms']:.0f} ms in {r['calls']} calls"
            for r in prof["top"]))
    log(f"[fleet] one fused tick: {main['host_copies']} device-to-host "
        f"copies; the device busy {busy_ms:.3f} ms in {kernels:.0f} kernels "
        f"(torch.profiler) = {busy_ms / mean_tick:.5f} of the mean tick")
    log(f"[fleet] {N_MODELS} models x 2 variants, {FLEET_TICKS} ticks: "
        f"decisions equal across {', '.join(FLEET_WAYS)}; {solve_ticks} "
        f"solve ticks (1 launch each of chain setup, sizing, chain stats and "
        f"fit), {FLEET_TICKS - solve_ticks} memo-hit ticks (1 fit launch); "
        f"launches of {', '.join(FLEET_KERNELS)} by way: "
        + ", ".join(f"{way} {tuple(r['total'])}" for way, r in runs.items())
        + "; "
        f"actions {dict(actions)}; set by {dict(set_by)}; trusted models by "
        f"forecaster at the end: {dict(trusted)}")
    global_solves = [(s, p) for s, p in main["fleet_solves"] if p is not None]
    require(global_solves, "the fleet solve never ran on the fused sizing")
    checks = [presized_check(*global_solves[i], f"solve {i}")
              for i in (0, len(global_solves) - 1)]
    # analyze_batch: one chain-statistics launch a call in every way but the
    # plain one; the staged way's solve calls it on the pairs it sizes, at
    # the shape of the main path's first fleet solve sized that way.
    analyze = {way: r["analyze"] for way, r in runs.items()}
    for way, a in analyze.items():
        want = 0 if way == "plain" else a["calls"]
        require(a["launches"] == want, f"{way}: analyze_batch made "
                f"{a['calls']} calls and {a['launches']} launches")
    require(analyze["staged"]["calls"] > 0,
            "the staged way's fleet solve never called analyze_batch")
    analyze_inputs = fleet_analyze_inputs(global_solves[0][0])
    shape = (int(analyze_inputs[1].alpha.shape[0]), analyze_inputs[2])
    staged_shapes = {tuple(x) for x in analyze["staged"]["shapes"]}
    require(shape in staged_shapes, f"analyze_batch at {shape}; the staged "
            f"way's calls were at {sorted(staged_shapes)}")
    log("[fleet] analyze_batch in the measured ticks, calls and chain-"
        "statistics launches by way: " + ", ".join(
            f"{way} {a['calls']}/{a['launches']}"
            for way, a in analyze.items())
        + f"; the staged way's shapes (C, k_cols) {sorted(staged_shapes)}; "
        f"timed at the first fleet solve's {shape}")
    cands = main["first_candidates"]
    cand, t_ttft, t_itl, _, ks = build_sizing_batch(cands, CUDA)
    args = bisection_args(cand, torch.stack([t_ttft, t_itl]),
                          qm.k_cols_for(ks))
    timing = time_kernel_and_plain(args, err)
    return dict(
        launches=main["total"], solve_ticks=solve_ticks, timing=timing,
        batch=(cand, t_ttft, t_itl), analyze_inputs=analyze_inputs,
        analyze={way: {k: a[k] for k in ("calls", "launches")}
                 for way, a in analyze.items()},
        launches_by_way={way: r["total"] for way, r in runs.items()},
        tick_ms={way: _ms_summary(r["tick_ms"]) for way, r in runs.items()},
        phases_ms=phases, stages_ms=stages, gc_ms_per_tick=gc_ms,
        gc_collections=dict(gens), host_copies=main["host_copies"],
        host_profile=main["host_profile"],
        device_busy_ms=busy_ms, device_kernels=kernels,
        device_busy_share=busy_ms / mean_tick, presized=checks, actions=dict(actions),
        set_by=dict(set_by), trusted=dict(trusted))

# ---------------------------------------------------------------- phase 3b

CHAIN_ROWS = (1, 7, 64, 2048)
CHAIN_K_COLS = (256, 512, 1024, 2048)


def chain_inputs(n, seed, k_cols):
    """Seeded candidates on the card with k up to k_cols (the edge rows
    first: k = 1, k = k_cols, no prompt), targets [3, C] (TTFT off in row
    3, ITL off in row 4, a TPS target in every third row) and rates [C] in
    req/s (a fifth below the bounds, a fifth above)."""
    cand, targets = population(n, seed, max(1, k_cols // 4), k_cols + 1)
    fields = [f.clone() for f in cand]
    k, avg_in = fields[6], fields[3]
    for i, (field, value) in enumerate(((k, 1), (k, k_cols), (avg_in, 0.0))):
        if i < n:
            field[i] = value
    cand = qm.CandidateBatch(*fields)
    tps = torch.zeros(n, device=CUDA)
    tps[2::3] = 500.0
    t = torch.cat([targets, tps[None]]).contiguous()
    t[0, 3::7] = 0.0
    t[1, 4::7] = 0.0
    lo, hi = qm.rate_bounds_per_ms(cand)
    u = torch.linspace(0.05, 0.95, n, device=CUDA)
    rate = 1000.0 * (lo + u * (hi - lo))
    rate[0::5] = 500.0 * lo[0::5]
    rate[1::5] = 2000.0 * hi[1::5]
    return cand, t, rate


def check_chain(got, want, keys, what, err):
    """Each key at rtol RTOL (absolute floor 1e-6), a difference of two
    larger terms (the wait) at RTOL of the larger; ``valid`` equal."""
    for key in keys:
        g, w = got[key], want[key]
        if key == "valid":
            require(torch.equal(g, w), f"{what}: valid differs")
            continue
        torch.cuda.synchronize()
        require(bool(torch.isfinite(g).all()), f"{what} {key}: not finite")
        scale = (want["avg_resp_time_ms"].abs() if key == "avg_wait_time_ms"
                 else w.abs())
        diff = (g - w).abs()
        err.max_abs = max(err.max_abs, float(diff.max()))
        err.max_rel = max(err.max_rel, float(
            (diff / scale.clamp(min=1e-30)).max()))
        require(bool((diff <= RTOL * scale + 1e-6).all()),
                f"{what} {key}: beyond rtol {RTOL}")


def check_setup(got, want, cand, k_cols, what, err):
    """The chain setup against its plain version: the bounds at rtol RTOL,
    clm up to each row's k within RTOL of the running sum of its terms'
    magnitudes and past k at RTOL of its own value, clm_at_k clm at k."""
    check_chain(dict(bounds=got.bounds), dict(bounds=want.bounds),
                ["bounds"], what, err)
    terms = qm._masked_log_mu(cand, k_cols).double()
    scale = torch.cumsum(terms.abs(), dim=1)
    inside = (torch.arange(1, k_cols + 1, device=CUDA)[None, :]
              <= cand.k[:, None])
    diff = (got.clm.double() - want.clm.double()).abs()
    bound = torch.where(inside, RTOL * scale, RTOL * want.clm.double().abs())
    err.max_rel = max(err.max_rel,
                      float((RTOL * diff / bound.clamp(min=1e-300)).max()))
    require(bool((diff <= bound).all()), f"{what} clm beyond its tolerance")
    at_k = torch.gather(got.clm, 1, (cand.k[:, None] - 1).long())[:, 0]
    require(torch.equal(got.clm_at_k, at_k), f"{what}: clm_at_k is not clm "
            f"at k")


def chain_launch_counts():
    return (chain_setup.launches, sizing_kernel.launches,
            chain_stats.launches)


def chain_op_ms(name, kernel, plain, fn_work, reps=200):
    """One chain entry at the main path's shape: the wrapper and its plain
    version (CUDA events, in turns: plain, kernel, kernel, plain), the
    kernel's device time (profiler), the plain version's PyTorch ops and
    device busy time, and the bound from its pointwise elements."""
    plain()
    with OpCount() as count:
        plain()
    runs = {"plain": [], "kernel": []}
    for turn in ("plain", "kernel", "kernel", "plain"):
        runs[turn].append(time_ms(kernel if turn == "kernel" else plain,
                                  reps if turn == "kernel" else 20))
    work = fn_work(count.pointwise_elements)
    bound_ms, term = work.bound()
    busy_ms, kernels = device_busy_ms(plain, 20)
    return dict(ms=sum(runs["kernel"]) / 2, plain_ms=sum(runs["plain"]) / 2,
                runs_ms=runs, device_ms=device_ms(kernel, reps, name),
                plain_ops=count.ops, plain_kernels=kernels,
                plain_device_busy_ms=busy_ms,
                pointwise_elements=count.pointwise_elements,
                bound_ms=bound_ms, bound_term=term,
                bound_by="bytes" if term == "bytes" else "operations",
                bounds_ms=work.bound_terms_ms())


def log_chain_times(label, t):
    log(f"[chain] {label}: the wrapper "
        f"{'/'.join(f'{x:.4f}' for x in t['runs_ms']['kernel'])} ms (CUDA "
        f"events), "
        + ("on the device not measured" if t["device_ms"] is None else
           f"on the device {t['device_ms']:.5f} ms (torch.profiler)")
        + f"; the plain version "
        f"{'/'.join(f'{x:.4f}' for x in t['runs_ms']['plain'])} ms, "
        f"{t['plain_ops']} PyTorch ops, {t['plain_kernels']:.0f} kernels, "
        f"the device busy {t['plain_device_busy_ms']:.4f} ms; the bound "
        f"{t['bound_ms']:.6f} ms ({t['bound_term']}; "
        + ", ".join(f"{n} {x:.6f}" for n, x in t["bounds_ms"].items())
        + "); library: none")


def phase_chain(batch=None, analyze_inputs=None):
    """The chain setup and the chain statistics (both entries, and the
    tuner's h and H) against their plain versions on the card; the launches
    of size_batch (3) and analyze_batch (1); a row's bits alone, in a batch
    and at a wider k_cols; the times at the fleet tick's first sizing call
    (``batch``: C=2048, k_cols=512) and at the fleet solve's analyze_batch
    call (``analyze_inputs``: rates, candidates, k_cols). Without them (run
    alone) it times a restated population at the same shapes."""
    err = Errors()
    seed = 500
    for k_cols in CHAIN_K_COLS:
        for n in CHAIN_ROWS:
            seed += 1
            cand, t, rate = chain_inputs(n, seed, k_cols)
            what = f"C={n} k_cols={k_cols}"
            plain = chain_setup.chain_setup_plain(cand, k_cols)
            check_setup(chain_setup.launch(cand, k_cols), plain, cand,
                        k_cols, f"setup {what}", err)
            lam_star = sizing_kernel.sizing_bisection_plain(
                plain.clm, plain.clm_at_k, cand, t[:2], plain.lo0, plain.hi0)
            args = (cand, lam_star, t, plain.bounds[2], k_cols)
            check_chain(chain_stats.size_tail(*args),
                        chain_stats.size_tail_plain(*args),
                        chain_stats.TAIL_KEYS, f"tail {what}", err)
            check_chain(chain_stats.analyze(rate, cand, k_cols),
                        chain_stats.analyze_plain(rate, cand, k_cols),
                        ["valid", *chain_stats.ANALYZE_KEYS],
                        f"analyze {what}", err)
            got = qm.size_batch(cand, *t, k_cols=k_cols)
            want = qm.size_batch(cand, *t, k_cols=k_cols, impl="plain")
            check_chain(got, want, chain_stats.TAIL_KEYS,
                        f"size_batch {what}", err)
    log(f"[chain] setup, tail and analyze against their plain versions at "
        f"C {CHAIN_ROWS} x k_cols {CHAIN_K_COLS}, and size_batch through "
        f"the three kernels against its plain version: max rel "
        f"{err.max_rel:.3g}, max abs {err.max_abs:.3g} (rtol {RTOL})")
    jacobian = jacobian_vs_plain()

    # Launches: size_batch 3 (setup, sizing, stats), analyze_batch 1.
    n = CHAIN_ROWS[-1]
    cand, t, rate = chain_inputs(n, 600, 512)
    before = chain_launch_counts()
    sized = qm.size_batch(cand, *t, k_cols=512)
    after = chain_launch_counts()
    analyzed = qm.analyze_batch(rate, cand, k_cols=512)
    last = chain_launch_counts()
    torch.cuda.synchronize()
    require(tuple(a - b for a, b in zip(after, before)) == (1, 1, 1),
            f"size_batch launches (setup, sizing, stats): {before} -> "
            f"{after}")
    require(tuple(a - b for a, b in zip(last, after)) == (0, 0, 1),
            f"analyze_batch launches: {after} -> {last}")

    # Bits: a row alone, in reverse order, and at a wider k_cols.
    rev = torch.arange(n - 1, -1, -1, device=CUDA)
    cr = qm.CandidateBatch(*(f[rev] for f in cand))
    tr, rr = t[:, rev].contiguous(), rate[rev]
    for what, got, want in (
            ("reversed", qm.size_batch(cr, *tr, k_cols=512), sized),
            ("k_cols 2048", qm.size_batch(cand, *t, k_cols=2048), sized)):
        for key in chain_stats.TAIL_KEYS:
            g = got[key][rev] if what == "reversed" else got[key]
            require(torch.equal(g, want[key]),
                    f"size_batch {what} changed {key}'s bits")
    for what, got in (("reversed", qm.analyze_batch(rr, cr, k_cols=512)),
                      ("k_cols 2048", qm.analyze_batch(rate, cand))):
        for key in analyzed:
            g = got[key][rev] if what == "reversed" else got[key]
            require(torch.equal(g, analyzed[key]),
                    f"analyze_batch {what} changed {key}'s bits")
    picked = (0, 1, 2, n // 2 - 1, n - 1)
    for i in picked:
        one = qm.CandidateBatch(*(f[i:i + 1] for f in cand))
        alone = qm.size_batch(one, *t[:, i:i + 1].contiguous(), k_cols=512)
        require(all(torch.equal(alone[k], sized[k][i:i + 1])
                    for k in chain_stats.TAIL_KEYS),
                f"row {i} alone differs from its bits in the batch")
        alone = qm.analyze_batch(rate[i:i + 1], one, k_cols=512)
        require(all(torch.equal(alone[k], analyzed[k][i:i + 1])
                    for k in analyzed),
                f"row {i} alone differs in analyze_batch")
    log(f"[chain] size_batch makes 3 launches (setup, sizing, stats) and "
        f"analyze_batch 1; a row's bits are the same alone (rows {picked} "
        f"of {n}), in reversed order and at k_cols 512 -> 2048")

    # Times at the main path's shapes.
    if batch is None:
        cand, targets = population(n, 601, 128, 513)
        batch = (cand, targets[0], targets[1])
    cand, ttft, itl = batch
    k_cols = qm.k_cols_for(cand.k.cpu().numpy())
    t = torch.stack([ttft, itl, torch.zeros_like(ttft)])
    setup = chain_setup.chain_setup(cand, k_cols)
    lam_star = sizing_kernel.sizing_bisection(
        setup.clm, setup.clm_at_k, cand, t[:2], setup.lo0, setup.hi0)
    tail_args = (cand, lam_star, t, setup.bounds[2], k_cols)
    c = int(cand.alpha.shape[0])
    times = {
        "setup": chain_op_ms(
            "chain_setup_kernel", lambda: chain_setup.chain_setup(cand, k_cols),
            lambda: chain_setup.chain_setup_plain(cand, k_cols),
            lambda ops: chain_setup.work(cand, k_cols, ops)),
        "tail": chain_op_ms(
            "chain_stats_kernel", lambda: chain_stats.size_tail(*tail_args),
            lambda: chain_stats.size_tail_plain(*tail_args),
            lambda ops: chain_stats.work(cand, "tail", ops))}
    if analyze_inputs is None:
        lo, hi = qm.rate_bounds_per_ms(cand)
        analyze_inputs = (500.0 * (lo + hi), cand, qm.K_MAX)
    rate, wide, analyze_k = analyze_inputs
    analyze_c = int(wide.alpha.shape[0])
    times["analyze"] = chain_op_ms(
        "chain_stats_kernel",
        lambda: chain_stats.analyze(rate, wide, analyze_k),
        lambda: chain_stats.analyze_plain(rate, wide, analyze_k),
        lambda ops: chain_stats.work(wide, "analyze", ops))
    for name, label in (("setup", f"chain setup at C={c}, k_cols={k_cols}"),
                        ("tail", f"chain statistics, the sizing tail, at "
                                 f"C={c}, k_cols={k_cols}"),
                        ("analyze", f"chain statistics, analyze_batch, at "
                                    f"C={analyze_c}, k_cols={analyze_k}")):
        log_chain_times(label, times[name])
    return dict(max_abs_err=err.max_abs, max_rel_err=err.max_rel,
                jacobian=jacobian, times=times, shape=dict(c=c, k_cols=k_cols),
                analyze_shape=dict(c=analyze_c, k_cols=analyze_k))


# ---------------------------------------------------------------- phase 4

FIT_ROWS = (1, 7, 1024, 4096)
FIT_RAGGED_ROWS = (1023, 1025)  # no multiple of any rows-per-block choice
# The calls timed: one model with a full history padded to a bucket of 1
# (the headline world, the fidelity event run, the backtest), and the fused
# tick's bucket of 1024 models, both with the seeded inputs' mixed valid
# counts and seasons (the shape earlier timings used) and with full
# histories and one season (a fleet in its steady state): name -> (M, full).
FIT_TIMED = {"M=1": (1, True), "M=1024": (1024, False),
             "M=1024 full": (1024, True)}
FIT_EDGE_SEASONS = (1, 2, 3, 64, 160)  # 1 and 2 carry terms in registers
FIT_EDGE_VALID = (0, 3, 4, 160)  # MIN_VALID is 4


def fit_inputs(m, seed, full=False):
    """Seeded fit inputs on the card: values 0-10, valid counts 0-160,
    horizons 0-20 (fine) and 0-5 (long) steps (tests/test_fused_plane.py
    :249-260), seasons 1-160. ``full``: every grid fully valid, season
    SEASON_STEPS (a model with history, as the main paths fit it)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.uniform(0, 10, (m, fc.N_GRID)).astype(np.float32),
              rng.integers(0, fc.N_GRID + 1, m).astype(np.float32),
              rng.uniform(0, 10, (m, fc.N_GRID)).astype(np.float32),
              rng.integers(0, fc.N_GRID + 1, m).astype(np.float32),
              rng.uniform(0, 20, m).astype(np.float32),
              rng.uniform(0, 5, m).astype(np.float32),
              rng.integers(1, fc.N_GRID + 1, m).astype(np.int32)]
    if full:
        arrays[1][:] = arrays[3][:] = fc.N_GRID
        arrays[6][:] = fc.SEASON_STEPS
    return [torch.from_numpy(a).to(CUDA) for a in arrays]


def fit_edge_inputs(seed):
    """One row for each season in FIT_EDGE_SEASONS and each pair of valid
    counts (fine, long) from FIT_EDGE_VALID."""
    combos = [(s, vf, vl) for s in FIT_EDGE_SEASONS for vf in FIT_EDGE_VALID
              for vl in FIT_EDGE_VALID]
    inputs = fit_inputs(len(combos), seed)
    for col, values in ((6, [c[0] for c in combos]),
                        (1, [c[1] for c in combos]),
                        (3, [c[2] for c in combos])):
        inputs[col] = torch.tensor(values, dtype=inputs[col].dtype,
                                   device=CUDA)
    return inputs


def check_fits(got, want, what):
    """The kernel must equal its plain version in every value; returns the
    max abs err (0)."""
    torch.cuda.synchronize()
    require(got.shape == want.shape, (what, got.shape, want.shape))
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    differ = int((got != want).sum())
    require(differ == 0, f"{what}: {differ} of {got.numel()} values differ "
            f"from the plain version's bits (max abs "
            f"{float((got - want).abs().max()):.3g})")
    return float((got - want).abs().max())


def fit_every_rows(inputs, m):
    """The kernel's output at each rows-per-block choice."""
    outs = {}
    for rows in fit_kernel.ROWS_CHOICES:
        out = torch.empty((len(fc.FORECASTERS), m), dtype=torch.float32,
                          device=CUDA)
        outs[rows] = fit_kernel.launch(*inputs, out, rows_per_block=rows)
    return outs


def device_ms(fn, reps, kernel):
    """Mean device time of one launch of the CUDA kernel whose name holds
    ``kernel``, over ``reps`` calls of ``fn``, from a torch.profiler trace;
    None when the trace holds no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in found)
    total_us = sum(getattr(e, "device_time_total", 0.0) for e in found)
    return total_us / count / 1e3 if count and total_us else None


class OpCount(TorchDispatchMode):
    """Counts the PyTorch ops dispatched inside it (on the card, each
    launches at most about one kernel), and the elements its pointwise ops
    write: one operation an element."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.pointwise_elements = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        out = func(*args, **(kwargs or {}))
        if torch.Tag.pointwise in func.tags:
            self.pointwise_elements += sum(
                t.numel() for t in (out if isinstance(out, (tuple, list))
                                    else (out,))
                if isinstance(t, torch.Tensor))
        return out


def phase_fit():
    max_abs = 0.0
    for m in FIT_ROWS + FIT_RAGGED_ROWS:
        inputs = fit_inputs(m, 700 + m)
        want = fc.fit_grid_plain(*inputs, m=m)
        max_abs = max(max_abs, check_fits(fc.fit_grid(*inputs, m=m), want,
                                          f"fit M={m}"))
        for rows, got in fit_every_rows(inputs, m).items():
            check_fits(got, want, f"fit M={m} R={rows}")
        log(f"[fit] M={m:5d}: 0 of {want.numel()} values differ from the "
            f"plain version at R in {fit_kernel.ROWS_CHOICES} and through "
            f"the wrapper")
    inputs = fit_edge_inputs(750)
    m = inputs[0].shape[0]
    want = fc.fit_grid_plain(*inputs, m=m)
    for rows, got in fit_every_rows(inputs, m).items():
        check_fits(got, want, f"fit edges R={rows}")
    log(f"[fit] edges ({m} rows: seasons {FIT_EDGE_SEASONS} x valid counts "
        f"{FIT_EDGE_VALID} in each grid): 0 values differ at every R")
    # Bitwise: a row alone against the row padded into 1024, and row order.
    inputs = fit_inputs(1024, 800)
    full = fc.fit_grid(*inputs, m=1024)
    for r in (0, 333, 1023):
        one = fc.fit_grid(*(t[r:r + 1].contiguous() for t in inputs), m=1)
        require(torch.equal(one[:, 0], full[:, r]),
                f"padding 1 -> 1024 changed row {r}'s bits")
    perm = torch.randperm(1024, generator=torch.Generator().manual_seed(8))
    perm = perm.to(CUDA)
    permuted = fc.fit_grid(*(t[perm].contiguous() for t in inputs), m=1024)
    require(torch.equal(permuted, full[:, perm]),
            "row order changed a row's bits")
    log("[fit] bitwise: padding 1 -> 1024 and row order hold")
    timed = {label: fit_times(label, m, full)
             for label, (m, full) in FIT_TIMED.items()}
    probe = fit_probe()
    at = timed["M=1024"]
    default = f"R={fit_kernel.ROWS_PER_BLOCK}"
    return dict(max_abs_err=max_abs, kernel_ms=at["wrapper_ms"],
                launch_ms=at["launch_ms"][default],
                device_ms=at["device_ms"][default], plain_ms=at["plain_ms"],
                plain_ops=at["plain_ops"], bound_ms=at["bound_ms"],
                bound_by=at["bound_by"], bound_term=at["bound_term"],
                bounds_ms=at["bounds_ms"], by_rows=timed, probe=probe)


def fit_times(label, m, full):
    """Time one fit of ``m`` rows: the wrapper as the fit paths call it,
    the launch alone at each rows-per-block choice (CUDA events, in turns
    forward and back) and on the device (torch.profiler), and the plain
    version first and last, beside the bound."""
    inputs = fit_inputs(m, 900 + m, full=full)
    out = torch.empty((len(fc.FORECASTERS), m), dtype=torch.float32,
                      device=CUDA)
    calls = {"wrapper": lambda: fc.fit_grid(*inputs, m=m)}
    for rows in fit_kernel.ROWS_CHOICES:
        calls[f"R={rows}"] = (lambda rows=rows: fit_kernel.launch(
            *inputs, out, rows_per_block=rows))
    counter = OpCount()
    with counter:
        fc.fit_grid_plain(*inputs, m=m)
    p1 = time_ms(lambda: fc.fit_grid_plain(*inputs, m=m), 3)
    runs = {name: [] for name in calls}
    for turn in (list(calls), list(calls)[::-1]):
        for name in turn:
            runs[name].append(time_ms(calls[name], 200))
    p2 = time_ms(lambda: fc.fit_grid_plain(*inputs, m=m), 3)
    ms = {name: sum(t) / len(t) for name, t in runs.items()}
    on_device = {name: device_ms(calls[name], 200, "fit_grid_kernel")
                 for name in calls if name != "wrapper"}
    work = fit_kernel.work(m)
    bound_ms, term = work.bound()
    terms = work.bound_terms_ms()
    launch_ms = {name: ms[name] for name in on_device}
    fastest = min(on_device, key=lambda name: (on_device[name] is None,
                                               on_device[name]))
    log(f"[fit] {label}: wrapper "
        f"{'/'.join(f'{x:.4f}' for x in runs['wrapper'])} ms (R="
        f"{fit_kernel.ROWS_PER_BLOCK}); plain {p1:.2f}/{p2:.2f} ms "
        f"({counter.ops} PyTorch ops); bound {bound_ms:.4f} ms ({term}; "
        + ", ".join(f"{n} {x:.4f}" for n, x in terms.items()) + "); "
        "library: none")
    for rows in on_device:
        dev_ms = on_device[rows]
        log(f"[fit] {label} {rows}: launch "
            f"{'/'.join(f'{x:.4f}' for x in runs[rows])} ms (CUDA events), "
            + ("device not measured (no device time in the profiler's "
               "trace)" if dev_ms is None else
               f"device {dev_ms:.4f} ms (torch.profiler), "
               f"the bound is {100 * bound_ms / dev_ms:.1f}% of it"))
    log(f"[fit] {label}: fastest on the device {fastest}; the fit paths take "
        f"R={fit_kernel.ROWS_PER_BLOCK}")
    return dict(wrapper_ms=ms["wrapper"], launch_ms=launch_ms,
                device_ms=on_device, fastest=fastest, plain_ms=(p1 + p2) / 2,
                plain_ops=counter.ops, bound_ms=bound_ms,
                bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term, bounds_ms=terms)


# Probe builds of the fit kernel (FIT_GRID_PROBE in csrc/fit_grid.cu): the
# kernel stopped after its staging, and each role's lane alone.
FIT_PROBES = {"staging only": -1, "linear lane alone": 0,
              "Holt lane alone": 1, "Holt-Winters lane alone": 2}
FIT_PROBE_COLUMNS = 160 * 64


def _bind_probe(lib):
    fit_kernel._bind(lib)
    lib.fit_grid_chain_probe.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.fit_grid_chain_probe.restype = ctypes.c_int


def fit_probe():
    """Where a fit's device time goes, at R=ROWS_PER_BLOCK with full
    histories: the probe builds timed on the device (torch.profiler) at
    M=1 and M=1024, and the Holt-Winters lane's dependent chain alone in
    one thread (clock64), in cycles a column. Probe launches go to the
    library directly and do not count as the wrapper's."""
    libs = {name: cuda_build.Library(
        fit_kernel._SOURCE, _bind_probe,
        fit_kernel.LIBRARY.flags + (f"-DFIT_GRID_PROBE={value}",))
        for name, value in FIT_PROBES.items()}
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    stream = torch.cuda.current_stream().cuda_stream
    probes = {}
    for label in ("M=1", "M=1024 full"):
        m, full = FIT_TIMED[label]
        inputs = fit_inputs(m, 900 + m, full=full)
        out = torch.empty((len(fc.FORECASTERS), m), dtype=torch.float32,
                          device=CUDA)
        ptrs = [t.data_ptr() for t in (*inputs, out)]
        probes[label] = {}
        for name, lib in libs.items():
            launch = lib.load().fit_grid_launch

            def call(launch=launch, name=name):
                require(launch(*ptrs, m, fc.N_GRID, fit_kernel.ROWS_PER_BLOCK,
                               fit_kernel._WEIGHTS_C, stream) == 0,
                        f"probe {name} launch")

            probes[label][name] = device_ms(call, 200, "fit_grid_kernel")
        log(f"[fit] probe, {label}, R={fit_kernel.ROWS_PER_BLOCK}, device "
            "ms (torch.profiler): " + ", ".join(
                f"{name} {ms:.4f}" for name, ms in probes[label].items()
                if ms is not None))
    state = torch.tensor([1.0, 0.5, 0.25, 0.125], device=CUDA)
    cycles = torch.zeros(1, dtype=torch.int64, device=CUDA)
    lib = libs["staging only"].load()
    for _ in range(2):  # the second run is timed warm
        require(lib.fit_grid_chain_probe(
            state.data_ptr(), cycles.data_ptr(), FIT_PROBE_COLUMNS,
            fit_kernel._WEIGHTS_C, stream) == 0, "chain probe launch")
    torch.cuda.synchronize()
    per_column = int(cycles.item()) / FIT_PROBE_COLUMNS
    log(f"[fit] probe: the Holt-Winters chain alone in one thread takes "
        f"{per_column:.2f} cycles a column "
        f"({per_column / fit_kernel.CHAIN_OPS_PER_STEP:.2f} a dependent "
        f"operation; the bound counts "
        f"{cuda_build.CYCLES_PER_DEPENDENT_OP}) over {FIT_PROBE_COLUMNS} "
        f"columns (clock64)")
    return dict(device_ms=probes, chain_cycles_per_column=per_column)


# The forecast golden world, tests/goldens/make_forecast_trace.py restated
# here because that script imports the JAX package, and its backtest.
# tests/test_torch_forecast_golden.py holds these constants equal to the
# script's and the world built from them to the reference's.
FORECAST_PERIOD = 600.0
FORECAST_LEAD = 90.0
FORECAST_SECONDS = 2400.0
FORECAST_SEED = 20260804
FORECAST_GRID_STEP = 5.0
FORECAST_TRACE = os.path.join("tests", "goldens", "forecast_trace_v1.jsonl")
FORECAST_REPORT = os.path.join("tests", "goldens",
                               "forecast_backtest_v1.json")


def forecast_harness(device):
    """The world's harness: one Llama variant on v5e-8 under a diurnal
    load of period FORECAST_PERIOD, the saturation analyzer, the forecast
    planner on with the period declared, 30 s engine ticks; its engine on
    ``device`` and its cycle records kept in memory."""
    cfg = new_test_config()
    cfg.set_forecast(ForecastConfig(
        enabled=True, seasonal_period_seconds=FORECAST_PERIOD,
        grid_step_seconds=FORECAST_GRID_STEP,
        default_lead_time_seconds=FORECAST_LEAD, min_trust_evals=2))
    cfg.set_trace(TraceConfig(enabled=True, ring_size=TRACE_RING))
    spec = VariantSpec(
        name="llama-v5e", model_id=MODEL, accelerator="v5e-8",
        chips_per_replica=8, cost=10.0, initial_replicas=1,
        serving=ServingParams(engine="jetstream"),
        load=diurnal(base_rate=2.0, amplitude=22.0, period=FORECAST_PERIOD),
        hpa=HPAParams(stabilization_up_seconds=10.0,
                      stabilization_down_seconds=60.0,
                      sync_period_seconds=10.0))
    return EmulationHarness(
        [spec],
        saturation_config=SaturationScalingConfig(
            analyzer_name="saturation",
            anticipation_horizon_seconds=FORECAST_LEAD),
        config=cfg, startup_seconds=60.0, engine_interval=30.0,
        stochastic_seed=FORECAST_SEED, device=device)


def forecast_events(record):
    """A cycle record's ``forecast`` stage events: plans and applied
    floors."""
    return [ev for ev in record.get("stages", ())
            if ev.get("stage") == "forecast"]


def run_forecast_world(device):
    """Run the forecast golden world with its engine on ``device``: every
    cycle's decisions and forecast stage events, and the wall time."""
    fused.clear_solve_memo()
    drain_decision_bus()
    harness = forecast_harness(device)
    t0 = time.perf_counter()
    harness.run(FORECAST_SECONDS)
    wall_s = time.perf_counter() - t0
    records = harness.flight_recorder.snapshot()
    harness.manager.shutdown()
    return dict(cycles=[cycle_summary(r) for r in records],
                forecast=[forecast_events(r) for r in records],
                wall_s=wall_s)


def run_golden_backtest(device):
    return run_backtest(FORECAST_TRACE, lead=FORECAST_LEAD,
                        period=FORECAST_PERIOD, grid_step=FORECAST_GRID_STEP,
                        min_history=FORECAST_LEAD, device=device)


def on_one_thread(fn, *args):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


def phase_forecast():
    """The fit kernel on real seasonal series: the backtest of the
    committed forecast trace and the forecast golden world, each on the
    card (the fit kernel's count set to 0 just before it and read just
    after) and again with ``device="cpu"`` (the plain version)."""
    with open(FORECAST_REPORT, encoding="utf-8") as f:
        golden = json.load(f)
    fit_kernel.launches = 0
    t0 = time.perf_counter()
    card = run_golden_backtest(None)
    backtest_s = time.perf_counter() - t0
    backtest_launches = fit_kernel.launches
    cpu = on_one_thread(run_golden_backtest, "cpu")
    for where, report in (("card", card), ("cpu", cpu)):
        problems = compare_to_golden(report, golden)
        require(not problems, f"backtest on the {where}: {problems}")
    require(card["ranking"] == cpu["ranking"] == golden["ranking"],
            f"rankings {card['ranking']} (card), {cpu['ranking']} (cpu)")
    results = differ = 0
    for key, per_model in cpu["models"].items():
        for name, fields in per_model.items():
            for field, value in fields.items():
                results += 1
                differ += card["models"][key][name][field] != value
    require(backtest_launches > 0, "the backtest launched no fit kernel")
    log(f"[backtest] {FORECAST_TRACE} (lead {FORECAST_LEAD:g} s, period "
        f"{FORECAST_PERIOD:g} s, grid step {FORECAST_GRID_STEP:g} s): card "
        f"and CPU both pass the golden gate, ranking {card['ranking']}; "
        f"{differ} of {results} per-forecaster results differ in bits "
        f"between them; {backtest_launches} fit launches at M=1, "
        f"{backtest_s:.2f} s on the card")

    fit_kernel.launches = 0
    world = run_forecast_world(None)
    world_launches = fit_kernel.launches
    oracle = on_one_thread(run_forecast_world, "cpu")
    n = len(oracle["cycles"])
    require(n > 0 and world["cycles"] == oracle["cycles"],
            "the forecast world's cycles differ between card and CPU: " + next(
                (f"{a} != {b}" for a, b in zip(world["cycles"],
                                               oracle["cycles"]) if a != b),
                f"{len(world['cycles'])} against {n} cycles"))
    require(world_launches > 0, "the forecast world launched no fit kernel")
    events_differ = sum(a != b for a, b in zip(world["forecast"],
                                               oracle["forecast"]))
    log(f"[forecast world] {FORECAST_SECONDS:.0f} emulated s, period "
        f"{FORECAST_PERIOD:g} s, 30 s ticks: card and CPU decide alike in all "
        f"{n} cycles (desired, target, action, set_by); {events_differ} "
        f"cycles' forecast stage events differ in bits; {world_launches} fit "
        f"launches; {world['wall_s']:.1f} s on the card, "
        f"{oracle['wall_s']:.1f} s on the CPU")
    return dict(backtest_launches=backtest_launches,
                backtest_results_differ=differ, backtest_results=results,
                backtest_s=backtest_s, ranking=card["ranking"],
                world_launches=world_launches, world_cycles=n,
                world_event_cycles_differ=events_differ,
                world_wall_s=world["wall_s"])


# ---------------------------------------------------------------- phase 5

DRYRUN_SHARDS = (1, 2, 4, 8)


def phase_entry():
    """The graft entry points on the card: ``entry()``'s forward step, and
    ``dryrun_multichip(n)`` for each n in DRYRUN_SHARDS (logical shards on
    the one card unless the process has n cards), each with the sizing
    kernel's count set to 0 just before it and read just after."""
    sizing_kernel.launches = 0
    fn, args = graft.entry()
    rate = fn(*args)
    entry_launches = sizing_kernel.launches
    torch.cuda.synchronize()
    require(rate.is_cuda and rate.shape == (8,), f"entry: {rate.shape}")
    require(bool(torch.isfinite(rate).all() and (rate > 0).all()),
            f"entry: rates {rate.tolist()}")
    want = fn(*(graft._to(args, "cpu")))
    err = float(((rate.cpu() - want).abs() / want.abs()).max())
    require(err <= RTOL, f"entry: card against CPU max rel {err:.3g}")
    require(entry_launches == 1, f"entry: {entry_launches} sizing launches")
    log(f"[entry] entry ok: {rate.cpu().numpy()[:4]}; against the plain "
        f"version on the CPU max rel {err:.3g}; {entry_launches} sizing "
        f"launch")
    dryrun = {}
    for n in DRYRUN_SHARDS:
        sizing_kernel.launches = 0
        t0 = time.perf_counter()
        out = graft.dryrun_multichip(n)
        seconds = time.perf_counter() - t0
        launches = sizing_kernel.launches
        want = fn(*graft._example_batch(2 * n, device="cpu")).numpy()
        cost_per_rate = np.linspace(1.0, 10.0, 2 * n, dtype=np.float32) / (
            np.maximum(want, 1e-9))
        require(out["best"] == int(np.argmin(cost_per_rate)),
                f"dryrun {n}: best {out['best']} on the card, "
                f"{int(np.argmin(cost_per_rate))} on the CPU")
        rel = float(np.max(np.abs(out["rate"] - want) / want))
        require(rel <= RTOL, f"dryrun {n}: card against CPU max rel {rel}")
        require(launches == 2 * n + 1,
                f"dryrun {n}: {launches} sizing launches, expected {2 * n + 1}")
        edge = out["edge_rate"].view(np.int32).astype(np.int64)
        ulps = np.abs(edge - out["edge_unsharded"].view(np.int32))
        require(not ulps.any(), f"dryrun {n}: edge rows differ from the "
                f"unsharded solve by up to {int(ulps.max())} ulp")
        log(f"[entry] dryrun_multichip({n}): {seconds:.2f} s, {launches} "
            f"sizing launches (each shard's solve, twice, and the edge "
            f"rows); best {out['best']} as on the CPU, rates at max rel "
            f"{rel:.3g}; chunked C={out['c2']}: {int((ulps > 0).sum())} of "
            f"{len(ulps)} edge rows differ in bits from the unsharded solve, "
            f"max {int(ulps.max())} ulp; "
            + ("distinct cards" if out["distinct_devices"]
               else "logical shards on one card"))
        dryrun[n] = dict(launches=launches, seconds=seconds, best=out["best"],
                         max_rel_vs_cpu=rel, edge_max_ulp=int(ulps.max()),
                         distinct_devices=out["distinct_devices"])
    return dict(entry_launches=entry_launches, entry_max_rel=err,
                dryrun=dryrun)


# ---------------------------------------------------------------- phase 6

# The headline emulated world, bench.py's run_policy("ours-realistic"),
# restated here because bench.py imports the JAX package.
# tests/test_torch_isolation.py holds these constants, and the world built
# from them, equal to bench.py's.
MODEL = "meta-llama/Llama-3.1-8B"
SLO_TTFT_SECONDS = 1.0
WARMUP_SECONDS = 180.0
RAMP_SECONDS = 300.0
HOLD_SECONDS = 1200.0
DOWN_SECONDS = 300.0
TAIL_SECONDS = 300.0
BASE_RATE = 4.0
PEAK_RATE = 90.0
STARTUP_SECONDS = 120.0
STOCHASTIC_SEED = 20260730
TOKEN_MIXTURE = ((0.50, 256, 128), (0.35, 640, 320), (0.15, 1064, 512))
MISCAL_FACTOR = 2.0
PROFILE_ALPHA_MS = 18.0
PROFILE_BETA = 0.00267
PROFILE_GAMMA = 0.00002
TRUE_PARMS = (PROFILE_ALPHA_MS, PROFILE_BETA, PROFILE_GAMMA)
FAST_HPA = dict(stabilization_up_seconds=10.0,
                stabilization_down_seconds=120.0,
                sync_period_seconds=10.0)
ENGINE_INTERVAL = 5.0
ARRIVAL_RATE_WINDOW = "30s"
WORLD_SECONDS = (WARMUP_SECONDS + RAMP_SECONDS + HOLD_SECONDS + DOWN_SECONDS
                 + TAIL_SECONDS)
ORACLE_SECONDS = 600.0  # warm-up and ramp
# What the world reaches in the reference (BENCH_LOCAL.json,
# detail.ours_realistic) and the band ROADMAP A5(d) allows its chip-seconds.
WORLD_PEAK_SLICES = 8
WORLD_END_SLICES = 4
CHIP_SECONDS_BAND = (121_160, 121_800)
TUNER_MIN_STEPS = 300
TUNER_ALPHA_RTOL = 0.10
# The tuner's first state in the world (the profile 2x off) and a ramp
# operating point: env = (lambda per ms, avg input tokens, avg output
# tokens, max batch, k). There lambda is clipped to lambda_max.
TUNER_X = (PROFILE_ALPHA_MS * MISCAL_FACTOR, PROFILE_BETA * MISCAL_FACTOR,
           PROFILE_GAMMA * MISCAL_FACTOR)
TUNER_ENV = (40.0 / 1000.0, 512.0, 253.0, 96.0, 480.0)
# Where the EKF jacobian kernel's branches turn, at TUNER_X: name -> env.
# tests/test_torch_jacobian_host.py holds each to its branch.
JACOBIAN_EDGES = {
    "lambda clipped high": TUNER_ENV,
    "lambda clipped low": (1e-9, 512.0, 253.0, 96.0, 480.0),
    "lambda unclipped": (0.005, 512.0, 253.0, 96.0, 480.0),
    "k = 1": (0.005, 512.0, 253.0, 96.0, 1.0),
    "k = B": (0.005, 512.0, 253.0, 96.0, 96.0),
    "k = 2048": (0.005, 512.0, 253.0, 96.0, 2048.0),
    "no prompt": (0.005, 0.0, 253.0, 96.0, 480.0),
    "output under one token": (0.005, 512.0, 0.5, 96.0, 480.0),
}
TRACE_RING = 4096  # more cycle records than the world makes


def world_saturation_config():
    true_slope = (PEAK_RATE - BASE_RATE) / RAMP_SECONDS
    cfg = SaturationScalingConfig(
        analyzer_name="slo",
        anticipation_horizon_seconds=STARTUP_SECONDS + 30.0,
        burst_slope_rps=true_slope / 2.0,
        headroom_replicas=1,
        enable_limiter=True,
        fast_actuation=True)
    cfg.apply_defaults()
    return cfg


def world_variant():
    return VariantSpec(
        name="llama-v5e", model_id=MODEL, accelerator="v5e-8",
        chips_per_replica=8, cost=10.0, initial_replicas=1,
        serving=ServingParams(engine="jetstream", token_mixture=TOKEN_MIXTURE,
                              latency_parms=TRUE_PARMS),
        load=trapezoid(BASE_RATE, PEAK_RATE, RAMP_SECONDS, HOLD_SECONDS,
                       DOWN_SECONDS, tail=TAIL_SECONDS, delay=WARMUP_SECONDS),
        hpa=HPAParams(**FAST_HPA))


def world_slo_config():
    """Profiles 2x off the world's true parameters, the EKF tuner live."""
    return SLOConfigData(
        service_classes=[ServiceClass(
            name="premium", priority=1,
            model_targets={MODEL: TargetPerf(
                target_ttft_ms=SLO_TTFT_SECONDS * 1000.0)})],
        profiles=[PerfProfile(
            model_id=MODEL, accelerator="v5e-8",
            service_parms=ServiceParms(alpha=PROFILE_ALPHA_MS * MISCAL_FACTOR,
                                       beta=PROFILE_BETA * MISCAL_FACTOR,
                                       gamma=PROFILE_GAMMA * MISCAL_FACTOR),
            max_batch_size=96, max_queue_size=384)],
        tuner_enabled=True)


def world_harness(device, config=None):
    """The world's harness, its engine on ``device``. The arrival-rate
    window is read when the harness registers its queries."""
    os.environ["WVA_SLO_ARRIVAL_RATE_WINDOW"] = ARRIVAL_RATE_WINDOW
    try:
        harness = EmulationHarness(
            [world_variant()],
            saturation_config=world_saturation_config(),
            config=config,
            nodepools=[("v5e-pool", "v5e", "2x4", 8)],
            startup_seconds=STARTUP_SECONDS,
            engine_interval=ENGINE_INTERVAL,
            stochastic_seed=STOCHASTIC_SEED,
            device=device)
    finally:
        os.environ.pop("WVA_SLO_ARRIVAL_RATE_WINDOW", None)
    harness.config.update_slo_config(world_slo_config())
    return harness


def cycle_summary(record):
    """One engine cycle's decisions: (variant, desired, target, action, the
    stage that set the final number)."""
    return [record.get("engine"), record.get("cycle"), [
        [d["variant_name"], d["desired_replicas"], d["target_replicas"],
         d["action"], explain_decision(record, d)["set_by"]]
        for d in record.get("decisions", ())]]


def run_world(device, seconds=WORLD_SECONDS, config=None, statuses=False):
    """Run the headline world for ``seconds`` emulated seconds with its
    engine on ``device``. Returns bench.py's headline numbers (measured from
    ramp onset), the tuner's state, every cycle's decisions and trace
    record, host-clock times of the tick and its stages, and with
    ``statuses`` every VA status after every step."""
    config = config or new_test_config()
    config.set_trace(TraceConfig(enabled=True, ring_size=TRACE_RING))
    fused.clear_solve_memo()
    drain_decision_bus()
    harness = world_harness(device, config)
    engine = harness.manager.engine
    times = {"tick": [], "tuner step": [], "grids": [], "fused program": []}
    tick_gc = []
    tuner_log = []  # (NIS, rejected) of every tuner step

    def timed(fn, label, keep=lambda out: True):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if keep(out):
                times[label].append(1e3 * (time.perf_counter() - t0))
            return out
        return wrapper

    def logged(out):
        if out is not None:
            tuner_log.append((out.nis, out.validation_failed))
        return out is not None

    engine.slo_tuner.observe = timed(engine.slo_tuner.observe, "tuner step",
                                     keep=logged)
    engine._fused_prepare = timed(engine._fused_prepare, "grids")
    engine._fused_dispatch = timed(engine._fused_dispatch, "fused program")
    dispatch_timed = engine._fused_dispatch

    def kept(grids, prep):
        state["grids"] = grids
        return dispatch_timed(grids, prep)

    engine._fused_dispatch = kept
    on_tick = engine.executor.on_tick

    def observe_tick(name, elapsed, ok):
        t1 = time.perf_counter()
        times["tick"].append(1e3 * elapsed)
        tick_gc.append(gc_clock.within(t1 - elapsed, t1))
        if on_tick is not None:
            on_tick(name, elapsed, ok)

    engine.executor.on_tick = observe_tick
    state = {"peak": 1, "chip_seconds": 0.0, "last": None, "statuses": [],
             "grids": None}

    def watch(h, t):
        reps = h.replicas_of("llama-v5e")
        state["peak"] = max(state["peak"], reps)
        if t >= WARMUP_SECONDS:
            dt = t - state["last"] if state["last"] is not None else 0.0
            state["chip_seconds"] += reps * h.variants[0].chips_per_replica * dt
        state["last"] = t
        if statuses:
            state["statuses"].append(json.dumps(
                {va.metadata.name: bb_encode(va.status) for va in
                 h.cluster.list("VariantAutoscaling",
                                namespace=h.namespace)}, sort_keys=True))

    t0 = time.perf_counter()
    with GcClock() as gc_clock:
        harness.run(seconds, on_step=watch)
    wall_s = time.perf_counter() - t0
    sim = harness.sim_of_model(MODEL)
    tuner = next(iter(engine.slo_tuner._tuners.values()), None)
    sp = engine.slo_analyzer.profiles.get(
        MODEL, "v5e-8", namespace=harness.namespace).service_parms
    records = harness.flight_recorder.snapshot()
    out = dict(
        slo_attainment=sim.slo_attainment(
            SLO_TTFT_SECONDS, since=harness.start_time + WARMUP_SECONDS),
        peak_slices=state["peak"],
        slices_at_end=harness.replicas_of("llama-v5e"),
        chip_seconds=int(state["chip_seconds"]),
        requests_served=sim.completed_total,
        tuner=dict(steps=tuner.steps if tuner else 0,
                   nis_rejected=tuner.rejected if tuner else 0,
                   final_parms=[sp.alpha, sp.beta, sp.gamma]),
        tuner_log=tuner_log,
        cycles=[cycle_summary(r) for r in records],
        records=records, statuses=state["statuses"], wall_s=wall_s,
        times=times, tick_gc=tick_gc, last_grids=state["grids"])
    harness.manager.shutdown()
    return out


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def device_busy_ms(fn, reps, warm=True):
    """Device time of every CUDA kernel ``fn`` launches, and their count,
    per call, over ``reps`` calls (after one more unless not ``warm``),
    from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = [e for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0.0) > 0]
    return (sum(e.self_device_time_total for e in busy) / reps / 1e3,
            sum(e.count for e in busy) / reps)


def jacobian_rows_err(got, want):
    """(largest abs difference, largest difference relative to h or to its
    H row's largest entry, largest relative to its own entry) of two
    ``[2, 4]`` outputs."""
    got, want = (t.double().cpu() for t in (got, want))
    scale = torch.cat([want[:, :1].abs(),
                       want[:, 1:].abs().amax(dim=1, keepdim=True)
                       .expand(2, 3)], dim=1)
    diff = (got - want).abs()
    own = torch.where(diff == 0, 0.0, diff / want.abs())
    return (float(diff.max()), float((diff / scale).max()), float(own.max()))


def jacobian_vs_plain():
    """The jacobian kernel against its plain version (``jacfwd``) on the same CUDA tensors at TUNER_X and every
    JACOBIAN_EDGES point: every entry of h and H at rtol RTOL, and each
    entry of H within RTOL of its row's largest entry (the row's rule alone
    would not see an error in a column far smaller than the row's largest,
    dh/dalpha beside dh/dgamma)."""
    x = torch.tensor(TUNER_X, dtype=torch.float32, device=CUDA)
    errs = {}
    for name, env in JACOBIAN_EDGES.items():
        e = torch.tensor(env, dtype=torch.float32, device=CUDA)
        got = jacobian_kernel.launch(x, e)
        h, jac = ekf.observe_and_jacobian_plain(x, e)
        want = torch.cat([h[:, None], jac], dim=1)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
                f"jacobian at {name}: {got.tolist()} against {want.tolist()}")
        errs[name] = jacobian_rows_err(got, want)
        require(errs[name][1] <= RTOL and errs[name][2] <= RTOL,
                f"jacobian at {name}: {got.tolist()} against {want.tolist()}")
    max_abs, max_rel, max_entry = (max(e[i] for e in errs.values())
                                   for i in range(3))
    log(f"[jacobian] kernel against jacfwd on the card at {len(errs)} points "
        f"(x {TUNER_X}): largest difference {max_rel:.3g} of h or its H "
        f"row's largest entry, {max_entry:.3g} of its own entry (tolerance "
        f"{RTOL} each), {max_abs:.4g} absolute; "
        + ", ".join(f"{n} {e[1]:.2g}" for n, e in errs.items()))
    return dict(max_abs_err=max_abs, max_rel_err=max_rel,
                max_entry_rel_err=max_entry,
                rel_err_by_point={n: e[1] for n, e in errs.items()})


def host_ms(fn, reps):
    """Mean host-clock ms of ``fn`` (which ends by reading the card) over
    ``reps`` calls, after one more."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def tuner_step_ops():
    """One tuner step's h and H on the card at TUNER_X and TUNER_ENV: the
    kernel through the tuner's wrapper and its launch alone (CUDA events, in
    turns with the plain version), on the device (torch.profiler); the
    plain version's PyTorch ops, time and device busy time; the bound. On
    the host clock: a whole ``KalmanTuner.run`` there, and its h and H alone
    (the copy up, the launch, the copy down)."""
    x = torch.tensor(TUNER_X, dtype=torch.float32, device=CUDA)
    env = torch.tensor(TUNER_ENV, dtype=torch.float32, device=CUDA)
    calls = {"plain": lambda: ekf.observe_and_jacobian_plain(x, env),
             "wrapper": lambda: ekf._observe_and_jacobian(x, env),
             "launch": lambda: jacobian_kernel.launch(x, env)}
    calls["plain"]()
    with OpCount() as count:
        calls["plain"]()
    runs = {name: [] for name in calls}
    for turn in (list(calls), list(calls)[::-1]):
        for name in turn:
            runs[name].append(time_ms(calls[name], 20 if name == "plain"
                                      else 1000))
    ms = {name: sum(t) / len(t) for name, t in runs.items()}
    device = device_ms(calls["launch"], 200, "jacobian_kernel")
    busy_ms, kernels = device_busy_ms(calls["plain"], 20)
    work = jacobian_kernel.work(count.pointwise_elements)
    bound_ms, term = work.bound()
    h = calls["wrapper"]()[0].tolist()
    kalman = ekf.KalmanTuner(ServiceParms(*TUNER_X), device=CUDA)
    observed = ekf.TunerEnvironment(
        lambda_per_min=TUNER_ENV[0] * 60_000.0,
        avg_input_tokens=TUNER_ENV[1], avg_output_tokens=TUNER_ENV[2],
        max_batch_size=int(TUNER_ENV[3]),
        max_queue_size=int(TUNER_ENV[4] - TUNER_ENV[3]),
        avg_ttft_ms=h[0], avg_itl_ms=h[1])
    inputs = [*TUNER_X, *TUNER_ENV]

    def observation():
        up = torch.tensor(inputs, dtype=torch.float32, device=CUDA)
        return ekf._observation(up[:3], up[3:]).cpu()

    step_host = dict(run_ms=host_ms(lambda: kalman.run(observed), 200),
                     observation_ms=host_ms(observation, 200))
    return dict(wrapper_ms=ms["wrapper"], launch_ms=ms["launch"],
                host=step_host, device_ms=device, runs_ms=runs, plain_ms=ms["plain"],
                plain_ops=count.ops, plain_device_busy_ms=busy_ms,
                plain_kernels=kernels,
                pointwise_elements=count.pointwise_elements,
                bound_ms=bound_ms, bound_term=term,
                bound_by="bytes" if term == "bytes" else "operations",
                bounds_ms=work.bound_terms_ms())


def first_flag_difference(log_a, log_b):
    """The first tuner step whose accept flag differs between two runs'
    (NIS, rejected) logs, as text, or None."""
    for i, (a, b) in enumerate(zip(log_a, log_b)):
        if a[1] != b[1]:
            return (f"step {i}: rejected {a[1]} (NIS {a[0]:.6g}) against "
                    f"{b[1]} (NIS {b[0]:.6g})")
    return None


def world_times():
    """The headline world on the card alone: its tick and tuner-step times
    and the tuner's outcome, using only what every version of the port has
    (copy the script into an older checkout to compare two trees in one
    call), with every tuner step's (NIS, rejected) in ``tuner_log``: two
    runs' lines go to ``first_flag_difference``."""
    world = run_world(None)
    tick, steps = world["times"]["tick"], world["times"]["tuner step"][1:]
    # Each stage's median over the ticks that ran it, its first run left
    # out (a fresh process builds each kernel at its first call).
    stage_p50 = {k: _percentile(v[1:], 50)
                 for k, v in world["times"].items() if k != "tick" and v[1:]}
    return dict(
        slo_attainment=world["slo_attainment"],
        peak_slices=world["peak_slices"],
        slices_at_end=world["slices_at_end"],
        chip_seconds=world["chip_seconds"], tuner=world["tuner"],
        wall_s=world["wall_s"],
        tick_ms=dict(mean=sum(tick) / len(tick), p50=_percentile(tick, 50),
                     p99=_percentile(tick, 99), ticks=len(tick)),
        per_tick_ms={k: sum(v) / len(tick)
                     for k, v in world["times"].items() if k != "tick"},
        stage_p50_ms=stage_p50,
        tuner_step_ms=dict(mean=sum(steps) / len(steps),
                           p50=_percentile(steps, 50),
                           p99=_percentile(steps, 99),
                           first=world["times"]["tuner step"][0]),
        tuner_log=world["tuner_log"])


# The fused program's parts, in the order a solve tick runs them: the chain
# setup before the sizing kernel, its launch, the tail after it (the chain
# statistics at the binding rate), the forecaster fits, and the rest (the
# stack of the rows read and the one host transfer).
FUSED_SEGMENTS = ("setup", "sizing", "tail", "fits", "transfer")


class _Segments:
    """Where the fused program is: the wrappers of ``fused_split`` move it
    from segment to segment, and it adds the host-clock time spent in each.
    With ``sync`` it waits for the card at every move, and with
    ``annotate`` it marks each segment for torch.profiler."""

    def __init__(self):
        self.sync = self.annotate = False
        self.reset()

    def reset(self):
        self.ms = dict.fromkeys(FUSED_SEGMENTS, 0.0)
        self.ops = dict.fromkeys(FUSED_SEGMENTS, 0)
        self.label, self.t, self._mark = "transfer", time.perf_counter(), None

    def move(self, label):
        if self.sync:
            torch.cuda.synchronize()
        if self._mark is not None:
            self._mark.__exit__(None, None, None)
            self._mark = None
        now = time.perf_counter()
        self.ms[self.label] += 1e3 * (now - self.t)
        self.label, self.t = label, now
        if self.annotate and label is not None:
            self._mark = torch.profiler.record_function(f"fused:{label}")
            self._mark.__enter__()


class _SegmentOps(TorchDispatchMode):
    """Counts the PyTorch ops dispatched in each segment."""

    def __init__(self, segments):
        super().__init__()
        self.segments = segments

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.segments.ops[self.segments.label] += 1
        return func(*args, **(kwargs or {}))


def fused_split(grids, reps=100, plain_chain=False):
    """The fused program (``fused.run``, memo off) on one tick's ``grids``,
    split into FUSED_SEGMENTS by wrapping the functions at their borders
    (``queue_model._size_batch_core``, the sizing bisection, the program's
    ``_fits``), which every version of the port has: per segment the host
    ms a call (no synchronisation but the transfer's own; mean of ``reps``
    calls), the PyTorch ops and, under torch.profiler with the card
    synchronised at every border, the card's kernels and copies and their
    device ms. With ``plain_chain`` the chain setup and the tail run their
    plain versions (the PyTorch ops the sizing path ran around the sizing
    kernel before those kernels existed) and the sizing and fit kernels
    stay."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wva_tpu_torch.fused import program

    seg = _Segments()

    def border(fn, enter, leave):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            seg.move(enter)
            try:
                return fn(*args, **kwargs)
            finally:
                seg.move(leave)
        return wrapper

    saved = [(qm, "_size_batch_core"), (sizing_kernel, "sizing_bisection"),
             (sizing_kernel, "sizing_bisection_plain"), (program, "_fits")]
    if plain_chain:
        saved += [(chain_setup, "chain_setup"), (chain_stats, "size_tail")]
    originals = [getattr(owner, name) for owner, name in saved]
    for (owner, name), fn in zip(saved, originals):
        if name == "chain_setup":
            setattr(owner, name, chain_setup.chain_setup_plain)
            continue
        if name == "size_tail":
            setattr(owner, name, chain_stats.size_tail_plain)
            continue
        enter, leave = {"_size_batch_core": ("setup", "transfer"),
                        "_fits": ("fits", "transfer")}.get(
                            name, ("sizing", "tail"))
        setattr(owner, name, border(fn, enter, leave))

    def call():
        seg.move("transfer")
        program.run(grids, memo=False)
        seg.move("transfer")

    try:
        call()
        torch.cuda.synchronize()
        seg.reset()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        total_ms = 1e3 * (time.perf_counter() - t0) / reps
        host = {k: v / reps for k, v in seg.ms.items()}
        seg.reset()
        with _SegmentOps(seg):
            call()
        ops = dict(seg.ops)
        seg.sync = seg.annotate = True
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            seg.move(None)
            torch.cuda.synchronize()
    finally:
        seg.sync = seg.annotate = False
        for (owner, name), fn in zip(saved, originals):
            setattr(owner, name, fn)
    events = prof.events()
    marks = [(e.name.split(":", 1)[1], e.time_range) for e in events
             if e.name.startswith("fused:")]
    # The card's side of each mark is an event of its own: not a kernel.
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("fused:")]
    kernels = dict.fromkeys(FUSED_SEGMENTS, 0)
    device_ms = dict.fromkeys(FUSED_SEGMENTS, 0.0)
    for e in device:
        where = next((label for label, r in marks
                      if r.start <= e.time_range.start <= r.end), None)
        if where is not None:
            kernels[where] += 1
            device_ms[where] += e.time_range.elapsed_us() / 1e3
    if not device:
        # The trace holds no device activity (PERF.md §7): not measured.
        kernels = device_ms = dict.fromkeys(FUSED_SEGMENTS)
    return dict(c=int(grids.cand.alpha.shape[0]), k_cols=grids.k_cols,
                m_bucket=grids.m_bucket, host_ms=host, call_ms=total_ms,
                ops=ops, kernels=kernels, device_ms=device_ms,
                kernels_in_trace=len(device),
                kernel_names=sorted({e.name for e in device}))


def log_fused_split(split, label):
    log(f"[fused] {label}: the fused program on the headline world's last "
        f"solve tick's grids (C={split['c']}, k_cols={split['k_cols']}, "
        f"M={split['m_bucket']}), memo off: {split['call_ms']:.4f} ms a call "
        f"(host clock); by part, host ms / ops / kernels and copies / "
        f"device ms: "
        + ", ".join(f"{k} {split['host_ms'][k]:.4f} / {split['ops'][k]} / "
                    + ("not measured / not measured"
                       if split["kernels"][k] is None else
                       f"{split['kernels'][k]} / {split['device_ms'][k]:.4f}")
                    for k in FUSED_SEGMENTS)
        + (f"; {split['kernels_in_trace']} kernels in the trace "
           f"({sum(split['kernels'].values())} placed)"
           if split["kernels_in_trace"] else
           "; the profiler's trace held no device activity"))


def fused_split_times():
    """The headline world's first ORACLE_SECONDS on the card, then
    ``fused_split`` on its last solve tick's grids, using only what every
    version of the port has (copy the script into an older checkout to
    compare two trees in one call)."""
    world = run_world(None, ORACLE_SECONDS)
    return fused_split(world["last_grids"])


def phase_world():
    """The jacobian kernel against its plain version, then the headline
    world on the card (the main path: the three kernels' counts set to 0
    just before it and read just after), then its first ORACLE_SECONDS on
    the CPU through the plain versions."""
    jacobian = jacobian_vs_plain()
    sizing_kernel.launches = fit_kernel.launches = 0
    jacobian_kernel.launches = 0
    chain_setup.launches = chain_stats.launches = 0
    world = run_world(None)
    launches = (sizing_kernel.launches, fit_kernel.launches,
                jacobian_kernel.launches, chain_setup.launches,
                chain_stats.launches)
    split = {"before": fused_split(world["last_grids"], plain_chain=True),
             "after": fused_split(world["last_grids"])}
    log_fused_split(split["before"], "before (the chain kernels' plain "
                    "versions, the PyTorch ops the sizing path ran around "
                    "the sizing kernel before them)")
    log_fused_split(split["after"], "after (the chain kernels)")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        oracle = run_world("cpu", ORACLE_SECONDS)
    finally:
        torch.set_num_threads(threads)
    step = tuner_step_ops()
    times = world["times"]
    tick = times["tick"]
    # The first tuner step loads the kernel's library; it is reported on its
    # own and left out of the step's distribution (not out of the ticks').
    first_step, steps = times["tuner step"][0], times["tuner step"][1:]
    log(f"[world] {WORLD_SECONDS:.0f} emulated s in {world['wall_s']:.1f} s "
        f"wall: attainment {world['slo_attainment']}, peak "
        f"{world['peak_slices']} slices, {world['slices_at_end']} at the end, "
        f"{world['chip_seconds']} chip-seconds, {world['requests_served']} "
        f"requests; sizing launches {launches[0]}, fit launches "
        f"{launches[1]}, jacobian launches {launches[2]}, chain setup "
        f"launches {launches[3]}, chain stats launches {launches[4]}")
    log(f"[world] engine tick ms over {len(tick)} ticks: mean "
        f"{sum(tick) / len(tick):.2f}, p50 {_percentile(tick, 50):.2f}, p99 "
        f"{_percentile(tick, 99):.2f}, max {max(tick):.2f} (host clock)")
    gc_ms = [g[0] for g in world["tick_gc"]]
    slowest = sorted(range(len(tick)), key=lambda i: -tick[i])[:5]
    log(f"[world] gc in the engine ticks: {sum(gc_ms) / len(tick):.2f} ms a "
        f"tick, {sum(bool(g[1].get(2)) for g in world['tick_gc'])} ticks "
        f"with a generation-2 collection; the slowest ticks (ms, gc ms, "
        f"collections by generation): " + ", ".join(
            f"{tick[i]:.1f}/{gc_ms[i]:.1f}/{world['tick_gc'][i][1]}"
            for i in slowest))
    per_tick = {k: sum(v) / len(tick) for k, v in times.items()
                if k != "tick"}
    log("[world] per tick, mean ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in per_tick.items())
        + f", the rest {sum(tick) / len(tick) - sum(per_tick.values()):.2f}"
        " (host clock)")
    log(f"[world] tuner: {world['tuner']['steps']} steps, "
        f"{world['tuner']['nis_rejected']} NIS rejections, final (alpha, "
        f"beta, gamma) {world['tuner']['final_parms']} against {TRUE_PARMS}; "
        f"step ms after the first: mean {sum(steps) / len(steps):.3f}, p50 "
        f"{_percentile(steps, 50):.3f}, p99 {_percentile(steps, 99):.3f}; "
        f"the first {first_step:.1f} (host clock)")
    log(f"[world] one step's h and H (x {TUNER_X}, env {TUNER_ENV}): the "
        f"kernel through the wrapper "
        f"{'/'.join(f'{t:.4f}' for t in step['runs_ms']['wrapper'])} ms, "
        f"its launch alone "
        f"{'/'.join(f'{t:.4f}' for t in step['runs_ms']['launch'])} ms "
        f"(CUDA events), "
        + ("on the device not measured (no device time in the profiler's "
           "trace)" if step["device_ms"] is None else
           f"on the device {step['device_ms']:.5f} ms (torch.profiler)")
        + f"; the plain jacfwd "
        f"{'/'.join(f'{t:.3f}' for t in step['runs_ms']['plain'])} ms "
        f"(CUDA events), {step['plain_ops']} PyTorch ops, the device busy "
        f"{step['plain_device_busy_ms']:.3f} ms in "
        f"{step['plain_kernels']:.0f} kernels (profiler); the bound "
        f"{step['bound_ms']:.6f} ms ({step['bound_term']}; "
        + ", ".join(f"{n} {x:.6f}" for n, x in step["bounds_ms"].items())
        + f"; {step['pointwise_elements']} pointwise elements); library: "
        f"none. On the host clock: KalmanTuner.run "
        f"{step['host']['run_ms']:.4f} ms, its h and H with both copies "
        f"{step['host']['observation_ms']:.4f} ms")
    require(world["slo_attainment"] == 1.0,
            f"attainment {world['slo_attainment']}")
    require(world["peak_slices"] == WORLD_PEAK_SLICES,
            f"peak {world['peak_slices']} slices")
    require(world["slices_at_end"] == WORLD_END_SLICES,
            f"{world['slices_at_end']} slices at the end")
    lo, hi = CHIP_SECONDS_BAND
    require(lo <= world["chip_seconds"] <= hi,
            f"chip-seconds {world['chip_seconds']} outside {lo}-{hi}")
    require(launches[0] > 0 and launches[1] > 0,
            f"world launches: sizing {launches[0]}, fit {launches[1]}")
    require(world["tuner"]["steps"] > TUNER_MIN_STEPS,
            f"{world['tuner']['steps']} tuner steps")
    require(launches[2] == world["tuner"]["steps"],
            f"{launches[2]} jacobian launches in "
            f"{world['tuner']['steps']} tuner steps")
    require(launches[3] == launches[4] == launches[0],
            f"world launches: chain setup {launches[3]} and chain stats "
            f"{launches[4]} in {launches[0]} solves")
    alpha = world["tuner"]["final_parms"][0]
    require(abs(alpha - TRUE_PARMS[0]) <= TUNER_ALPHA_RTOL * TRUE_PARMS[0],
            f"tuner alpha {alpha}")
    n = len(oracle["cycles"])
    require(n > 0 and world["cycles"][:n] == oracle["cycles"],
            "the CPU oracle's cycles differ from the card's: " + next(
                (f"{a} != {b}" for a, b in zip(world["cycles"],
                                               oracle["cycles"]) if a != b),
                f"{len(world['cycles'])} against {n} cycles"))
    flags = first_flag_difference(world["tuner_log"], oracle["tuner_log"])
    log(f"[world] the CPU oracle ({ORACLE_SECONDS:.0f} emulated s, plain "
        f"versions, {oracle['wall_s']:.1f} s wall) decides as the card in "
        f"all {n} cycles: desired, target, action and set_by; its "
        f"{len(oracle['tuner_log'])} tuner steps' accept flags "
        + (f"differ from the card's first at {flags}" if flags else
           "equal the card's"))
    return dict(
        launches=launches, wall_s=world["wall_s"],
        slo_attainment=world["slo_attainment"],
        peak_slices=world["peak_slices"],
        slices_at_end=world["slices_at_end"],
        chip_seconds=world["chip_seconds"], tuner=world["tuner"],
        tick_ms=dict(mean=sum(tick) / len(tick), p50=_percentile(tick, 50),
                     p99=_percentile(tick, 99), max=max(tick),
                     ticks=len(tick)),
        per_tick_ms=per_tick, gc_ms_per_tick=sum(gc_ms) / len(tick),
        slowest_ticks=[dict(ms=tick[i], gc_ms=gc_ms[i],
                            gc_by_gen=world["tick_gc"][i][1])
                       for i in slowest],
        tuner_step_ms=dict(mean=sum(steps) / len(steps),
                           p50=_percentile(steps, 50),
                           p99=_percentile(steps, 99), first=first_step),
        tuner_step=step, jacobian=jacobian, fused_split=split,
        oracle_cycles=n, oracle_wall_s=oracle["wall_s"],
        oracle_first_flag_difference=flags)


# ---------------------------------------------------------------- phase 7

# The policy sweep at `make bench-sweep`'s full shape: bench.py's
# sweep_plane_bench(smoke=False), restated here because bench.py imports the
# JAX package. tests/test_torch_sweep.py holds this shape equal to bench.py's.
SWEEP_PARAMS = sweep_world.WorldParams(horizon_s=1200.0)
SWEEP_GRID = "default"
SWEEP_TRAIN = 32
SWEEP_HOLDOUT = 8
SWEEP_CHUNK = 256
SWEEP_MIN_WORLDS = 1024
SWEEP_RTOL = 5e-3  # the reference's jit-vs-Python tolerance
SWEEP_ATOL = 1e-3
SWEEP_ORACLE_WORLDS = 8
SWEEP_NARROW_WORLDS = 24
SWEEP_NARROW_CHUNK = 3
SWEEP_KEYS = ("attainment", "chip_seconds", "wrong_direction")
SWEEP_MIN_RATIO = 20.0  # bench.py's gate: the batch against the Python loop
SWEEP_TIMED_RUNS = 5
SCAN_WIDTHS = (1, 16, 64)  # the batch repeated: 256, 4096, 16384 worlds


def sweep_rates():
    """The sweep scenario's ``[1, T]`` true-rate table: the bench
    trapezoid's shape at the sweep's scale."""
    return sweep_world.rate_table([trapezoid(
        4.0, 40.0, 300.0, 420.0, 180.0, tail=120.0, delay=180.0)],
        SWEEP_PARAMS)


def run_sweep_search(lam, device=None):
    return sweep_search.run_sweep(
        SWEEP_PARAMS, lam, [MODEL], algo="grid", grid=SWEEP_GRID,
        n_train=SWEEP_TRAIN, n_holdout=SWEEP_HOLDOUT, chunk=SWEEP_CHUNK,
        device=device)


def sweep_far(got, want):
    """Worlds where ``got`` and ``want`` are further apart than rel 5e-3,
    abs 1e-3 (pytest.approx's rule) on any of the three outputs."""
    far = np.zeros(len(got["attainment"]), dtype=bool)
    for key in SWEEP_KEYS:
        a = np.asarray(got[key], dtype=np.float64)
        b = np.asarray(want[key], dtype=np.float64)
        far |= (np.abs(a - b) > np.maximum(SWEEP_RTOL * np.abs(b),
                                           SWEEP_ATOL)).reshape(len(far), -1
                                                               ).any(axis=1)
    return far


def sm_clock_mhz(fn, seconds=1.5):
    """The card's SM clock, MHz (nvidia-smi), sampled while ``fn`` runs
    back to back for about ``seconds``: the median and the samples. A
    failed sample raises here."""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, check=True, timeout=60)
            samples.append(float(out.stdout.split()[0]))

    with ThreadPoolExecutor(1) as pool:
        sampler = pool.submit(sample)
        t0 = time.perf_counter()
        try:
            while ((time.perf_counter() - t0 < seconds or not samples)
                   and not sampler.done()):
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
        finally:
            stop.set()
        sampler.result()
    require(samples, "no SM clock sample from nvidia-smi")
    return float(np.median(samples)), samples


# The scan kernel's roles by warp, and its tile and round offsets, read
# from the source (enum Warp, kTile, enum Offset).
_SCAN_SOURCE = scan_kernel._SOURCE.read_text()
SCAN_TILE = int(re.search(r"kTile = (\d+);", _SCAN_SOURCE).group(1))
SCAN_FILL = len(re.search(r"enum Offset \{(.*?)\};", _SCAN_SOURCE,
                          re.S).group(1).split(",")) - 1
SCAN_ROLES = ("loader", "stage 1", "error walk", "stage 2", "serving")


def _bind_scan_probe(lib):
    scan_kernel._bind(lib)
    lib.world_scan_set_probe.argtypes = [ctypes.c_void_p]
    lib.world_scan_set_probe.restype = None


def scan_raw_launch(so, params, inputs):
    """A launch of ``so``'s world_scan_launch on the chunk's CUDA tensors,
    past the wrapper (its launches do not count as the wrapper's)."""
    knob_rows, lam_t, arrivals, faults = inputs
    (w, k), (t, m) = knob_rows.shape, lam_t.shape
    out = torch.empty((4, w, m), dtype=torch.float32, device=CUDA)
    consts = sweep_world.scan_constants(params, 1.0)
    values = (ctypes.c_float * len(scan_kernel.CONSTANT_NAMES))(
        *(float(consts[n]) for n in scan_kernel.CONSTANT_NAMES))
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        require(so.world_scan_launch(
            knob_rows.data_ptr(), lam_t.data_ptr(), arrivals.data_ptr(),
            faults.data_ptr(), out.data_ptr(), w, m, t, params.lead_steps, k,
            values, len(values), stream) == 0, "world_scan_launch")
        return out

    return go


# The scan kernel built to take stage 2's general path at every lead.
SCAN_GENERAL = cuda_build.Library(
    scan_kernel._SOURCE, scan_kernel._bind,
    scan_kernel.LIBRARY.flags + ("-DWORLD_SCAN_GENERAL_FOLDS",))


def scan_general_folds(params, inputs, want):
    """Stage 2's long-lead path against its general path at the bench lead
    (``SCAN_GENERAL``): both bit for bit against ``want``, then timed by
    CUDA events over 200 launches each, in turns shipped, general, general,
    shipped."""
    general = SCAN_GENERAL
    go = {"shipped": scan_raw_launch(scan_kernel.LIBRARY.load(), params,
                                     inputs),
          "general": scan_raw_launch(general.load(), params, inputs)}
    for name, fn in go.items():
        got = fn().cpu().numpy()
        nan = np.isnan(want)
        require(np.array_equal(np.isnan(got), nan)
                and not ((got != want) & ~nan).any(),
                f"the {name} stage 2 differs from run_chunk_plain")
    ms = {name: [] for name in go}
    for name in ("shipped", "general", "general", "shipped"):
        ms[name].append(time_ms(go[name], 200))
    regs = {name: next(r["registers"] for r in cuda_build.resources(
        lib.build_log()) if "world_scan_kernel" in r["entry"])
        for name, lib in (("shipped", scan_kernel.LIBRARY),
                          ("general", general))}
    log(f"[sweep] stage 2 at L={params.lead_steps}: the long-lead path "
        f"(shipped) " + "/".join(f"{x:.5f}" for x in ms["shipped"])
        + " ms, the general path " + "/".join(f"{x:.5f}" for x in ms["general"])
        + f" ms a launch (CUDA events, 200 launches, in turns), both bitwise "
        f"equal to run_chunk_plain; {regs['shipped']} and {regs['general']} "
        f"registers")
    return dict(ms=ms, registers=regs)


def scan_probe(params, inputs):
    """Where a round of the scan kernel goes, at the bench chunk: probe
    builds (-DWORLD_SCAN_PROBE) mark clock64() in block 0 as each barrier
    releases, with every role at work and with each role alone at work
    (the others only meet the barriers, on tiles of 1.0). Over the rounds
    in which every role has a tile: cycles a round. Probe launches go to
    the libraries directly and do not count as the wrapper's."""
    probes = {"all roles": -1, **{name: i for i, name in
                                  enumerate(SCAN_ROLES + ("pool",))}}
    libs = {name: cuda_build.Library(
        scan_kernel._SOURCE, _bind_scan_probe,
        scan_kernel.LIBRARY.flags + (f"-DWORLD_SCAN_PROBE={value}",))
        for name, value in probes.items()}
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    t = inputs[1].shape[0]
    rounds = -(-t // SCAN_TILE) + SCAN_FILL
    steady = range(SCAN_FILL, rounds - SCAN_FILL)
    cycles, total = {}, None
    for name, lib in libs.items():
        so = lib.load()
        marks = torch.zeros(rounds + 1, dtype=torch.int64, device=CUDA)
        so.world_scan_set_probe(marks.data_ptr())
        go = scan_raw_launch(so, params, inputs)
        for _ in range(2):  # the second launch is read warm
            go()
        torch.cuda.synchronize()
        left = marks.cpu().numpy().astype(np.float64)
        cycles[name] = float(np.mean([left[r + 1] - left[r]
                                      for r in steady]))
        if total is None:
            total = float(left[-1] - left[0])
    log(f"[sweep] scan probe (clock64, block 0, the bench chunk): {rounds} "
        f"rounds of {SCAN_TILE} steps, {total:.0f} cycles from the ring's "
        f"zeroing to the last barrier ({total / t:.1f} a step); over the "
        f"{len(steady)} rounds in which every role has a tile, cycles a "
        f"round: " + ", ".join(
            f"{n} {c:.0f}" if n == "all roles" else f"{n} alone {c:.0f}"
            for n, c in cycles.items()))
    return dict(rounds=rounds, cycles=total, round_cycles=cycles)


def scan_kernel_vs_plain(params, points, lam, arr, flt):
    """The scan kernel against ``run_chunk_plain`` on the same CUDA tensors
    of the 256-world batch: every output bit for bit, NaN where NaN; then
    their times (CUDA events, in turns plain, kernel, kernel, plain), the
    kernel's device time (torch.profiler), the SM clock beside it and the
    cycles a step they give, its bound, its registers and shared memory,
    and its wrapper and device times at wider chunks."""
    rows = np.asarray([sweep_knobs.to_vector(k) for k in points],
                      dtype=np.float32)
    inputs = sweep_world.chunk_tensors(rows, lam, arr, flt, CUDA)

    def kernel():
        return sweep_world.run_chunk(params, *inputs, 1.0)

    def plain():
        return sweep_world.run_chunk_plain(params, *inputs, 1.0)

    got = torch.stack(kernel()).cpu().numpy()
    want = torch.stack(plain()).cpu().numpy()
    nan = np.isnan(want)
    differ = int(((got != want) & ~nan).sum())
    require(np.array_equal(np.isnan(got), nan) and differ == 0,
            f"the scan kernel differs from run_chunk_plain: {differ} values, "
            f"NaN positions equal: {np.array_equal(np.isnan(got), nan)}")
    max_abs = float(np.abs(np.where(nan, 0.0, got - want)).max())
    counter = OpCount()
    with counter:
        plain()
    p1 = time_ms(plain, 2)
    k1 = time_ms(kernel, 200)
    k2 = time_ms(kernel, 200)
    p2 = time_ms(plain, 2)
    device = device_ms(kernel, 200, "world_scan_kernel")
    clock_mhz, clock_samples = sm_clock_mhz(kernel)
    cycles = (None if device is None
              else device * 1e-3 * clock_mhz * 1e6 / params.steps)
    # Wider chunks (the batch's worlds repeated): a lane's steps are serial,
    # so while the lanes fit on the card at once the time should not grow.
    by_width, device_by_width = {}, {}
    for reps in SCAN_WIDTHS:
        wide = sweep_world.chunk_tensors(
            np.tile(rows, (reps, 1)), lam, np.tile(arr, (reps, 1, 1)),
            np.tile(flt, (reps, 1, 1)), CUDA)

        def call(wide=wide):
            return sweep_world.run_chunk(params, *wide, 1.0)

        by_width[len(points) * reps] = time_ms(call, 50)
        device_by_width[len(points) * reps] = device_ms(
            call, 50, "world_scan_kernel")
    work = scan_kernel.work(len(points), lam.shape[0], params.steps)
    bound_ms, term = work.bound()
    terms = work.bound_terms_ms()
    with ThreadPoolExecutor(1) as pool:
        general_built = pool.submit(SCAN_GENERAL.build)
        probe = scan_probe(params, inputs)
        general_built.result()
    general_folds = scan_general_folds(params, inputs, want)
    block = scan_kernel.block(params.lead_steps)
    build = next(r for r in cuda_build.resources(
        scan_kernel.LIBRARY.build_log()) if "world_scan_kernel" in r["entry"])
    log(f"[sweep] world_scan at the bench chunk (W={len(points)}, "
        f"M={lam.shape[0]}, T={params.steps}, L={params.lead_steps}): "
        f"equal to run_chunk_plain bit for bit on all four outputs "
        f"({got.size} values, {int(nan.sum())} NaN, max abs err {max_abs}); "
        f"wrapper {k1:.4f}/{k2:.4f} ms (CUDA events), device "
        + ("not measured (no device time in the profiler's trace)"
           if device is None else f"{device:.4f} ms (torch.profiler)")
        + f"; plain {p1:.1f}/{p2:.1f} ms ({counter.ops} PyTorch ops); "
        f"bound {bound_ms:.5f} ms ({term}; "
        + ", ".join(f"{n} {x:.6f}" for n, x in terms.items()) + ")"
        + ("" if device is None else
           f", {100 * bound_ms / device:.1f}% of the device time")
        + f"; SM clock {clock_mhz:.0f} MHz (nvidia-smi, median of "
        f"{len(clock_samples)} samples while the kernel ran: "
        + "/".join(f"{x:.0f}" for x in clock_samples) + ")"
        + ("" if cycles is None else
           f", {cycles:.1f} cycles a step (device time x clock / T)")
        + f"; {build['registers']} registers, {build['spill_stores']} B "
        f"spill stores, {build['spill_loads']} B spill loads, "
        f"{block['threads']} threads and {block['shared_bytes']} B shared "
        f"memory a block"
        + "; by width, wrapper (CUDA events) / device (profiler): "
        + ", ".join(f"W={w} {ms:.4f}/"
                    + ("n/a" if device_by_width[w] is None
                       else f"{device_by_width[w]:.4f}") + " ms"
                    for w, ms in by_width.items()))
    return dict(max_abs_err=max_abs, values=int(got.size),
                nan_values=int(nan.sum()), kernel_ms=(k1 + k2) / 2,
                device_ms=device, plain_ms=(p1 + p2) / 2,
                plain_ops=counter.ops, bound_ms=bound_ms,
                bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term, bounds_ms=terms, bytes=work.bytes,
                chain_ops=work.chain_ops, ms_by_width=by_width,
                device_ms_by_width=device_by_width, sm_clock_mhz=clock_mhz,
                sm_clock_samples=clock_samples, cycles_per_step=cycles,
                probe=probe, general_folds=general_folds,
                registers=build["registers"],
                spill_bytes=build["spill_stores"] + build["spill_loads"],
                **block)


def sweep_host_split(params, points, lam, arr, flt):
    """A 256-world batch's stages on the host clock, in ms: the knob rows
    and degeneracy flags ``run_worlds`` builds, the copies of the chunk's
    inputs to the card, and the kernel through the host transfer."""
    t0 = time.perf_counter()
    rows = np.asarray([sweep_knobs.to_vector(k) for k in points],
                      dtype=np.float32)
    np.asarray([sweep_knobs.is_degenerate(k) for k in points])
    t1 = time.perf_counter()
    inputs = sweep_world.chunk_tensors(rows, lam, arr, flt, CUDA)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    torch.stack(sweep_world.run_chunk(params, *inputs, 1.0)).cpu()
    t3 = time.perf_counter()
    return {"knob rows": 1e3 * (t1 - t0), "copies in": 1e3 * (t2 - t1),
            "kernel and host transfer": 1e3 * (t3 - t2)}


def phase_sweep():
    """The policy sweep on the card: bench.py's search and gates with the
    scan kernel's count set to 0 just before the search and read just
    after, the 256-world batch timed against the Python loop, the kernel
    against its plain version, the chunk width, the card against the CPU
    and the scalar oracle, then the fidelity gate with every kernel's count
    set to 0 just before it."""
    started = time.perf_counter()
    params, lam = SWEEP_PARAMS, sweep_rates()
    d0 = dispatch.count()
    scan_kernel.launches = 0
    t0 = time.perf_counter()
    report = run_sweep_search(lam)
    search_s = time.perf_counter() - t0
    search_launches = scan_kernel.launches
    dispatches = dispatch.count() - d0
    worlds = report["worlds_evaluated"]
    chunks = (-(-worlds // SWEEP_CHUNK)
              + -(-2 * SWEEP_HOLDOUT // SWEEP_CHUNK))
    rec = report["recommendations"][MODEL]
    log(f"[sweep] grid search: {worlds} train worlds + "
        f"{2 * SWEEP_HOLDOUT} holdout worlds, {params.steps} steps, "
        f"{dispatches} noted dispatches, {search_launches} scan kernel "
        f"launches for {chunks} chunks, {search_s:.2f} s wall; trust "
        f"{rec['trust']['trusted']} after {rec['trust']['evals']} evals "
        f"(ewma regret {rec['trust']['ewma_regret']}); applied knobs "
        f"{rec['applied_knobs']}")
    require(worlds >= SWEEP_MIN_WORLDS, f"the sweep evaluated {worlds} worlds")
    require(dispatches <= params.steps,
            f"{dispatches} dispatches for a {params.steps}-step horizon")
    require(search_launches == chunks == dispatches,
            f"the grid search launched the scan kernel {search_launches} "
            f"times for {chunks} chunks ({dispatches} noted dispatches)")
    require(bool(rec["applied_knobs"]), "empty recommendation")
    require(rec["trust"]["evals"] >= 3 and rec["trust"]["trusted"],
            f"the recommendation failed the trust gate: {rec['trust']}")

    # A 256-world batch, as bench.py times it: the grid's points cycled over
    # the train seeds, the seeded tables built once outside every timer.
    train = report["seeds"]["train"]
    points = (sweep_knobs.grid_points(SWEEP_GRID) * SWEEP_CHUNK)[:SWEEP_CHUNK]
    seeds = [train[i % len(train)] for i in range(SWEEP_CHUNK)]
    arr = sweep_world.arrivals_table(seeds, lam, params)
    flt = sweep_world.fault_table(seeds, lam.shape[0], params)

    def batch(device=None, n=SWEEP_CHUNK, chunk=SWEEP_CHUNK):
        return sweep_world.run_worlds(params, points[:n], seeds[:n], lam,
                                      chunk=chunk, arrivals=arr[:n],
                                      faults=flt[:n], device=device)

    scan_kernel.launches = 0
    card = batch()
    batch_launches = scan_kernel.launches
    require(batch_launches == 1, f"the 256-world batch launched the scan "
            f"kernel {batch_launches} times")
    # bench.py times run_worlds on the host clock (time.time()); the batch
    # ends in its one host transfer, so the host clock holds the device's
    # work. CUDA events around the same call, beside it.
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    event_ms, host_ms = [], []
    for _ in range(SWEEP_TIMED_RUNS):
        t0 = time.perf_counter()
        start.record()
        batch()
        end.record()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        event_ms.append(start.elapsed_time(end))
    chunk_host_ms = float(np.median(host_ms))
    chunk_ms = float(np.median(event_ms))
    with OpCount() as count:
        batch()
    host_split = sweep_host_split(params, points, lam, arr, flt)

    scan = scan_kernel_vs_plain(params, points, lam, arr, flt)
    busy_ms, kernels = device_busy_ms(batch, 3)

    # The chunk width: 24 worlds at chunk 3 against the same worlds inside
    # the chunk of 256, every output bit for bit.
    narrow = batch(n=SWEEP_NARROW_WORLDS, chunk=SWEEP_NARROW_CHUNK)
    for key in SWEEP_KEYS + ("arrivals_total",):
        require(np.array_equal(narrow[key], card[key][:SWEEP_NARROW_WORLDS]),
                f"chunk {SWEEP_NARROW_CHUNK} changed {key}'s bits")

    # The card against the CPU (one thread, as the tests run it).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        cpu = batch("cpu")
        cpu_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        torch.set_num_threads(threads)
    far = sweep_far(card, cpu)
    differ = int(np.any(np.stack([card[k] != cpu[k] for k in SWEEP_KEYS]),
                        axis=(0, 2)).sum())
    require(not far.any(), f"{int(far.sum())} worlds differ from the CPU "
            f"beyond rel {SWEEP_RTOL}, abs {SWEEP_ATOL}")

    # The scalar oracle on 8 sampled worlds, and its time a world.
    sample = sorted(np.random.default_rng(20261017).choice(
        SWEEP_CHUNK, SWEEP_ORACLE_WORLDS, replace=False).tolist())
    t0 = time.perf_counter()
    oracle = [sweep_world.run_world_python(params, points[i], lam, arr[i],
                                           flt[i]) for i in sample]
    py_ms = 1e3 * (time.perf_counter() - t0) / len(sample)
    want = {k: np.stack([o[k] for o in oracle]) for k in SWEEP_KEYS}
    got = {k: card[k][sample] for k in SWEEP_KEYS}
    far = sweep_far(got, want)
    require(not far.any(), f"worlds {np.asarray(sample)[far].tolist()} "
            f"differ from run_world_python beyond rel {SWEEP_RTOL}")

    vec_ms_host = chunk_host_ms / SWEEP_CHUNK
    ratio = py_ms / vec_ms_host
    log(f"[sweep] chunk 256 (240 steps), median of {SWEEP_TIMED_RUNS}: "
        f"{chunk_host_ms:.3f} ms on the host clock ("
        + "/".join(f"{x:.3f}" for x in host_ms) + f"), {chunk_ms:.3f} ms "
        f"by CUDA events; {vec_ms_host:.5f} ms a world; the Python loop "
        f"{py_ms:.4f} ms a world ({len(sample)} worlds): ratio {ratio:.1f}x "
        f"on the host clock ({py_ms / (chunk_ms / SWEEP_CHUNK):.1f}x by "
        f"CUDA events); bench.py's gate >= {SWEEP_MIN_RATIO:.0f}x")
    # The profiler's trace of a whole batch has come back without the
    # kernel in a full run; then only the kernel's own share is printed.
    busy_seen = kernels >= 1
    kernel_share = (None if scan["device_ms"] is None
                    else scan["device_ms"] / chunk_host_ms)
    log(f"[sweep] a chunk: {count.ops} PyTorch ops, "
        + (f"{kernels:.0f} CUDA kernels and copies, device busy "
           f"{busy_ms:.4f} ms = {busy_ms / chunk_host_ms:.3f} of the chunk's "
           f"host-clock time (profiler)" if busy_seen else
           "device busy not measured (the profiler's trace holds "
           f"{kernels:.2f} kernels a chunk)")
        + (f"; the kernel's device time is {kernel_share:.3f} of it"
           if kernel_share is not None else "")
        + "; the host clock's split, ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in host_split.items()))
    log(f"[sweep] chunk 3 x 8 = chunk 256 bitwise on all four outputs; card "
        f"vs CPU ({cpu_ms:.0f} ms on one thread): {differ} of {SWEEP_CHUNK} "
        f"worlds not bitwise equal, all within rel {SWEEP_RTOL}, abs "
        f"{SWEEP_ATOL}; worlds {sample} within it of run_world_python")
    require(ratio >= SWEEP_MIN_RATIO,
            f"the sweep is {ratio:.1f}x the Python loop on the host clock, "
            f"under bench.py's {SWEEP_MIN_RATIO:.0f}x")

    sizing_kernel.launches = fit_kernel.launches = scan_kernel.launches = 0
    t0 = time.perf_counter()
    fid = fidelity_check()
    fidelity_s = time.perf_counter() - t0
    launches = (sizing_kernel.launches, fit_kernel.launches,
                scan_kernel.launches)
    log(f"[sweep] fidelity ({fidelity_s:.1f} s): event {fid['event']}, fluid "
        f"{ {k: fid['fluid'][k] for k in ('slo_attainment', 'chip_seconds')} }"
        f"; attainment delta {fid['attainment_delta_abs']}, chip-seconds "
        f"rel {fid['chip_seconds_delta_rel']} (tolerance {fid['tolerance']});"
        f" sizing launches {launches[0]}, fit launches {launches[1]}, scan "
        f"launches {launches[2]}")
    require(fid["within_tolerance"],
            f"fluid world outside the fidelity tolerance: attainment delta "
            f"{fid['attainment_delta_abs']}, chip-seconds rel "
            f"{fid['chip_seconds_delta_rel']}")
    require(launches[0] > 0, "the fidelity event run launched no sizing "
            "kernel")
    require(launches[2] == 1, f"the fidelity fluid run launched the scan "
            f"kernel {launches[2]} times")
    wall_s = time.perf_counter() - started
    log(f"[sweep] phase 7 took {wall_s:.1f} s")
    return dict(
        worlds=worlds, holdout_worlds=2 * SWEEP_HOLDOUT, steps=params.steps,
        dispatches=dispatches, search_s=search_s,
        search_launches=search_launches, batch_launches=batch_launches,
        trust={k: rec["trust"][k] for k in ("trusted", "evals",
                                            "ewma_regret", "reason")},
        applied_knobs=rec["applied_knobs"],
        chunk_ms=chunk_ms, chunk_host_ms=chunk_host_ms,
        chunk_host_ms_runs=host_ms, chunk_event_ms_runs=event_ms,
        ms_per_world=chunk_ms / SWEEP_CHUNK, ms_per_world_host=vec_ms_host,
        python_ms_per_world=py_ms, ratio_vs_python=ratio,
        ops_per_chunk=count.ops, kernels_per_chunk=kernels,
        device_busy_ms=busy_ms if busy_seen else None,
        device_busy_share=busy_ms / chunk_host_ms if busy_seen else None,
        kernel_device_share=kernel_share,
        host_split_ms=host_split,
        scan=scan, cpu_chunk_ms=cpu_ms, worlds_not_bitwise_vs_cpu=differ,
        oracle_worlds=sample, fidelity=fid, fidelity_s=fidelity_s,
        fidelity_launches=launches, wall_s=wall_s)


# ---------------------------------------------------------------- phase 8

# The golden worlds with more than one engine, restated because their
# scripts import the JAX package: tests/goldens/make_shard_trace.py (six
# models under a 3-shard plane, shard 1 crashed at a seeded time mid
# ramp-down during a partial scrape outage) and make_federation_trace.py
# (three regions a third of a diurnal period apart, a metrics blackout in
# us-east1, the arbiter spilling to asia-ne1). tests/test_torch_golden_
# {shard,federation}.py hold these constants to the scripts' and the
# worlds to the reference's.
SHARD_SEED = 20260804
SHARD_COUNT = 3
SHARD_HORIZON = 900.0
FED_TARGET_REGION = "asia-ne1"
FED_DARK_REGION = "us-east1"
FED_REGIONS = (FED_DARK_REGION, FED_TARGET_REGION, "eu-west4")
FED_SEED = 20260807
FED_DURATION = 480.0


def run_shard_world(trace, device=None):
    """make_shard_trace.py's world with its engines on ``device``; its
    cycle records are written to ``trace``. Returns the records."""
    from wva_tpu_torch.blackbox.replay import load_trace
    from wva_tpu_torch.config.loader import load as load_config
    from wva_tpu_torch.emulator import FaultPlan, FaultWindow
    from wva_tpu_torch.emulator.faults import (
        KIND_METRICS_PARTIAL,
        seeded_shard_crashes,
    )

    if os.path.exists(trace):
        os.remove(trace)
    fused.clear_solve_memo()
    drain_decision_bus()
    cfg = load_config(env={
        "PROMETHEUS_BASE_URL": "http://prometheus.test:9090",
        "WVA_TRACE_ENABLED": "true",
        "WVA_TRACE_PATH": trace,
        "WVA_SHARDING": "true",
        "WVA_SHARD_COUNT": str(SHARD_COUNT),
    })
    event = seeded_shard_crashes(seed=SHARD_SEED, horizon=SHARD_HORIZON,
                                 shards=SHARD_COUNT, n=1)[0]
    load = trapezoid(base_rate=2.0, peak_rate=20.0, ramp_up=180.0,
                     hold=160.0, ramp_down=100.0, tail=1e9, delay=60.0)
    plan = FaultPlan([
        FaultWindow(kind=KIND_METRICS_PARTIAL, start=435.0, end=560.0,
                    drop_fraction=0.5),
    ], seed=SHARD_SEED)
    specs = [VariantSpec(
        name=f"s{i}-v5e", model_id=f"golden/shard-model-{i}",
        accelerator="v5e-8", chips_per_replica=8, cost=10.0,
        initial_replicas=2, serving=ServingParams(engine="jetstream"),
        load=load,
        hpa=HPAParams(stabilization_up_seconds=10.0,
                      stabilization_down_seconds=30.0,
                      sync_period_seconds=5.0))
        for i in range(6)]
    harness = EmulationHarness(
        specs,
        saturation_config=SaturationScalingConfig(
            analyzer_name="saturation", enable_limiter=True),
        config=cfg,
        nodepools=[("v5e-pool", "v5e", "2x4", 24)],
        startup_seconds=30.0, engine_interval=15.0,
        stochastic_seed=SHARD_SEED, fault_plan=plan, device=device)
    harness.run(event.at)
    harness.crash_shard(event.shard, clean=event.clean)
    harness.run(SHARD_HORIZON - event.at)
    harness.manager.shutdown()
    return load_trace(trace)


def run_federation_world(trace, device=None):
    """make_federation_trace.py's world with every region's engine on
    ``device``; the target region's cycle records are copied to ``trace``.
    Returns the records."""
    import shutil
    import tempfile

    from wva_tpu_torch.blackbox.replay import load_trace
    from wva_tpu_torch.config import HealthConfig
    from wva_tpu_torch.emulator import (
        FaultPlan,
        FaultWindow,
        FederatedHarness,
        RegionSpec,
        regional,
    )
    from wva_tpu_torch.emulator.faults import KIND_METRICS_BLACKOUT

    if os.path.exists(trace):
        os.remove(trace)
    fused.clear_solve_memo()
    drain_decision_bus()

    def cfg():
        c = new_test_config()
        c.set_health(HealthConfig(degraded_after_seconds=30.0,
                                  freeze_after_seconds=60.0,
                                  recovery_ticks=2))
        return c

    def specs(i):
        base = diurnal(base_rate=2.0, amplitude=18.0, period=600.0)
        return [VariantSpec(
            name="m0-v5e", model_id="golden/fed-model-0",
            accelerator="v5e-8", chips_per_replica=8, cost=10.0,
            initial_replicas=1, serving=ServingParams(engine="jetstream"),
            load=regional(base, i, len(FED_REGIONS), period=600.0),
            hpa=HPAParams(stabilization_up_seconds=10.0,
                          stabilization_down_seconds=30.0,
                          sync_period_seconds=5.0))]

    plan = FaultPlan([FaultWindow(kind=KIND_METRICS_BLACKOUT,
                                  start=120.0, end=420.0)], seed=FED_SEED)
    tmp = tempfile.mkdtemp(prefix="fed-golden-")
    try:
        fh = FederatedHarness(
            [RegionSpec(name=name, variants=specs(i), config=cfg(),
                        fault_plan=plan if name == FED_DARK_REGION else None,
                        nodepools=[("v5e-pool", "v5e", "2x4", 8)])
             for i, name in enumerate(FED_REGIONS)],
            namespace="inference", engine_interval=15.0,
            startup_seconds=30.0, stochastic_seed=FED_SEED, trace_dir=tmp,
            device=device)
        fh.run(FED_DURATION)
        for harness in fh.clusters.values():
            harness.manager.shutdown()
        shutil.copyfile(os.path.join(tmp, f"{FED_TARGET_REGION}.jsonl"),
                        trace)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return load_trace(trace)


GOLDEN_WORLDS = {"shard": run_shard_world, "federation": run_federation_world}


def phase_golden_worlds():
    """The shard and federation golden worlds on the card (the fit
    kernel's count set to 0 just before each and read just after), then on
    the CPU: every cycle's decisions equal; whole records compared."""
    import tempfile

    found = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-golden-") as tmp:
        for name, run in GOLDEN_WORLDS.items():
            sizing_kernel.launches = fit_kernel.launches = 0
            t0 = time.perf_counter()
            card = run(os.path.join(tmp, f"{name}-card.jsonl"))
            card_s = time.perf_counter() - t0
            launches = (sizing_kernel.launches, fit_kernel.launches)
            t0 = time.perf_counter()
            cpu = on_one_thread(run, os.path.join(tmp, f"{name}-cpu.jsonl"),
                                "cpu")
            cpu_s = time.perf_counter() - t0
            a = [cycle_summary(r) for r in card]
            b = [cycle_summary(r) for r in cpu]
            require(a and a == b, f"the {name} world's cycles differ between "
                    "card and CPU: " + next((f"{x} != {y}" for x, y in zip(
                        a, b) if x != y), f"{len(a)} against {len(b)}"))
            whole = sum(json.dumps(x, sort_keys=True)
                        != json.dumps(y, sort_keys=True)
                        for x, y in zip(card, cpu))
            log(f"[golden] {name} world: card and CPU decide alike in all "
                f"{len(a)} cycles (desired, target, action, set_by); "
                f"{whole} whole records differ; launches sizing "
                f"{launches[0]}, fit {launches[1]}; {card_s:.1f} s on the "
                f"card, {cpu_s:.1f} s on the CPU")
            found[name] = dict(cycles=len(a), whole_records_differ=whole,
                               launches=launches, card_s=card_s, cpu_s=cpu_s)
    return found


# ---------------------------------------------------------------- phase 9

# What a wheel of the repo is built from (the Dockerfile's first stage
# copies the same).
WHEEL_SOURCES = ("pyproject.toml", "README.md", "wva_tpu", "wva_tpu_torch")


def kernel_libraries():
    """The port's five kernel libraries by short name."""
    return {"sizing": _build.LIBRARY, "setup": chain_setup.LIBRARY,
            "stats": chain_stats.LIBRARY, "fit": fit_kernel.LIBRARY,
            "scan": scan_kernel.LIBRARY}


def kernel_counters():
    """The wrappers' modules, each with its kernel's ``launches``."""
    return {"sizing": sizing_kernel, "setup": chain_setup,
            "stats": chain_stats, "fit": fit_kernel, "scan": scan_kernel,
            "jacobian": jacobian_kernel}


# Launches of one kernel_entry_outputs(): size_batch 3 (setup, sizing,
# stats), analyze_batch 1 (stats), a fit at each of FIT_TIMED, one chunk,
# one tuner step.
ENTRY_LAUNCHES = {"sizing": 1, "setup": 1, "stats": 2, "fit": len(FIT_TIMED),
                  "scan": 1, "jacobian": 1}
INSTALLED_SEED = 20261017


def kernel_entry_outputs():
    """Every kernel entry of the port on fixed seeded inputs on the card,
    each through the public path that the main paths call: ``size_batch``
    at the headline grids (C=8, k_cols 512), ``analyze_batch`` at the
    staged solve's shape (C=512, k_cols 2048), the fits at M=1 and M=1024,
    ``run_chunk`` at the bench chunk (W=256, M=1, T=240) and one tuner
    step's h and H. Returns (name -> numpy array, launches by kernel)."""
    for module in kernel_counters().values():
        module.launches = 0
    out = {}
    cand, targets = chain_times_inputs(8, INSTALLED_SEED)
    for key, v in qm.size_batch(cand, *targets, k_cols=512).items():
        out[f"size_batch C=8 {key}"] = v
    cand, _ = chain_times_inputs(512, INSTALLED_SEED + 1)
    rate = torch.tensor(np.random.default_rng(INSTALLED_SEED + 2).uniform(
        0.5, 60.0, 512), dtype=torch.float32, device=CUDA)
    for key, v in qm.analyze_batch(rate, cand, k_cols=2048).items():
        out[f"analyze_batch C=512 {key}"] = v
    for name, (m, full) in FIT_TIMED.items():  # M=1, M=1024 mixed and full
        out[f"fit_grid {name}"] = fc.fit_grid(
            *fit_inputs(m, INSTALLED_SEED + m, full=full), m=m)
    params, lam = SWEEP_PARAMS, sweep_rates()
    train, _ = sweep_search.split_seeds(SWEEP_TRAIN, SWEEP_HOLDOUT)
    points = (sweep_knobs.grid_points(SWEEP_GRID) * SWEEP_CHUNK)[:SWEEP_CHUNK]
    seeds = [train[i % len(train)] for i in range(SWEEP_CHUNK)]
    rows = np.asarray([sweep_knobs.to_vector(k) for k in points],
                      dtype=np.float32)
    inputs = sweep_world.chunk_tensors(
        rows, lam, sweep_world.arrivals_table(seeds, lam, params),
        sweep_world.fault_table(seeds, lam.shape[0], params), CUDA)
    for key, v in zip(("attainment", "chip_seconds", "wrong_direction",
                       "total"), sweep_world.run_chunk(params, *inputs, 1.0)):
        out[f"run_chunk W=256 {key}"] = v
    out["tuner step h"], out["tuner step H"] = ekf._observe_and_jacobian(
        torch.tensor(TUNER_X, dtype=torch.float32, device=CUDA),
        torch.tensor(TUNER_ENV, dtype=torch.float32, device=CUDA))
    torch.cuda.synchronize()
    launches = {k: m.launches for k, m in kernel_counters().items()}
    require(launches == ENTRY_LAUNCHES,
            f"the kernel entries launched {launches}, expected "
            f"{ENTRY_LAUNCHES}")
    return {k: v.cpu().numpy() for k, v in out.items()}, launches


def installed_child(out_npz):
    """Phase 9's child, started with only the installed wheel on
    ``PYTHONPATH``: build the five libraries (one thread each, timed),
    write :func:`kernel_entry_outputs` to ``out_npz`` and print what it
    found as one JSON line. Fails if a module of the port came from
    anywhere but the install, or if jax or wva_tpu was imported."""
    import wva_tpu_torch

    site = os.path.realpath(os.environ["PYTHONPATH"])

    def installed(path):
        return os.path.commonpath([os.path.realpath(path), site]) == site

    here = os.path.dirname(wva_tpu_torch.__file__)
    require(installed(here),
            f"wva_tpu_torch imported from {here}, not from {site}")

    def build(lib):
        t0 = time.perf_counter()
        path = lib.build()
        return str(path), time.perf_counter() - t0

    libraries = kernel_libraries()
    with ThreadPoolExecutor(len(libraries)) as pool:
        built = dict(zip(libraries, pool.map(build, libraries.values())))
    arrays, launches = kernel_entry_outputs()
    np.savez(out_npz, **arrays)
    foreign = sorted(
        name for name, m in list(sys.modules.items())
        if name.split(".")[0] == "wva_tpu_torch"
        and getattr(m, "__file__", None) and not installed(m.__file__))
    require(not foreign, f"port modules from outside the install: {foreign}")
    imported = sorted({"jax", "wva_tpu"} & set(sys.modules))
    require(not imported, f"the installed port imported {imported}")
    print(json.dumps({"package": here, "built": built,
                      "launches": launches}), flush=True)


def copy_wheel_sources(dest):
    """WHEEL_SOURCES of this checkout into ``dest``, without build outputs
    or bytecode."""
    import shutil

    ignore = shutil.ignore_patterns("__pycache__", "*.pyc", "build",
                                    "*.egg-info")
    for name in WHEEL_SOURCES:
        src = os.path.join(REPO, name)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dest, name), ignore=ignore)
        else:
            shutil.copy2(src, os.path.join(dest, name))


def pip(*args):
    """``python -m pip`` offline, with no cache and no version check."""
    proc = subprocess.run(
        [sys.executable, "-m", "pip", *args, "--no-deps", "--no-index",
         "--no-cache-dir", "--disable-pip-version-check", "-q"],
        capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0,
            f"pip {args[0]} failed ({proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")


def phase_installed():
    """The port as a user installs it: a wheel built from a copy of this
    checkout, installed with ``--target`` into a temporary directory, and
    a child ``python`` run outside the repository with only that install on
    ``PYTHONPATH`` and a fresh ``XDG_CACHE_HOME``. Every kernel entry's
    outputs there must equal this checkout's bit for bit, the five
    libraries must be built in that cache under this checkout's names (a
    hash of the same sources and flags) and nothing under the install, and
    the ``wva-tpu-torch`` command's ``sweep --smoke`` must write the
    checkout's recommendation file."""
    import tempfile
    import zipfile

    from wva_tpu_torch.__main__ import main as port_main

    started = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="wva-installed-") as tmp:
        src, site = os.path.join(tmp, "src"), os.path.join(tmp, "site")
        cache, run = os.path.join(tmp, "cache"), os.path.join(tmp, "run")
        os.mkdir(src)
        os.mkdir(run)
        copy_wheel_sources(src)
        t0 = time.perf_counter()
        pip("wheel", "--no-build-isolation", "-w", os.path.join(tmp, "dist"),
            src)
        wheel = next(os.scandir(os.path.join(tmp, "dist"))).path
        pip("install", "--target", site, wheel)
        install_s = time.perf_counter() - t0
        with zipfile.ZipFile(wheel) as z:
            shipped = sorted(n for n in z.namelist() if "/csrc/" in n)
        on_disk = sorted(
            os.path.relpath(os.path.join(d, f), REPO)
            for d, _, files in os.walk(os.path.join(REPO, "wva_tpu_torch"))
            if os.path.basename(d) == "csrc" for f in files)
        require(shipped == on_disk,
                f"the wheel ships {shipped} of csrc/, the checkout holds "
                f"{on_disk}")

        # The child: a copy of this script alone in its directory, so
        # that nothing of the checkout is on its path.
        script = os.path.join(run, os.path.basename(__file__))
        with open(__file__, encoding="utf-8") as f, \
                open(script, "w", encoding="utf-8") as g:
            g.write(f.read())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=site, XDG_CACHE_HOME=cache)
        npz = os.path.join(tmp, "installed.npz")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, script, "--installed-child",
                               npz], cwd=run, env=env, capture_output=True,
                              text=True, timeout=900)
        child_s = time.perf_counter() - t0
        require(proc.returncode == 0, f"the installed child failed "
                f"({proc.returncode}):\n{proc.stdout[-4000:]}"
                f"{proc.stderr[-4000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])

        mine, launches = kernel_entry_outputs()
        with np.load(npz) as theirs:
            require(sorted(theirs.files) == sorted(mine),
                    f"entries {sorted(theirs.files)} against {sorted(mine)}")
            differ = [k for k in mine
                      if theirs[k].dtype != mine[k].dtype
                      or theirs[k].shape != mine[k].shape
                      or theirs[k].tobytes() != mine[k].tobytes()]
        require(not differ, f"installed and checkout outputs differ: "
                f"{differ}")
        require(child["launches"] == launches,
                f"launches {child['launches']} installed, {launches} here")

        kernels = os.path.join(cache, "wva_tpu_torch", "kernels")
        libraries = kernel_libraries()
        want = sorted(lib.path().name for lib in libraries.values())
        got = sorted(f for f in os.listdir(kernels) if f.endswith(".so"))
        require(got == want, f"libraries in the cache {got}, the "
                f"checkout's {want}")
        require(all(os.path.dirname(p) == kernels
                    for p, _ in child["built"].values()),
                f"libraries built outside {kernels}: {child['built']}")
        # Reported, not required: nvcc may stamp a build's own path or id.
        same_bytes = {name: lib.path().read_bytes() == pathlib.Path(
            kernels, lib.path().name).read_bytes()
            for name, lib in libraries.items()}
        in_site = sorted(
            os.path.relpath(os.path.join(d, f), site)
            for d, dirs, files in os.walk(site) for f in files + dirs
            if f == "build" or f.endswith((".so", ".tmp", ".log")))
        require(not in_site, f"built inside the install: {in_site}")

        recs = os.path.join(tmp, "recs.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [os.path.join(site, "bin", "wva-tpu-torch"), "sweep", "--smoke",
             "--out", recs], cwd=run, env=env, capture_output=True,
            text=True, timeout=600)
        command_s = time.perf_counter() - t0
        require(proc.returncode == 0, f"wva-tpu-torch sweep --smoke failed "
                f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        mine_recs = os.path.join(tmp, "recs-checkout.json")
        require(port_main(["sweep", "--smoke", "--out", mine_recs]) == 0,
                "the checkout's sweep --smoke failed")
        with open(recs, "rb") as f, open(mine_recs, "rb") as g:
            require(f.read() == g.read(), "wva-tpu-torch sweep --smoke "
                    "wrote another recommendation than the checkout's")
        found = dict(
            wheel=os.path.basename(wheel), wheel_bytes=os.path.getsize(wheel),
            csrc=shipped, wheel_and_install_s=install_s,
            child_s=child_s, command_s=command_s,
            built={name: dict(path=os.path.relpath(p, tmp), s=s)
                   for name, (p, s) in child["built"].items()},
            library_bytes_equal=same_bytes,
            entries=len(mine), entries_bitwise_equal=True,
            launches=launches, sweep_smoke_equal=True,
            phase_s=time.perf_counter() - started)
    log(f"[installed] {found['wheel']} {found['wheel_bytes']} B, "
        f"{len(shipped)} files under csrc/: {', '.join(shipped)}; built in "
        f"XDG_CACHE_HOME, none in the install: " + ", ".join(
            f"{name} {b['s']:.1f} s {b['path']}"
            for name, b in found["built"].items())
        + f"; library bytes equal to the checkout's {same_bytes}; "
        f"{len(mine)} entry outputs bitwise equal, launches {launches}; "
        f"wva-tpu-torch sweep --smoke equal to the checkout's "
        f"({command_s:.1f} s); phase {found['phase_s']:.1f} s")
    return found


def jacobian_times():
    """One tuner step's h and H at TUNER_X and TUNER_ENV: the kernel's
    launch (CUDA events) and device time (profiler), twice each, using only
    what every version of the jacobian kernel has (copy the script into an
    older checkout to compare two trees in one call)."""
    x = torch.tensor(TUNER_X, dtype=torch.float32, device=CUDA)
    env = torch.tensor(TUNER_ENV, dtype=torch.float32, device=CUDA)
    call = functools.partial(jacobian_kernel.launch, x, env)
    return dict(launch_ms=[time_ms(call, 1000) for _ in range(2)],
                device_ms=[device_ms(call, 200, "jacobian_kernel")
                           for _ in range(2)])


# --only chain-times: the chain kernels' entries and the sizing kernel
# between them at the main paths' shapes (label, C, k_cols, entries), every
# row at the worlds' max batch and k.
CHAIN_TIMED = (("headline world's grids", 8, 512, ("setup", "sizing", "tail")),
               ("fleet tick's first call", 2048, 512,
                ("setup", "sizing", "tail")),
               ("staged solve's analyze_batch", 512, 2048, ("analyze",)))
CHAIN_TIMED_KERNELS = {"setup": "chain_setup_kernel",
                       "sizing": "sizing_bisection_kernel",
                       "tail": "chain_stats_kernel",
                       "analyze": "chain_stats_kernel"}
CHAIN_TIMED_BATCH, CHAIN_TIMED_K = 96, 480

LAUNCH_FLOOR_SOURCE = r"""// An empty kernel: the launch floor.
#include <cuda_runtime.h>
__global__ void launch_floor_kernel() {}
extern "C" {
int launch_floor_launch(cudaStream_t stream) {
  launch_floor_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
const char* launch_floor_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
}
"""


def launch_floor():
    """An empty kernel's launch time (CUDA events) and device time
    (profiler), twice each: the floor under every launch, not a bound."""
    # Checkouts older than cuda_build.build_dir have a BUILD_DIR.
    kernels = (cuda_build.build_dir() if hasattr(cuda_build, "build_dir")
               else cuda_build.BUILD_DIR)
    kernels.mkdir(parents=True, exist_ok=True)
    source = kernels / "launch_floor.cu"
    source.write_text(LAUNCH_FLOOR_SOURCE)

    def bind(lib):
        lib.launch_floor_launch.argtypes = [ctypes.c_void_p]
        lib.launch_floor_launch.restype = ctypes.c_int

    lib = cuda_build.Library(source, bind).load()
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        require(lib.launch_floor_launch(stream) == 0, "empty kernel launch")

    return dict(launch_ms=[time_ms(call, 1000) for _ in range(2)],
                device_ms=[device_ms(call, 200, "launch_floor_kernel")
                           for _ in range(2)])


def chain_times_inputs(c, seed):
    """Seeded candidates on the card, every row at CHAIN_TIMED_BATCH and
    CHAIN_TIMED_K, and targets [3, C] (TTFT, ITL, no TPS)."""
    rng = np.random.default_rng(seed)
    cand = qm.candidate_batch(
        rng.uniform(3.0, 30.0, c), rng.uniform(0.001, 0.05, c),
        rng.uniform(0.00001, 0.002, c), rng.uniform(64, 2048, c),
        rng.uniform(32, 1024, c), np.full(c, CHAIN_TIMED_BATCH),
        np.full(c, CHAIN_TIMED_K), device=CUDA)
    targets = torch.tensor(np.stack([rng.uniform(100, 3000, c),
                                     rng.uniform(5, 100, c), np.zeros(c)]),
                           dtype=torch.float32, device=CUDA)
    return cand, targets


def chain_entry_calls(entry, cand, targets, k_cols):
    """One chain entry on fixed inputs: its wrapper as the path calls it,
    its C function alone on the same buffers, its outputs (one launch
    through the kernel's ``launch``), its plain version and its work (from
    the plain version's pointwise elements)."""
    c = int(cand.alpha.shape[0])
    stream = torch.cuda.current_stream().cuda_stream
    fields = [f.data_ptr() for f in cand]
    if entry == "sizing":
        # Its inputs as the sizing path gives them: the chain setup's.
        setup = chain_setup.launch(cand, k_cols)
        args = (setup.clm, setup.clm_at_k, cand, targets[:2].contiguous(),
                setup.lo0, setup.hi0)
        shape = sizing_kernel.launch_shape(c, k_cols)
        nv = shape.values_per_lane
        order = sizing_kernel.launch_order(
            cand.k, k_cols, sizing_kernel.rows_per_wave(CUDA, nv))
        out = sizing_kernel.sizing_bisection(*args)
        lib = _build.LIBRARY.load()
        ptrs = [t.data_ptr() for t in (
            setup.clm, setup.clm_at_k, cand.alpha, cand.beta, cand.gamma,
            cand.avg_input_tokens, cand.avg_output_tokens, cand.max_batch,
            cand.k, args[3], setup.lo0, setup.hi0)] + [
            None if order is None else order.data_ptr(), out.data_ptr()]
        return dict(
            wrapper=functools.partial(sizing_kernel.sizing_bisection, *args),
            alone=lambda: lib.sizing_bisection_launch(
                *ptrs, c, k_cols, qm._BISECTION_ITERS, nv,
                sizing_kernel.ROWS_PER_BLOCK, 1, stream),
            outs=[out],
            plain=functools.partial(sizing_kernel.sizing_bisection_plain,
                                    *args),
            work=lambda ops: sizing_kernel.work(cand, k_cols))
    if entry == "setup":
        outs = list(chain_setup.launch(cand, k_cols))
        lib = chain_setup.LIBRARY.load()
        ptrs = fields + [t.data_ptr() for t in outs]
        return dict(
            wrapper=lambda: chain_setup.chain_setup(cand, k_cols),
            alone=lambda: lib.chain_setup_launch(*ptrs, c, k_cols, stream),
            outs=outs,
            plain=lambda: chain_setup.chain_setup_plain(cand, k_cols),
            work=lambda ops: chain_setup.work(cand, k_cols, ops))
    plain = chain_setup.chain_setup_plain(cand, k_cols)
    inputs = dict.fromkeys(("rate", "lam_star", "targets", "lam_max"))
    if entry == "tail":
        inputs.update(
            lam_star=sizing_kernel.sizing_bisection_plain(
                plain.clm, plain.clm_at_k, cand, targets[:2].contiguous(),
                plain.lo0, plain.hi0),
            targets=targets, lam_max=plain.bounds[2].contiguous())
        args = (cand, inputs["lam_star"], targets, inputs["lam_max"], k_cols)
        wrapper = functools.partial(chain_stats.size_tail, *args)
        plain_fn = functools.partial(chain_stats.size_tail_plain, *args)
    else:
        inputs["rate"] = 500.0 * (plain.bounds[0] + plain.bounds[2])
        args = (inputs["rate"], cand, k_cols)
        wrapper = functools.partial(chain_stats.analyze, *args)
        plain_fn = functools.partial(chain_stats.analyze_plain, *args)
    out, valid = chain_stats.launch(
        cand, k_cols, entry, **{k: v for k, v in inputs.items()
                                if v is not None})
    lib = chain_stats.LIBRARY.load()
    ptrs = fields + [0 if t is None else t.data_ptr()
                     for t in (*inputs.values(), out, valid)]
    mode = 0 if entry == "tail" else 1
    return dict(
        wrapper=wrapper,
        alone=lambda: lib.chain_stats_launch(*ptrs, c, k_cols, mode, stream),
        outs=[out] + ([] if valid is None else [valid]), plain=plain_fn,
        work=lambda ops: chain_stats.work(cand, entry, ops))


def chain_times():
    """The chain setup, the sizing kernel and the chain statistics at
    CHAIN_TIMED's shapes: each entry through its wrapper and its C function
    alone (CUDA events, in turns: wrapper, launch, launch, wrapper) and on
    the device (profiler, twice), beside its bound and the bound's terms,
    with the sha256 of its outputs on fixed seeded inputs;
    an empty kernel's times as the launch floor, and the jacobian kernel's.
    Uses only what every version of the chain kernels has (copy the script
    into an older checkout to compare two trees in one call)."""
    import hashlib

    times = {"launch_floor": launch_floor(), "jacobian": jacobian_times()}
    for label, c, k_cols, entries in CHAIN_TIMED:
        cand, targets = chain_times_inputs(c, 700 + c)
        for entry in entries:
            calls = chain_entry_calls(entry, cand, targets, k_cols)
            torch.cuda.synchronize()
            digest = hashlib.sha256(b"".join(
                t.cpu().numpy().tobytes() for t in calls["outs"])).hexdigest()
            with OpCount() as count:
                calls["plain"]()
            work = calls["work"](count.pointwise_elements)
            bound_ms, term = work.bound()
            runs = {"wrapper": [], "alone": []}
            for turn in ("wrapper", "alone", "alone", "wrapper"):
                runs[turn].append(time_ms(calls[turn], 1000))
            kernel = CHAIN_TIMED_KERNELS[entry]
            times[f"{entry} C={c} k_cols={k_cols}"] = dict(
                shape=label, wrapper_ms=runs["wrapper"],
                launch_ms=runs["alone"],
                device_ms=[device_ms(calls["alone"], 200, kernel)
                           for _ in range(2)],
                bound_ms=bound_ms, bound_term=term,
                bounds_ms=work.bound_terms_ms(), sha256=digest)
    return times


def fit_wrapper_times():
    """``fc.fit_grid``'s time through the wrapper (CUDA events) and on the
    device (torch.profiler) at each of FIT_TIMED, using only what every
    version of the port has, so that two checkouts can be compared in one
    run on one card."""
    fit_kernel.LIBRARY.build()
    times = {}
    for name, (m, full) in FIT_TIMED.items():
        inputs = fit_inputs(m, 900 + m, full=full)

        def call():
            return fc.fit_grid(*inputs, m=m)

        times[name] = dict(
            wrapper_ms=min(time_ms(call, 200) for _ in range(3)),
            device_ms=device_ms(call, 200, "fit_grid_kernel"))
    return times


def chain_entry(name, source, replaces, launches, by_path, chain, part,
                card):
    """The kernels line's entry of one chain kernel's entry point."""
    t = chain["times"][part]
    shape = chain["analyze_shape" if part == "analyze" else "shape"]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": chain["max_abs_err"],
            "max_rel_err": chain["max_rel_err"], "ms": t["ms"],
            "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "plain_ops": t["plain_ops"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "bound_term": t["bound_term"],
            "bounds_ms": t["bounds_ms"], "library_ms": None,
            "shape": f"C={shape['c']}, k_cols={shape['k_cols']}",
            "card": card}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--only", choices=("fit", "fit-times", "sweep", "world", "chain",
                           "installed", "world-times", "fused-split",
                           "jacobian-times", "chain-times"),
        help="fit: phases 1 and 4 alone; fit-times: the fit's wrapper and "
        "device times alone (also in an older checkout); sweep: phases 1 and "
        "7 alone; world: phases 1 and 6 alone; chain: phases 1 and 3b alone "
        "(the fleet tick's batch restated); installed: phases 1 and 9 alone "
        "(the port installed from a wheel); world-times: the headline "
        "world's tick and tuner step alone (also in an older checkout); "
        "fused-split: the fused program's split by part on the headline "
        "world's grids; jacobian-times: the tuner step's h and H kernel "
        "alone; chain-times: the chain setup, sizing and statistics at the "
        "main paths' shapes, with output digests and the launch floor (these "
        "three also in an older checkout). "
        "None prints the result lines.")
    parser.add_argument(
        "--fleet-way", choices=list(FLEET_WAYS)[1:],
        help="run the fleet world this way alone and print its decisions, "
        "tick times and launches as JSON (phase 3 starts these itself)")
    parser.add_argument(
        "--installed-child", metavar="NPZ",
        help="build the kernels and write every kernel entry's outputs to "
        "NPZ (phase 9 starts this itself, with only the installed port on "
        "PYTHONPATH)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.installed_child:
        installed_child(args.installed_child)
        return 0
    if args.fleet_way:
        r = run_fleet_way(args.fleet_way)
        print(json.dumps({k: r[k] for k in ("decisions", "tick_ms",
                                            "launches", "total",
                                            "analyze")}))
        return 0
    if args.only == "fit-times":
        log(f"[fit-times] {json.dumps(fit_wrapper_times())}")
        return 0
    if args.only == "world-times":
        log(f"[world-times] {json.dumps(world_times())}")
        return 0
    if args.only == "jacobian-times":
        log(f"[jacobian-times] {json.dumps(jacobian_times())}")
        return 0
    if args.only == "chain-times":
        log(f"[chain-times] {json.dumps(chain_times())}")
        return 0
    if args.only == "fused-split":
        split = fused_split_times()
        log_fused_split(split, "this checkout")
        log(f"[fused-split] {json.dumps(split)}")
        return 0
    if chain_stats is None:
        print("chip_smoke: this checkout has no chain kernels",
              file=sys.stderr)
        return 1
    started = time.perf_counter()
    card, resources = phase_build()
    if args.only in ("fit", "sweep", "world", "chain", "installed"):
        phases = {"fit": (4, lambda: (phase_fit(), phase_forecast())),
                  "sweep": (7, phase_sweep), "world": (6, phase_world),
                  "chain": ("3b", phase_chain),
                  "installed": (9, phase_installed)}
        number, run = phases[args.only]
        run()
        log(f"[time] phases 1 and {number} took "
            f"{time.perf_counter() - started:.1f} s")
        return 0
    times = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            times[name] = time.perf_counter() - t0

    err, bench_timings = timed("2 sizing kernel", phase_kernel_vs_plain)
    tick = timed("3 fleet tick", phase_fleet_tick, err)
    t = tick["timing"]
    chain = timed("3b chain kernels", phase_chain, tick.pop("batch"),
                  tick.pop("analyze_inputs"))
    fit = timed("4 fit kernel", phase_fit)
    forecast = timed("4 forecast", phase_forecast)
    graft_run = timed("5 graft entry", phase_entry)
    world = timed("6 headline world", phase_world)
    sweep = timed("7 policy sweep", phase_sweep)
    golden = timed("8 golden worlds", phase_golden_worlds)
    installed = timed("9 installed wheel", phase_installed)
    log(f"[time] chip_smoke.py phases took "
        f"{time.perf_counter() - started:.1f} s: " + ", ".join(
            f"{name} {s:.1f}" for name, s in times.items()))
    sizing_launches, fit_launches, setup_launches, stats_launches = tick[
        "launches"]
    staged = tick["launches_by_way"]["staged"]
    # analyze_batch runs in the staged way's fleet solve (the main path's
    # solve reuses the fused sizing and calls it only for pairs the fused
    # program did not size): that way's measured ticks are its path.
    analyze_launches = tick["analyze"]["staged"]["launches"]
    world_launches = dict(zip(("sizing", "fit", "jacobian", "setup", "stats"),
                              world["launches"]))
    dryrun = {f"dryrun_multichip({n})": r["launches"]
              for n, r in graft_run["dryrun"].items()}
    log(json.dumps({"kernels": [{
        "name": "sizing_bisection",
        "route": "cuda",
        "source": "wva_tpu_torch/analyzers/queueing/csrc/sizing_bisection.cu",
        "replaces": "wva_tpu/analyzers/queueing/pallas_kernel.py:49",
        "launches": sizing_launches,
        "launches_by_path": {
            "fleet tick through the Manager (12 ticks)": sizing_launches,
            "headline world (2280 s)": world["launches"][0],
            "policy sweep fidelity event run": sweep["fidelity_launches"][0],
            "graft entry": graft_run["entry_launches"], **dryrun,
            "shard golden world (900 s)": golden["shard"]["launches"][0],
            "federation golden world (480 s)":
                golden["federation"]["launches"][0]},
        "max_abs_err": err.max_abs,
        "max_rel_err": err.max_rel,
        "ms": t["kernel_ms"],
        "kernel_ms": t["kernel_ms"],
        "launch_ms": t["launch_ms"],
        "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "bound_term": t["bound_term"],
        "bounds_ms": t["bounds_ms"],
        "library_ms": None,
        "shape": "the fleet tick's first sizing call",
        "rows_per_block": sizing_kernel.ROWS_PER_BLOCK,
        "ms_by_variant": t["ms_by_variant"],
        "bench": bench_timings,
        "fleet_tick": {k: v for k, v in tick.items() if k != "timing"},
        "headline_world": world,
        "policy_sweep": sweep,
        "graft": graft_run,
        "golden_worlds": golden,
        "installed": installed,
        "phase_s": times,
        "resources": resources,
        "card": card,
    }, {
        "name": "fit_grid",
        "route": "cuda",
        "source": "wva_tpu_torch/forecast/csrc/fit_grid.cu",
        "replaces": "wva_tpu/forecast/forecasters.py:104 (an XLA program)",
        "launches": fit_launches,
        "launches_by_path": {
            "fleet tick through the Manager (12 ticks)": fit_launches,
            "headline world (2280 s)": world["launches"][1],
            "policy sweep fidelity event run": sweep["fidelity_launches"][1],
            "forecast backtest (golden trace)":
                forecast["backtest_launches"],
            "forecast golden world (2400 s)": forecast["world_launches"],
            "shard golden world (900 s)": golden["shard"]["launches"][1],
            "federation golden world (480 s)":
                golden["federation"]["launches"][1]},
        "max_abs_err": fit["max_abs_err"],
        "ms": fit["kernel_ms"],
        "launch_ms": fit["launch_ms"],
        "device_ms": fit["device_ms"],
        "plain_ms": fit["plain_ms"],
        "plain_ops": fit["plain_ops"],
        "bound_ms": fit["bound_ms"],
        "bound_by": fit["bound_by"],
        "bound_term": fit["bound_term"],
        "bounds_ms": fit["bounds_ms"],
        "library_ms": None,
        "shape": "M=1024, the fleet tick's model bucket",
        "rows_per_block": fit_kernel.ROWS_PER_BLOCK,
        "device_ms_by_rows": {name: t["device_ms"]
                              for name, t in fit["by_rows"].items()},
        "by_rows": fit["by_rows"],
        "probe": fit["probe"],
        "forecast": forecast,
        "card": card,
    }, {
        "name": "world_scan",
        "route": "cuda",
        "source": "wva_tpu_torch/sweep/csrc/world_scan.cu",
        "replaces": "wva_tpu/sweep/world.py:177 (an XLA program, "
                    "jit(lax.scan))",
        "launches": sweep["search_launches"],
        "launches_by_path": {
            "policy sweep grid search (1536 + 16 worlds)":
                sweep["search_launches"],
            "256-world batch": sweep["batch_launches"],
            "policy sweep fidelity fluid run": sweep["fidelity_launches"][2]},
        "max_abs_err": sweep["scan"]["max_abs_err"],
        "ms": sweep["scan"]["kernel_ms"],
        "device_ms": sweep["scan"]["device_ms"],
        "device_ms_by_width": sweep["scan"]["device_ms_by_width"],
        "ms_by_width": sweep["scan"]["ms_by_width"],
        "cycles_per_step": sweep["scan"]["cycles_per_step"],
        "sm_clock_mhz": sweep["scan"]["sm_clock_mhz"],
        "registers": sweep["scan"]["registers"],
        "shared_bytes": sweep["scan"]["shared_bytes"],
        "probe": sweep["scan"]["probe"],
        "general_folds": sweep["scan"]["general_folds"],
        "chunk_host_ms": sweep["chunk_host_ms"],
        "plain_ms": sweep["scan"]["plain_ms"],
        "plain_ops": sweep["scan"]["plain_ops"],
        "bound_ms": sweep["scan"]["bound_ms"],
        "bound_by": sweep["scan"]["bound_by"],
        "bound_term": sweep["scan"]["bound_term"],
        "bounds_ms": sweep["scan"]["bounds_ms"],
        "library_ms": None,
        "shape": "the bench chunk: W=256, M=1, T=240, L=24",
        "python_ms_per_world": sweep["python_ms_per_world"],
        "ratio_vs_python": sweep["ratio_vs_python"],
        "card": card,
    }, {
        "name": "ekf_jacobian",
        "route": "cuda",
        "source": "wva_tpu_torch/analyzers/queueing/csrc/chain_stats.cu",
        "replaces": "wva_tpu/analyzers/queueing/tuner.py:158 (an XLA "
                    "program, jax.jacfwd through _chain_stats)",
        "jacobian_vs_plain_chain_phase": chain["jacobian"],
        "launches": world["launches"][2],
        "launches_by_path": {
            "headline world (2280 s)": world["launches"][2]},
        "tuner_steps": world["tuner"]["steps"],
        "max_abs_err": world["jacobian"]["max_abs_err"],
        "max_rel_err": world["jacobian"]["max_rel_err"],
        "ms": world["tuner_step"]["wrapper_ms"],
        "launch_ms": world["tuner_step"]["launch_ms"],
        "device_ms": world["tuner_step"]["device_ms"],
        "plain_ms": world["tuner_step"]["plain_ms"],
        "plain_ops": world["tuner_step"]["plain_ops"],
        "bound_ms": world["tuner_step"]["bound_ms"],
        "bound_by": world["tuner_step"]["bound_by"],
        "bound_term": world["tuner_step"]["bound_term"],
        "bounds_ms": world["tuner_step"]["bounds_ms"],
        "library_ms": None,
        "shape": "one tuner step: C=1, 2048 states, 3 tangents",
        "card": card,
    }, chain_entry(
        "chain_setup", "wva_tpu_torch/analyzers/queueing/csrc/chain_setup.cu",
        "wva_tpu/analyzers/queueing/queue_model.py:155 (an XLA program: "
        "_cum_log_mu with rate_bounds_per_ms and the gather at k)",
        setup_launches, {
            "fleet tick through the Manager (12 ticks)": setup_launches,
            "headline world (2280 s)": world_launches["setup"],
            "fleet tick, staged way (12 ticks)": staged[2]},
        chain, "setup", card), chain_entry(
        "chain_stats (sizing tail)",
        "wva_tpu_torch/analyzers/queueing/csrc/chain_stats.cu",
        "wva_tpu/analyzers/queueing/queue_model.py:229 (an XLA program: "
        "_chain_stats and _derived_latencies at the binding rate)",
        stats_launches, {
            "fleet tick through the Manager (12 ticks)": stats_launches,
            "headline world (2280 s)": world_launches["stats"]},
        chain, "tail", card), chain_entry(
        "chain_stats (analyze_batch)",
        "wva_tpu_torch/analyzers/queueing/csrc/chain_stats.cu",
        "wva_tpu/analyzers/queueing/queue_model.py:293 (an XLA program: "
        "analyze_batch through _chain_stats)",
        analyze_launches, {
            "fleet tick, staged way (12 ticks; the fleet solve sizes its "
            "own pairs)": analyze_launches,
            "fleet tick through the Manager (12 ticks; the fleet solve "
            "reuses the fused sizing)": tick["analyze"]["fused"]["launches"]},
        chain, "analyze", card)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
