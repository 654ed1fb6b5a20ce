#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``wva_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Build both kernels, one ``nvcc`` each, started together: the sizing
   bisection from ``wva_tpu_torch/analyzers/queueing/csrc/
   sizing_bisection.cu`` and the forecaster fits from ``wva_tpu_torch/
   forecast/csrc/fit_grid.cu``. Print the build time, each sizing
   instantiation's registers, spills and shared memory (it fails on a
   spill), the SASS instructions per 32-state chunk, the fit kernel's
   registers, spills and local memory a thread, and the card's name and
   power limit.
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
3. Drive the port's main path at full size: a seeded fleet of 1000 models x
   2 variants (v5e-8, v5p-8) through 3 ticks of ``run_slo_pass``, 15 s
   apart on a FakeClock — once through the kernel, once with analyzers
   forced to the plain version on the card. Target replicas must be equal,
   per-replica capacities agree at rtol 2e-3, and the kernel must launch
   exactly once per tick. Then time the same on the slice's own sizing
   batch (C=2048, k_cols=512); the wrapper's time there is the kernel's
   ``ms``.
4. Hold the forecaster-fit kernel (``wva_tpu_torch/forecast/csrc/
   fit_grid.cu``) against its plain version on the card at M in {1, 7,
   1024, 4096} rows, with valid counts 0-160, seasons 1-160 and the
   horizons of tests/test_fused_plane.py: rtol 2e-3 with an absolute floor
   of 1e-4 x (1 + the row's largest forecast); seasonal_naive and every
   persistence fallback bitwise; a row bitwise unchanged by padding 1 ->
   1024 and by row order. Time, with CUDA events at M=1024, the kernel
   through its wrapper, the launch alone and the plain version (with the
   count of PyTorch ops it dispatches), beside the bound.
5. Drive this slice's main path, the fused SLO tick, at full size: 1000
   models x 2 variants, a quarter routed to the fleet solve, each model's
   demand history pre-filled over 2.5 days, forecasting on, 12 ticks, four
   ways: ``run_fused_pass`` with the solve memo on (the main path, with the
   kernels' counts set to 0 just before it), with it off, the staged
   ``run_slo_pass``, and the fused tick with both kernels' plain versions.
   Decisions (target replicas, action, accelerator) must be equal across
   the four, and forecast plans equal between fused and staged. A solve
   tick launches the sizing kernel once and the fit kernel once, a
   memo-hit tick the fit kernel once and the sizing kernel never. Then the
   fleet solve is run with and without the fused sizing (``presized``) on
   the global-routed models: replicas and accelerators must be equal, and
   the rates' bit differences are printed.
6. Print one JSON line describing every kernel of the path.
7. Print ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""

import collections
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from wva_tpu_torch import cuda_build, fused
from wva_tpu_torch.analyzers.queueing import _build, sizing_kernel
from wva_tpu_torch.analyzers.queueing import queue_model as qm
from wva_tpu_torch.analyzers.queueing.analyzer import (
    QueueingModelAnalyzer,
    build_sizing_batch,
)
from wva_tpu_torch.analyzers.queueing.convert import profile_store_from_records
from wva_tpu_torch.analyzers.queueing.params import TargetPerf
from wva_tpu_torch.config.slo import SLOConfigData
from wva_tpu_torch.engines import slo_pass
from wva_tpu_torch.engines.slo_pass import (
    FleetRoute,
    run_fused_pass,
    run_slo_pass,
)
from wva_tpu_torch.fleet import SolverSpec, build_candidates, solve
from wva_tpu_torch.forecast import fit_kernel
from wva_tpu_torch.forecast import forecasters as fc
from wva_tpu_torch.forecast.planner import CapacityPlanner
from wva_tpu_torch.interfaces import (
    AnalyzerInput,
    ReplicaMetrics,
    SaturationScalingConfig,
    VariantReplicaState,
)
from wva_tpu_torch.interfaces.allocation import OptimizerMetrics
from wva_tpu_torch.pipeline.optimizer import CostAwareOptimizer
from wva_tpu_torch.utils.clock import FakeClock

RTOL = 2e-3
RTOL_DISABLED = 1e-5
INSTANTIATIONS = {8, 16, 32, 64}  # values per lane (NV), k_cols 256..2048
ROWS_TRIED = (4, 8)  # rows per block timed; the sizing path runs 8

CUDA = torch.device("cuda")


def log(*args):
    print(*args, flush=True)


def require(ok, what):
    """Fail the run (a bare assert would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# ---------------------------------------------------------------- phase 1


def phase_build():
    libraries = (_build.LIBRARY, fit_kernel.LIBRARY)
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
    (fit,) = cuda_build.resources(fit_kernel.LIBRARY.build_log())
    log(f"[build] fit_grid: {fit['registers']} registers, "
        f"{fit['spill_stores']} B spill stores, {fit['spill_loads']} B "
        f"spill loads, {fit['stack']} B local memory a thread (the seasonal "
        f"terms), {fit['smem']} B shared memory")
    resources.append(dict(kernel="fit_grid", **fit))
    fit_sass = sass_opcodes(paths[1], "fit_grid_kernel")
    log(f"[build] fit_grid SASS: {sum(fit_sass.values())} instructions: "
        + ", ".join(f"{op} {n}" for op, n in fit_sass.most_common(12)))
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


def sass_opcodes(library, kernel):
    found = [ops for name, ops in sass_functions(library) if kernel in name]
    require(len(found) == 1, f"SASS functions named {kernel}: {len(found)}")
    return found[0]


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

N_MODELS = 1000
TICKS = 3
TICK_SECONDS = 15.0
ACCELERATORS = (("v5e-8", 10.0, 1.0), ("v5p-8", 30.0, 0.5))  # name, cost, speed


def fleet(seed=20261016):
    """1000 models x (v5e-8, v5p-8): profiles around the bench.py ranges
    with max_batch_size 96 / max_queue_size 384, and per-tick inputs whose
    demand spans under- and over-provisioned models."""
    rng = np.random.default_rng(seed)
    records, models = [], []
    for m in range(N_MODELS):
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
                                 cost=cost, ready=int(rng.integers(0, 5)),
                                 pending=int(rng.integers(0, 2))))
        models.append(dict(
            model_id=model_id, namespace=f"ns-{m % 8}", variants=variants,
            avg_in=float(rng.uniform(128, 2048)),
            avg_out=float(rng.uniform(64, 1024)),
            rates_per_s=np.exp(rng.uniform(np.log(0.5), np.log(150.0)))
            * rng.uniform(0.8, 1.25, TICKS)))
    return records, models


def tick_inputs(models, tick, cfg):
    return [AnalyzerInput(
        model_id=md["model_id"], namespace=md["namespace"],
        replica_metrics=[ReplicaMetrics(
            pod_name=f"{v['name']}-0", variant_name=v["name"],
            model_id=md["model_id"], namespace=md["namespace"],
            accelerator_name=v["accelerator"], cost=v["cost"],
            avg_input_tokens=md["avg_in"], avg_output_tokens=md["avg_out"])
            for v in md["variants"]],
        variant_states=[VariantReplicaState(
            variant_name=v["name"], accelerator_name=v["accelerator"],
            current_replicas=v["ready"] + v["pending"],
            desired_replicas=v["ready"] + v["pending"],
            pending_replicas=v["pending"]) for v in md["variants"]],
        config=SaturationScalingConfig(analyzer_name="slo"),
        optimizer_metrics=OptimizerMetrics(
            arrival_rate=float(md["rates_per_s"][tick]) * 60.0),
        slo_config=cfg) for md in models]


def run_ticks(analyzer, clock, models, cfg, count_launches):
    optimizer = CostAwareOptimizer()
    decisions, tick_ms = [], []
    for tick in range(TICKS):
        inputs = tick_inputs(models, tick, cfg)
        before = sizing_kernel.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decisions.append(run_slo_pass(analyzer, optimizer, inputs))
        torch.cuda.synchronize()
        tick_ms.append(1e3 * (time.perf_counter() - t0))
        if count_launches:
            require(sizing_kernel.launches == before + 1,
                    f"tick {tick}: {sizing_kernel.launches - before} launches")
        clock.advance(TICK_SECONDS)
    return decisions, tick_ms


def phase_slice(err):
    records, models = fleet()
    cfg = SLOConfigData(default_targets=TargetPerf(
        target_ttft_ms=1000.0, target_itl_ms=50.0))

    def analyzer(impl):
        clock = FakeClock(1000.0)
        return clock, QueueingModelAnalyzer(
            profiles=profile_store_from_records(records), clock=clock,
            device=CUDA, impl=impl)

    clk_k, an_k = analyzer(None)
    clk_p, an_p = analyzer("plain")
    sizing_kernel.launches = 0
    got, tick_ms = run_ticks(an_k, clk_k, models, cfg, count_launches=True)
    launches = sizing_kernel.launches
    want, plain_tick_ms = run_ticks(an_p, clk_p, models, cfg,
                                    count_launches=False)
    require(launches == TICKS, f"{launches} launches in {TICKS} ticks")

    ups = downs = 0
    for tick, (a, b) in enumerate(zip(got, want)):
        require(len(a) == len(b) == 2 * N_MODELS, (tick, len(a), len(b)))
        for da, db in zip(a, b):
            key_a = (da.model_id, da.namespace, da.variant_name,
                     da.accelerator_name, da.target_replicas, da.action)
            key_b = (db.model_id, db.namespace, db.variant_name,
                     db.accelerator_name, db.target_replicas, db.action)
            require(key_a == key_b, (tick, key_a, key_b))
            ups += da.action == "scale-up"
            downs += da.action == "scale-down"
        log(f"[slice] tick {tick}: {2 * N_MODELS} decisions equal; kernel "
            f"tick {tick_ms[tick]:.1f} ms, plain tick "
            f"{plain_tick_ms[tick]:.1f} ms")
    require(ups and downs, f"scale-ups {ups}, scale-downs {downs}")

    # The per-replica capacities those ticks sized, kernel against plain.
    plans = [an_k.prepare(inp) for inp in tick_inputs(models, 0, cfg)]
    cands = [c for p in plans for c in p.candidates]
    require(len(cands) == 2 * N_MODELS, len(cands))
    sizing_ms = {}
    caps = {}
    for name, an in (("kernel", an_k), ("plain", an_p)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caps[name] = torch.tensor(an.size_candidates(cands),
                                  dtype=torch.float64)
        sizing_ms[name] = 1e3 * (time.perf_counter() - t0)
    cap_k, cap_p = caps["kernel"], caps["plain"]
    log(f"[slice] one size_candidates call over {len(cands)} candidates: "
        f"kernel {sizing_ms['kernel']:.2f} ms, plain "
        f"{sizing_ms['plain']:.2f} ms (host clock, includes batch build)")
    require(torch.isfinite(cap_k).all() and (cap_k > 0).all(),
            "capacities must be finite and positive")
    rel = float(((cap_k - cap_p).abs() / cap_p.abs()).max())
    require(rel <= RTOL, f"per-replica capacity max rel err {rel:.3g}")
    log(f"[slice] {N_MODELS} models x 2 variants, {TICKS} ticks: "
        f"{ups} scale-ups, {downs} scale-downs; launches {launches} "
        f"(1 per tick); capacities max rel err {rel:.3g}")

    # The kernel at the shape and on the data of the slice's sizing call.
    cand, t_ttft, t_itl, _, ks = build_sizing_batch(cands, CUDA)
    args = bisection_args(cand, torch.stack([t_ttft, t_itl]),
                          qm.k_cols_for(ks))
    return launches, time_kernel_and_plain(args, err)


# ---------------------------------------------------------------- phase 4

FIT_ROWS = (1, 7, 1024, 4096)
FIT_TIMED_ROWS = 1024  # the slice's model bucket
FIT_ATOL_SCALE = 1e-4


def fit_inputs(m, seed):
    """Seeded fit inputs on the card: values 0-10, valid counts 0-160,
    horizons 0-20 (fine) and 0-5 (long) steps (tests/test_fused_plane.py
    :249-260), seasons 1-160."""
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(0, 10, (m, fc.N_GRID)).astype(np.float32),
              rng.integers(0, fc.N_GRID + 1, m).astype(np.float32),
              rng.uniform(0, 10, (m, fc.N_GRID)).astype(np.float32),
              rng.integers(0, fc.N_GRID + 1, m).astype(np.float32),
              rng.uniform(0, 20, m).astype(np.float32),
              rng.uniform(0, 5, m).astype(np.float32),
              rng.integers(1, fc.N_GRID + 1, m).astype(np.int32))
    return [torch.from_numpy(a).to(CUDA) for a in arrays]


def check_fits(got, want, inputs, what):
    """The fit's tolerance; returns (max abs err, values not bitwise
    equal)."""
    torch.cuda.synchronize()
    require(got.shape == want.shape, (what, got.shape, want.shape))
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    diff = (got - want).abs()
    scale = 1.0 + want.abs().amax(dim=0)
    bad = diff > RTOL * want.abs() + FIT_ATOL_SCALE * scale
    require(not bool(bad.any()),
            f"{what}: {int(bad.sum())} forecasts beyond tolerance")
    sn = fc.FORECASTERS.index("seasonal_naive")
    require(torch.equal(got[sn], want[sn]), f"{what}: seasonal_naive bits")
    short_fine = inputs[1] < fc.MIN_VALID
    short_long = inputs[3] < fc.MIN_VALID
    require(torch.equal(got[:2, short_fine], want[:2, short_fine])
            and torch.equal(got[2:, short_long], want[2:, short_long]),
            f"{what}: a persistence fallback's bits")
    return float(diff.max()), int((got != want).sum())


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
    launches at most about one kernel)."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def phase_fit():
    max_abs = 0.0
    for m in FIT_ROWS:
        inputs = fit_inputs(m, 700 + m)
        got = fc.fit_grid(*inputs, m=m)
        want = fc.fit_grid_plain(*inputs, m=m)
        err, differ = check_fits(got, want, inputs, f"fit M={m}")
        max_abs = max(max_abs, err)
        log(f"[fit] M={m:5d}: max abs err {err:.3g} vs plain; {differ} of "
            f"{got.numel()} values not bitwise equal")
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

    # Times at the slice's bucket: plain first and last, the rest between.
    m = FIT_TIMED_ROWS
    inputs = fit_inputs(m, 900)
    out = torch.empty((len(fc.FORECASTERS), m), dtype=torch.float32,
                      device=CUDA)
    calls = {"wrapper": lambda: fc.fit_grid(*inputs, m=m),
             "launch": lambda: fit_kernel.launch(*inputs, out)}
    counter = OpCount()
    with counter:
        fc.fit_grid_plain(*inputs, m=m)
    p1 = time_ms(lambda: fc.fit_grid_plain(*inputs, m=m), 3)
    runs = {name: [] for name in calls}
    for turn in (list(calls), list(calls)[::-1]):
        for name in turn:
            runs[name].append(time_ms(calls[name], 50))
    p2 = time_ms(lambda: fc.fit_grid_plain(*inputs, m=m), 3)
    ms = {name: sum(t) / len(t) for name, t in runs.items()}
    on_device = device_ms(calls["launch"], 50, "fit_grid_kernel")
    log("[fit] M=1024: the kernel on the device "
        + ("not measured (no device time in the profiler's trace)"
           if on_device is None else f"{on_device:.4f} ms a launch")
        + " (torch.profiler)")
    work = fit_kernel.work(m)
    bound_ms, term = work.bound()
    terms = work.bound_terms_ms()
    log(f"[fit] M={m}: wrapper {'/'.join(f'{x:.4f}' for x in runs['wrapper'])}"
        f" ms, launch {'/'.join(f'{x:.4f}' for x in runs['launch'])} ms; "
        f"plain {p1:.2f}/{p2:.2f} ms ({counter.ops} PyTorch ops); bound "
        f"{bound_ms:.4f} ms ({term}; "
        + ", ".join(f"{n} {x:.4f}" for n, x in terms.items())
        + f"); wrapper at {100 * bound_ms / ms['wrapper']:.1f}% of the "
        f"bound; library: none")
    return dict(max_abs_err=max_abs, kernel_ms=ms["wrapper"],
                launch_ms=ms["launch"], device_ms=on_device,
                plain_ms=(p1 + p2) / 2,
                plain_ops=counter.ops, bound_ms=bound_ms,
                bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term, bounds_ms=terms)


# ---------------------------------------------------------------- phase 5

FUSED_TICKS = 12
T0 = 1_000_000.0
DAY = 86400.0
LEAD_SECONDS = 45.0
SHAPES = ("sine", "ramp", "growth", "step")
WAYS = ("fused", "memo off", "staged", "plain")


def forecast_fleet(seed=20261020):
    """1000 models x (v5e-8, v5p-8), profiles as :func:`fleet`, and per
    model a demand shape (daily sine; a ramp starting with the run; a daily
    sine growing 4x a day; a daily square wave), a quarter routed "global",
    and how much history is pre-filled (most 2.5 days; every 12th two
    samples, so the long grid stays under MIN_VALID; every 12th other
    none). Every 5th model's prompt length drifts at ticks 4 and 8, so
    those ticks re-solve and the rest hit the solve memo. The world of
    tests/test_torch_slice.py at full width."""
    rng = np.random.default_rng(seed)
    records, models = [], []
    for m in range(N_MODELS):
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
                                 cost=cost, ready=int(rng.integers(0, 5)),
                                 pending=int(rng.integers(0, 2))))
        models.append(dict(
            model_id=model_id, namespace=f"ns-{m % 8}", variants=variants,
            avg_in=float(rng.uniform(128, 2048)),
            avg_out=float(rng.uniform(64, 1024)),
            base=float(np.exp(rng.uniform(np.log(0.5), np.log(150.0)))),
            shape=SHAPES[m % 4], phase=float(rng.uniform(0, 2 * np.pi)),
            noise_seed=int(rng.integers(1 << 30)), route_global=m % 8 in (1, 6),
            drifts=m % 5 == 0,
            history=("none" if m % 12 == 11 else
                     "short" if m % 12 == 7 else "full")))
    return records, models


def demand(md, t):
    noise = np.random.default_rng([md["noise_seed"], int(round(t))]).uniform(
        0.97, 1.03)
    wave = math.sin(2 * math.pi * t / DAY + md["phase"])
    shape = {"sine": 1.0 + 0.5 * wave,
             "ramp": 1.0 + max(t - (T0 - 60.0), 0.0) / 600.0,
             "growth": (1.0 + 0.5 * wave) * (1.0 + 4.0 * (t - T0 + DAY) / DAY),
             "step": 2.0 if wave > 0 else 1.0}[md["shape"]]
    return md["base"] * shape * noise


def prefill(planner, models):
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


def fused_inputs(models, tick, cfg):
    now = T0 + tick * TICK_SECONDS
    inputs = []
    for md in models:
        drift = 1.0 + 0.25 * (tick // 4) if md["drifts"] else 1.0
        inputs.append(AnalyzerInput(
            model_id=md["model_id"], namespace=md["namespace"],
            replica_metrics=[ReplicaMetrics(
                pod_name=f"{v['name']}-0", variant_name=v["name"],
                model_id=md["model_id"], namespace=md["namespace"],
                accelerator_name=v["accelerator"], cost=v["cost"],
                avg_input_tokens=md["avg_in"] * drift,
                avg_output_tokens=md["avg_out"])
                for v in md["variants"]],
            variant_states=[VariantReplicaState(
                variant_name=v["name"], accelerator_name=v["accelerator"],
                current_replicas=v["ready"] + v["pending"],
                desired_replicas=v["ready"] + v["pending"],
                pending_replicas=v["pending"]) for v in md["variants"]],
            config=SaturationScalingConfig(
                analyzer_name="slo",
                optimizer_name="global" if md["route_global"] else ""),
            optimizer_metrics=OptimizerMetrics(
                arrival_rate=demand(md, now) * 60.0),
            slo_config=cfg))
    return inputs


class Stages:
    """Host-clock time of each stage of a tick: wraps the functions the
    tick calls, and sums their calls' times per tick under a label."""

    TIMED = ((QueueingModelAnalyzer, "prepare", "prepare"),
             (QueueingModelAnalyzer, "size_candidates", "sizing call"),
             (CapacityPlanner, "prepare_tick", "planner learning pass"),
             (fused, "build_candidate_axis", "grids"),
             (fused, "build_model_axis", "grids"),
             (fused, "run", "fused program"),
             (QueueingModelAnalyzer, "finalize", "finalize"),
             (FleetRoute, "decide", "fleet solve"),
             (CostAwareOptimizer, "optimize", "cost-aware optimizer"),
             (CapacityPlanner, "plan", "planner plan"))

    def __init__(self):
        self.ticks = []
        self._saved = []

    def __enter__(self):
        for owner, name, label in self.TIMED:
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._timed(fn, label))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)

    def _timed(self, fn, label):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                tick = self.ticks[-1]
                tick[label] = tick.get(label, 0.0) + 1e3 * (
                    time.perf_counter() - t0)
        return timed

    def mean_ms(self):
        labels = dict.fromkeys(k for t in self.ticks for k in t)
        return {k: sum(t.get(k, 0.0) for t in self.ticks) / len(self.ticks)
                for k in labels}


def run_way(way, records, models, cfg):
    """12 ticks one way. The fused way is the main path: both kernels'
    counts are set to 0 just before it and read just after, tick by tick."""
    clock = FakeClock(T0)
    analyzer = QueueingModelAnalyzer(
        profiles=profile_store_from_records(records), clock=clock,
        device=CUDA, impl="plain" if way == "plain" else None)
    planner = CapacityPlanner(default_lead_time_seconds=LEAD_SECONDS,
                              device=CUDA)
    prefill(planner, models)
    fleet, optimizer = FleetRoute(), CostAwareOptimizer()
    fused.clear_solve_memo()
    decisions, tick_ms, launches, solves, fleet_solves = [], [], [], [], []
    solve_fleet = slo_pass.solve

    def recorded_solve(system, spec, presized=None, device=None):
        fleet_solves.append((system, presized))
        return solve_fleet(system, spec, presized=presized, device=device)

    slo_pass.solve = recorded_solve
    try:
        with Stages() as stages:
            if way == "fused":
                sizing_kernel.launches = fit_kernel.launches = 0
            for tick in range(FUSED_TICKS):
                inputs = fused_inputs(models, tick, cfg)
                before = (sizing_kernel.launches, fit_kernel.launches,
                          fused.solve_memo_counters()["solve_ticks"])
                stages.ticks.append({})
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if way == "staged":
                    out = run_slo_pass(analyzer, optimizer, inputs, planner,
                                       fleet)
                else:
                    out = run_fused_pass(analyzer, optimizer, inputs, planner,
                                         fleet, memo=way == "fused")
                torch.cuda.synchronize()
                tick_ms.append(1e3 * (time.perf_counter() - t0))
                decisions.append(out)
                launches.append((sizing_kernel.launches - before[0],
                                 fit_kernel.launches - before[1]))
                solves.append(fused.solve_memo_counters()["solve_ticks"]
                              > before[2])
                clock.advance(TICK_SECONDS)
            total = (sizing_kernel.launches, fit_kernel.launches)
    finally:
        slo_pass.solve = solve_fleet
    require(len(fleet_solves) == FUSED_TICKS,
            f"{way}: {len(fleet_solves)} fleet solves in {FUSED_TICKS} ticks")
    return dict(decisions=decisions, tick_ms=tick_ms, launches=launches,
                total=total, solve_ticks=solves, fleet_solves=fleet_solves,
                program_ms=[t["fused program"] for t in stages.ticks
                            if "fused program" in t],
                stages_ms=stages.mean_ms(),
                plans={k: dataclasses.asdict(p)
                       for k, p in planner._last_plan.items()},
                trusted=collections.Counter(
                    p.forecaster for p in planner._last_plan.values()
                    if p.trusted))


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
    log(f"[presized] {what}: {len(own)} servers, {pairs} pairs: replicas, "
        f"accelerators and allocations equal; rate_star bits differ on "
        f"{differ} pairs, max {max(ulps)} ulp")
    return dict(pairs=pairs, differ=differ, max_ulp=max(ulps))


def phase_fused_tick():
    records, models = forecast_fleet()
    cfg = SLOConfigData(default_targets=TargetPerf(
        target_ttft_ms=1000.0, target_itl_ms=50.0))
    t0 = time.perf_counter()
    runs = {way: run_way(way, records, models, cfg) for way in WAYS}
    log(f"[fused] {len(WAYS)} ways x {FUSED_TICKS} ticks in "
        f"{time.perf_counter() - t0:.1f} s")
    main = runs["fused"]
    for tick in range(FUSED_TICKS):
        keys = {way: [(d.model_id, d.namespace, d.variant_name,
                       d.accelerator_name, d.target_replicas, d.action)
                      for d in r["decisions"][tick]]
                for way, r in runs.items()}
        require(len(keys["fused"]) == 2 * N_MODELS,
                (tick, len(keys["fused"])))
        for way in WAYS[1:]:
            require(keys[way] == keys["fused"],
                    f"tick {tick}: {way} decisions differ from fused")
        sizing, fit = main["launches"][tick]
        want = (1, 1) if main["solve_ticks"][tick] else (0, 1)
        require((sizing, fit) == want,
                f"tick {tick}: sizing {sizing}, fit {fit} launches; "
                f"expected {want}")
    require(runs["staged"]["plans"] == main["plans"],
            "forecast plans differ between fused and staged")
    solve_ticks = sum(main["solve_ticks"])
    require(0 < solve_ticks < FUSED_TICKS, f"{solve_ticks} solve ticks")
    flat = [d for tick in main["decisions"] for d in tick]
    steps = [{s.name for s in d.decision_steps} for d in flat]
    n_global = sum("optimizer:global" in s for s in steps)
    n_floor = sum("forecast" in s for s in steps)
    require(n_global == FUSED_TICKS * N_MODELS // 2,
            f"{n_global} fleet-solved decisions")
    require(n_floor > 0, "no forecast floor raised")
    trusted = main["trusted"]
    require({"holt", "seasonal_naive", "holt_winters"} <= set(trusted),
            f"trusted forecasters: {dict(trusted)}")
    ups = sum(d.action == "scale-up" for d in flat)
    downs = sum(d.action == "scale-down" for d in flat)
    for way, r in runs.items():
        log(f"[fused] {way}: tick ms "
            + ", ".join(f"{x:.1f}" for x in r["tick_ms"])
            + (f"; fused program ms "
               + ", ".join(f"{x:.2f}" for x in r["program_ms"])
               if r["program_ms"] else ""))
        mean_tick = sum(r["tick_ms"]) / FUSED_TICKS
        stages = r["stages_ms"]
        log(f"[stages] {way}: mean tick {mean_tick:.1f} ms = "
            + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
            + f", the rest {mean_tick - sum(stages.values()):.1f} (host "
            f"clock, mean over the ticks)")
    log(f"[fused] {N_MODELS} models x 2 variants, {FUSED_TICKS} ticks: "
        f"decisions equal across {', '.join(WAYS)}; forecast plans equal "
        f"fused/staged; {solve_ticks} solve ticks (1 sizing + 1 fit launch "
        f"each), {FUSED_TICKS - solve_ticks} memo-hit ticks (1 fit launch); "
        f"{n_global} fleet-solved decisions, {n_floor} raised by forecast "
        f"floors, {ups} scale-ups, {downs} scale-downs; trusted models by "
        f"forecaster at the end: {dict(trusted)}")
    checks = [presized_check(*main["fleet_solves"][i], f"tick {i}")
              for i in (0, FUSED_TICKS - 1)]
    return dict(launches=main["total"], runs={
        way: dict(tick_ms=r["tick_ms"], program_ms=r["program_ms"],
                  stages_ms=r["stages_ms"])
        for way, r in runs.items()}, presized=checks,
        trusted=dict(trusted), solve_ticks=solve_ticks)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    started = time.perf_counter()
    card, resources = phase_build()
    err, bench_timings = phase_kernel_vs_plain()
    staged_launches, t = phase_slice(err)
    fit = phase_fit()
    tick = phase_fused_tick()
    sizing_launches, fit_launches = tick["launches"]
    require(sizing_launches > 0 and fit_launches > 0,
            f"main path launches: sizing {sizing_launches}, "
            f"fit {fit_launches}")
    log(f"[time] chip_smoke.py phases took "
        f"{time.perf_counter() - started:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "sizing_bisection",
        "route": "cuda",
        "source": "wva_tpu_torch/analyzers/queueing/csrc/sizing_bisection.cu",
        "replaces": "wva_tpu/analyzers/queueing/pallas_kernel.py:49",
        "launches": sizing_launches,
        "launches_by_path": {"fused tick (12 ticks)": sizing_launches,
                             "staged SLO pass (3 ticks)": staged_launches},
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
        "shape": "the slice's sizing call",
        "rows_per_block": sizing_kernel.ROWS_PER_BLOCK,
        "ms_by_variant": t["ms_by_variant"],
        "bench": bench_timings,
        "resources": resources,
        "card": card,
    }, {
        "name": "fit_grid",
        "route": "cuda",
        "source": "wva_tpu_torch/forecast/csrc/fit_grid.cu",
        "replaces": "wva_tpu/forecast/forecasters.py:104 (an XLA program)",
        "launches": fit_launches,
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
        "shape": f"M={FIT_TIMED_ROWS}, the slice's model bucket",
        "fused_tick": tick,
        "card": card,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
