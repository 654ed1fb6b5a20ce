#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``wva_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Build the sizing-bisection kernel from ``wva_tpu_torch/analyzers/
   queueing/csrc/sizing_bisection.cu`` and print the build time, each
   instantiation's registers, spills and shared memory (it fails on a
   spill), the SASS instructions per 32-state chunk, and the card's name
   and power limit.
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
4. Print one JSON line describing every kernel of the path.
5. Print ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""

import collections
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from wva_tpu_torch.analyzers.queueing import _build, sizing_kernel
from wva_tpu_torch.analyzers.queueing import queue_model as qm
from wva_tpu_torch.analyzers.queueing.analyzer import (
    QueueingModelAnalyzer,
    build_sizing_batch,
)
from wva_tpu_torch.analyzers.queueing.convert import profile_store_from_records
from wva_tpu_torch.analyzers.queueing.params import TargetPerf
from wva_tpu_torch.config.slo import SLOConfigData
from wva_tpu_torch.engines.slo_pass import run_slo_pass
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
    fresh = not _build.library_path().exists()
    t0 = time.perf_counter()
    path = _build.build()
    seconds = time.perf_counter() - t0
    log(f"[build] {path.name}: {seconds:.2f} s"
        + ("" if fresh else " (already built)"))
    resources = _build.resources(_build.build_log())
    for r in resources:
        log(f"[build] NV={r['values_per_lane']}: {r['registers']} registers, "
            f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill "
            f"loads, {r['stack']} B stack, {r['smem']} B shared memory")
    require({r["values_per_lane"] for r in resources} == INSTANTIATIONS,
            f"instantiations in the compiler's report: {resources}")
    require(not any(r["spill_stores"] or r["spill_loads"] for r in resources),
            "an instantiation spills registers")
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


def sass_per_chunk(library):
    """Instructions per 32-state chunk in the compiled kernel, by opcode:
    the NV=64 instantiation's code less the NV=32 one's, over the 32 chunks
    it adds. Each chunk's code runs in every iteration, except its load."""
    sass = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass", str(library)],
        capture_output=True, text=True, check=True, timeout=120).stdout
    counts = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        nv = re.search(r"sizing_bisection_kernelILi(\d+)E", fn)
        ops = collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", ins.strip()).split()[0].split(".")[0]
            for ins in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", fn))
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
    log(f"[time] C={c} k_cols={k_cols}: "
        + ", ".join(f"{n} {'/'.join(f'{x:.4f}' for x in t)}"
                    for n, t in runs.items())
        + f" ms; plain {p1:.3f}/{p2:.3f} ms; bound {bound_ms:.4f} ms ({term}; "
        + ", ".join(f"{n} {x:.4f}" for n, x in terms.items())
        + f"); wrapper at {100 * bound_ms / ms['wrapper']:.1f}% and launch at "
        f"{100 * bound_ms / launch_ms:.1f}% of the bound; library: none")
    return dict(kernel_ms=ms["wrapper"], launch_ms=launch_ms,
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card, resources = phase_build()
    err, bench_timings = phase_kernel_vs_plain()
    launches, t = phase_slice(err)
    log(json.dumps({"kernels": [{
        "name": "sizing_bisection",
        "route": "cuda",
        "source": "wva_tpu_torch/analyzers/queueing/csrc/sizing_bisection.cu",
        "replaces": "wva_tpu/analyzers/queueing/pallas_kernel.py:49",
        "launches": launches,
        "max_abs_err": err.max_abs,
        "max_rel_err": err.max_rel,
        "ms": t["kernel_ms"],
        "kernel_ms": t["kernel_ms"],
        "launch_ms": t["launch_ms"],
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
