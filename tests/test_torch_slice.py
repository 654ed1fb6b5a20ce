"""The port's SLO sizing pass against the JAX package's staged tick.

A seeded 24-model x 2-variant fleet (v5e-8 and v5p-8 per model) runs 3
ticks 15 s apart on a FakeClock in both packages:

- the JAX package's staged sequence — ``prepare`` per model, ONE
  ``size_candidates`` over the fleet, ``finalize`` per model,
  ``CostAwareOptimizer.optimize`` — as its engine runs it with the fused
  program and the vectorized decision stage off;
- the port's ``run_slo_pass`` with ``device="cpu"``.

Decisions must be equal (variant, accelerator, replicas, action); the
analyzer's demand/supply/required/spare figures recorded in each
decision's audit step agree at rtol 2e-3.

The fused tick: a seeded 24-model world with a quarter of the models routed
to the fleet solve (``optimizer_name="global"``), forecasting on and each
model's demand history pre-filled over 2.5 days, runs 12 ticks through the
JAX package's fused tick (composed below from its public pieces and the
engine's ``_optimize_global``) and the port's ``run_fused_pass``. Decisions
must be equal on every tick. Inside the port, the fused tick equals the
staged tick (``run_slo_pass`` with the same planner and fleet route) and the
solve memo on equals it off, byte for byte, decisions and forecast plans.
"""

import dataclasses
import math
import re

import numpy as np
import pytest

import wva_tpu.analyzers.queueing.analyzer as j_analyzer
import wva_tpu.forecast as j_forecast
import wva_tpu.forecast.planner as j_planner
import wva_tpu.fused as j_fused
import wva_tpu.analyzers.queueing.params as j_params
import wva_tpu.config.slo as j_slo
import wva_tpu.interfaces as j_if
import wva_tpu.interfaces.allocation as j_alloc
import wva_tpu.pipeline.optimizer as j_opt
import wva_tpu.utils.clock as j_clock
import wva_tpu_torch.analyzers.queueing.analyzer as t_analyzer
import wva_tpu_torch.forecast.planner as t_planner
import wva_tpu_torch.fused as t_fused
import wva_tpu_torch.analyzers.queueing.params as t_params
import wva_tpu_torch.config.slo as t_slo
import wva_tpu_torch.interfaces as t_if
import wva_tpu_torch.interfaces.allocation as t_alloc
import wva_tpu_torch.pipeline.optimizer as t_opt
import wva_tpu_torch.utils.clock as t_clock
from wva_tpu_torch.analyzers.queueing import sizing_kernel
from wva_tpu_torch.analyzers.queueing.convert import profile_store_from_records
from wva_tpu.engines.saturation.engine import SaturationEngine
from wva_tpu_torch.engines.slo_pass import (
    FleetRoute,
    run_fused_pass,
    run_slo_pass,
)
from wva_tpu_torch.forecast import fit_kernel

RTOL = 2e-3
TICKS = 3
TICK_SECONDS = 15.0
ACCELERATORS = (("v5e-8", 10.0, 1.0), ("v5p-8", 30.0, 0.5))  # name, cost, speed


def fleet(n_models=24, seed=20261016):
    """Plain-value fleet: profile records and per-model tick inputs."""
    rng = np.random.default_rng(seed)
    records, models = [], []
    for m in range(n_models):
        model_id = f"model-{m:03d}"
        base = dict(alpha=rng.uniform(3.0, 20.0), beta=rng.uniform(0.001, 0.02),
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
            model_id=model_id, namespace=f"ns-{m % 3}", variants=variants,
            avg_in=float(rng.uniform(128, 2048)),
            avg_out=float(rng.uniform(64, 1024)),
            rates_per_s=np.exp(rng.uniform(np.log(0.5), np.log(150.0)))
            * rng.uniform(0.8, 1.25, TICKS)))
    return records, models


def slo_config(slo, params):
    return slo.SLOConfigData(default_targets=params.TargetPerf(
        target_ttft_ms=1000.0, target_itl_ms=50.0))


def tick_inputs(i, alloc, cfg, models, tick):
    inputs = []
    for md in models:
        inputs.append(i.AnalyzerInput(
            model_id=md["model_id"], namespace=md["namespace"],
            replica_metrics=[i.ReplicaMetrics(
                pod_name=f"{v['name']}-0", variant_name=v["name"],
                model_id=md["model_id"], namespace=md["namespace"],
                accelerator_name=v["accelerator"], cost=v["cost"],
                avg_input_tokens=md["avg_in"], avg_output_tokens=md["avg_out"])
                for v in md["variants"]],
            variant_states=[i.VariantReplicaState(
                variant_name=v["name"], accelerator_name=v["accelerator"],
                current_replicas=v["ready"] + v["pending"],
                desired_replicas=v["ready"] + v["pending"],
                pending_replicas=v["pending"]) for v in md["variants"]],
            config=i.SaturationScalingConfig(analyzer_name="slo"),
            optimizer_metrics=alloc.OptimizerMetrics(
                arrival_rate=float(md["rates_per_s"][tick]) * 60.0),
            slo_config=cfg))
    return inputs


def jax_staged_tick(analyzer, inputs):
    """The JAX engine's staged SLO sequence (engine.py:2029-2075, 2125-2208,
    2279), written out over the JAX package's public pieces."""
    by_key = {f"{inp.model_id}|{inp.namespace}": inp for inp in inputs}
    keys = sorted(by_key)
    plans = {k: analyzer.prepare(by_key[k]) for k in keys}
    batch_keys = [k for k in keys if plans[k].needs_sizing]
    per_replica = analyzer.size_candidates(
        [c for k in batch_keys for c in plans[k].candidates])
    sized, offset = {}, 0
    for k in batch_keys:
        n = len(plans[k].candidates)
        sized[k] = per_replica[offset:offset + n]
        offset += n
    requests = []
    for k in keys:
        result = analyzer.finalize(plans[k], sized[k])
        if result.variant_capacities:
            requests.append(j_opt.ModelScalingRequest(
                model_id=result.model_id, namespace=result.namespace,
                result=result, variant_states=by_key[k].variant_states))
    return j_opt.CostAwareOptimizer().optimize(requests, None)


def jax_store(records):
    store = j_params.PerfProfileStore()
    for r in records:
        store.put(j_params.PerfProfile(
            model_id=r["model_id"], accelerator=r["accelerator"],
            service_parms=j_params.ServiceParms(
                alpha=r["alpha"], beta=r["beta"], gamma=r["gamma"]),
            max_batch_size=r["max_batch_size"],
            max_queue_size=r["max_queue_size"]))
    return store


_STEP_FIGURES = re.compile(
    r"demand=(\S+) supply=(\S+) required=(\S+) spare=(\S+)")


def _figures(decision):
    return [float(x) for x in _STEP_FIGURES.fullmatch(
        decision.decision_steps[0].reason).groups()]


@pytest.fixture(scope="module")
def ticks():
    records, models = fleet()
    j_cfg, t_cfg = slo_config(j_slo, j_params), slo_config(t_slo, t_params)
    j_clk, t_clk = j_clock.FakeClock(1000.0), t_clock.FakeClock(1000.0)
    j_an = j_analyzer.QueueingModelAnalyzer(profiles=jax_store(records),
                                            clock=j_clk)
    t_an = t_analyzer.QueueingModelAnalyzer(
        profiles=profile_store_from_records(records), clock=t_clk,
        device="cpu")
    t_opt_ = t_opt.CostAwareOptimizer()
    launches = sizing_kernel.launches
    out = []
    for tick in range(TICKS):
        a = jax_staged_tick(j_an, tick_inputs(j_if, j_alloc, j_cfg, models, tick))
        b = run_slo_pass(t_an, t_opt_,
                         tick_inputs(t_if, t_alloc, t_cfg, models, tick))
        out.append((a, b))
        j_clk.advance(TICK_SECONDS)
        t_clk.advance(TICK_SECONDS)
    assert sizing_kernel.launches == launches  # CPU: the plain version
    return out


@pytest.mark.parametrize("tick", range(TICKS))
def test_decisions_equal(ticks, tick):
    a, b = ticks[tick]
    assert len(b) == len(a) == 48
    for da, db in zip(a, b):
        assert (db.model_id, db.namespace, db.variant_name,
                db.accelerator_name, db.cost, db.current_replicas,
                db.target_replicas, db.action) == \
            (da.model_id, da.namespace, da.variant_name, da.accelerator_name,
             da.cost, da.current_replicas, da.target_replicas, da.action)
        assert [s.name for s in db.decision_steps] == \
            [s.name for s in da.decision_steps]
        assert [s.timestamp for s in db.decision_steps] == \
            [s.timestamp for s in da.decision_steps]


@pytest.mark.parametrize("tick", range(TICKS))
def test_analyzer_figures_close(ticks, tick):
    a, b = ticks[tick]
    for da, db in zip(a, b):
        # The figures are printed to 2 decimals: allow that rounding too.
        np.testing.assert_allclose(_figures(db), _figures(da), rtol=RTOL,
                                   atol=0.01)


def test_fleet_scales_both_ways(ticks):
    actions = {d.action for a, _ in ticks for d in a}
    assert {"scale-up", "scale-down", "no-change"} <= actions
    accelerators = {d.accelerator_name for a, _ in ticks for d in a
                    if d.action == "scale-up"}
    assert accelerators  # capacity lands somewhere


# --- the fused tick, with forecasting and the fleet solve ---

FUSED_TICKS = 12
FUSED_MODELS = 24
T0 = 1_000_000.0
DAY = 86400.0
LEAD_SECONDS = 45.0  # the planner's default lead time: trust within 5 ticks
# The world's seed: with it every trend and seasonal forecaster earns trust
# on some model within the run.
FUSED_SEED = 20261020
SHAPES = ("sine", "ramp", "growth", "step")


def forecast_fleet(n_models=FUSED_MODELS, seed=FUSED_SEED):
    """Plain-value world for the fused tick: profiles as :func:`fleet`, and
    per model a demand shape (daily sine, a ramp that starts with the run,
    a daily sine growing 4x a day, a daily square wave), a quarter routed
    "global", and how much history is pre-filled (most: 2.5 days; every
    12th: two samples, so the long grid stays under MIN_VALID; every 12th
    other: none). Every 5th model's prompt length drifts at ticks 4 and 8,
    so those ticks re-solve the candidates and the rest hit the memo."""
    rng = np.random.default_rng(seed)
    records, models = [], []
    for m in range(n_models):
        model_id = f"model-{m:03d}"
        base = dict(alpha=rng.uniform(3.0, 20.0), beta=rng.uniform(0.001, 0.02),
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
            model_id=model_id, namespace=f"ns-{m % 3}", variants=variants,
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
    """Seeded demand (req/s) of a model at time ``t``, with 3% noise."""
    noise = np.random.default_rng([md["noise_seed"], int(round(t))]).uniform(
        0.97, 1.03)
    wave = math.sin(2 * math.pi * t / DAY + md["phase"])
    shape = {"sine": 1.0 + 0.5 * wave,
             "ramp": 1.0 + max(t - (T0 - 60.0), 0.0) / 600.0,
             "growth": (1.0 + 0.5 * wave) * (1.0 + 4.0 * (t - T0 + DAY) / DAY),
             "step": 2.0 if wave > 0 else 1.0}[md["shape"]]
    return md["base"] * shape * noise


def prefill(planner, models):
    """The history before the first tick: the long grid's 2.5 days at half
    its step, then the fine grid's 40 minutes at the tick interval."""
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


def fused_inputs(i, alloc, cfg, models, tick):
    now = T0 + tick * TICK_SECONDS
    inputs = []
    for md in models:
        drift = 1.0 + 0.25 * (tick // 4) if md["drifts"] else 1.0
        inputs.append(i.AnalyzerInput(
            model_id=md["model_id"], namespace=md["namespace"],
            replica_metrics=[i.ReplicaMetrics(
                pod_name=f"{v['name']}-0", variant_name=v["name"],
                model_id=md["model_id"], namespace=md["namespace"],
                accelerator_name=v["accelerator"], cost=v["cost"],
                avg_input_tokens=md["avg_in"] * drift,
                avg_output_tokens=md["avg_out"])
                for v in md["variants"]],
            variant_states=[i.VariantReplicaState(
                variant_name=v["name"], accelerator_name=v["accelerator"],
                current_replicas=v["ready"] + v["pending"],
                desired_replicas=v["ready"] + v["pending"],
                pending_replicas=v["pending"]) for v in md["variants"]],
            config=i.SaturationScalingConfig(
                analyzer_name="slo",
                optimizer_name="global" if md["route_global"] else ""),
            optimizer_metrics=alloc.OptimizerMetrics(
                arrival_rate=demand(md, now) * 60.0),
            slo_config=cfg))
    return inputs


class _EngineStub:
    """What the JAX engine's ``_optimize_global`` reads of its engine: no
    limiter, no capacity plane, the tick's fused sizing and the holds."""

    limiter = None
    capacity = None
    _optimize_global = SaturationEngine._optimize_global
    _allocations_to_decisions = SaturationEngine._allocations_to_decisions

    def __init__(self, analyzer, clock):
        self.slo_analyzer = analyzer
        self.clock = clock
        self._migration_holds = {}
        self._tick_presized = None


def jax_fused_tick(analyzer, planner, stub, inputs):
    """The JAX engine's fused SLO tick (``WVA_FUSED=on``, memo on,
    forecasting on, ``WVA_VEC_DECIDE=off``; engine.py:2016-2064,
    3242-3317, 2238-2254, 2974-3241, 2736-2775), written out over the JAX
    package's public pieces."""
    by_key = {f"{inp.model_id}|{inp.namespace}": inp for inp in inputs}
    keys = sorted(by_key)
    slo_cfg_by_ns = {inp.namespace: inp.slo_config for inp in inputs}
    plans = {k: analyzer.prepare(by_key[k]) for k in keys}
    batch_keys = [k for k in keys if plans[k].needs_sizing]
    prep = planner.prepare_tick(
        [(plans[k].input.namespace, plans[k].input.model_id,
          analyzer.plan_demand(plans[k]), plans[k].input.variant_states)
         for k in batch_keys], stub.clock.now())
    grids = j_fused.FleetGrids()
    j_fused.build_candidate_axis(grids, plans, batch_keys)
    by_pkey = {planner.key_for(plans[k].input.namespace,
                               plans[k].input.model_id): plans[k].input
               for k in batch_keys}
    rows = [by_pkey[k] for k in prep.keys]
    global_routed = [inp.config.optimizer_name == "global" for inp in rows]
    j_fused.build_model_axis(
        grids, prep.grids, prep.keys, prep.trust_idx, prep.trusted,
        global_routed, [False] * len(rows),
        [not any(vs.ready_replicas > 0 for vs in inp.variant_states)
         for inp in rows])
    prep.global_no_floor = frozenset(
        k for k, g in zip(prep.keys, global_routed) if g)
    result = j_fused.run(grids, memo=True)
    prep.fits, prep.chosen = result.fits, result.chosen
    stub._tick_presized = result.presized
    requests, global_reqs, local_reqs = [], [], []
    for k in keys:
        res = analyzer.finalize(plans[k], result.per_replica[k])
        if not res.variant_capacities:
            continue
        req = j_opt.ModelScalingRequest(
            model_id=res.model_id, namespace=res.namespace, result=res,
            variant_states=by_key[k].variant_states)
        requests.append(req)
        (global_reqs if by_key[k].config.optimizer_name == "global"
         else local_reqs).append(req)
    decisions = stub._optimize_global(global_reqs, slo_cfg_by_ns)
    decisions.extend(j_opt.CostAwareOptimizer().optimize(local_reqs, None))
    _, floors = planner.plan(requests, prep.now,
                             no_floor_keys=prep.global_no_floor,
                             prepared=prep)
    j_forecast.apply_forecast_floors(decisions, floors, prep.now)
    return decisions


def _port_run(records, models, way):
    """The port's 12 ticks one way: "fused", "memo off" or "staged". Returns
    each tick's decisions and the planner's last plans."""
    clk = t_clock.FakeClock(T0)
    an = t_analyzer.QueueingModelAnalyzer(
        profiles=profile_store_from_records(records), clock=clk,
        device="cpu")
    planner = t_planner.CapacityPlanner(
        default_lead_time_seconds=LEAD_SECONDS, device="cpu")
    prefill(planner, models)
    cfg = slo_config(t_slo, t_params)
    fleet, opt = FleetRoute(), t_opt.CostAwareOptimizer()
    out = []
    for tick in range(FUSED_TICKS):
        inputs = fused_inputs(t_if, t_alloc, cfg, models, tick)
        if way == "staged":
            out.append(run_slo_pass(an, opt, inputs, planner, fleet))
        else:
            out.append(run_fused_pass(an, opt, inputs, planner, fleet,
                                      memo=way == "fused"))
        clk.advance(TICK_SECONDS)
    return out, dict(planner._last_plan)


@pytest.fixture(scope="module")
def fused_ticks():
    records, models = forecast_fleet()
    j_fused.clear_solve_memo()
    t_fused.clear_solve_memo()
    j_clk = j_clock.FakeClock(T0)
    j_an = j_analyzer.QueueingModelAnalyzer(profiles=jax_store(records),
                                            clock=j_clk)
    j_plan = j_planner.CapacityPlanner(default_lead_time_seconds=LEAD_SECONDS)
    prefill(j_plan, models)
    stub = _EngineStub(j_an, j_clk)
    j_cfg = slo_config(j_slo, j_params)
    reference = []
    for tick in range(FUSED_TICKS):
        reference.append(jax_fused_tick(
            j_an, j_plan, stub, fused_inputs(j_if, j_alloc, j_cfg, models,
                                             tick)))
        j_clk.advance(TICK_SECONDS)
    launches = fit_kernel.launches
    runs = {"fused": _port_run(records, models, "fused")}
    counters = t_fused.solve_memo_counters()
    for way in ("memo off", "staged"):
        runs[way] = _port_run(records, models, way)
    assert fit_kernel.launches == launches  # CPU: the plain version
    j_fused.clear_solve_memo()
    t_fused.clear_solve_memo()
    return dict(reference=reference, jax_plans=dict(j_plan._last_plan),
                runs=runs, counters=counters, models=models)


def _key(d):
    return (d.model_id, d.namespace, d.variant_name, d.accelerator_name,
            d.current_replicas, d.target_replicas, d.action)


@pytest.mark.parametrize("tick", range(FUSED_TICKS))
def test_fused_decisions_equal_reference(fused_ticks, tick):
    want = fused_ticks["reference"][tick]
    got = fused_ticks["runs"]["fused"][0][tick]
    assert len(got) == len(want) == 2 * FUSED_MODELS
    assert [_key(d) for d in got] == [_key(d) for d in want]
    assert [[s.name for s in d.decision_steps] for d in got] == \
        [[s.name for s in d.decision_steps] for d in want]


def test_fused_plans_agree_with_reference(fused_ticks):
    got = fused_ticks["runs"]["fused"][1]
    want = fused_ticks["jax_plans"]
    assert sorted(got) == sorted(want)
    for key, p in got.items():
        q = want[key]
        assert (p.forecaster, p.trusted, p.demoted, p.floor_replicas,
                p.variant_name, p.evals) == \
            (q.forecaster, q.trusted, q.demoted, q.floor_replicas,
             q.variant_name, q.evals), key
        for name in q.forecasts:
            scale = 1.0 + max(abs(v) for v in q.forecasts.values())
            assert p.forecasts[name] == pytest.approx(
                q.forecasts[name], rel=RTOL, abs=1e-4 * scale), (key, name)


@pytest.mark.parametrize("way", ["staged", "memo off"])
def test_port_fused_equals_port(fused_ticks, way):
    """Inside the port the fused tick is byte for byte the staged tick, and
    the memo changes nothing: every decision field, every audit step and
    every forecast plan."""
    fused_out, fused_plans = fused_ticks["runs"]["fused"]
    other_out, other_plans = fused_ticks["runs"][way]
    for a, b in zip(fused_out, other_out):
        assert [dataclasses.asdict(d) for d in a] == \
            [dataclasses.asdict(d) for d in b]
    assert {k: dataclasses.asdict(p) for k, p in fused_plans.items()} == \
        {k: dataclasses.asdict(p) for k, p in other_plans.items()}


def test_fused_world_exercises_the_path(fused_ticks):
    """The world reaches every part of the tick: the fleet solve, forecast
    floors, each forecaster trusted somewhere, models under MIN_VALID, and
    both memo-hit and solve ticks."""
    out, plans = fused_ticks["runs"]["fused"]
    steps = [{s.name for s in d.decision_steps} for tick in out for d in tick]
    assert sum("optimizer:global" in s for s in steps) == \
        FUSED_TICKS * 2 * FUSED_MODELS // 4
    assert any("forecast" in s for s in steps)
    trusted = {p.forecaster for p in plans.values() if p.trusted}
    assert {"holt", "seasonal_naive", "holt_winters"} <= trusted
    for md in fused_ticks["models"]:
        if md["history"] == "short":  # the long grid under MIN_VALID
            p = plans[f"{md['namespace']}|{md['model_id']}"]
            assert p.forecasts["seasonal_naive"] == \
                p.forecasts["holt_winters"] > 0
    assert fused_ticks["counters"] == {"hit_ticks": 9, "solve_ticks": 3}
    actions = {d.action for tick in out for d in tick}
    assert {"scale-up", "scale-down"} <= actions
