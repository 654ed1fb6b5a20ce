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
"""

import re

import numpy as np
import pytest

import wva_tpu.analyzers.queueing.analyzer as j_analyzer
import wva_tpu.analyzers.queueing.params as j_params
import wva_tpu.config.slo as j_slo
import wva_tpu.interfaces as j_if
import wva_tpu.interfaces.allocation as j_alloc
import wva_tpu.pipeline.optimizer as j_opt
import wva_tpu.utils.clock as j_clock
import wva_tpu_torch.analyzers.queueing.analyzer as t_analyzer
import wva_tpu_torch.analyzers.queueing.params as t_params
import wva_tpu_torch.config.slo as t_slo
import wva_tpu_torch.interfaces as t_if
import wva_tpu_torch.interfaces.allocation as t_alloc
import wva_tpu_torch.pipeline.optimizer as t_opt
import wva_tpu_torch.utils.clock as t_clock
from wva_tpu_torch.analyzers.queueing import sizing_kernel
from wva_tpu_torch.analyzers.queueing.convert import profile_store_from_records
from wva_tpu_torch.engines.slo_pass import run_slo_pass

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
