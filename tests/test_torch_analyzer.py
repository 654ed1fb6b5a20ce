"""The port's SLO analyzer against the JAX package's, on the CPU.

The ``TestQueueingModelAnalyzer`` scenarios of tests/test_queueing_model.py
are rebuilt from the same plain values in both packages. What decides
replicas is held equal: the candidate set, costs, replica counts, demand,
whether capacity is required or spare, and the cost-aware optimizer's
targets and actions. Capacities are held at rtol 2e-3, the tolerance the
JAX package applies between its own bisection backends.
"""

from types import SimpleNamespace

import pytest

import wva_tpu.analyzers.queueing.analyzer as j_analyzer
import wva_tpu.analyzers.queueing.params as j_params
import wva_tpu.config.slo as j_slo
import wva_tpu.interfaces as j_if
import wva_tpu.interfaces.allocation as j_alloc
import wva_tpu.pipeline.optimizer as j_opt
import wva_tpu_torch.analyzers.queueing.analyzer as t_analyzer
import wva_tpu_torch.analyzers.queueing.params as t_params
import wva_tpu_torch.config.slo as t_slo
import wva_tpu_torch.interfaces as t_if
import wva_tpu_torch.interfaces.allocation as t_alloc
import wva_tpu_torch.pipeline.optimizer as t_opt

RTOL = 2e-3


def _pkg(analyzer, params, slo, interfaces, alloc, opt, **analyzer_kw):
    return SimpleNamespace(
        analyzer=lambda **kw: analyzer.QueueingModelAnalyzer(
            **kw, **analyzer_kw),
        p=params, slo=slo, i=interfaces, OptimizerMetrics=alloc.OptimizerMetrics,
        opt=opt)


JAX = _pkg(j_analyzer, j_params, j_slo, j_if, j_alloc, j_opt)
TORCH = _pkg(t_analyzer, t_params, t_slo, t_if, t_alloc, t_opt, device="cpu")


def slo_cfg_for_model(pkg, ttft=1000.0, itl=0.0):
    p = pkg.p
    return pkg.slo.SLOConfigData(
        service_classes=[pkg.slo.ServiceClass(
            name="default", priority=10,
            model_targets={"m": p.TargetPerf(target_ttft_ms=ttft,
                                             target_itl_ms=itl)})],
        profiles=[
            p.PerfProfile(model_id="m", accelerator="v5e-8",
                          service_parms=p.ServiceParms(
                              alpha=6.973, beta=0.027, gamma=0.001),
                          max_batch_size=64, max_queue_size=512),
            p.PerfProfile(model_id="m", accelerator="v5p-8",
                          service_parms=p.ServiceParms(
                              alpha=3.0, beta=0.012, gamma=0.0005),
                          max_batch_size=128, max_queue_size=512),
        ])


def make_input(pkg, rate_per_min=600.0, replicas=1, pending=0, config=None):
    i = pkg.i
    return i.AnalyzerInput(
        model_id="m", namespace="ns",
        replica_metrics=[i.ReplicaMetrics(
            pod_name="p0", variant_name="va-v5e", model_id="m",
            accelerator_name="v5e-8", avg_input_tokens=512,
            avg_output_tokens=256, cost=10.0)],
        variant_states=[i.VariantReplicaState(
            variant_name="va-v5e", accelerator_name="v5e-8",
            current_replicas=replicas + pending,
            desired_replicas=replicas + pending,
            pending_replicas=pending)],
        config=config or i.SaturationScalingConfig(analyzer_name="slo"),
        optimizer_metrics=pkg.OptimizerMetrics(arrival_rate=rate_per_min),
    )


def _synced(pkg, **cfg_kw):
    an = pkg.analyzer()
    an.sync_from_config(slo_cfg_for_model(pkg, **cfg_kw))
    return an


# Each scenario returns the (input, result) pairs it analyzed.

def produces_capacity_and_demand(pkg):
    an = _synced(pkg)
    inp = make_input(pkg, rate_per_min=600.0)
    return [(inp, an.analyze(inp))]


def overload_requires_capacity(pkg):
    an = _synced(pkg)
    low, high = make_input(pkg, 6.0), make_input(pkg, 60000.0)
    return [(low, an.analyze(low)), (high, an.analyze(high))]


def pending_replicas_reduce_required(pkg):
    an = _synced(pkg)
    return [(inp, an.analyze(inp)) for inp in (
        make_input(pkg, 60000.0, pending=0),
        make_input(pkg, 60000.0, pending=3))]


def burst_slope_stands_derived_headroom(pkg):
    an = _synced(pkg)
    cfg = pkg.i.SaturationScalingConfig(
        analyzer_name="slo", anticipation_horizon_seconds=150.0,
        burst_slope_rps=0.2867)
    return [(inp, an.analyze(inp)) for inp in (
        make_input(pkg, 240.0, config=cfg), make_input(pkg, 240.0))]


def burst_slope_takes_max_with_headroom_replicas(pkg):
    an = _synced(pkg)
    pairs = []
    for kw in (dict(headroom_replicas=2, burst_slope_rps=0.001),
               dict(headroom_replicas=2)):
        cfg = pkg.i.SaturationScalingConfig(
            analyzer_name="slo", anticipation_horizon_seconds=150.0, **kw)
        inp = make_input(pkg, 240.0, config=cfg)
        pairs.append((inp, an.analyze(inp)))
    return pairs


def missing_profile_excludes_variant(pkg):
    an = pkg.analyzer(profiles=pkg.p.PerfProfileStore())
    cfg = slo_cfg_for_model(pkg)
    cfg.profiles = []
    an.sync_from_config(cfg)
    inp = make_input(pkg)
    return [(inp, an.analyze(inp))]


def no_slo_config_or_targets_skips(pkg):
    an = pkg.analyzer()
    inp = make_input(pkg)
    first = an.analyze(inp)
    an.sync_from_config(pkg.slo.SLOConfigData())
    return [(inp, first), (inp, an.analyze(inp))]


def unavailable_demand_skips_model(pkg):
    an = _synced(pkg)
    inp = make_input(pkg)
    inp.optimizer_metrics = None
    return [(inp, an.analyze(inp))]


def bucketed_padding_matches_exact(pkg):
    an = _synced(pkg)
    inp = make_input(pkg)
    inp.variant_states = inp.variant_states + [
        pkg.i.VariantReplicaState(variant_name=f"va-{i}",
                                  accelerator_name="v5p-8",
                                  current_replicas=1) for i in range(2)]
    return [(inp, an.analyze(inp))]


def scheduler_queue_adds_demand(pkg):
    an = _synced(pkg)
    base = make_input(pkg, 600.0)
    queued = make_input(pkg, 600.0)
    queued.scheduler_queue = pkg.i.SchedulerQueueMetrics(queue_size=120)
    return [(base, an.analyze(base)), (queued, an.analyze(queued))]


def itl_target_and_two_accelerators(pkg):
    an = _synced(pkg, ttft=800.0, itl=40.0)
    inp = make_input(pkg, 3000.0, replicas=2)
    inp.variant_states.append(pkg.i.VariantReplicaState(
        variant_name="va-v5p", accelerator_name="v5p-8", current_replicas=1))
    return [(inp, an.analyze(inp))]


SCENARIOS = [
    produces_capacity_and_demand,
    overload_requires_capacity,
    pending_replicas_reduce_required,
    burst_slope_stands_derived_headroom,
    burst_slope_takes_max_with_headroom_replicas,
    missing_profile_excludes_variant,
    no_slo_config_or_targets_skips,
    unavailable_demand_skips_model,
    bucketed_padding_matches_exact,
    scheduler_queue_adds_demand,
    itl_target_and_two_accelerators,
]


def _close(a, b):
    return a == pytest.approx(b, rel=RTOL, abs=1e-9)


def _decisions(pkg, inp, result):
    req = pkg.opt.ModelScalingRequest(
        model_id=inp.model_id, namespace=inp.namespace, result=result,
        variant_states=inp.variant_states)
    return [(d.variant_name, d.accelerator_name, d.current_replicas,
             d.target_replicas, d.action)
            for d in pkg.opt.CostAwareOptimizer().optimize([req], None)]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_analyzer_matches_jax(scenario):
    jax_pairs, torch_pairs = scenario(JAX), scenario(TORCH)
    assert len(jax_pairs) == len(torch_pairs)
    for (j_inp, a), (t_inp, b) in zip(jax_pairs, torch_pairs):
        assert (b.analyzer_name, b.model_id, b.namespace) == \
            (a.analyzer_name, a.model_id, a.namespace)
        assert b.total_demand == a.total_demand
        assert b.avg_input_tokens == a.avg_input_tokens
        assert b.avg_output_tokens == a.avg_output_tokens
        assert len(b.variant_capacities) == len(a.variant_capacities)
        for vb, va in zip(b.variant_capacities, a.variant_capacities):
            assert (vb.variant_name, vb.accelerator_name, vb.cost,
                    vb.replica_count, vb.pending_replicas) == \
                (va.variant_name, va.accelerator_name, va.cost,
                 va.replica_count, va.pending_replicas)
            assert _close(vb.per_replica_capacity, va.per_replica_capacity)
            assert _close(vb.total_capacity, va.total_capacity)
        for field in ("total_supply", "required_capacity", "spare_capacity",
                      "utilization", "scaling_demand", "headroom_capacity"):
            assert _close(getattr(b, field), getattr(a, field)), field
        assert (b.required_capacity > 0) == (a.required_capacity > 0)
        assert (b.spare_capacity > 0) == (a.spare_capacity > 0)
        if a.variant_capacities:
            assert _decisions(TORCH, t_inp, b) == _decisions(JAX, j_inp, a)


def test_reference_scenario_expectations_hold_in_port():
    """The JAX test's own assertions, on the port's results."""
    (_, res), = produces_capacity_and_demand(TORCH)
    assert res.analyzer_name == "slo" and len(res.variant_capacities) == 1
    assert res.variant_capacities[0].per_replica_capacity > 0
    assert res.total_demand == pytest.approx(10.0)
    (_, low), (_, high) = overload_requires_capacity(TORCH)
    assert low.required_capacity == 0.0 and low.spare_capacity > 0.0
    assert high.required_capacity > 0.0 and high.spare_capacity == 0.0
    (_, without), (_, with_pending) = pending_replicas_reduce_required(TORCH)
    assert with_pending.required_capacity < without.required_capacity
    (_, burst), (_, base) = burst_slope_stands_derived_headroom(TORCH)
    assert burst.required_capacity >= \
        base.required_capacity + 0.2867 * 150.0 - 5.0
    assert burst.spare_capacity == 0.0
    (_, padded), = bucketed_padding_matches_exact(TORCH)
    caps = [vc.per_replica_capacity for vc in padded.variant_capacities]
    assert len(caps) == 3 and all(c > 0 for c in caps)
    assert caps[1] == caps[2]  # same profile, same row arithmetic
    (_, base), (_, queued) = scheduler_queue_adds_demand(TORCH)
    assert queued.total_demand > base.total_demand


def test_size_candidates_single_host_list_of_floats():
    an = _synced(TORCH)
    plan = an.prepare(make_input(TORCH))
    sized = an.size_candidates(plan.candidates)
    assert isinstance(sized, list) and len(sized) == 1
    assert isinstance(sized[0], float) and sized[0] > 0
    plain = _synced(TORCH)
    plain.impl = "plain"
    assert plain.size_candidates(plan.candidates) == sized
