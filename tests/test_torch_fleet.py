"""The port's fleet solve against the JAX package's.

The worlds of ``tests/test_fleet.py`` (``make_system``: two models on v5e-8
and v5p-8, premium and free classes), under the unlimited and the greedy
solver, capacity pressure and every best-effort policy, and a seeded
24-server world, go through both packages' ``solve``. Accelerators, replica
counts and unallocated servers are equal; cost at rtol 1e-6; the sized rate
and the latency fields (``itl_ms``, ``ttft_ms``, ``rho``) at rtol 2e-3, the
reference's own tolerance between its backends.

Inside the port, the candidate builder's ``presized`` path (the fused
program's sizing of every pair, in a batch of another size and state-axis
width) gives the same replicas as the builder's own sizing, and the same
rates bit for bit on the CPU.
"""

import numpy as np
import pytest

import wva_tpu.analyzers.queueing as j_q
import wva_tpu.config.slo as j_slo
import wva_tpu.fleet as j_fleet
import wva_tpu_torch.analyzers.queueing as t_q
import wva_tpu_torch.config.slo as t_slo
import wva_tpu_torch.fleet as t_fleet
from wva_tpu_torch import fused
from wva_tpu_torch.analyzers.queueing import sizing_kernel
from wva_tpu_torch.analyzers.queueing.analyzer import _Candidate
from wva_tpu_torch.analyzers.queueing.params import RequestSize

RTOL = 2e-3
COST_RTOL = 1e-6

JAX = (j_q, j_slo, j_fleet)
PORT = (t_q, t_slo, t_fleet)


def make_system(pkg, llama_rate=600.0, gemma_rate=1200.0, capacity=None,
                llama_current=None):
    """``tests/test_fleet.py:47`` in either package."""
    q, slo, fleet = pkg
    store = q.PerfProfileStore()
    store.sync_namespace("", [
        q.PerfProfile(model_id="llama", accelerator="v5e-8",
                      service_parms=q.ServiceParms(alpha=6.973, beta=0.027,
                                                   gamma=0.001),
                      max_batch_size=64, max_queue_size=256),
        q.PerfProfile(model_id="llama", accelerator="v5p-8",
                      service_parms=q.ServiceParms(alpha=3.0, beta=0.012,
                                                   gamma=0.0005),
                      max_batch_size=128, max_queue_size=256),
        q.PerfProfile(model_id="gemma", accelerator="v5e-8",
                      service_parms=q.ServiceParms(alpha=4.0, beta=0.02,
                                                   gamma=0.001),
                      max_batch_size=64, max_queue_size=256),
    ])
    current = None
    if llama_current is not None:
        current = fleet.CurrentAlloc(*llama_current)
    return fleet.FleetSystem(
        accelerators={
            "v5e-8": fleet.AcceleratorSpec(name="v5e-8", type="v5e",
                                           chips_per_replica=8, cost=1.0),
            "v5p-8": fleet.AcceleratorSpec(name="v5p-8", type="v5p",
                                           chips_per_replica=8, cost=3.0),
        },
        servers={
            "inf/llama": fleet.ServerSpec(
                name="inf/llama", namespace="inf", model_id="llama",
                service_class="premium", current=current,
                load=fleet.ServerLoad(arrival_rate_per_min=llama_rate,
                                      avg_input_tokens=512,
                                      avg_output_tokens=256)),
            "inf/gemma": fleet.ServerSpec(
                name="inf/gemma", namespace="inf", model_id="gemma",
                service_class="free",
                load=fleet.ServerLoad(arrival_rate_per_min=gemma_rate,
                                      avg_input_tokens=256,
                                      avg_output_tokens=128)),
        },
        service_classes={
            "premium": slo.ServiceClass(
                name="premium", priority=1,
                model_targets={"llama": q.TargetPerf(target_ttft_ms=500,
                                                     target_itl_ms=40)}),
            "free": slo.ServiceClass(
                name="free", priority=100,
                model_targets={"gemma": q.TargetPerf(target_ttft_ms=2000)}),
        },
        profiles=store,
        capacity_chips=capacity or {"v5e": 256, "v5p": 256},
    )


def seeded_system(pkg, capacity, seed=24):
    """24 servers over three accelerators and three service classes, with
    seeded profiles, loads, targets and current placements."""
    q, slo, fleet = pkg
    rng = np.random.default_rng(seed)
    accels = {"v5e-8": ("v5e", 1.0, 1.0), "v5p-8": ("v5p", 3.0, 0.5),
              "v6e-8": ("v6e", 2.0, 0.7)}
    store = q.PerfProfileStore()
    classes = {name: slo.ServiceClass(name=name, priority=prio)
               for name, prio in (("gold", 1), ("silver", 10),
                                  ("bronze", 100))}
    servers, profiles = {}, []
    for s in range(24):
        model = f"m{s:02d}"
        base = (rng.uniform(3, 20), rng.uniform(0.001, 0.03),
                rng.uniform(1e-5, 1e-3))
        mb = int(rng.integers(16, 160))
        for acc, (_, _, speed) in accels.items():
            if rng.uniform() < 0.2:
                continue  # not every model has a profile everywhere
            profiles.append(q.PerfProfile(
                model_id=model, accelerator=acc,
                service_parms=q.ServiceParms(*(v * speed for v in base)),
                max_batch_size=mb, max_queue_size=int(rng.integers(64, 512))))
        cls = ("gold", "silver", "bronze")[s % 3]
        classes[cls].model_targets[model] = q.TargetPerf(
            target_ttft_ms=float(rng.uniform(300, 3000)),
            target_itl_ms=float(rng.choice([0.0, rng.uniform(20, 80)])))
        current = None
        if s % 4 == 0:
            acc = ("v5e-8", "v5p-8", "v6e-8")[s % 3]
            n = int(rng.integers(1, 6))
            current = fleet.CurrentAlloc(acc, n, accels[acc][1] * n)
        name = f"ns/{model}"
        servers[name] = fleet.ServerSpec(
            name=name, namespace="ns", model_id=model, service_class=cls,
            min_replicas=int(rng.integers(0, 2)), current=current,
            load=fleet.ServerLoad(
                arrival_rate_per_min=float(np.exp(rng.uniform(
                    np.log(30), np.log(20000)))),
                avg_input_tokens=float(rng.uniform(64, 2048)),
                avg_output_tokens=float(rng.uniform(16, 1024))))
    store.sync_namespace("ns", profiles)
    return fleet.FleetSystem(
        accelerators={a: fleet.AcceleratorSpec(
            name=a, type=t, chips_per_replica=8, cost=c)
            for a, (t, c, _) in accels.items()},
        servers=servers, service_classes=classes, profiles=store,
        capacity_chips=capacity)


def assert_same_solution(got, want):
    assert sorted(got.unallocated) == sorted(want.unallocated)
    assert sorted(got.allocations) == sorted(want.allocations)
    for name, w in want.allocations.items():
        g = got.allocations[name]
        assert (g.accelerator, g.accelerator_type, g.num_replicas,
                g.max_batch, g.chips_per_replica) == \
            (w.accelerator, w.accelerator_type, w.num_replicas, w.max_batch,
             w.chips_per_replica), name
        assert g.cost == pytest.approx(w.cost, rel=COST_RTOL, abs=0)
        assert g.value == pytest.approx(w.value, rel=COST_RTOL, abs=1e-9)
        for field in ("max_rate_per_replica", "itl_ms", "ttft_ms", "rho"):
            assert getattr(g, field) == pytest.approx(
                getattr(w, field), rel=RTOL, abs=1e-6), (name, field)
    assert {k: vars(v) for k, v in got.diffs.items()} == \
        {k: vars(v) for k, v in want.diffs.items()}


def _spec(fleet, **kw):
    if "saturation_policy" in kw:
        kw["saturation_policy"] = fleet.SaturationPolicy(
            kw["saturation_policy"])
    return fleet.SolverSpec(**kw)


WORLDS = {
    "unlimited": (dict(), dict(unlimited=True)),
    "unlimited low load": (dict(llama_rate=120), dict(unlimited=True)),
    "unlimited high load": (dict(llama_rate=6000), dict(unlimited=True)),
    "zero load": (dict(llama_rate=0), dict(unlimited=True)),
    "greedy": (dict(), dict()),
    "capacity pressure": (dict(capacity={"v5e": 8, "v5p": 64}), dict()),
    "priority starves": (dict(capacity={"v5e": 8, "v5p": 0}), dict()),
    "policy none": (dict(capacity={"v5e": 8, "v5p": 0}),
                    dict(saturation_policy="none")),
    "round robin": (dict(capacity={"v5e": 16, "v5p": 0}),
                    dict(saturation_policy="round-robin")),
    "priority round robin": (dict(capacity={"v5e": 16, "v5p": 0}),
                             dict(saturation_policy="priority-round-robin")),
    "whole slices": (dict(capacity={"v5e": 12, "v5p": 0}), dict()),
    "sticky current": (dict(llama_current=("v5p-8", 2, 6.0)),
                       dict(unlimited=True)),
    "current diffs": (dict(llama_current=("v5e-8", 1, 1.0)), dict()),
}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_solve_matches_reference(world):
    system_kw, spec_kw = WORLDS[world]
    want = j_fleet.solve(make_system(JAX, **system_kw),
                         _spec(j_fleet, **spec_kw))
    got = t_fleet.solve(make_system(PORT, **system_kw),
                        _spec(t_fleet, **spec_kw), device="cpu")
    assert_same_solution(got, want)


@pytest.mark.parametrize("capacity", [
    {}, {"v5e": 64, "v5p": 32, "v6e": 48}, {"v5e": 16, "v5p": 0, "v6e": 8}],
    ids=["unlimited", "pressure", "starved"])
def test_seeded_fleet_matches_reference(capacity):
    spec = dict(unlimited=not capacity)
    want = j_fleet.solve(seeded_system(JAX, capacity),
                         _spec(j_fleet, **spec))
    got = t_fleet.solve(seeded_system(PORT, capacity),
                        _spec(t_fleet, **spec), device="cpu")
    assert_same_solution(got, want)
    assert len(set(want.allocations) | set(want.unallocated)) == 24


def test_analyze_model_matches_reference():
    want = j_fleet.analyze_model(make_system(JAX), "inf/llama")
    got = t_fleet.analyze_model(make_system(PORT), "inf/llama", device="cpu")
    assert [a.accelerator for a in got] == [a.accelerator for a in want]
    for g, w in zip(got, want):
        assert g.num_replicas == w.num_replicas
        assert g.max_rate_per_replica == pytest.approx(
            w.max_rate_per_replica, rel=RTOL)


def fused_presized(system):
    """Every (model, namespace, accelerator) pair of ``system`` sized by the
    port's fused program, in a batch with extra rows of a larger occupancy
    bound, so the candidate axis differs in size and in k_cols from the
    fleet builder's own batch."""
    plans = {}
    for server in system.servers.values():
        targets = system.targets_for(server)
        if targets is None or server.load.arrival_rate_per_min <= 0:
            continue
        cands = []
        for acc in system.candidate_accelerators(server):
            prof = system.profiles.get(server.model_id, acc.name,
                                       namespace=server.namespace)
            cands.append(_Candidate(
                variant_name=f"{server.model_id}-{acc.name}",
                accelerator=acc.name, cost=acc.cost, ready=0, pending=0,
                profile=prof, targets=targets,
                request_size=RequestSize(
                    avg_input_tokens=server.load.avg_input_tokens,
                    avg_output_tokens=max(server.load.avg_output_tokens,
                                          1.0))))
        plans[f"{server.model_id}|{server.namespace}"] = \
            type("Plan", (), {"candidates": cands})()
    wide = t_q.PerfProfile(model_id="wide", accelerator="v5e-8",
                           service_parms=t_q.ServiceParms(5.0, 0.01, 0.001),
                           max_batch_size=64, max_queue_size=1900)
    plans["wide|x"] = type("Plan", (), {"candidates": [_Candidate(
        variant_name="wide", accelerator="v5e-8", cost=1.0, ready=0,
        pending=0, profile=wide, targets=t_q.TargetPerf(target_ttft_ms=900),
        request_size=RequestSize(avg_input_tokens=100,
                                 avg_output_tokens=50))] * 40})()
    grids = fused.FleetGrids(device="cpu")
    fused.build_candidate_axis(grids, plans, sorted(plans))
    assert grids.k_cols == 2048
    return fused.run(grids, memo=False).presized


@pytest.mark.parametrize("capacity", [{}, {"v5e": 64, "v5p": 32, "v6e": 48}],
                         ids=["unlimited", "pressure"])
def test_presized_equals_own_sizing(capacity):
    system = seeded_system(PORT, capacity)
    spec = t_fleet.SolverSpec(unlimited=not capacity)
    presized = fused_presized(system)
    own = t_fleet.build_candidates(system, device="cpu")
    reused = t_fleet.build_candidates(system, presized=presized, device="cpu")
    assert sorted(own) == sorted(reused)
    for name in own:
        assert [(a.accelerator, a.num_replicas, a.max_rate_per_replica)
                for a in reused[name]] == \
            [(a.accelerator, a.num_replicas, a.max_rate_per_replica)
             for a in own[name]]
    launches = sizing_kernel.launches
    a = t_fleet.solve(system, spec, device="cpu")
    b = t_fleet.solve(system, spec, presized=presized, device="cpu")
    assert sizing_kernel.launches == launches
    assert {k: (v.accelerator, v.num_replicas)
            for k, v in a.allocations.items()} == \
        {k: (v.accelerator, v.num_replicas)
         for k, v in b.allocations.items()}
