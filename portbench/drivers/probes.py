"""Wrappers the benchmark puts around calls into the program's layers.
Each records into a ``Record`` while it records, and hands the call on
unchanged: a host-clock timer, the inputs and outputs of the calls the
record's reservoir keeps for the comparison (references to the program's
own tensors, read once the window has closed, so nothing is copied or
synchronised inside it), and in a traced run each kernel launch's shapes
for its roofline."""

from __future__ import annotations

import time

import torch


class Patches:
    """Attributes replaced on the program's modules, restored on exit."""

    def __init__(self):
        self._saved = []

    def replace(self, owner, attr, make):
        inner = getattr(owner, attr)
        self._saved.append((owner, attr, inner))
        setattr(owner, attr, make(inner))

    def restore(self):
        for owner, attr, inner in reversed(self._saved):
            setattr(owner, attr, inner)
        self._saved.clear()


def labelled(label: str):
    """A host range named ``portbench:<label>`` in a profiler's trace."""
    return torch.profiler.record_function(f"portbench:{label}")


class PhaseRanges:
    """The engine's tick phases (prepare, fingerprint, analyze, apply) as
    host ranges in a profiler's trace, opened and closed where the engine
    opens and closes its own phase spans."""

    def __init__(self, patches: Patches, engine):
        self.open = None

        def begin(inner):
            def begin_phase_span(name, *args, **kwargs):
                # The engine's own begin closes the previous phase through
                # its end, which closes the previous range: open after it.
                out = inner(name, *args, **kwargs)
                self.open = labelled(f"phase:{name}")
                self.open.__enter__()
                return out
            return begin_phase_span

        def end(inner):
            def end_phase_span(*args, **kwargs):
                self.close()
                return inner(*args, **kwargs)
            return end_phase_span

        patches.replace(engine, "_begin_phase_span", begin)
        patches.replace(engine, "_end_phase_span", end)

    def close(self):
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None


def fused_program(patches: Patches, rec, timer: str | None = None):
    """``fused.run``: each call's grids and host result; with ``timer``
    its host-clock ms."""
    from wva_tpu_torch import fused

    def make(inner):
        def run(grids, *args, **kwargs):
            if not rec.recording:
                return inner(grids, *args, **kwargs)
            t0 = time.perf_counter()
            with labelled("fused program"):
                out = inner(grids, *args, **kwargs)
            ms = 1e3 * (time.perf_counter() - t0)
            if timer:
                rec.timers[timer].append(ms)
            slot = rec.slot("fused")
            if slot is not None:
                rec.keep("fused", slot, (grids, out))
            return out
        return run

    patches.replace(fused, "run", make)


def kernel_launches(patches: Patches, rec):
    """The sizing, jacobian and scan kernels' wrappers: in a traced run,
    each launch's shape tensors, kept as references."""
    from wva_tpu_torch.analyzers.queueing import jacobian_kernel, sizing_kernel
    from wva_tpu_torch.sweep import scan_kernel

    def sizing(inner):
        def launch(clm, clm_at_k, cand, *args, **kwargs):
            if rec.recording and rec.traced and clm.is_cuda:
                rec.launches["sizing_bisection"].append(
                    {"k_cols": int(clm.shape[1]), "k": cand.k})
            return inner(clm, clm_at_k, cand, *args, **kwargs)
        return launch

    def jacobian(inner):
        def launch(x, env, *args, **kwargs):
            if rec.recording and rec.traced:
                rec.launches["chain_jacobian"].append({"env": env})
            return inner(x, env, *args, **kwargs)
        return launch

    def scan(inner):
        def launch(knob_rows, lam_t, arrivals, faults, *args, **kwargs):
            if rec.recording and rec.traced:
                rec.launches["world_scan"].append(
                    {"steps": int(arrivals.shape[0]),
                     "worlds": int(arrivals.shape[1]),
                     "models": int(arrivals.shape[2]),
                     "knobs": int(knob_rows.shape[1])})
            return inner(knob_rows, lam_t, arrivals, faults, *args, **kwargs)
        return launch

    patches.replace(sizing_kernel, "sizing_bisection", sizing)
    patches.replace(jacobian_kernel, "launch", jacobian)
    patches.replace(scan_kernel, "launch", scan)


def tuner_observation(patches: Patches, rec):
    """The EKF step's h and H (``tuner._observation``): x, env and the
    ``[2, 4]`` result of the steps kept."""
    from wva_tpu_torch.analyzers.queueing import tuner

    def make(inner):
        def observation(x, env):
            out = inner(x, env)
            if rec.recording:
                slot = rec.slot("observation")
                if slot is not None:
                    rec.keep("observation", slot, (x, env, out))
            return out
        return observation

    patches.replace(tuner, "_observation", make)


def host_values(launches: dict) -> dict:
    """The recorded launches with their tensors read to the host."""
    out = {}
    for kernel, calls in launches.items():
        rows = []
        for call in calls:
            row = {}
            for key, value in call.items():
                if isinstance(value, torch.Tensor):
                    value = value.detach().cpu().tolist()
                row[key] = value
            rows.append(row)
        out[kernel] = rows
    return out



def decision_stage(patches: Patches, rec, engine):
    """The engine's decision stage (``_optimize_v2``: finalize, optimizer,
    fleet solve, enforcer, forecast floors, limiter) on the ticks the
    record's reservoir keeps: what each step starts from and what the
    stage returns, taken during the tick as plain host values (the
    program rebuilds its objects every tick and mutates some after the
    stage). Kept under ``calls["decisions"]``, one dict a tick."""
    from wva_tpu_torch import fleet
    from wva_tpu_torch.pipeline import vectorized

    state = {"tick": None}

    def optimize(inner):
        def _optimize_v2(*args, **kwargs):
            slot = rec.slot("decisions") if rec.recording else None
            if slot is None:
                return inner(*args, **kwargs)
            tick = {"now": engine.clock.now(),
                    "holds": dict(engine._migration_holds), "slopes": {},
                    "plans": [], "floors": [], "pools": None, "solves": [],
                    "pre_limit": None, "decisions": None}
            state["tick"] = tick
            try:
                out = inner(*args, **kwargs)
            finally:
                state["tick"] = None
            tick["decisions"] = [decision_values(d) for d in out]
            rec.keep("decisions", slot, tick)
            return out
        return _optimize_v2

    def observe(inner):
        def trend_observe(key, now, demand):
            slope = inner(key, now, demand)
            if state["tick"] is not None:
                state["tick"]["slopes"][key] = slope
            return slope
        return trend_observe

    def finalize_fleet(inner):
        def fleet_pass(analyzer, items, *args, **kwargs):
            if state["tick"] is not None:
                state["tick"]["plans"].extend(
                    plan_values(plan, per_replica)
                    for _key, plan, per_replica in items)
            return inner(analyzer, items, *args, **kwargs)
        return fleet_pass

    def finalize(inner):
        def one(plan, per_replica):
            if state["tick"] is not None:
                state["tick"]["plans"].append(plan_values(plan, per_replica))
            return inner(plan, per_replica)
        return one

    def plan(inner):
        def forecast_plan(*args, **kwargs):
            plans, floors = inner(*args, **kwargs)
            if state["tick"] is not None:
                state["tick"]["floors"].extend(
                    (f.get("namespace", ""), f.get("variant_name", ""),
                     int(f.get("floor_replicas", 0))) for f in floors)
            return plans, floors
        return forecast_plan

    def limiter(inner):
        def apply_limiter(decisions):
            if state["tick"] is not None:
                state["tick"]["pre_limit"] = [decision_values(d)
                                              for d in decisions]
            return inner(decisions)
        return apply_limiter

    def refresh(inner):
        def inventory_refresh():
            out = inner()
            if state["tick"] is not None:
                state["tick"]["pools"] = {
                    name: p.limit for name, p in
                    engine.limiter.inventory.pools().items()}
            return out
        return inventory_refresh

    def solve(inner):
        def fleet_solve(system, spec=None, *args, **kwargs):
            out = inner(system, spec, *args, **kwargs)
            if state["tick"] is not None:
                state["tick"]["solves"].append(
                    solve_values(system, spec, kwargs.get("presized"), out))
            return out
        return fleet_solve

    analyzer = engine.slo_analyzer
    patches.replace(engine, "_optimize_v2", optimize)
    patches.replace(analyzer._demand_trend, "observe", observe)
    patches.replace(vectorized, "finalize_fleet", finalize_fleet)
    patches.replace(analyzer, "finalize", finalize)
    patches.replace(engine, "_apply_limiter", limiter)
    patches.replace(fleet, "solve", solve)
    if engine.forecast is not None:
        patches.replace(engine.forecast, "plan", plan)
    if engine.limiter is not None:
        patches.replace(engine.limiter.inventory, "refresh", refresh)


def decision_values(d) -> dict:
    """A decision's fields that the comparison judges, and the stage that
    set its target: the last step that moved the running target off the
    current replicas (the first step where none did)."""
    running, set_by = d.current_replicas, None
    for step in d.decision_steps:
        if step.target_replicas != running:
            set_by = step.name
        running = step.target_replicas
    if set_by is None and d.decision_steps:
        set_by = d.decision_steps[0].name
    return {"namespace": d.namespace, "model_id": d.model_id,
            "variant": d.variant_name, "accelerator": d.accelerator_name,
            "current": d.current_replicas, "target": d.target_replicas,
            "action": d.action, "chips": d.chips_per_replica,
            "cost": d.cost, "spare": d.spare_capacity, "set_by": set_by or ""}


def plan_values(plan, per_replica) -> dict:
    """What the SLO analyzer's finalize starts from for one model: its
    telemetry, variants, configuration, candidate variants with the rows
    they were sized from (profile, request size, bounds, targets) and
    their sized per-replica rates."""
    inp = plan.input
    cfg = inp.config
    return {
        "namespace": inp.namespace, "model_id": inp.model_id,
        "analyzer": plan.result.analyzer_name,
        "arrival_rate_per_min": (inp.optimizer_metrics.arrival_rate
                                 if inp.optimizer_metrics is not None
                                 else None),
        "replicas": [(rm.variant_name, rm.cost, rm.queue_length,
                      rm.avg_input_tokens, rm.avg_output_tokens)
                     for rm in inp.replica_metrics],
        "scheduler_queue": (inp.scheduler_queue.queue_size
                            if inp.scheduler_queue is not None else None),
        "variants": [(vs.variant_name, vs.accelerator_name,
                      vs.current_replicas, vs.pending_replicas,
                      vs.chips_per_replica) for vs in inp.variant_states],
        "config": {k: getattr(cfg, k, None) for k in (
            "scale_up_threshold", "scale_down_boundary",
            "anticipation_horizon_seconds", "headroom_replicas",
            "burst_slope_rps", "optimizer_name")},
        "candidates": [c.variant_name for c in plan.candidates],
        "rows": [(c.profile.service_parms.alpha, c.profile.service_parms.beta,
                  c.profile.service_parms.gamma,
                  c.request_size.avg_input_tokens,
                  c.request_size.avg_output_tokens,
                  c.profile.max_batch_size, c.profile.max_queue_size,
                  c.targets.target_ttft_ms, c.targets.target_itl_ms,
                  c.targets.target_tps) for c in plan.candidates],
        "per_replica": [float(r) for r in per_replica],
    }


def solve_values(system, spec, presized, solution) -> dict:
    """The fleet solve: what the program gave it beyond the models'
    results (the pools, the accelerators' tier weights, which pairs have
    a fitted profile, each pair's sized throughput) and its allocation."""
    servers = {}
    for name, server in system.servers.items():
        targets = system.targets_for(server)
        accs = [a.name for a in system.candidate_accelerators(server)]
        servers[name] = {
            "priority": system.priority(server),
            "target_tps": targets.target_tps if targets is not None
            else None,
            "accelerators": accs,
            "rate_star": {a: presized.get((server.model_id,
                                           server.namespace, a))
                          for a in accs} if presized else {}}
    return {
        "unlimited": bool(spec is not None and spec.unlimited),
        "capacity_chips": dict(system.capacity_chips),
        "accelerators": {a.name: (a.type, a.chips_per_replica, a.cost,
                                  a.tier_cost_weight)
                         for a in system.accelerators.values()},
        "servers": servers,
        "allocations": {name: (a.accelerator, a.num_replicas)
                        for name, a in solution.allocations.items()}}
