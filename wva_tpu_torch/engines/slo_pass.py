"""The SLO engine tick: the staged pass and the fused pass.

Counterparts of the SLO branch of the JAX engine's analyze phase
(``wva_tpu/engines/saturation/engine.py``), given explicit arguments instead
of engine state, with the vectorized decision stage off
(``WVA_VEC_DECIDE=off``) and without the enforcer, the limiter, the capacity
plane or the tuner:

- :func:`run_slo_pass` is the tick with the fused program off
  (``WVA_FUSED=off``): per-model ``prepare``, ONE batched
  ``size_candidates`` over the fleet, per-model ``finalize``, then the
  optimizers and the forecast planner, each with its own device calls.
- :func:`run_fused_pass` is the tick with it on (the engine's default):
  the planner's learning pass first (``prepare_tick``), the fused grids,
  ONE fused program (the sizing kernel and the fit kernel, one host
  transfer, ``fused.run``), then ``finalize``, the optimizers on the
  fused sizing, and the planner's planning loop on the fused fits.

Both route each model by its ``optimizer_name``: "global" models go
through the fleet solve (:class:`FleetRoute`), the rest through the
cost-aware optimizer; the fleet's decisions come first, as in the engine.
A ``planner`` (:class:`~wva_tpu_torch.forecast.planner.CapacityPlanner`)
turns forecasting on: its floors raise the decisions of models the fleet
solve does not own. Given the same inputs and the same state, the two
passes return the same decisions.
"""

from __future__ import annotations

import math

from wva_tpu_torch import fused
from wva_tpu_torch.analyzers.queueing.analyzer import QueueingModelAnalyzer
from wva_tpu_torch.config.slo import (
    DEFAULT_SERVICE_CLASS_PRIORITY,
    ServiceClass,
)
from wva_tpu_torch.fleet import (
    AcceleratorSpec,
    CurrentAlloc,
    FleetSystem,
    ServerLoad,
    ServerSpec,
    SolverSpec,
    solve,
)
from wva_tpu_torch.forecast import apply_forecast_floors
from wva_tpu_torch.interfaces import (
    ACTION_NO_CHANGE,
    ACTION_SCALE_DOWN,
    ACTION_SCALE_UP,
    AnalyzerInput,
    VariantDecision,
)
from wva_tpu_torch.pipeline.optimizer import (
    CostAwareOptimizer,
    ModelScalingRequest,
)

# How long a cross-variant migration may hold the losing variants' replicas
# while the winner is not ready, before it drains one replica a tick
# (engine.py:176).
MIGRATION_HOLD_TIMEOUT = 600.0


class FleetRoute:
    """The fleet-solve route (``optimizerName: "global"``): the engine's
    ``_optimize_global`` and ``_allocations_to_decisions``
    (``engine.py:2974-3241``) with no limiter and no capacity plane, so the
    solve is unlimited, as in the engine without inventory. Keeps the
    readiness-aware migration holds from tick to tick: pass the same
    instance to every tick."""

    def __init__(self) -> None:
        self.migration_holds: dict[str, tuple[float, int, str]] = {}

    def decide(self, analyzer: QueueingModelAnalyzer,
               requests: list[ModelScalingRequest],
               slo_cfg_by_ns: dict[str, object],
               presized: dict | None = None) -> list[VariantDecision]:
        """Fleet-wide assignment for ``requests``: one FleetSystem across
        every model, solved on the analyzer's device. ``presized`` is the
        fused program's sizing of every (model, namespace, accelerator)
        pair; with it the solve sizes nothing itself."""
        accelerators: dict[str, AcceleratorSpec] = {}
        servers: dict[str, ServerSpec] = {}
        service_classes = {}
        req_by_server: dict[str, ModelScalingRequest] = {}
        for req in requests:
            slo_cfg = slo_cfg_by_ns.get(req.namespace)
            if slo_cfg is None or req.result is None:
                continue
            # Service-class names are namespace-qualified in the shared
            # system: same-named classes in different namespaces must not
            # override each other's priority/targets.
            sc_name = slo_cfg.class_for_model(req.model_id)
            if sc_name is not None:
                qualified = f"{req.namespace}|{sc_name}"
                for sc in slo_cfg.service_classes:
                    if sc.name == sc_name:
                        service_classes[qualified] = sc
            elif slo_cfg.default_targets is not None:
                qualified = f"{req.namespace}|__default__"
                sc = service_classes.setdefault(qualified, ServiceClass(
                    name="__default__",
                    priority=DEFAULT_SERVICE_CLASS_PRIORITY))
                sc.model_targets[req.model_id] = slo_cfg.default_targets
            else:
                continue

            chips_by_accel = {vs.accelerator_name: vs.chips_per_replica
                              for vs in req.variant_states
                              if vs.accelerator_name}
            current = None
            for vc in sorted(req.result.variant_capacities,
                             key=lambda v: -v.replica_count):
                accel = vc.accelerator_name
                if not accel:
                    continue
                if accel not in accelerators:
                    accelerators[accel] = AcceleratorSpec(
                        name=accel, type=accel.split("-")[0],
                        chips_per_replica=chips_by_accel.get(accel, 1),
                        cost=vc.cost)
                if current is None and vc.replica_count > 0:
                    current = CurrentAlloc(
                        accelerator=accel, num_replicas=vc.replica_count,
                        cost=vc.cost * vc.replica_count)

            name = f"{req.namespace}/{req.model_id}"
            servers[name] = ServerSpec(
                name=name, namespace=req.namespace, model_id=req.model_id,
                service_class=qualified,
                load=ServerLoad(
                    # What scale-up must cover: the anticipated demand plus
                    # the standing headroom, as the per-model path sizes it.
                    arrival_rate_per_min=(
                        max(req.result.scaling_demand, req.result.total_demand)
                        + req.result.headroom_capacity) * 60.0,
                    avg_input_tokens=req.result.avg_input_tokens,
                    avg_output_tokens=req.result.avg_output_tokens),
                min_replicas=1,
                # A fitted profile alone does not make a placement
                # actuatable: only accelerators with deployed variants.
                allowed_accelerators=frozenset(chips_by_accel),
                current=current)
            req_by_server[name] = req
        if not servers:
            return []
        system = FleetSystem(
            accelerators=accelerators, servers=servers,
            service_classes=service_classes, profiles=analyzer.profiles,
            capacity_chips={})
        solution = solve(system, SolverSpec(unlimited=True),
                         presized=presized or None, device=analyzer.device)
        return self._allocations_to_decisions(analyzer.clock.now(),
                                              req_by_server, solution)

    def _allocations_to_decisions(self, now: float, req_by_server,
                                  solution) -> list[VariantDecision]:
        """Fleet-solver allocations -> per-variant decisions, with
        readiness-aware migration holds (make-before-break)."""
        decisions: list[VariantDecision] = []
        active_holds: set[str] = set()
        for name, req in req_by_server.items():
            alloc = solution.allocations.get(name)
            # Exactly ONE variant receives the solution's replica count:
            # most READY replicas, then most current, then name.
            winner = None
            if alloc is not None and alloc.accelerator:
                matching = [vs for vs in req.variant_states
                            if vs.accelerator_name == alloc.accelerator]
                if matching:
                    winner = max(matching, key=lambda vs: (
                        vs.ready_replicas, vs.current_replicas,
                        vs.variant_name))
            # Losing variants decay with the winner's readiness, and a hold
            # timeout forces a one-replica-per-tick drain.
            migration_ready = True
            winner_ready = 0
            if winner is not None:
                winner_ready = winner.ready_replicas
                migration_ready = winner_ready >= alloc.num_replicas
            if alloc is not None and alloc.accelerator and winner is None:
                alloc = None  # no variant serves the choice: hold steady
            for vs in req.variant_states:
                hold_key = f"{name}|{vs.variant_name}"
                reason = "global optimizer (fleet assignment)"
                if alloc is None:
                    target = vs.current_replicas  # unallocated: hold steady
                elif winner is not None and vs is winner:
                    target = alloc.num_replicas
                elif migration_ready or vs.current_replicas == 0:
                    target = 0  # consolidate onto the chosen variant
                else:
                    held = self.migration_holds.get(hold_key)
                    if held is None or held[2] != alloc.accelerator:
                        held = (now, vs.current_replicas, alloc.accelerator)
                    self.migration_holds[hold_key] = held
                    active_holds.add(hold_key)
                    started, initial, _ = held
                    shortfall = 1.0 - winner_ready / max(alloc.num_replicas, 1)
                    decayed = math.ceil(initial * shortfall)
                    if now - started > MIGRATION_HOLD_TIMEOUT:
                        target = max(0, vs.current_replicas - 1)
                        reason = ("global optimizer (migration hold timed "
                                  f"out after {MIGRATION_HOLD_TIMEOUT:.0f}s; "
                                  "draining to unblock the winner)")
                    else:
                        target = min(vs.current_replicas, decayed)
                        reason = ("global optimizer (holding replicas until "
                                  f"{alloc.accelerator} reports "
                                  f"{alloc.num_replicas} ready)")
                d = VariantDecision(
                    variant_name=vs.variant_name, namespace=req.namespace,
                    model_id=req.model_id,
                    accelerator_name=vs.accelerator_name,
                    current_replicas=vs.current_replicas,
                    target_replicas=target,
                    chips_per_replica=vs.chips_per_replica,
                    cost=next((vc.cost for vc in req.result.variant_capacities
                               if vc.variant_name == vs.variant_name), 0.0),
                    action=(ACTION_SCALE_UP if target > vs.current_replicas
                            else ACTION_SCALE_DOWN
                            if target < vs.current_replicas
                            else ACTION_NO_CHANGE),
                    reason=reason)
                d.add_step(
                    f"analyzer:{req.result.analyzer_name or 'slo'}",
                    f"demand={req.result.total_demand:.2f} "
                    f"supply={req.result.total_supply:.2f} "
                    f"required={req.result.required_capacity:.2f}",
                    now=now)
                d.add_step("optimizer:global", reason, now=now)
                decisions.append(d)
        # Prune holds that did not re-assert themselves this solve.
        self.migration_holds = {k: v for k, v in self.migration_holds.items()
                                if k in active_holds}
        return decisions


def _group(inputs: list[AnalyzerInput]):
    """Inputs by group key (``model_id|namespace``), the keys in the
    engine's sorted order, and each namespace's SLO config."""
    by_key = {f"{inp.model_id}|{inp.namespace}": inp for inp in inputs}
    slo_cfg_by_ns = {}
    for inp in inputs:
        slo_cfg_by_ns.setdefault(inp.namespace, inp.slo_config)
    return by_key, sorted(by_key), slo_cfg_by_ns


def _is_global(inp: AnalyzerInput) -> bool:
    return inp.config is not None and inp.config.optimizer_name == "global"


def _decide(analyzer, optimizer, keys, plans, sized, fleet, slo_cfg_by_ns,
            presized=None):
    """``finalize`` per sized model in sorted key order, then the fleet
    solve for global-routed models and the cost-aware optimizer for the
    rest (``engine.py:2125-2208, 2238-2279``). A model whose result has no
    variant capacities is left out, as the engine leaves it at its current
    replicas. Returns (requests, decisions)."""
    requests, global_reqs, local_reqs = [], [], []
    for k in keys:
        plan = plans[k]
        result = (analyzer.finalize(plan, sized[k]) if plan.needs_sizing
                  else plan.result)
        if not result.variant_capacities:
            continue
        req = ModelScalingRequest(
            model_id=plan.input.model_id, namespace=plan.input.namespace,
            result=result, variant_states=plan.input.variant_states)
        requests.append(req)
        (global_reqs if _is_global(plan.input) else local_reqs).append(req)
    decisions: list[VariantDecision] = []
    if global_reqs:
        decisions.extend((fleet or FleetRoute()).decide(
            analyzer, global_reqs, slo_cfg_by_ns, presized))
    if local_reqs:
        decisions.extend(optimizer.optimize(local_reqs, None))
    return requests, decisions


def run_slo_pass(analyzer: QueueingModelAnalyzer,
                 optimizer: CostAwareOptimizer,
                 inputs: list[AnalyzerInput], planner=None,
                 fleet: FleetRoute | None = None) -> list[VariantDecision]:
    """One staged tick's SLO decisions for ``inputs``, in the engine's
    order (fleet-solved models first, then the rest in sorted
    ``model_id|namespace`` order):

    1. ``analyzer.prepare`` per model;
    2. one ``analyzer.size_candidates`` over the concatenated candidates of
       every model that needs sizing, sliced back per model
       (``engine.py:2029-2075``);
    3. ``analyzer.finalize`` per sized model, the fleet solve (``fleet``,
       sizing its own batch) for models routed "global" and
       ``optimizer.optimize(requests, None)`` for the rest;
    4. with a ``planner``: its full pass — observation, scoring, one fit
       (``fit_batch``) and planning — and its floors on the decisions of
       models the fleet solve does not own (``engine.py:2719-2775``).

    ``fleet`` keeps migration holds across ticks; None starts from none."""
    by_key, keys, slo_cfg_by_ns = _group(inputs)
    plans = {k: analyzer.prepare(by_key[k]) for k in keys}
    batch_keys = [k for k in keys if plans[k].needs_sizing]
    sized: dict[str, list[float]] = {}
    if batch_keys:
        per_replica = analyzer.size_candidates(
            [c for k in batch_keys for c in plans[k].candidates])
        offset = 0
        for k in batch_keys:
            n = len(plans[k].candidates)
            sized[k] = per_replica[offset:offset + n]
            offset += n
    requests, decisions = _decide(analyzer, optimizer, keys, plans, sized,
                                  fleet, slo_cfg_by_ns)
    if planner is not None and requests:
        now = analyzer.clock.now()
        no_floor = frozenset(planner.key_for(r.namespace, r.model_id)
                             for r in requests if _is_global(
                                 by_key[f"{r.model_id}|{r.namespace}"]))
        _, floors = planner.plan(requests, now, no_floor_keys=no_floor)
        apply_forecast_floors(decisions, floors, now)
    return decisions


def run_fused_pass(analyzer: QueueingModelAnalyzer,
                   optimizer: CostAwareOptimizer,
                   inputs: list[AnalyzerInput], planner=None,
                   fleet: FleetRoute | None = None,
                   memo: bool = True) -> list[VariantDecision]:
    """One fused tick's SLO decisions for ``inputs``, in the same order as
    :func:`run_slo_pass` and equal to its decisions:

    1. ``analyzer.prepare`` per model;
    2. with a ``planner``: its learning pass (``prepare_tick``: demand and
       variant observation, eviction, grids, backtest scoring, trust
       selection) over the models that need sizing;
    3. the fused grids (``engine.py:3242-3299``) and ONE fused program on
       the analyzer's device (``fused.run``: the sizing kernel and the fit
       kernel, one host transfer), with the solve memo when ``memo``;
    4. ``finalize``, the fleet solve on the fused sizing (``presized``: it
       sizes nothing) and the cost-aware optimizer;
    5. the planner's planning loop over the fused fits, and its floors.

    A kernel failure raises; nothing falls back to the staged calls."""
    by_key, keys, slo_cfg_by_ns = _group(inputs)
    plans = {k: analyzer.prepare(by_key[k]) for k in keys}
    batch_keys = [k for k in keys if plans[k].needs_sizing]
    sized: dict[str, list[float]] = {}
    presized = None
    prep = None
    if batch_keys:
        if planner is not None:
            prep = planner.prepare_tick(
                [(plans[k].input.namespace, plans[k].input.model_id,
                  analyzer.plan_demand(plans[k]),
                  plans[k].input.variant_states) for k in batch_keys],
                analyzer.clock.now())
        grids = fused.FleetGrids(device=analyzer.device)
        fused.build_candidate_axis(grids, plans, batch_keys)
        if prep is not None:
            by_pkey = {planner.key_for(plans[k].input.namespace,
                                       plans[k].input.model_id): plans[k]
                       for k in batch_keys}
            inputs_by_row = [by_pkey[pkey].input for pkey in prep.keys]
            global_routed = [_is_global(inp) for inp in inputs_by_row]
            fused.build_model_axis(
                grids, prep.grids, prep.keys, prep.trust_idx, prep.trusted,
                global_routed,
                [bool(getattr(inp.slo_config, "tuner_enabled", False))
                 for inp in inputs_by_row],
                [not any(vs.ready_replicas > 0 for vs in inp.variant_states)
                 for inp in inputs_by_row])
            prep.global_no_floor = frozenset(
                k for k, g in zip(prep.keys, global_routed) if g)
        result = fused.run(grids, memo=memo, impl=analyzer.impl)
        if prep is not None:
            prep.fits = result.fits
            prep.chosen = result.chosen
        sized = result.per_replica
        presized = result.presized
    requests, decisions = _decide(analyzer, optimizer, keys, plans, sized,
                                  fleet, slo_cfg_by_ns, presized)
    if planner is not None and requests:
        now = prep.now if prep is not None else analyzer.clock.now()
        no_floor = (prep.global_no_floor if prep is not None else frozenset(
            planner.key_for(r.namespace, r.model_id) for r in requests
            if _is_global(by_key[f"{r.model_id}|{r.namespace}"])))
        _, floors = planner.plan(requests, now, no_floor_keys=no_floor,
                                 prepared=prep)
        apply_forecast_floors(decisions, floors, now)
    return decisions
