"""The fleet of ``fleet_feed`` under the sharded engine plane.

The same models, profiles, telemetry, demand and seed as ``fleet_feed``,
built the same way through ``build_manager``, with ``WVA_SHARDING`` on:
the configuration's ``sharding`` block (shards, workers, rebalance hold,
summary staleness) as the manager's ``ShardingConfig``, the in-process
summary bus. The fleet engine then drives one worker engine a shard;
each analyzes the models the consistent-hash ring gives it, runs its own
fused program and decision stage up to the limiter, and publishes a
capture; the fleet engine merges the captures, solves the fleet-solved
models once, and applies.

The decision stage is recorded across the plane as one tick: what every
worker's stage started from (plans, slopes, floors), the fleet solve, and
the merged decisions, so that ``decision_gap`` judges the merged set as it
judges an unsharded tick's. Each kept tick also keeps its ownership: the
live and stale shards, the fleet's models, the models each shard's
capture holds and its entries by kind, and the decisions of the workers'
entries, of the fleet solve and of the merge, for ``shard_gap``.
"""

from __future__ import annotations

from portbench.core import GcClock
from portbench.drivers import fleet_feed, probes
from portbench.drivers.probes import (
    decision_values,
    labelled,
    plan_values,
    solve_values,
)


def build(config: dict, traffic: dict, seed: int, device):
    """(manager, clock, feed): ``fleet_feed.build`` with the plane on."""
    from wva_tpu_torch import config as config_module
    from wva_tpu_torch.config.config import ShardingConfig

    sharding = ShardingConfig(enabled=True, **config["sharding"])
    patches = probes.Patches()

    def sharded(inner):
        def new_test_config():
            cfg = inner()
            cfg.set_sharding(sharding)
            return cfg
        return new_test_config

    patches.replace(config_module, "new_test_config", sharded)
    try:
        return fleet_feed.build(config, traffic, seed, device)
    finally:
        patches.restore()


class WorkerRanges:
    """A worker engine's phases as host ranges ``shard:phase:<name>``, and
    its whole analysis tick as ``shard worker``."""

    def __init__(self, patches: probes.Patches, worker):
        self.open = None
        engine = worker.engine

        def begin(inner):
            def begin_phase_span(name, *args, **kwargs):
                out = inner(name, *args, **kwargs)
                self.close()
                self.open = labelled(f"shard:phase:{name}")
                self.open.__enter__()
                return out
            return begin_phase_span

        def end(inner):
            def end_phase_span(*args, **kwargs):
                self.close()
                return inner(*args, **kwargs)
            return end_phase_span

        def analyze(inner):
            def worker_analyze(*args, **kwargs):
                try:
                    with labelled("shard worker"):
                        return inner(*args, **kwargs)
                finally:
                    self.close()
            return worker_analyze

        patches.replace(engine, "_begin_phase_span", begin)
        patches.replace(engine, "_end_phase_span", end)
        patches.replace(worker, "analyze", analyze)

    def close(self):
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None


def entry_key(values: dict) -> tuple:
    return tuple(sorted(values.items()))


def sharded_decisions(patches: probes.Patches, rec, engine):
    """``probes.decision_stage`` across the plane: the fleet engine's
    ``_optimize_sharded`` is the tick; every worker's finalize, demand
    trend and forecast plans, the fleet solve and the fleet's limiter
    record into it. Kept under ``calls["decisions"]``, one dict a tick,
    with the tick's ownership under ``"shards"``."""
    from wva_tpu_torch import fleet
    from wva_tpu_torch.pipeline import vectorized
    from wva_tpu_torch.shard.summary import ENTRY_GLOBAL

    plane = engine.shard_plane
    state = {"tick": None}

    def optimize(inner):
        def _optimize_sharded(*args, **kwargs):
            slot = rec.slot("decisions") if rec.recording else None
            if slot is None:
                return inner(*args, **kwargs)
            tick = {"now": engine.clock.now(),
                    "holds": dict(engine._migration_holds), "slopes": {},
                    "plans": [], "floors": [], "pools": None, "solves": [],
                    "pre_limit": None, "decisions": None,
                    "shards": {"alive": [], "stale": [], "models": [],
                               "analyzed": {}, "kinds": {}, "reread": [],
                               "entry_decisions": [],
                               "solved_decisions": [],
                               "merged_decisions": []}}
            refs = {"entries": [], "solved": [], "captures": {},
                    "reread": set()}
            state["tick"], state["refs"] = tick, refs
            try:
                out = inner(*args, **kwargs)
            finally:
                state["tick"] = None
            tick["decisions"] = [decision_values(d) for d in out]
            rec.keep("decisions", slot, tick)
            return out
        return _optimize_sharded

    def gather(inner):
        def plane_gather(model_groups, *args, **kwargs):
            out = inner(model_groups, *args, **kwargs)
            if state["tick"] is not None:
                shards, refs = state["tick"]["shards"], state["refs"]
                shards["models"] = sorted({
                    vas[0].spec.model_id for vas in model_groups.values()})
                shards["alive"] = list(out.alive)
                shards["stale"] = list(out.stale)
                # The captures the merge took: each live worker's, and a
                # capture read back from the bus for a shard whose worker
                # did not run, unless the plane found it stale.
                for shard, cap in sorted(refs["captures"].items()):
                    if shard in out.stale:
                        continue
                    entries = list(cap.entries.values())
                    shards["analyzed"][shard] = sorted(
                        {e.model_id for e in entries})
                    kinds = {}
                    for e in entries:
                        kinds[e.kind] = kinds.get(e.kind, 0) + 1
                        if e.kind != ENTRY_GLOBAL:
                            refs["entries"].extend(e.decisions)
                    shards["kinds"][shard] = kinds
                    if shard in refs["reread"]:
                        shards["reread"].append(shard)
            return out
        return plane_gather

    def capture(reread):
        def make(inner):
            def taken(*args, **kwargs):
                cap = inner(*args, **kwargs)
                if state["tick"] is not None and cap is not None:
                    state["refs"]["captures"][cap.shard_id] = cap
                    if reread:
                        state["refs"]["reread"].add(cap.shard_id)
                return cap
            return taken
        return make

    def optimize_global(inner):
        def _optimize_global(*args, **kwargs):
            out = inner(*args, **kwargs)
            if state["tick"] is not None:
                state["refs"]["solved"].extend(out)
            return out
        return _optimize_global

    def limiter(inner):
        def apply_limiter(decisions):
            tick = state["tick"]
            if tick is not None:
                tick["pre_limit"] = [decision_values(d) for d in decisions]
                shards, refs = tick["shards"], state["refs"]
                shards["merged_decisions"] = [
                    entry_key(v) for v in tick["pre_limit"]]
                shards["entry_decisions"] = [
                    entry_key(decision_values(d)) for d in refs["entries"]]
                shards["solved_decisions"] = [
                    entry_key(decision_values(d)) for d in refs["solved"]]
            return inner(decisions)
        return apply_limiter

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
                # Each pair's throughput as the solve was given it, else
                # as the workers' fused programs sized it this tick (a
                # fleet solve that sizes its pairs itself).
                presized = kwargs.get("presized")
                if presized is None:
                    presized = {}
                    for worker in plane.workers.values():
                        presized.update(worker.engine._tick_presized or {})
                state["tick"]["solves"].append(
                    solve_values(system, spec, presized, out))
            return out
        return fleet_solve

    patches.replace(engine, "_optimize_sharded", optimize)
    patches.replace(plane, "gather", gather)
    patches.replace(plane.bus, "read", capture(True))
    patches.replace(engine, "_optimize_global", optimize_global)
    patches.replace(engine, "_apply_limiter", limiter)
    patches.replace(vectorized, "finalize_fleet", finalize_fleet)
    patches.replace(fleet, "solve", solve)
    planners = {}
    for worker in plane.workers.values():
        patches.replace(worker, "analyze", capture(False))
        analyzer = worker.engine.slo_analyzer
        patches.replace(analyzer._demand_trend, "observe", observe)
        patches.replace(analyzer, "finalize", finalize)
        if worker.engine.forecast is not None:
            planners[id(worker.engine.forecast)] = worker.engine.forecast
    for planner in planners.values():
        patches.replace(planner, "plan", plan)
    if engine.limiter is not None:
        patches.replace(engine.limiter.inventory, "refresh", refresh)


class Driver(fleet_feed.Driver):
    def __init__(self, config, traffic, seed, device, rec):
        self.config, self.traffic, self.rec = config, traffic, rec
        self.interval = config["engine_interval_s"]
        self.patches = probes.Patches()
        probes.fused_program(self.patches, rec)
        probes.kernel_launches(self.patches, rec)
        self.mgr, self.clock, self.feed = build(config, traffic, seed, device)
        self.gc = GcClock()
        engine = self.mgr.engine
        self.phases = probes.PhaseRanges(self.patches, engine)
        sharded_decisions(self.patches, rec, engine)
        self.worker_ranges = [
            WorkerRanges(self.patches, worker)
            for _, worker in sorted(engine.shard_plane.workers.items())]
        inner = engine.executor.on_tick
        self.outcome = {}

        def on_tick(name, elapsed, ok):
            self.outcome["ok"] = ok
            if inner is not None:
                inner(name, elapsed, ok)

        engine.executor.on_tick = on_tick

    def tick(self):
        """``fleet_feed``'s tick; a traced tick also keeps each worker's
        analysis tick in ms (the program's ``shard_tick`` spans)."""
        n = len(self.rec.ticks)
        super().tick()
        if self.rec.traced and len(self.rec.ticks) > n:
            tree = self.mgr.spans.last_tree() if self.mgr.spans else None
            self.rec.ticks[-1]["workers_ms"] = [
                child.get("dur_ms", 0.0)
                for child in (tree or {}).get("children", ())
                if child["name"] == "shard_tick"]
