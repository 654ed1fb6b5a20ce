"""The shard plane: N consistent-hash shard workers + the fleet merge
(docs/design/sharding.md).

Topology
--------
- **Shard workers** each run the existing informer + snapshot + analysis
  stack scoped to the models their shard owns, publishing a
  :class:`~wva_tpu_torch.shard.summary.ShardCapture` per tick under their shard
  lease's fencing token. In this in-process plane (emulator / bench /
  single-binary deployments) the workers are engine instances driven
  synchronously from inside the fleet tick; process-per-shard deployments
  run the identical worker engine in its own process and publish through
  the ConfigMap summary bus — the fleet merge consumes both transports
  identically.
- **The fleet shard** is the distinguished shard riding the existing
  leader-election lease: its holder merges summaries in sorted model
  order, runs the fleet-level solve over the shards' compact arrays, and
  owns the limiter / health gate / apply / capacity phases.

Rebalance rides the resilience plane: when a shard joins/leaves/crashes,
the ring moves only that shard's models; each moved model's first ticks on
its new owner are clamped by the rebalance ramp (scale-up allowed, nothing
drops below max(last-known-good, current)) until its inputs prove fresh —
the PR-11 boot-ramp discipline per model instead of per process — so a
rebalance can never produce a wrong-direction scale event.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

from wva_tpu_torch.constants import (
    FLEET_SHARD_ID,
    LABEL_SHARD,
    WVA_SHARD_MODELS_OWNED,
    WVA_SHARD_OWNER,
    WVA_SHARD_REBALANCE_TOTAL,
    WVA_SHARD_SUMMARY_AGE_SECONDS,
)
from wva_tpu_torch.obs.spans import scoped
from wva_tpu_torch.shard.hashring import HashRing, ownership_moves
from wva_tpu_torch.shard.lease import ShardLeaseManager
from wva_tpu_torch.shard.summary import (
    InProcessSummaryBus,
    ShardCapture,
    TraceBuffer,
)
from wva_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock

log = logging.getLogger(__name__)

DEFAULT_REBALANCE_HOLD_TICKS = 5
DEFAULT_SUMMARY_STALE_SECONDS = 90.0


@dataclass
class WorkerTickCtx:
    """One worker analysis tick's context, installed as
    ``engine.shard_ctx`` for the duration of the tick."""

    owned: frozenset
    capture: ShardCapture
    # The tick's fleet-solved requests, encoded into the capture with its
    # other entries once the worker's decision stage has run.
    global_requests: list = field(default_factory=list)

    def owns(self, model_id: str) -> bool:
        return model_id in self.owned


@dataclass
class PlaneTick:
    """What one fleet tick gathered from the shards."""

    alive: list[int] = field(default_factory=list)
    entries: dict = field(default_factory=dict)
    health: dict = field(default_factory=dict)
    trace: list = field(default_factory=list)
    plans: list = field(default_factory=list)
    floors: list = field(default_factory=list)
    raised: int = 0
    analyzed: int = 0
    skipped: int = 0
    moves: list[str] = field(default_factory=list)
    holds_opened: list[str] = field(default_factory=list)
    stale: list[int] = field(default_factory=list)
    uncovered: list[str] = field(default_factory=list)
    # Worker span subtrees (obs plane): each capture's serialized tick
    # tree, stamped (fleet tick id, shard id) — the fleet engine grafts
    # them under its own tick span (docs/design/observability.md).
    spans: list = field(default_factory=list)


class ShardWorker:
    """One shard's scoped analysis stack (an engine in shard-worker role)."""

    def __init__(self, shard_id: int, engine) -> None:
        self.shard_id = shard_id
        self.engine = engine
        self.dead = False
        self.last_analyze_seconds = 0.0
        # Lazily-built span recorder for this worker's analysis ticks
        # (obs plane): created only when the FLEET records spans, records
        # under the fleet's adopted (tick id, shard id) context, and the
        # resulting subtree ships in the ShardCapture. Ring of 2 — the
        # fleet grafts each tree the same tick it was recorded.
        self._spans = None

    def _ensure_spans(self, clock: Clock):
        if self._spans is None:
            from wva_tpu_torch.obs.spans import SpanRecorder

            self._spans = SpanRecorder(clock=clock, ring_size=2)
        return self._spans

    def analyze(self, owned_model_ids: frozenset, epoch: int,
                clock: Clock, collector=None,
                fleet_spans=None, trace: bool = True) -> ShardCapture:
        """One worker analysis tick over the owned partition. The engine's
        flight recorder is swapped for a TraceBuffer so every record the
        unsharded engine would have emitted is captured, section-tagged,
        for the fleet's sorted merge. ``collector`` is the fleet's SHARED
        tick collector view (in-process plane): all workers in one fleet
        tick serve their metrics from the same memoized fleet-wide
        executions, so the O(series) evaluation is paid once per fleet
        tick — process-per-shard workers leave it None and the backend
        computes it server-side per query instead. ``trace`` False (the
        fleet records no trace) captures no records: the fleet would drop
        them."""
        eng = self.engine
        buf = TraceBuffer() if trace else None
        cap = ShardCapture(shard_id=self.shard_id, epoch=epoch)
        eng.shard_ctx = WorkerTickCtx(owned=owned_model_ids, capture=cap)
        eng.flight = buf
        eng.enforcer.flight_recorder = buf
        eng.optimizer.flight_recorder = buf
        eng.tick_collector_override = collector
        wrec = None
        if fleet_spans is not None:
            # Record this worker tick under the FLEET's span context:
            # the subtree ships in the capture, stamped (fleet tick id,
            # shard id), and the fleet grafts it under its tick span.
            wrec = self._ensure_spans(clock)
            wrec.adopt(fleet_spans.trace_id, self.shard_id)
            eng.spans = wrec
        t0 = time.perf_counter()
        try:
            eng.optimize()
        finally:
            self.last_analyze_seconds = time.perf_counter() - t0
            eng.shard_ctx = None
            eng.flight = None
            eng.enforcer.flight_recorder = None
            eng.optimizer.flight_recorder = None
            eng.tick_collector_override = None
            eng.spans = None
        cap.trace = buf.records if buf is not None else []
        if wrec is not None:
            cap.spans, cap.span_ctx = wrec.take_capture_spans()
        return cap


class ShardPlane:
    """Coordinates shard leases, the ownership ring, worker drive/summary
    consumption, rebalance holds, and the ``wva_shard_*`` gauges. Installed
    as ``engine.shard_plane`` on the fleet engine; ``gather`` runs on the
    fleet tick thread."""

    def __init__(self, leases: ShardLeaseManager,
                 workers: dict[int, ShardWorker],
                 bus=None, registry=None, clock: Clock | None = None,
                 rebalance_hold_ticks: int = DEFAULT_REBALANCE_HOLD_TICKS,
                 summary_stale_seconds: float =
                 DEFAULT_SUMMARY_STALE_SECONDS) -> None:
        self.leases = leases
        self.workers = workers
        self.bus = bus or InProcessSummaryBus()
        self.registry = registry
        self.clock = clock or SYSTEM_CLOCK
        self.rebalance_hold_ticks = max(0, int(rebalance_hold_ticks))
        self.summary_stale_seconds = float(summary_stale_seconds)
        self._assignment: dict[str, int] = {}
        self._holds: dict[str, int] = {}   # group key -> ticks remaining
        self.rebalance_total = 0
        self.last_worker_seconds: dict[int, float] = {}
        self.last_alive: list[int] = []
        # The templates the last tick's workers asked the shared view for:
        # what the next tick warms (None, before a first tick: all).
        self._warm_names: frozenset[str] | None = None

    # --- fleet-tick entry point ---

    def gather(self, model_groups: dict, collector=None,
               spans=None, trace: bool = True) -> PlaneTick:
        now = self.clock.now()
        # Warm the fleet's shared tick view ONCE before any worker's timed
        # analysis: the fleet-wide grouped evaluations (O(series) — what a
        # real Prometheus computes server-side) land in the shared memo,
        # and every worker below serves metric slices and fingerprint
        # versions from it. Serving/stamping is exactly what the first
        # organic toucher would have done, so decisions and fingerprints
        # stay byte-identical; only who pays the backend's share changes.
        if collector is not None and model_groups:
            source = getattr(collector, "source", None)
            warm = getattr(source, "warm_fleet_queries", None)
            if warm is not None:
                from wva_tpu_torch.collector.source.source import (
                    PARAM_MODEL_ID,
                    PARAM_NAMESPACE,
                )

                first = model_groups[sorted(model_groups)[0]][0]
                with scoped(spans, "fleet_queries"):
                    warm({PARAM_MODEL_ID: first.spec.model_id,
                          PARAM_NAMESPACE: first.metadata.namespace},
                         self._warm_names)
        with scoped(spans, "shard_leases", shards=self.leases.shards):
            held = self.leases.tick()
        alive = sorted(held)
        tick = PlaneTick(alive=alive)
        self.last_alive = alive
        ring_span = spans.begin_span("ring") if spans is not None else None
        model_ids = sorted({vas[0].spec.model_id
                            for vas in model_groups.values()})
        groups_by_model: dict[str, list[str]] = {}
        for gk, vas in model_groups.items():
            groups_by_model.setdefault(vas[0].spec.model_id, []).append(gk)

        # Existing rebalance holds age by one fleet tick; the engine's
        # health gate releases them early on proven-fresh inputs.
        for gk in list(self._holds):
            self._holds[gk] -= 1
            if self._holds[gk] <= 0:
                del self._holds[gk]

        if not alive:
            # No live shard anywhere: nothing is covered, nothing is
            # decided — the apply phase holds every model's previous
            # desired (the do-no-harm direction) until a lease returns.
            log.warning("shard plane: no live shard leases; holding fleet")
            tick.uncovered = model_ids
            if spans is not None:
                spans.end_span(ring_span)
            self._emit_gauges({}, {}, now)
            return tick

        ring = HashRing(alive)
        assignment = ring.assign(model_ids)
        moves = ownership_moves(self._assignment, assignment)
        holds_opened: list[str] = []
        if moves and self.rebalance_hold_ticks > 0:
            for mid in moves:
                old = self._assignment.get(mid)
                old_worker = self.workers.get(old) if old is not None \
                    else None
                for gk in groups_by_model.get(mid, []):
                    self._holds[gk] = self.rebalance_hold_ticks
                    holds_opened.append(gk)
                if old_worker is not None:
                    # The old owner stops tracking the moved models'
                    # forecast/trend gauges WITHOUT removing the series —
                    # the new owner keeps emitting them.
                    old_worker.engine.forget_forecast_gauges(
                        {(mid, gk.rpartition("|")[2])
                         for gk in groups_by_model.get(mid, [])})
        if moves:
            self.rebalance_total += len(moves)
            log.info("shard plane: %d model(s) rebalanced (alive shards: "
                     "%s)", len(moves), alive)
        self._assignment = assignment

        owned_by_shard: dict[int, set[str]] = {s: set() for s in alive}
        for mid, shard in assignment.items():
            owned_by_shard[shard].add(mid)
        if spans is not None:
            spans.end_span(ring_span)

        ages: dict[int, float] = {}
        self.last_worker_seconds = {}
        for shard in alive:
            owned = frozenset(owned_by_shard[shard])
            worker = self.workers.get(shard)
            cap: ShardCapture | None = None
            if worker is not None and not worker.dead:
                epoch = self.leases.fencing_token(shard)
                if epoch is not None:
                    cap = worker.analyze(owned, epoch, self.clock,
                                         collector=collector,
                                         fleet_spans=spans, trace=trace)
                    self.bus.publish(cap)
                    self.last_worker_seconds[shard] = \
                        worker.last_analyze_seconds
            else:
                # Process-per-shard transport: another process owns this
                # shard's lease and publishes through the bus.
                cap = self.bus.read(shard)
            age = None if cap is None else max(0.0, now - cap.published_at)
            if cap is None or age > self.summary_stale_seconds:
                # Do-no-harm: a missing/stale summary covers nothing this
                # tick — those models get no decision, the apply phase
                # holds their previous desired.
                tick.stale.append(shard)
                tick.uncovered.extend(sorted(owned))
                continue
            ages[shard] = age
            for gk, entry in cap.entries.items():
                tick.entries[gk] = entry
            for key, hs in cap.health.items():
                tick.health[key] = hs
            tick.trace.extend(cap.trace)
            tick.spans.extend(cap.spans)
            tick.plans.extend(cap.plans)
            tick.floors.extend(cap.floors)
            tick.raised += cap.floors_raised
            tick.analyzed += cap.analyzed
            tick.skipped += cap.skipped

        requested = getattr(getattr(collector, "source", None),
                            "requested", None)
        if requested is not None and self.last_worker_seconds:
            self._warm_names = requested()
        tick.moves = moves
        tick.holds_opened = holds_opened
        self._emit_gauges(owned_by_shard, ages, now)
        return tick

    # --- rebalance ramp (consumed by the engine's health gate) ---

    def hold_keys(self) -> set[str]:
        return set(self._holds)

    def release_hold(self, key: str) -> None:
        """The model's inputs proved fresh on its new owner — the hold
        ends early (the health ladder owns any later degradation)."""
        self._holds.pop(key, None)

    # --- chaos / lifecycle ---

    def kill_shard(self, shard: int, release_lease: bool = True) -> None:
        """Simulate the shard worker dying. ``release_lease`` selects a
        clean death (ownership moves within ~a retry period) vs a crash
        (the lease rides out its duration first)."""
        worker = self.workers.get(shard)
        if worker is not None:
            worker.dead = True
        if release_lease:
            self.leases.kill(shard)
        else:
            self.leases.sever(shard)

    def revive_shard(self, shard: int) -> None:
        worker = self.workers.get(shard)
        if worker is not None:
            worker.dead = False
        self.leases.revive(shard)

    def shutdown(self) -> None:
        self.leases.release_all()
        for worker in self.workers.values():
            worker.engine.close()

    # --- observability ---

    def _emit_gauges(self, owned_by_shard: dict, ages: dict,
                     now: float) -> None:
        if self.registry is None:
            return
        held = self.leases.held()
        for shard in range(self.leases.shards):
            labels = {LABEL_SHARD: str(shard)}
            self.registry.set_gauge(WVA_SHARD_OWNER, labels,
                                    1.0 if shard in held else 0.0)
            self.registry.set_gauge(
                WVA_SHARD_MODELS_OWNED, labels,
                float(len(owned_by_shard.get(shard, ()))))
            if shard in ages:
                self.registry.set_gauge(WVA_SHARD_SUMMARY_AGE_SECONDS,
                                        labels, round(ages[shard], 3))
        # The fleet shard is this engine itself: it is "held" exactly when
        # this code runs (the leader gate admitted the tick).
        self.registry.set_gauge(WVA_SHARD_OWNER,
                                {LABEL_SHARD: FLEET_SHARD_ID}, 1.0)
        self.registry.set_gauge(WVA_SHARD_REBALANCE_TOTAL, {},
                                float(self.rebalance_total))


def build_shard_plane(client, config, clock, collector, actuator,
                      prom_source, forecast_planner, analysis_workers: int,
                      identity: str, registry=None,
                      device=None) -> ShardPlane:
    """Wire the in-process shard plane: N worker engines sharing the
    process's client / metrics substrate / forecast planner, each with its
    own analyzers, fingerprint memos, enforcer, and health classification
    books — plus the shard-lease family. Called from ``build_manager``
    when ``WVA_SHARDING`` is on. ``device`` is where every worker engine
    sizes, fits and tunes (None: the CUDA card)."""
    from wva_tpu_torch.collector.registration.scale_to_zero import (
        collect_model_request_count,
    )
    from wva_tpu_torch.engines.saturation import SaturationEngine
    from wva_tpu_torch.pipeline import Enforcer

    shard_cfg = config.sharding_config()
    health_cfg = config.health_config()

    def make_worker(shard_id: int) -> ShardWorker:
        def request_count(model_id, namespace, retention, source=None):
            return collect_model_request_count(
                source or prom_source, model_id, namespace, retention)

        request_count.supports_source = True
        enforcer = Enforcer(request_count)

        health = None
        if health_cfg.enabled:
            from wva_tpu_torch.health import InputHealthMonitor

            health = InputHealthMonitor(
                degraded_after=health_cfg.degraded_after_seconds,
                freeze_after=health_cfg.freeze_after_seconds,
                recovery_ticks=health_cfg.recovery_ticks)

        engine = SaturationEngine(
            client=client, config=config, collector=collector,
            actuator=actuator, enforcer=enforcer, limiter=None,
            clock=clock, analysis_workers=analysis_workers,
            forecast_planner=forecast_planner, health=health,
            device=device)
        engine.grouped_collection = config.grouped_collection_enabled()
        engine.incremental_enabled = config.incremental_enabled()
        engine.resync_ticks = config.resync_ticks()
        engine.fp_delta_enabled = config.fp_delta_enabled()
        engine.fp_assert = config.fp_assert_enabled()
        # Each worker fuses its own partition's analyze phase into one
        # dispatch (the fleet role never sizes — workers ship results).
        engine.fused_enabled = config.fused_enabled()
        # ... and runs the vectorized decision stage over its own
        # partition (finalize columns + cost-aware fills + enforcer
        # grouping are per-partition row arithmetic).
        engine.vec_decide = config.vec_decide_enabled()
        engine.vec_assert = config.vec_assert_enabled()
        engine.solve_memo = config.solve_memo_enabled()
        return ShardWorker(shard_id, engine)

    workers = {i: make_worker(i) for i in range(shard_cfg.shards)}
    if shard_cfg.shards > 1:
        # The in-process plane drives workers strictly serially, so N
        # engines each lazily building a full-width ThreadPoolExecutor
        # would hold N*W threads with all but one pool idle at any
        # instant. Pre-wire ONE shared pool: behavior is identical (the
        # pool is only ever used by the currently-analyzing worker; the
        # affinity-chain ordering that makes results byte-identical is
        # per-call) at 1/N the thread and memory cost. Close() shutting
        # it N times is harmless (shutdown is idempotent).
        from concurrent.futures import ThreadPoolExecutor

        width = max(1, int(analysis_workers))
        if width > 1:
            shared_pool = ThreadPoolExecutor(
                max_workers=width, thread_name_prefix="wva-shard-analysis")
            for worker in workers.values():
                worker.engine._analysis_pool = shared_pool
    leases = ShardLeaseManager(client, identity=identity,
                               shards=shard_cfg.shards, clock=clock)
    return ShardPlane(
        leases=leases, workers=workers, registry=registry, clock=clock,
        rebalance_hold_ticks=shard_cfg.rebalance_hold_ticks,
        summary_stale_seconds=shard_cfg.summary_stale_seconds)
