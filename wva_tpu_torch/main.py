"""Process wiring (reference ``cmd/main.go:83-520``).

Assembles the full controller: config load (fail-fast), datastore with the
EPP pod-scraping source factory, Prometheus source + query registration,
engines as leader-gated runnables, reconcilers, health endpoints, metric
registration. ``Manager`` supports wall-clock threaded operation and
single-threaded simulated ticks (the emulation harness and bench drive
``run_once``).
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass

from wva_tpu_torch.actuator import Actuator, DirectActuator
from wva_tpu_torch.analyzers.saturation_v2 import CapacityKnowledgeStore
from wva_tpu_torch.blackbox import FlightRecorder
from wva_tpu_torch.collector.registration import (
    register_saturation_queries,
    register_scale_to_zero_queries,
    register_slo_queries,
)
from wva_tpu_torch.collector.registration.scale_to_zero import collect_model_request_count
from wva_tpu_torch.collector.replica_metrics import ReplicaMetricsCollector
from wva_tpu_torch.collector.source import (
    HTTPPromAPI,
    InMemoryPromAPI,
    PodScrapingSource,
    PodVAMapper,
    PrometheusSource,
    SourceRegistry,
    TimeSeriesDB,
    http_pod_fetcher,
)
from wva_tpu_torch.collector.source.registry import PROMETHEUS_SOURCE_NAME
from wva_tpu_torch.config import Config
from wva_tpu_torch.controller import (
    ConfigMapReconciler,
    InferencePoolReconciler,
    VariantAutoscalingReconciler,
)
from wva_tpu_torch.datastore import Datastore
from wva_tpu_torch.discovery import TPUSliceDiscovery
from wva_tpu_torch.engines.fastpath import FastPathMonitor
from wva_tpu_torch.engines.saturation import SaturationEngine
from wva_tpu_torch.engines.saturation.engine import DEFAULT_ANALYSIS_WORKERS
from wva_tpu_torch.engines.scalefromzero import ScaleFromZeroEngine
from wva_tpu_torch.indexers import Indexer
from wva_tpu_torch.k8s.client import KubeClient
from wva_tpu_torch.k8s.events import EventRecorder
from wva_tpu_torch.k8s.informer import InformerKubeClient
from wva_tpu_torch.leaderelection import LeaderElector, LeaderElectorConfig
from wva_tpu_torch.metrics import MetricsRegistry
from wva_tpu_torch.pipeline import (
    DefaultLimiter,
    Enforcer,
    GreedyBySaturation,
    SliceInventory,
)
from wva_tpu_torch.utils import freeze as frz
from wva_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock
from wva_tpu_torch.utils.gcpolicy import GcPolicy
from wva_tpu_torch.utils.variant import get_controller_instance

log = logging.getLogger(__name__)


@dataclass
class Manager:
    """Everything wired; the process object."""

    client: KubeClient
    config: Config
    clock: Clock
    registry: MetricsRegistry
    source_registry: SourceRegistry
    datastore: Datastore
    indexer: Indexer
    engine: SaturationEngine
    scale_from_zero: ScaleFromZeroEngine
    fastpath: FastPathMonitor
    va_reconciler: VariantAutoscalingReconciler
    configmap_reconciler: ConfigMapReconciler
    pool_reconciler: InferencePoolReconciler
    capacity_store: CapacityKnowledgeStore
    # Leader election (None = disabled -> always act as leader). Engines are
    # leader-gated; reconcilers and watches run on every replica (reference
    # cmd/main.go:378-425 leader-gated Runnables).
    elector: "LeaderElector | None" = None
    # Decision flight recorder (None = tracing disabled via config).
    flight_recorder: "FlightRecorder | None" = None
    # Obs-plane span recorder (None = WVA_SPANS off).
    spans: "object | None" = None
    # The engine's share of the collector policy (utils/gcpolicy.py).
    gc_policy: "GcPolicy | None" = None

    _threads: list[threading.Thread] = None
    _last_election_tick: float = -1e18

    # --- health endpoints (reference cmd/main.go:482-498) ---

    def healthz(self) -> bool:
        return True

    def readyz(self) -> bool:
        return self.config.configmaps_bootstrap_complete()

    # --- lifecycle ---

    def setup(self) -> "Manager":
        self.indexer.setup()
        self.configmap_reconciler.bootstrap_initial_configmaps()
        self.configmap_reconciler.setup()
        self.pool_reconciler.setup()
        self.va_reconciler.setup()
        return self

    def start(self, stop: threading.Event) -> None:
        """Wall-clock mode: engines + trigger loop in daemon threads."""
        # Event-driven wake-ups (wall-clock mode ONLY — simulation drivers
        # using run_once stay tick-deterministic): material watch events on
        # VAs/Deployments/Pods end the engines' inter-tick waits
        # immediately, so a spec edit or a scale-from-zero-relevant change
        # is acted on in watch latency instead of up to a full poll
        # interval. Triggers are idempotent; event bursts collapse into one
        # immediate tick.
        if hasattr(self.client, "add_nudge_listener"):
            def _nudge(kind: str, event: str, obj) -> None:
                self.engine.executor.trigger()
                if kind in ("VariantAutoscaling", "Deployment",
                            "LeaderWorkerSet"):
                    self.scale_from_zero.executor.trigger()
            self.client.add_nudge_listener(_nudge)
        # Background cache warmer (fetch_interval > 0): keeps the
        # Prometheus result cache hot between engine ticks.
        prom = self.source_registry.get(PROMETHEUS_SOURCE_NAME)
        if prom is not None and hasattr(prom, "start_background_fetch"):
            prom.start_background_fetch(stop)
        self._threads = [
            threading.Thread(target=self.engine.start_optimize_loop, args=(stop,),
                             name="saturation-engine", daemon=True),
            threading.Thread(target=self.scale_from_zero.start_loop, args=(stop,),
                             name="scale-from-zero", daemon=True),
            threading.Thread(target=self.fastpath.start_loop, args=(stop,),
                             name="fast-path", daemon=True),
            threading.Thread(target=self.va_reconciler.run_trigger_loop, args=(stop,),
                             name="va-trigger-loop", daemon=True),
        ]
        if self.elector is not None:
            def election_loop():
                while not stop.is_set():
                    try:
                        self.elector.tick()
                    except Exception:  # noqa: BLE001 — election must outlive
                        # transient client errors; a dead election thread
                        # would silently demote this replica forever.
                        logging.getLogger(__name__).exception(
                            "leader-election tick failed; retrying")
                    stop.wait(self.elector.config.retry_period)
                self.elector.release()
            self._threads.append(threading.Thread(
                target=election_loop, name="leader-election", daemon=True))
        for t in self._threads:
            t.start()

    def is_leader(self) -> bool:
        return self.elector is None or self.elector.is_leader()

    def election_tick(self) -> bool:
        """One leader-election acquire/renew step, throttled to the elector's
        retry_period so a fast simulation cadence doesn't multiply lease
        traffic (no-op when disabled)."""
        if self.elector is None:
            return True
        now = self.clock.now()
        if now - self._last_election_tick < self.elector.config.retry_period \
                and self._last_election_tick > -1e17:
            return self.elector.is_leader()
        self._last_election_tick = now
        return self.elector.tick()

    def run_once(self) -> None:
        """Simulation mode: one saturation tick + one scale-from-zero tick +
        drain reconcile triggers (single-threaded, deterministic)."""
        self.election_tick()
        if self.is_leader():
            self.engine.executor.tick()
            self.scale_from_zero.executor.tick()
            self.fastpath.executor.tick()
            # The engine tick above ran BEFORE the fast-path scan: a backlog
            # it just detected would otherwise wait a whole cycle, defeating
            # the fast path in combined-tick drivers.
            if self.engine.executor.consume_trigger():
                self.engine.executor.tick()
        self.va_reconciler.drain_triggers()

    def scale_from_zero_tick(self) -> None:
        if self.is_leader():
            self.scale_from_zero.executor.tick()
        self.va_reconciler.drain_triggers()

    def fast_path_tick(self) -> bool:
        """One fast-path monitoring pass; returns True when an immediate
        saturation tick was requested (simulation drivers run the engine
        tick themselves — see EmulationHarness.run)."""
        if not self.is_leader():
            return False
        self.fastpath.executor.tick()
        return self.engine.executor.consume_trigger()

    def shutdown(self) -> None:
        """Voluntary leader step-down on exit (ReleaseOnCancel semantics);
        flush the decision trace so the last cycle is never lost; release
        the persistent worker pools (engine analysis, Prometheus queries)."""
        if self.elector is not None:
            self.elector.release()
        if self.flight_recorder is not None:
            self.flight_recorder.close()
        if self.spans is not None:
            self.spans.close()
        if self.engine.shard_plane is not None:
            # Voluntary shard-lease step-down + worker pool release: a
            # clean shutdown hands every shard to a successor in ~one
            # retry period instead of a lease timeout.
            self.engine.shard_plane.shutdown()
        self.engine.close()
        if self.gc_policy is not None:
            self.gc_policy.release()
        prom = self.source_registry.get(PROMETHEUS_SOURCE_NAME)
        if prom is not None and hasattr(prom, "close"):
            prom.close()


def build_manager(
    client: KubeClient,
    config: Config,
    clock: Clock | None = None,
    tsdb: TimeSeriesDB | None = None,
    pod_fetcher=None,
    mirror_wva_metrics: bool = True,
    slice_provisioner=None,
    prom_api=None,
    device=None,
) -> Manager:
    """Wire the full controller (reference cmd/main.go).

    ``tsdb`` selects the in-memory Prometheus backend (emulation/bench);
    when None, an HTTP backend against ``config.prometheus_base_url()`` is
    used. ``pod_fetcher`` overrides EPP pod scraping (in-process harness);
    defaults to HTTP. ``slice_provisioner`` backs the elastic capacity
    plane (WVA_CAPACITY): the emulation harness injects a
    FakeGkeProvisioner; None leaves the NullProvisioner, which plans
    strictly within discovered inventory. ``prom_api`` overrides the
    metrics backend entirely (the chaos harness wraps the in-memory API
    with a fault injector); None derives it from ``tsdb``/config.
    ``device`` is where the engine's sizing, fits and tuner run (None:
    the CUDA card).
    """
    clock = clock or SYSTEM_CLOCK

    # Zero-copy object plane (WVA_ZERO_COPY, default on;
    # docs/design/object-plane.md): store reads across the stack return
    # frozen shared objects. Process-global — the lever gates read-path
    # behavior of every store built below.
    frz.set_zero_copy(config.zero_copy_enabled())

    # Watch-backed informer cache (WVA_INFORMER, default on;
    # docs/design/informer.md): every per-kind LIST the control plane makes
    # per tick is served from a watch-fed store instead — steady-state
    # ticks issue ZERO list requests against the apiserver. Everything
    # below (engines, reconcilers, indexer) reads through the same wrapped
    # client; targeted GETs and all writes still hit the live client (and
    # write through to the store).
    if config.informer_enabled():
        client = InformerKubeClient(
            client, namespace=config.watch_namespace() or None,
            clock=clock).start()

    registry = MetricsRegistry(
        controller_instance=get_controller_instance(),
        # Mirror wva_* gauges into the TSDB so the emulated HPA loop can
        # read them exactly as Prometheus Adapter would.
        mirror_tsdb=tsdb if mirror_wva_metrics else None,
    )

    if prom_api is None:
        if tsdb is not None:
            prom_api = InMemoryPromAPI(tsdb)
        else:
            prom_api = HTTPPromAPI.from_config(config.prometheus())
    source_registry = SourceRegistry()
    prom_source = PrometheusSource(prom_api, config.prometheus_cache_config(),
                                   clock=clock)
    source_registry.register(PROMETHEUS_SOURCE_NAME, prom_source)
    register_saturation_queries(source_registry)
    register_scale_to_zero_queries(source_registry)
    register_slo_queries(source_registry)

    def pod_source_factory(pool):
        fetcher = pod_fetcher or http_pod_fetcher(
            pool.endpoint_picker.metrics_port_number,
            bearer_token=config.epp_metric_reader_bearer_token())
        return PodScrapingSource(
            client, pool.endpoint_picker.service_name,
            pool.endpoint_picker.namespace, fetcher, clock=clock)

    datastore = Datastore(source_registry=source_registry,
                          source_factory=pod_source_factory)
    indexer = Indexer(client)
    mapper = PodVAMapper(client, indexer)
    cache_cfg = config.prometheus_cache_config()
    collector = ReplicaMetricsCollector(
        prom_source, mapper, clock=clock,
        freshness=cache_cfg.freshness if cache_cfg else None)

    actuator = Actuator(client, registry)
    direct_actuator = DirectActuator(client)

    def request_count(model_id, namespace, retention, source=None):
        # ``source`` is the engine's tick-scoped GroupedMetricsView when
        # grouped collection is on (one fleet-wide request-count query per
        # tick instead of one per model); the raw source otherwise.
        return collect_model_request_count(
            source or prom_source, model_id, namespace, retention)

    request_count.supports_source = True
    enforcer = Enforcer(request_count)

    discovery = TPUSliceDiscovery(client)
    inventory = SliceInventory(discovery)
    limiter = DefaultLimiter("tpu-slice-limiter", inventory,
                             GreedyBySaturation(), clock=clock)

    # Decision flight recorder (config-gated): the executor opens one cycle
    # record per engine tick and every pipeline stage appends its part.
    trace_cfg = config.trace_config()
    flight = None
    if trace_cfg.enabled:
        flight = FlightRecorder(
            clock=clock, ring_size=trace_cfg.ring_size,
            spill_path=trace_cfg.path or None, registry=registry)
        enforcer.flight_recorder = flight
        limiter.flight_recorder = flight

    capacity_store = CapacityKnowledgeStore(clock=clock)
    recorder = EventRecorder(client, clock=clock)
    # Predictive capacity planner (WVA_FORECAST, default on): demand
    # history + measured lead times -> proactive replica floors and
    # scale-from-zero pre-wakes (docs/design/forecast.md). Disabled,
    # decisions are byte-identical to pre-forecast builds.
    forecast_planner = None
    fc_cfg = config.forecast_config()
    if fc_cfg.enabled:
        from wva_tpu_torch.forecast import CapacityPlanner

        forecast_planner = CapacityPlanner(
            seasonal_period_seconds=fc_cfg.seasonal_period_seconds,
            grid_step_seconds=fc_cfg.grid_step_seconds,
            default_lead_time_seconds=fc_cfg.default_lead_time_seconds,
            lead_time_quantile=fc_cfg.lead_time_quantile,
            target_utilization=fc_cfg.target_utilization,
            demote_error_threshold=fc_cfg.demote_error_threshold,
            min_trust_evals=fc_cfg.min_trust_evals,
            prewake_enabled=fc_cfg.prewake_enabled,
            prewake_min_demand=fc_cfg.prewake_min_demand,
            device=device)
    # Elastic capacity plane (WVA_CAPACITY, default on): ledger +
    # provisioner between discovery and the solver — pools become
    # ready + provisioning-arriving-within-lead-time, preemptions release
    # chips the same tick, quota stockouts circuit-break per (variant,
    # tier) (docs/design/capacity.md). Disabled, inventory is static and
    # decisions are byte-identical to pre-capacity builds.
    capacity = None
    cap_cfg = config.capacity_config()
    if cap_cfg.enabled:
        from wva_tpu_torch.capacity import CapacityManager, NullProvisioner
        from wva_tpu_torch.forecast.leadtime import LeadTimeEstimator

        # Share the forecast planner's lead-time estimator when
        # forecasting is on: both planes learn from the same measured
        # actuation->scheduled->ready episodes.
        leadtime = (forecast_planner.leadtime
                    if forecast_planner is not None
                    else LeadTimeEstimator(
                        default_seconds=cap_cfg
                        .default_provision_lead_seconds))
        # Per-region tier weight override (wva_tpu_torch/federation): a
        # federated region prices its OWN pools with its region's weights
        # so one region's spot discount (the per-process
        # WVA_CAPACITY_TIER_WEIGHTS) never distorts another region's
        # arbitrage (tests/test_federation.py).
        fed_cfg = config.federation_config()
        tier_weights = cap_cfg.tier_cost_weights
        if fed_cfg.enabled and fed_cfg.region:
            tier_weights = fed_cfg.region_tier_weights.get(
                fed_cfg.region, tier_weights)
        capacity = CapacityManager(
            discovery, slice_provisioner or NullProvisioner(),
            leadtime=leadtime,
            tier_preference=cap_cfg.tier_preference,
            tier_weights=tier_weights,
            stockout_reprobe_seconds=cap_cfg.stockout_reprobe_seconds,
            default_lead_seconds=cap_cfg.default_provision_lead_seconds,
            clock=clock)
        inventory.capacity = capacity
        # Node watch -> ledger: a deleted / NotReady / cordoned host marks
        # its slice lost the instant the event lands (the informer's nudge
        # then forces the immediate re-solve in wall-clock mode). Without
        # an informer, a raw watch registration serves the same feed.
        if hasattr(client, "add_nudge_listener"):
            def _capacity_node_feed(kind: str, event: str, obj) -> None:
                if kind == "Node":
                    capacity.on_node_event(event, obj)
            client.add_nudge_listener(_capacity_node_feed)
        else:
            client.watch("Node", capacity.on_node_event)

    # Input-health plane (WVA_HEALTH, default on): per-model trust ladder
    # over collector slice ages, scrape coverage, and control-plane
    # staleness, with a do-no-harm gate on final decisions — hold
    # last-known-good under degradation, freeze under blackout, K-tick
    # hysteresis before scale-downs resume (docs/design/health.md).
    # Disabled, decisions/statuses/traces are byte-identical to pre-health
    # builds in a fault-free world.
    health = None
    health_cfg = config.health_config()
    if health_cfg.enabled:
        from wva_tpu_torch.health import InputHealthMonitor

        health = InputHealthMonitor(
            degraded_after=health_cfg.degraded_after_seconds,
            freeze_after=health_cfg.freeze_after_seconds,
            recovery_ticks=health_cfg.recovery_ticks)

    # Crash-restart resilience plane (WVA_RESILIENCE, default on): on
    # boot, re-seed health last-known-goods from durable VA status and
    # rehydrate capacity/forecast/lead-time soft state from the
    # rv-guarded checkpoint ConfigMap (WVA_CHECKPOINT); run every model
    # through a do-no-harm boot ramp (WVA_STARTUP_HOLD_TICKS) until its
    # inputs prove fresh; fence the apply phase with the lease epoch
    # (docs/design/resilience.md). Disabled, boots are blind (pre-change
    # behavior) and decisions/statuses/traces are byte-identical in a
    # fault-free world.
    boot_ramp = checkpointer = boot_report = None
    res_cfg = config.resilience_config()
    if res_cfg.enabled:
        from wva_tpu_torch.config.helpers import system_namespace
        from wva_tpu_torch.resilience import BootRamp, CheckpointStore, warm_start

        if res_cfg.checkpoint_enabled:
            checkpointer = CheckpointStore(
                client, namespace=system_namespace(),
                interval_ticks=res_cfg.checkpoint_interval_ticks,
                clock=clock)
        boot_report = warm_start(
            client, config.watch_namespace() or None, clock.now(),
            health=health, capacity=capacity, forecast=forecast_planner,
            store=checkpointer)
        if health is not None:
            # The ramp rides the health gate; without the health plane it
            # has no clamp path and stays inert.
            boot_ramp = BootRamp(res_cfg.startup_hold_ticks)

    # Analysis pool width 0 = auto, resolved by the metrics backend (same
    # rule as PrometheusSource's query concurrency): per-model collection
    # against HTTP Prometheus is I/O-bound and overlaps across workers; the
    # in-memory backend is pure Python, where extra threads only pay GIL
    # tax — and simulation/bench drivers stay single-threaded-deterministic.
    workers = config.engine_analysis_workers()
    if workers == 0:
        workers = 1 if tsdb is not None else DEFAULT_ANALYSIS_WORKERS
    engine = SaturationEngine(
        client=client, config=config, collector=collector, actuator=actuator,
        enforcer=enforcer, limiter=limiter, capacity_store=capacity_store,
        clock=clock, poll_interval=min(config.optimization_interval() / 2, 30.0),
        direct_actuator=direct_actuator, recorder=recorder,
        flight_recorder=flight,
        analysis_workers=workers,
        forecast_planner=forecast_planner,
        capacity=capacity,
        health=health,
        boot_ramp=boot_ramp,
        checkpointer=checkpointer,
        device=device)
    engine.boot_report = boot_report
    engine.grouped_collection = config.grouped_collection_enabled()
    engine.incremental_enabled = config.incremental_enabled()
    engine.resync_ticks = config.resync_ticks()
    engine.fp_delta_enabled = config.fp_delta_enabled()
    engine.fp_assert = config.fp_assert_enabled()
    # One-jitted-program decision plane (WVA_FUSED, default on;
    # docs/design/fused-plane.md): one device dispatch per SLO tick, and
    # the limiter's grant pass flips to the equivalent masked arithmetic.
    engine.fused_enabled = config.fused_enabled()
    if hasattr(limiter, "algorithm") and hasattr(limiter.algorithm,
                                                 "vectorized"):
        limiter.algorithm.vectorized = config.fused_enabled()
    # Vectorized decision stage (WVA_VEC_DECIDE, default on;
    # docs/design/fused-plane.md §host-vectorization): finalize/optimize/
    # enforce as fleet-wide row arithmetic instead of per-model loops.
    engine.vec_decide = config.vec_decide_enabled()
    engine.vec_assert = config.vec_assert_enabled()
    engine.solve_memo = config.solve_memo_enabled()
    # Sharded active-active engine (WVA_SHARDING, default off;
    # docs/design/sharding.md): N shard workers — each the existing
    # snapshot+analysis stack scoped to a consistent-hash partition under
    # its own Lease — publish per-shard summaries; THIS engine becomes the
    # fleet role (merge, fleet-level solve, limiter/health/apply). The
    # distinguished `fleet` shard rides the leader-election lease below.
    if config.sharding_enabled():
        from wva_tpu_torch.shard import build_shard_plane

        engine.shard_plane = build_shard_plane(
            client=client, config=config, clock=clock, collector=collector,
            actuator=actuator, prom_source=prom_source,
            forecast_planner=forecast_planner, analysis_workers=workers,
            identity=f"{os.uname().nodename}-{os.getpid()}",
            registry=registry, device=device)
    # Multi-cluster federation plane (WVA_FEDERATION, default on;
    # docs/design/federation.md): constructed only when this cluster
    # names its region — capture export + arbiter election over the
    # ConfigMap bus on the hub cluster this kubeconfig points at. The
    # single-cluster default builds nothing and stays byte-identical to
    # pre-federation builds.
    if config.federation_enabled() and config.federation_config().region:
        from wva_tpu_torch.federation import build_federation_plane

        engine.federation = build_federation_plane(
            client, config, clock=clock, registry=registry,
            identity=f"{os.uname().nodename}-{os.getpid()}")
    if flight is not None:
        engine.optimizer.flight_recorder = flight
    scale_from_zero = ScaleFromZeroEngine(client, config, datastore,
                                          direct_actuator, clock=clock,
                                          recorder=recorder,
                                          forecast_planner=forecast_planner)
    fastpath = FastPathMonitor(
        client, config, datastore, engine.executor,
        prom_source=prom_source, slo_analyzer=engine.slo_analyzer,
        clock=clock, forecast_planner=forecast_planner)
    # Self-observability: every engine loop reports its tick duration and
    # success/error outcome on /metrics (controller-runtime reconcile
    # metrics equivalent).
    for ex in (engine.executor, scale_from_zero.executor, fastpath.executor):
        ex.on_tick = registry.observe_tick
        # A tick longer than its poll interval means the loop is falling
        # behind its own cadence — surfaced as wva_tick_overruns_total.
        ex.on_overrun = registry.observe_tick_overrun
    # The collector policy (utils/gcpolicy.py): after each engine tick it
    # reads what the tick cost the interpreter's collector and, at fleet
    # width, freezes the standing heap and sizes the young generation to
    # the tick. The observer runs inside the executor's tick.
    gc_policy = GcPolicy()
    engine.gc_policy = gc_policy
    engine.executor.on_tick = gc_policy.observe(engine.executor.on_tick)

    # Obs plane (WVA_SPANS, default on; docs/design/observability.md):
    # span-structured tick tracing with a slow-tick flight recorder and
    # optional OTLP export. Strictly out-of-band — statuses, traces, and
    # goldens are byte-identical with the lever off OR on; off builds no
    # recorder at all (the off-lever is zero-cost, asserted by
    # `make bench-spans`).
    spans = None
    obs_cfg = config.obs_config()
    if obs_cfg.spans:
        from wva_tpu_torch.obs import SpanRecorder

        spans = SpanRecorder(
            clock=clock, ring_size=obs_cfg.spans_ring,
            spill_path=obs_cfg.spans_path or None,
            slow_tick_ms=obs_cfg.slow_tick_ms,
            slow_dump_dir=obs_cfg.slow_dump_dir,
            otlp_endpoint=obs_cfg.otlp_endpoint,
            registry=registry, engine=engine.executor.name)
        engine.spans = spans
        if capacity is not None:
            capacity.spans = spans
        # Slow-tick flight recorder rides the overrun hook: a tick that
        # outran its poll interval dumps the span tree that explains it.
        def _engine_overrun(name: str,
                            _observe=registry.observe_tick_overrun,
                            _spans=spans) -> None:
            _observe(name)
            _spans.note_overrun(name)

        engine.executor.on_overrun = _engine_overrun

    watch_ns = config.watch_namespace() or ""
    va_reconciler = VariantAutoscalingReconciler(client, datastore, indexer,
                                                 clock=clock, recorder=recorder,
                                                 watch_namespace=watch_ns,
                                                 flight_recorder=flight)
    configmap_reconciler = ConfigMapReconciler(client, config, datastore,
                                               recorder=recorder)
    pool_reconciler = InferencePoolReconciler(client, datastore,
                                              watch_namespace=watch_ns)

    elector = None
    if config.leader_election_enabled():
        elector = LeaderElector(
            client, identity=f"{os.uname().nodename}-{os.getpid()}",
            config=LeaderElectorConfig(lease_name=config.leader_election_id()),
            clock=clock)
        # Engines only act while leading (reference cmd/main.go:378-425).
        engine.executor.gate = elector.is_leader
        scale_from_zero.executor.gate = elector.is_leader
        fastpath.executor.gate = elector.is_leader
        # A demoted manager must stop EVERY write path, not just the
        # engine tick: the scale-from-zero wake re-checks leadership
        # immediately before actuating (its worker pool can outlive a
        # mid-tick demotion), and the reconciler's decision-trigger drain
        # is leader-gated (DecisionCache entries from the leadership era
        # must not be flushed by a standby). See the non-leader-never-
        # writes regression in tests/test_resilience.py.
        scale_from_zero.write_gate = elector.is_leader
        va_reconciler.gate = elector.is_leader
        if res_cfg.enabled:
            # Lease-epoch fencing through the apply phase: captured at
            # tick start, re-checked between analyze and apply — a
            # deposed leader mid-tick can never actuate
            # (docs/design/resilience.md).
            engine.fence = elector.fencing_token

    return Manager(
        client=client, config=config, clock=clock, registry=registry,
        source_registry=source_registry, datastore=datastore, indexer=indexer,
        engine=engine, scale_from_zero=scale_from_zero, fastpath=fastpath,
        va_reconciler=va_reconciler, configmap_reconciler=configmap_reconciler,
        pool_reconciler=pool_reconciler, capacity_store=capacity_store,
        elector=elector, flight_recorder=flight, spans=spans,
        gc_policy=gc_policy,
    )
