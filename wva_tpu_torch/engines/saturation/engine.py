"""The main optimization loop
(reference ``internal/engines/saturation/{engine,engine_v2}.go``).

Per tick: list active VAs -> group by model -> per-model data preparation
(deployments, costs, live metrics, variant states with pending replicas and
chips-per-replica from pod TPU requests) -> V1 or V2 analysis path (selected
by ``analyzerName`` in the default saturation config) -> enforcer -> (V1,
optional) slice limiter -> apply: update VA status + conditions, emit
``wva_*`` gauges, publish to DecisionCache, fire DecisionTrigger.

Failure safety net: when analysis fails for a model, previous-desired or
current replicas are still emitted so the external HPA never starves
(reference engine.go:1022-1095).
"""

from __future__ import annotations

import logging
import math
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

from wva_tpu_torch.actuator import Actuator
from wva_tpu_torch.analyzers.queueing import QueueingModelAnalyzer
from wva_tpu_torch.analyzers.queueing.tuner import TunerController, TunerEnvironment
from wva_tpu_torch.analyzers.saturation import SaturationAnalyzer
from wva_tpu_torch.analyzers.saturation_v2 import (
    CapacityKnowledgeStore,
    SaturationV2Analyzer,
)
from wva_tpu_torch.collector.registration.saturation import (
    QUERY_AVG_INPUT_TOKENS,
    QUERY_AVG_OUTPUT_TOKENS,
    QUERY_CACHE_CONFIG_INFO,
    QUERY_GENERATE_BACKLOG,
    QUERY_KV_CACHE_USAGE,
    QUERY_PREFIX_CACHE_HIT_RATE,
    QUERY_QUEUE_LENGTH,
    QUERY_SCHEDULER_QUEUE_BYTES,
    QUERY_SCHEDULER_QUEUE_SIZE,
    QUERY_SERVING_CONFIG_INFO,
    QUERY_SLOTS_AVAILABLE,
    QUERY_SLOTS_USED,
)
from wva_tpu_torch.collector.registration.scale_to_zero import (
    PARAM_RETENTION_PERIOD,
    QUERY_MODEL_REQUEST_COUNT,
)
from wva_tpu_torch.collector.registration.slo import (
    QUERY_ARRIVAL_RATE,
    QUERY_ARRIVAL_RATE_FAST,
    QUERY_AVG_ITL,
    QUERY_AVG_TTFT,
    collect_accelerator_telemetry,
    collect_optimizer_metrics,
)
from wva_tpu_torch.collector.source.promql import format_promql_duration
from wva_tpu_torch.collector.source.source import PARAM_MODEL_ID, PARAM_NAMESPACE
from wva_tpu_torch.config.scale_to_zero import (
    is_scale_to_zero_enabled,
    scale_to_zero_retention_seconds,
)
from wva_tpu_torch.api.v1alpha1 import (
    HEALTH_CONDITIONS,
    OptimizedAlloc,
    REASON_OPTIMIZATION_SUCCEEDED,
    TYPE_INPUTS_HEALTHY,
    TYPE_OPTIMIZATION_READY,
    REASON_METRICS_FOUND,
    REASON_METRICS_MISSING,
    VariantAutoscaling,
)
from wva_tpu_torch.blackbox.schema import (
    STAGE_BOOT,
    STAGE_CAPACITY,
    STAGE_FEDERATION,
    STAGE_FINGERPRINT_SKIP,
    STAGE_FORECAST,
    STAGE_HEALTH,
    STAGE_SHARD,
)
from wva_tpu_torch.federation.apply import apply_federation_directives
from wva_tpu_torch.obs import logjson
from wva_tpu_torch.resilience import LeadershipLostError, SimulatedCrash
from wva_tpu_torch.health import BLACKOUT, FRESH, HEALTH_STATES, InputHealth
from wva_tpu_torch.health.apply import apply_health_clamps
from wva_tpu_torch.collector.replica_metrics import ReplicaMetricsCollector
from wva_tpu_torch.collector.source.grouped import GroupedMetricsView
from wva_tpu_torch.config import Config
from wva_tpu_torch.constants import (
    LABEL_ACCELERATOR_TYPE,
    LABEL_FORECASTER,
    LABEL_KIND,
    LABEL_MODEL_NAME,
    LABEL_NAMESPACE,
    LABEL_OUTCOME,
    LABEL_STATE,
    LABEL_TIER,
    TPU_RESOURCE_NAME,
    WVA_CAPACITY_CHIPS_EFFECTIVE,
    WVA_CAPACITY_PREEMPTED_TOTAL,
    WVA_CAPACITY_PROVISION_LEAD_SECONDS,
    WVA_CAPACITY_PROVISION_TOTAL,
    WVA_CAPACITY_SLICES,
    WVA_CAPACITY_STOCKED_OUT,
    WVA_FORECAST_DEMAND,
    WVA_FORECAST_DEMOTED,
    WVA_FORECAST_ERROR,
    WVA_FORECAST_LEAD_TIME_SECONDS,
    LABEL_PHASE,
    LABEL_SOURCE,
    WVA_BOOT_RAMP_MODELS_HELD,
    WVA_BOOT_RECOVERED_ITEMS,
    WVA_CHECKPOINT_LAST_SAVE_TIMESTAMP,
    WVA_CHECKPOINT_WRITES,
    WVA_INFORMER_AGE_SECONDS,
    WVA_INFORMER_SYNCED,
    WVA_INPUT_HEALTH,
    WVA_LEADER_EPOCH,
    WVA_TICK_MODELS_ANALYZED,
    WVA_TICK_MODELS_SKIPPED,
    WVA_TICK_OBJECT_COPIES,
    WVA_TICK_PHASE_SECONDS,
    WVA_TREND_SERIES_SAMPLES,
    WVA_TREND_SERIES_STALENESS_SECONDS,
)
from wva_tpu_torch.engines import common
from wva_tpu_torch.forecast import apply_forecast_floors
from wva_tpu_torch.forecast.forecasters import FORECASTERS
from wva_tpu_torch.engines.executor import PollingExecutor
from wva_tpu_torch.interfaces import (
    ACTION_NO_CHANGE,
    ACTION_SCALE_DOWN,
    ACTION_SCALE_UP,
    AnalyzerInput,
    ReplicaMetrics,
    SaturationScalingConfig,
    VariantDecision,
    VariantReplicaState,
)
from wva_tpu_torch.interfaces.saturation_config import SLO_ANALYZER_NAME, V2_ANALYZER_NAME
from wva_tpu_torch.k8s.client import KubeClient, NotFoundError
from wva_tpu_torch.k8s.objects import Deployment, clone, labels_match, parse_quantity
from wva_tpu_torch.k8s.snapshot import DEFAULT_SNAPSHOT_KINDS, SnapshotKubeClient
from wva_tpu_torch.utils import freeze as frz
from wva_tpu_torch.pipeline import (
    CostAwareOptimizer,
    Enforcer,
    Limiter,
    ModelScalingRequest,
    SCALE_TO_ZERO_REASON,
    ScalingOptimizer,
    bridge_enforce,
    saturation_targets_to_decisions,
)
from wva_tpu_torch.pipeline import vectorized
from wva_tpu_torch.utils import scale_target
from wva_tpu_torch.utils import variant as variant_utils
from wva_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock
from wva_tpu_torch.utils.variant import namespaced_key

log = logging.getLogger(__name__)

DEFAULT_ENGINE_POLL_INTERVAL = 30.0  # reference engine.go:147
# Max age of a VA's status ``lastRunTime`` before the engine refreshes it
# even when nothing material changed. Status writes are otherwise
# change-driven (the reference only patches via the event-driven
# reconciler); without this bound a quiet model's lastRunTime would go
# stale forever, hiding a live engine from operators.
STATUS_HEARTBEAT_SECONDS = 60.0
# Make-before-break migrations: max time a losing variant may hold its
# replicas waiting for the winner's slices to become ready (TPU node-pool
# provisioning upper bound) before forced gradual drain.
MIGRATION_HOLD_TIMEOUT = 600.0
# Bounded worker pool for per-model prepare->analyze (ENGINE_ANALYSIS_WORKERS
# config knob). 1 = fully serial (the pre-change loop shape); results are
# always merged in sorted model-key order, so decisions, status writes, and
# flight-recorder records are byte-identical at any pool width.
DEFAULT_ANALYSIS_WORKERS = 8
# Below this many active VAs the tick snapshot fetches scale targets with
# memoized targeted GETs instead of one LIST per kind: on a shared cluster
# WVA may track a handful of VAs among thousands of foreign Deployments,
# and LISTing the whole kind each tick would cost more than a few GETs
# (still one request per target per tick — the memo absorbs the 3-5 reads
# each target gets per tick). VariantAutoscalings are always LISTed (they
# are all ours).
SNAPSHOT_LIST_MIN_VAS = 8
# Dirty-set incremental ticks (WVA_RESYNC_TICKS): every Nth tick analyzes
# every model regardless of fingerprints, bounding staleness from inputs
# the fingerprint cannot see (enforcer retention windows sliding with time,
# analyzer-internal state like trend windows and tuner filters).
DEFAULT_RESYNC_TICKS = 12
# Query templates whose demuxed per-model slices form the metrics component
# of the input fingerprint: the full replica-metrics set the analyzers
# consume, plus the scheduler flow-control backlog pair. All are served
# from this tick's memoized fleet-wide grouped executions, so
# fingerprinting adds zero backend queries.
FINGERPRINT_QUERIES = (
    QUERY_KV_CACHE_USAGE,
    QUERY_QUEUE_LENGTH,
    QUERY_CACHE_CONFIG_INFO,
    QUERY_SERVING_CONFIG_INFO,
    QUERY_AVG_OUTPUT_TOKENS,
    QUERY_AVG_INPUT_TOKENS,
    QUERY_PREFIX_CACHE_HIT_RATE,
    QUERY_GENERATE_BACKLOG,
    QUERY_SLOTS_USED,
    QUERY_SLOTS_AVAILABLE,
)
# V2/SLO analyzers additionally consume the scheduler flow-control backlog;
# the SLO analyzer also consumes the windowed demand/latency telemetry —
# rates DECAY after traffic stops while the gauges above freeze at their
# idle values, so without these the post-burst scale-down would wait for
# the periodic resync (the V1 percentage analyzer reads none of them).
FINGERPRINT_QUERIES_V2 = FINGERPRINT_QUERIES + (
    QUERY_SCHEDULER_QUEUE_SIZE,
    QUERY_SCHEDULER_QUEUE_BYTES,
)
FINGERPRINT_QUERIES_SLO = FINGERPRINT_QUERIES_V2 + (
    QUERY_ARRIVAL_RATE,
    QUERY_ARRIVAL_RATE_FAST,
    QUERY_AVG_TTFT,
    QUERY_AVG_ITL,
)

# Load-bearing queries whose cached-slice age classifies a model's metrics
# freshness for the input-health plane: the pair whose failure aborts
# collection (KV usage + queue length) — if THESE are old, every decision
# quantity is old. A healthy tick re-caches them (grouped demux or
# per-model refresh); stale-serve during an outage does not, so the cache
# age is exactly "how old is the data we are deciding on".
HEALTH_AGE_QUERIES = (QUERY_KV_CACHE_USAGE, QUERY_QUEUE_LENGTH)

METRICS_REASON_AVAILABLE = REASON_METRICS_FOUND
METRICS_REASON_UNAVAILABLE = REASON_METRICS_MISSING
METRICS_MESSAGE_AVAILABLE = "Saturation metrics data is available for scaling decisions"
METRICS_MESSAGE_UNAVAILABLE = (
    "No saturation metrics available - pods may not be ready or metrics not yet scraped")


_status_material = variant_utils.va_status_material


def _conditions_material_with(va, *upserts: tuple[str, str, str, str],
                              drop: tuple[str, ...] = ()) -> tuple:
    """The conditions slice of ``va_status_material`` AS IF
    ``va.set_condition(ctype, status, reason, message)`` had run for each
    upsert in order — upsert-in-place, append-if-absent — and any ``drop``
    types had been removed, computed without mutating the (frozen,
    store-shared) object. Lets the writer skip both the status PUT and
    the copy-on-write clone when nothing material would change."""
    gen = va.metadata.generation
    by_type = {u[0]: u for u in upserts}
    out = []
    for c in va.status.conditions:
        if c.type in drop:
            continue
        u = by_type.pop(c.type, None)
        if u is not None:
            out.append((u[0], u[1], u[2], u[3], gen))
        else:
            out.append((c.type, c.status, c.reason, c.message,
                        c.observed_generation))
    for u in upserts:
        if u[0] in by_type:  # not present on the object: appended in order
            out.append((u[0], u[1], u[2], u[3], gen))
    return tuple(out)


@dataclass
class _ModelData:
    """Pre-processed per-model inputs shared by V1/V2 (reference engine.go:662-672)."""

    model_id: str = ""
    namespace: str = ""
    replica_metrics: list[ReplicaMetrics] = field(default_factory=list)
    deployments: dict[str, Deployment] = field(default_factory=dict)
    variant_autoscalings: dict[str, VariantAutoscaling] = field(default_factory=dict)
    variant_costs: dict[str, float] = field(default_factory=dict)
    variant_states: list[VariantReplicaState] = field(default_factory=list)


class SaturationEngine:
    def __init__(
        self,
        client: KubeClient,
        config: Config,
        collector: ReplicaMetricsCollector,
        actuator: Actuator,
        enforcer: Enforcer,
        limiter: Limiter | None = None,
        optimizer: ScalingOptimizer | None = None,
        capacity_store: CapacityKnowledgeStore | None = None,
        clock: Clock | None = None,
        poll_interval: float = DEFAULT_ENGINE_POLL_INTERVAL,
        direct_actuator=None,
        recorder=None,
        flight_recorder=None,
        analysis_workers: int = DEFAULT_ANALYSIS_WORKERS,
        forecast_planner=None,
        capacity=None,
        health=None,
        boot_ramp=None,
        checkpointer=None,
        device=None,
    ) -> None:
        self.client = client
        self.config = config
        self.collector = collector
        self.actuator = actuator
        # Optional k8s.events.EventRecorder: desired-replica changes publish
        # a ScalingDecision Event carrying the pipeline's step trail.
        self.recorder = recorder
        # Optional DirectActuator for the fastActuation config: scale-UP
        # decisions hit the scale subresource immediately instead of waiting
        # for the external HPA loop (which still converges to the same
        # wva_desired_replicas gauge).
        self.direct_actuator = direct_actuator
        self.enforcer = enforcer
        self.limiter = limiter
        self.clock = clock or SYSTEM_CLOCK
        self.v1_analyzer = SaturationAnalyzer(clock=self.clock)
        self.capacity_store = capacity_store or CapacityKnowledgeStore(clock=self.clock)
        self.v2_analyzer = SaturationV2Analyzer(self.capacity_store, clock=self.clock)
        # Where the sizing, the fits and the tuner's jacobian run: None
        # is the CUDA card, "cpu" the kernels' plain versions.
        self.device = device
        self.slo_analyzer = QueueingModelAnalyzer(clock=self.clock,
                                                  device=device)
        self.slo_tuner = TunerController(self.slo_analyzer.profiles,
                                         device=device)
        self.optimizer = optimizer or CostAwareOptimizer()
        # Active make-before-break holds: "ns/model|variant" ->
        # (hold start time, replicas at hold start, target accelerator).
        self._migration_holds: dict[str, tuple[float, int, str]] = {}
        # Optional blackbox.FlightRecorder (decision trace): the executor
        # opens one cycle record per tick; the engine and pipeline stages
        # fill it with analyzer inputs/outputs, decisions, and actuation.
        self.flight = flight_recorder
        # Optional forecast.CapacityPlanner (WVA_FORECAST, default on from
        # build_manager): demand history + measured lead times -> proactive
        # replica floors applied between enforcement and the limiter, on
        # the V2/SLO paths (the V1 percentage analyzer has no demand/
        # capacity quantities to forecast). None = pure reactive, decisions
        # byte-identical to pre-forecast builds.
        self.forecast = forecast_planner
        # Optional capacity.CapacityManager (WVA_CAPACITY, default on from
        # build_manager): elastic slice inventory — the limiter's pools
        # extend to provisioning-in-flight capacity, post-analysis
        # shortfalls become provisioning requests, preemptions release
        # chips the same tick. None = static inventory, decisions
        # byte-identical to pre-capacity builds.
        self.capacity = capacity
        # Optional health.InputHealthMonitor (WVA_HEALTH, default on from
        # build_manager): per-model input-trust ladder (FRESH -> DEGRADED
        # -> BLACKOUT) over collector slice ages, scrape coverage, and
        # control-plane staleness, gating final decisions do-no-harm
        # (docs/design/health.md). None = pre-health behavior: decisions,
        # statuses, and traces byte-identical in a fault-free world.
        self.health = health
        # Crash-restart resilience plane (WVA_RESILIENCE, default on from
        # build_manager; wva_tpu_torch/resilience):
        # - boot_ramp: do-no-harm startup hold — every model is DEGRADED-
        #   equivalent (scale-up allowed, down forbidden) until its inputs
        #   PROVE fresh or WVA_STARTUP_HOLD_TICKS elapse. Requires the
        #   health plane (the ramp rides its gate); inert without it.
        # - checkpointer: resilience.CheckpointStore — durable soft-state
        #   snapshot (capacity orders, health LKGs, forecast trust, lead
        #   times) written at most every WVA_CHECKPOINT_INTERVAL ticks.
        # - fence: the elector's fencing_token callable (None = election
        #   disabled). Captured at tick start, re-checked between analyze
        #   and apply: a leader deposed mid-tick raises instead of
        #   actuating.
        # - boot_report: WarmStartReport from build_manager's warm_start,
        #   recorded once as STAGE_BOOT on the first traced cycle that has
        #   something to say.
        self.boot_ramp = boot_ramp
        self.checkpointer = checkpointer
        self.fence = None
        self.boot_report = None
        self._boot_recorded = False
        # Sharded active-active engine (wva_tpu_torch/shard;
        # docs/design/sharding.md). Exactly one of these is ever set:
        # - shard_plane (fleet role): the engine stops analyzing models
        #   itself — shard workers analyze their consistent-hash partitions
        #   and this engine merges their summaries in sorted model order,
        #   runs the fleet-level solve for global-routed models, then the
        #   limiter / health gate / apply exactly as before. None +
        #   shard_ctx None = the unsharded engine, byte-identical to
        #   pre-shard builds (WVA_SHARDING=off).
        # - shard_ctx (shard-worker role): analysis stops BEFORE the
        #   limiter and publishes a ShardCapture (pre-limiter decisions,
        #   fleet-solve arrays, health signals, buffered trace records)
        #   instead of applying anything.
        self.shard_plane = None
        self.shard_ctx = None
        # Multi-cluster federation plane (WVA_FEDERATION + a configured
        # region; wva_tpu_torch/federation): publishes this region's
        # ClusterCapture each tick, arbitrates the fleet while holding the
        # arbiter lease, and applies the arbiter's raise-only spill
        # directives AFTER the health gate (docs/design/federation.md).
        # None = single-cluster engine, byte-identical to pre-federation
        # builds.
        self.federation = None
        # Fleet-installed shared tick collector for shard workers (see
        # _tick_collector); always None outside a plane-driven worker tick.
        self.tick_collector_override = None
        # Chaos-harness hook (emulator restart storms): when armed, the
        # fence check raises SimulatedCrash — the tick dies with decisions
        # computed but never applied, exactly a process kill mid-tick.
        self.crash_before_apply = False
        self._tick_epoch: int | None = None
        # Models whose inputs were observed with a REAL backend age this
        # tick (slice_age_seconds returned a value) — the boot ramp's
        # proof-of-freshness signal, distinct from the health monitor's
        # restart-bootstrap "clock starts now" freshness.
        self._tick_age_observed: set[str] = set()
        self._tick_ramp_holds: frozenset[str] = frozenset()
        # Tick-scoped health state: per-model classification (gate +
        # condition + gauges consume it) and per-model scrape coverage
        # (scraped pods vs expected ready pods, captured during analysis).
        self._tick_health: dict[str, InputHealth] = {}
        self._tick_coverage: dict[str, tuple[int, int]] = {}
        # Accelerator variants serving BLACKED-OUT models this tick: the
        # capacity pass holds exactly these variants' order expiry
        # (per-variant — one model's blackout must not suppress an
        # unrelated healthy variant's wedge detection).
        self._tick_hold_variants: frozenset[str] = frozenset()
        self._health_gauge_keys: set[tuple] = set()
        # Introspection for bench-chaos: non-fresh models + clamps applied
        # last tick.
        self.last_tick_health: dict[str, int] = {}
        # Cumulative preempted-slice counts the capacity gauge sweep saw
        # last tick (counter emission needs deltas), and the limiter's
        # per-tick discovery snapshot handed to the capacity pass.
        self._capacity_preempted_seen: dict[str, int] = {}
        # Variants whose capacity gauges were emitted last tick: a variant
        # that left the ledger (its last slice gone, its VAs deleted) has
        # its wva_capacity_* GAUGES removed instead of freezing at their
        # last value (counters stay — rate() semantics).
        self._capacity_gauge_keys: set[str] = set()
        self._tick_slices: dict | None = None
        # Label sets the trend/forecast gauge sweeps emitted last tick: a
        # deleted model's gauges are REMOVED from the registry, not left
        # frozen at their last value (an operator alerting on staleness
        # must not see a permanently fresh-looking dead series).
        self._trend_gauge_keys: set[tuple] = set()
        self._forecast_gauge_keys: set[tuple] = set()
        # Fleet-scale tick levers (docs/design/tick-scale.md +
        # docs/design/metrics-plane.md). All are independently toggleable so
        # `make bench-tick` / `make bench-collect` can reproduce the
        # pre-change loop against the same world:
        # - tick_snapshot_enabled: one LIST per kind per tick instead of
        #   per-VA GETs (SnapshotKubeClient);
        # - analysis_workers: bounded pool for per-model prepare->analyze;
        # - solver_batching: one jitted sizing call across every model's
        #   candidates in the SLO path instead of one dispatch per model;
        # - grouped_collection: ONE fleet-wide backend query per registered
        #   template per tick (GroupedMetricsView) instead of ~10 queries
        #   per model (WVA_GROUPED_COLLECTION / wva.groupedCollection).
        self.analysis_workers = max(1, int(analysis_workers))
        self.tick_snapshot_enabled = True
        self.solver_batching = True
        self.grouped_collection = True
        # One-jitted-program decision plane (WVA_FUSED, default on;
        # docs/design/fused-plane.md): on the SLO path, the tick's whole
        # numeric pipeline — every model's queueing-solve sizing, every
        # model's forecast fit, and the trusted-forecast selection — runs
        # as ONE device dispatch on fixed padded grids, with per-model
        # dynamics as mask columns and one host transfer of the result
        # arrays; the fleet solve and the limiter's masked grant pass
        # reuse it. Off restores the staged per-stage dispatches
        # (byte-identical statuses AND trace cycles, tested like
        # WVA_FP_DELTA=off).
        self.fused_enabled = True
        # Vectorized decision stage (WVA_VEC_DECIDE, default on;
        # docs/design/fused-plane.md §host-vectorization): the SLO path's
        # post-dispatch host pipeline — finalize's supply/demand algebra,
        # the cost-aware optimizer's greedy fills, and the enforcer
        # bridge — runs as fleet-wide row arithmetic over the [M] model
        # axis (pipeline.vectorized) instead of per-model Python. Off
        # restores the per-model loops (byte-identical statuses AND trace
        # cycles, tested like WVA_FUSED=off). Works identically under
        # staged and fused ticks and inside shard workers.
        self.vec_decide = True
        # Equivalence cross-check (WVA_VEC_ASSERT, tests/debugging only):
        # run BOTH decision-stage forms every tick and raise on the first
        # diverging bit.
        self.vec_assert = False
        # Delta-sizing solve memo (WVA_SOLVE_MEMO, default on;
        # docs/design/fused-plane.md §host-vectorization): candidate rows
        # whose complete solve key (profile parms, request mix, bounds,
        # targets) is unchanged reuse the memoized sized rate; a tick
        # with zero changed rows dispatches only the forecast fits (still
        # one dispatch). Off = full re-solve every tick (byte-identical
        # either way — sizing is a pure per-row function of the key).
        self.solve_memo = True
        # The fused dispatch's per-(model, ns, accelerator) sized rates,
        # reused by this tick's fleet solve (_optimize_global) instead of
        # a second sizing dispatch. Tick-scoped; None = staged sizing.
        self._tick_presized: dict | None = None
        # Dirty-set incremental ticks (docs/design/informer.md): a per-model
        # input fingerprint (VA generations/labels, scale-target state, pod
        # set, this tick's grouped metric slices, config epoch) gates
        # prepare->analyze; unchanged-quiet models re-emit the prior cycle's
        # decision as a heartbeat. WVA_INCREMENTAL=off restores
        # analyze-everything (byte-identical outputs, like WVA_FORECAST=off).
        self.incremental_enabled = True
        self.resync_ticks = DEFAULT_RESYNC_TICKS
        # Versioned fingerprint plane (WVA_FP_DELTA, default on;
        # docs/design/informer.md §versioned-fingerprints): the per-model
        # fingerprint is maintained by DELTA — K8s components are memoized
        # per (object, freeze.object_version) and re-derived only when the
        # frozen store instance was replaced, pod components per informer
        # pod-set epoch, and metric components are SliceVersionBook
        # versions stamped during the grouped demux — so a quiet tick's
        # fingerprint costs O(changed inputs), not O(models x templates x
        # series). Off restores the recomputed path byte-for-byte.
        self.fp_delta_enabled = True
        # Equivalence cross-check (WVA_FP_ASSERT, tests/debugging only):
        # compute BOTH fingerprints every tick and raise when their
        # equality dynamics diverge.
        self.fp_assert = False
        self._tick_seq = 0
        # group_key ("model|ns") -> last analyzed fingerprint / the
        # PRE-limiter decisions that analysis produced (deep copies; the
        # limiter re-clamps the merged set every tick, so re-emitted
        # decisions see current inventory).
        self._fingerprints: dict[str, tuple] = {}
        self._decision_memo: dict[str, list[VariantDecision]] = {}
        # Delta-fingerprint memos: component tuples re-derived only when
        # their source changed. VA/target parts key on the frozen store
        # object's process-monotonic version; per-model pod parts key on
        # the informer's per-namespace pod-set epoch + selector identity.
        self._va_part_memo: dict[tuple, tuple[int, tuple]] = {}
        self._target_part_memo: dict[tuple, tuple[int, tuple, object]] = {}
        self._pod_parts_memo: dict[str, tuple[int, tuple, tuple]] = {}
        # Recomputed-path shadow fingerprints (fp_assert mode only).
        self._fp_shadow: dict[str, tuple] = {}
        self._shadow_tick: dict[str, tuple | None] = {}
        # Epoch-gated SLO config sync: ns -> (mutation_epoch, resolved
        # cfg). An unchanged epoch proves the resolved config is value-
        # identical, so the per-tick fleet-sized deepcopy + re-adoption
        # is skipped (at 480 models the profile-list copy alone was a
        # double-digit share of the quiet tick).
        self._slo_sync_memo: dict[str, tuple[int, object]] = {}
        # Introspection for tests/bench: analyzed vs skipped last tick.
        self.last_tick_stats: dict[str, int] = {"analyzed": 0, "skipped": 0}
        # Wall-clock spent per tick phase (wva_tick_phase_seconds): the
        # next hot path must be visible from metrics, not only from
        # `make bench-profile`.
        self.last_tick_phase_seconds: dict[str, float] = {}
        # Obs plane (WVA_SPANS; docs/design/observability.md): the span
        # recorder build_manager installs when spans are on. Every tick
        # opens one span tree — tick -> phase -> per-model prepare/analyze
        # -> fused dispatch / backend queries / capacity orders / status
        # writes — strictly out-of-band (statuses, traces, and goldens
        # byte-identical with the lever off OR on). None = off: no
        # recorder exists, the guards below cost one attribute read.
        self.spans = None
        # The collector policy build_manager installs
        # (wva_tpu_torch/utils/gcpolicy.py): read as each tick starts, its
        # counters on the tick's span. None: the engine never reads the
        # collector.
        self.gc_policy = None
        self._span_root = None
        self._cur_phase_span = None
        self._span_phases: dict[str, object] = {}
        # The tick's grouped metrics view, whose counts (queries, memo
        # hits, models demuxed) each phase span carries, and the counts
        # at the open phase's start.
        self._tick_view = None
        self._phase_counts: dict[str, int] = {}
        # K8s object copies taken during the last tick (object plane
        # accounting; ~0 at steady state — see wva_tick_object_copies).
        self.last_tick_object_copies = 0
        self._analysis_pool: ThreadPoolExecutor | None = None
        self.executor = PollingExecutor(self.optimize, poll_interval,
                                        clock=self.clock,
                                        name=common.SOURCE_SATURATION)
        self.executor.flight_recorder = flight_recorder

    # --- loop entry ---

    def start_optimize_loop(self, stop) -> None:
        self.executor.start(stop)

    def close(self) -> None:
        """Release the persistent analysis pool (process shutdown)."""
        if self._analysis_pool is not None:
            self._analysis_pool.shutdown(wait=False)
            self._analysis_pool = None

    def _tick_client(self) -> KubeClient:
        """The tick's read view: a fresh snapshot client (one LIST per kind,
        frozen for the tick) — or the live client when the snapshot lever is
        off (bench legacy mode). Small fleets flip scale-target kinds to
        memoized targeted GETs (see SNAPSHOT_LIST_MIN_VAS) so a shared
        cluster's foreign Deployments are never LISTed."""
        if not self.tick_snapshot_enabled:
            return self.client
        # Informer-backed client (k8s/informer.py): the snapshot's one LIST
        # per kind is served from the watch-fed store — zero API requests —
        # so the small-fleet targeted-GET economy no longer applies, and
        # Pods join the snapshot (the dirty-set fingerprint hashes the pod
        # set only when reading it is free).
        informer_backed = getattr(self.client, "lists_are_local", False)
        kinds = DEFAULT_SNAPSHOT_KINDS
        if informer_backed and "Pod" in getattr(self.client, "kinds", ()):
            kinds = DEFAULT_SNAPSHOT_KINDS + ("Pod",)
        snap = SnapshotKubeClient(
            self.client, namespace=self.config.watch_namespace() or None,
            kinds=kinds)
        if not informer_backed:
            n_vas = len(snap.list(
                "VariantAutoscaling",
                namespace=self.config.watch_namespace() or None))
            if n_vas < SNAPSHOT_LIST_MIN_VAS:
                snap.use_targeted_gets(("Deployment", "LeaderWorkerSet"))
        return snap

    def _tick_collector(self) -> ReplicaMetricsCollector:
        """The tick's metrics read view: the shared collector rebound to a
        fresh GroupedMetricsView, so every per-model query this tick is
        served by demuxing ONE fleet-wide query per template
        (docs/design/metrics-plane.md) — or the collector unchanged when
        the lever is off / the source has no grouped substrate.

        Shard-worker role: the fleet installs its own tick view here
        (``tick_collector_override``) so every worker in a fleet tick
        shares ONE set of fleet-wide executions and version resolutions —
        exactly the unsharded engine's cost, instead of once per worker."""
        if self.tick_collector_override is not None:
            return self.tick_collector_override
        source = self.collector.source
        if (self.grouped_collection
                and getattr(source, "supports_grouped_collection", False)):
            # A namespace-scoped controller's fleet-wide queries keep the
            # watch namespace as an equality matcher (shared Prometheus:
            # never aggregate other tenants' series).
            view = GroupedMetricsView(
                source, scope_namespace=self.config.watch_namespace() or "",
                versioned=self.fp_delta_enabled, spans=self.spans)
            return self.collector.scoped(view)
        return self.collector

    # --- obs-plane span helpers (WVA_SPANS; no-ops when spans are off) ---

    def _begin_phase_span(self, name: str) -> None:
        """Open the named phase span under the tick root, closing the
        previous phase's (phases are strictly sequential)."""
        if self.spans is None:
            return
        self._end_phase_span()
        span = self.spans.begin_span(f"phase:{name}",
                                     parent=self._span_root)
        self._cur_phase_span = span
        self._phase_counts = self._view_counts()
        # Helper threads (analysis pool, query warmers) with no open span
        # of their own attribute to the phase that spawned their work.
        self.spans.set_default_parent(span)
        if span is not None:
            self._span_phases[name] = span

    def _end_phase_span(self) -> None:
        if self.spans is not None and self._cur_phase_span is not None:
            start = self._phase_counts
            self.spans.end_span(self._cur_phase_span, **{
                k: v - start.get(k, 0)
                for k, v in self._view_counts().items()})
            self._cur_phase_span = None
            self.spans.set_default_parent(None)

    def _view_counts(self) -> dict[str, int]:
        view = self._tick_view
        return view.counts() if view is not None else {}

    def _obs_span(self, name: str, **attrs):
        """Scoped span under the calling thread's innermost open span
        (falls back to the current phase / tick root)."""
        if self.spans is None:
            return nullcontext()
        return self.spans.span(name, **attrs)

    def _open_span(self, name: str, **attrs):
        """``_obs_span`` entered until ``_close_span``, for a stage too
        long to indent under a ``with``. An exception between the two
        fails the tick: the phase's end then closes the stage's profiler
        range before its own (``SpanRecorder._close_range``), and the next
        tick's root clears the thread's stack."""
        if self.spans is None:
            return None
        ctx = self.spans.span(name, **attrs)
        ctx.__enter__()
        return ctx

    @staticmethod
    def _close_span(ctx) -> None:
        if ctx is not None:
            ctx.__exit__(None, None, None)

    @contextmanager
    def _model_span(self, model_id: str, namespace: str):
        """Per-model prepare/analyze span (parented to the analyze phase —
        the worker pool's threads have no open span of their own) plus the
        model field for JSON log context. Only analyzed (dirty) models
        pass through here, so quiet-tick cost stays near zero."""
        if logjson.ACTIVE:
            logjson.set_context(model=model_id, model_namespace=namespace)
        try:
            if self.spans is None:
                yield
            else:
                with self.spans.span("model", parent=self._cur_phase_span,
                                     model=model_id, namespace=namespace):
                    yield
        finally:
            if logjson.ACTIVE:
                logjson.clear_context("model", "model_namespace")

    def _map_models(self, model_groups: dict, fn, affinity=None) -> dict:
        """Run ``fn(group_key, model_vas)`` for every model, across the
        bounded worker pool when it pays (>1 worker and >1 model). Returns
        ``{group_key: fn result}``. ``fn`` owns its per-model exception
        isolation and returns tagged outcomes; an exception escaping ``fn``
        propagates here exactly as it would from the serial loop (failing
        the tick into the executor's retry) — but only after EVERY future
        has finished, so a tick retry never overlaps stale workers from the
        failed attempt.

        ``affinity(group_key, model_vas)`` maps groups to a token; groups
        sharing a token run in ONE worker, serially, in sorted key order.
        The V2/SLO paths key it by model_id: analyzer state that is shared
        ACROSS namespaces of the same model (k2 rolling history, capacity
        records consulted by find_compatible) would otherwise interleave in
        scheduler order and break the decisions-are-byte-identical-at-any-
        pool-width guarantee."""
        keys = sorted(model_groups)
        if self.analysis_workers <= 1 or len(keys) <= 1:
            return {key: fn(key, model_groups[key]) for key in keys}
        if self._analysis_pool is None:
            self._analysis_pool = ThreadPoolExecutor(
                max_workers=self.analysis_workers,
                thread_name_prefix="wva-analysis")
        chains: dict[object, list[str]] = {}
        for key in keys:
            token = key if affinity is None else affinity(
                key, model_groups[key])
            chains.setdefault(token, []).append(key)

        def run_chain(chain_keys: list[str]) -> list[tuple[str, object]]:
            return [(k, fn(k, model_groups[k])) for k in chain_keys]

        futures = [self._analysis_pool.submit(run_chain, chain)
                   for chain in chains.values()]
        results: dict[str, object] = {}
        first_exc: Exception | None = None
        for fut in futures:  # drain ALL before raising (no stale workers)
            try:
                for key, value in fut.result():
                    results[key] = value
            except Exception as e:  # noqa: BLE001 — re-raised below
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc
        return results

    def optimize(self) -> None:
        """One optimization tick (reference engine.go:171-277)."""
        if self.gc_policy is not None:
            self.gc_policy.begin_tick()
        # Object-plane accounting: K8s object copies taken during THIS
        # tick (clone/thaw of a Freezable). Steady-state ticks are ~0 —
        # reads are zero-copy frozen views; a copy marks a write site.
        copies_at_start = frz.copy_count()
        phase_start = time.perf_counter()
        self._phase_seconds: dict[str, float] = {}
        # One span tree per tick (obs plane). Shard-worker role records
        # under the fleet's adopted trace context; the fleet stitches the
        # worker subtrees under its own tick span after gather.
        if self.spans is not None:
            self._span_phases = {}
            self._span_root = self.spans.begin_tick(
                engine=self.executor.name)
            self._begin_phase_span("prepare")
        if logjson.ACTIVE:
            logjson.set_context(
                engine=self.executor.name,
                tick=(self.spans.trace_id
                      if self.spans is not None else None),
                shard=(self.shard_ctx.capture.shard_id
                       if self.shard_ctx is not None else None))
        tick_ok = False
        # Everything below the span/logctx setup runs inside ONE
        # try/finally: a failure anywhere in the prepare section (fence
        # check, informer resync, snapshot LIST, collector construction)
        # must still commit the tick's span tree with outcome "error" and
        # clear the JSON-log context — an abandoned open root would
        # silently vanish (uncounted) and the executor's retry/backoff
        # log lines would carry a stale tick id.
        try:
            # Fencing token for this tick (wva_tpu_torch/resilience): the lease
            # epoch we act under. Captured BEFORE any work and re-checked
            # between analyze and apply — losing it mid-tick aborts before
            # a single write. None fence = election disabled (always
            # leader).
            if self.fence is not None:
                self._tick_epoch = self.fence()
                if self._tick_epoch is None:
                    raise LeadershipLostError(
                        "leadership lost before tick start; not analyzing")
            else:
                self._tick_epoch = None
            if self.flight is not None:
                # Retried ticks must not stack duplicate model records
                # into the failed attempt's cycle.
                self.flight.reset_cycle()
            # Tick-scoped: the limiter's discovery snapshot for the
            # capacity pass. Reset HERE, not per-path — any path that
            # skips the limiter (no active VAs, V2 with zero requests)
            # must leave the capacity pass on fresh discovery, never a
            # previous tick's snapshot.
            self._tick_slices = None
            # Tick-scoped: the fused dispatch's sized pairs for the fleet
            # solve. Reset here so a failed/absent fused pass never
            # leaves a previous tick's rates for _optimize_global to
            # consume.
            self._tick_presized = None
            # Informer staleness backstop: re-LIST any kind whose last
            # list is older than the resync interval (no-op on
            # non-informer clients).
            resync = getattr(self.client, "resync_if_stale", None)
            if callable(resync):
                resync()
            # Tick-scoped cluster snapshot: every K8s read below
            # (active-VA filter, per-model data prep, decision
            # application, safety net) is served from one LIST per kind
            # instead of a GET per VA — O(kinds) API requests per tick
            # regardless of fleet size, and a consistent view for every
            # model's analysis.
            snap = self._tick_client()
            # Tick-scoped metrics view, same idea on the metrics plane:
            # one fleet-wide backend query per registered template,
            # demuxed to every model (instead of ~10 backend queries per
            # model per tick). The enforcer's scale-to-zero request
            # counts ride the same view (enforcement runs on this thread
            # only; cleared in the finally).
            collector = self._tick_collector()
            if collector is not self.collector:
                self.enforcer.metrics_source = collector.source
            if isinstance(collector.source, GroupedMetricsView):
                self._tick_view = collector.source
            # Snapshot + collector construction, resync probe: the first
            # slice of the "prepare" phase (the rest — VA listing,
            # grouping — is accumulated inside _optimize_with).
            self._phase_seconds["prepare"] = \
                time.perf_counter() - phase_start
            self._optimize_with(snap, collector)
            tick_ok = True
        finally:
            self.enforcer.metrics_source = None
            copies = frz.copy_count() - copies_at_start
            self.last_tick_object_copies = copies
            self.last_tick_phase_seconds = dict(self._phase_seconds)
            registry = getattr(self.actuator, "registry", None)
            if registry is not None:
                registry.set_gauge(WVA_TICK_OBJECT_COPIES, {},
                                   float(copies))
                for phase in ("prepare", "fingerprint", "analyze", "apply"):
                    registry.set_gauge(
                        WVA_TICK_PHASE_SECONDS, {LABEL_PHASE: phase},
                        round(self._phase_seconds.get(phase, 0.0), 6))
                if self.spans is not None:
                    # Span-id exemplars next to wva_tick_phase_seconds:
                    # a slow phase sample links straight to the span that
                    # timed it (comment-line exemplars; see registry).
                    for phase, sp in self._span_phases.items():
                        registry.set_exemplar(
                            WVA_TICK_PHASE_SECONDS, {LABEL_PHASE: phase},
                            {"trace_id": self.spans.trace_id,
                             "span_id": sp.span_id})
            if self.spans is not None:
                self._end_phase_span()
                if self.gc_policy is not None:
                    self.spans.annotate(self._span_root,
                                        **self.gc_policy.tick_attrs())
                self._span_root = None
                self.spans.end_tick("success" if tick_ok else "error")
            self._tick_view = None
            if logjson.ACTIVE:
                logjson.clear_context("engine", "tick", "shard")

    def _optimize_with(self, snap: KubeClient,
                       collector: ReplicaMetricsCollector) -> None:
        prep_start = time.perf_counter()
        active_vas = variant_utils.active_variant_autoscalings(
            snap, namespace=self.config.watch_namespace() or None)
        if not active_vas:
            log.debug("No active VariantAutoscalings, skipping optimization")
            return

        model_groups = variant_utils.group_variant_autoscalings_by_model(active_vas)
        # Shard-worker role: analyze only the owned consistent-hash
        # partition, stop before the limiter, and publish a summary —
        # nothing below (health gate, apply, capacity) runs on a worker.
        if self.shard_ctx is not None:
            self._shard_analyze(model_groups, snap, collector, prep_start)
            return
        va_map = {namespaced_key(va.metadata.namespace, va.metadata.name): va
                  for va in active_vas}

        # Per-tick state hygiene: learned per-model series (demand trends,
        # k2 history) must not accumulate for deleted models.
        active_keys = {
            f"{vas[0].metadata.namespace}|{vas[0].spec.model_id}"
            for vas in model_groups.values()}
        self.v2_analyzer.prune(active_keys)
        self.slo_analyzer.prune(active_keys)

        analyzer_name = ""
        global_cfg = self.config.saturation_config().get("default")
        if global_cfg is not None:
            global_cfg.apply_defaults()
            analyzer_name = global_cfg.analyzer_name

        if self.flight is not None:
            self.flight.annotate(analyzer=analyzer_name or "v1")

        # Dirty-set gate: models whose input fingerprint is unchanged skip
        # prepare->analyze and re-emit the prior cycle's decisions below.
        # In sharded fleet mode the WORKERS own fingerprints and memos —
        # the fleet engine only advances its tick sequence (checkpoint
        # cadence) and merges what the shards shipped.
        fp_start = time.perf_counter()
        self._phase_seconds["prepare"] = (
            self._phase_seconds.get("prepare", 0.0)
            + fp_start - prep_start)
        self._begin_phase_span("fingerprint")
        if self.shard_plane is None:
            clean, fingerprints = self._partition_clean(
                model_groups, snap, collector, analyzer_name)
            self._prune_incremental_state(set(model_groups))
            self.last_tick_stats = {
                "analyzed": len(model_groups) - len(clean),
                "skipped": len(clean)}
        else:
            self._tick_seq += 1
            clean, fingerprints = set(), {}
        analyze_start = time.perf_counter()
        self._phase_seconds["fingerprint"] = analyze_start - fp_start
        self._begin_phase_span("analyze")

        # Analyzer selection by name (reference engine.go:236-254); "slo"
        # reuses the V2 optimizer/enforcer flow with the queueing-model
        # analyzer producing req/s capacities instead of token capacities.
        self._tick_coverage = {}
        if self.shard_plane is not None:
            decisions = self._optimize_sharded(model_groups, snap,
                                               collector, analyzer_name)
        elif analyzer_name in (V2_ANALYZER_NAME, SLO_ANALYZER_NAME):
            decisions = self._optimize_v2(
                model_groups, snap, use_slo=analyzer_name == SLO_ANALYZER_NAME,
                collector=collector, clean=clean, fingerprints=fingerprints)
        else:
            decisions = self._optimize_v1(model_groups, snap,
                                          collector=collector, clean=clean,
                                          fingerprints=fingerprints)

        # Input-health gate (WVA_HEALTH): the do-no-harm clamp on FINAL
        # (post-limiter) decisions — holds/freezes are absolute, so they
        # must have the last word — recorded as a stage so replay
        # re-applies them, BEFORE the decisions themselves are recorded.
        with self._obs_span("health_gate"):
            self._apply_health_gate(decisions, va_map)
        # Federation gate (WVA_FEDERATION + region): capture export +
        # raise-only spill floors from the arbiter plan. Runs AFTER the
        # health gate (targets are healthy regions, and a raise-only
        # floor cannot fight a local freeze) and BEFORE the decisions are
        # recorded, so replay re-applies the recorded directives in the
        # same position.
        if self.federation is not None:
            with self._obs_span("federation_gate"):
                self._apply_federation_gate(decisions)
        if self.flight is not None:
            with self._obs_span("record", decisions=len(decisions)):
                self.flight.record_decisions(decisions)
        apply_start = time.perf_counter()
        self._phase_seconds["analyze"] = apply_start - analyze_start
        self._begin_phase_span("apply")
        # Fence re-check between analyze and apply (wva_tpu_torch/resilience):
        # a leader deposed while analyzing must never actuate — the lease
        # epoch captured at tick start must still be ours. Every write
        # below additionally rides rv-guarded paths, so even a check that
        # races a handover by microseconds cannot dual-actuate.
        self._check_fence()
        self._apply_decisions(decisions, va_map, snap)
        self._apply_capacity()
        self._emit_trend_metrics(analyzer_name)
        self._emit_control_plane_metrics()
        self._emit_health_metrics()
        self._maybe_checkpoint()
        self._phase_seconds["apply"] = time.perf_counter() - apply_start

    def _check_fence(self) -> None:
        """Raise unless this process still holds the lease epoch the tick
        started under. Also the chaos harness's kill point: an armed
        ``crash_before_apply`` dies here — decisions computed, nothing
        applied — simulating a process crash mid-tick."""
        if self.crash_before_apply:
            self.crash_before_apply = False
            raise SimulatedCrash(
                "chaos: process killed between analyze and apply")
        if self.fence is None:
            return
        current = self.fence()
        if current is None or current != self._tick_epoch:
            raise LeadershipLostError(
                f"leadership lost mid-tick (epoch {self._tick_epoch} -> "
                f"{current}); not applying decisions")

    def _maybe_checkpoint(self) -> None:
        """Durable soft-state checkpoint, throttled by the store. Runs at
        the very end of the apply phase so the snapshot reflects what this
        tick actually committed; the store fences and rv-guards the write
        and never raises."""
        if self.checkpointer is None:
            return
        self.checkpointer.maybe_save(self._tick_seq, self._tick_epoch,
                                     self._checkpoint_payload)

    def _checkpoint_payload(self) -> dict:
        payload: dict = {}
        if self.capacity is not None:
            payload["capacity"] = self.capacity.ledger.export_state()
        if self.health is not None:
            payload["health"] = self.health.export_state()
        if self.forecast is not None:
            payload["forecast"] = self.forecast.export_trust()
        leadtime = (self.forecast.leadtime if self.forecast is not None
                    else getattr(self.capacity, "leadtime", None))
        if leadtime is not None:
            payload["leadtime"] = leadtime.export_state()
        return payload

    def _emit_trend_metrics(self, analyzer_name: str) -> None:
        """Surface the active analyzer's DemandTrend health (per-key sample
        count + staleness) as wva_trend_* gauges — the estimator silently
        returning slope 0 for a starved series was previously invisible."""
        registry = getattr(self.actuator, "registry", None)
        if registry is None:
            return
        analyzer = (self.slo_analyzer if analyzer_name == SLO_ANALYZER_NAME
                    else self.v2_analyzer)
        now = self.clock.now()
        stats = dict(analyzer.demand_trend_stats(now))
        if self.shard_plane is not None:
            # Sharded fleet role: the trends live in the WORKERS' analyzer
            # state (this engine never analyzes) — aggregate the in-process
            # workers' stats so wva_trend_* keeps existing (and sweeping)
            # at any shard count. Dead workers are skipped, and a key
            # reported by several workers (a rebalanced model whose old
            # owner's analyzer still holds its stale series) resolves to
            # the FRESHEST entry — the live owner's, not whichever shard
            # id sorts last. Process-per-shard workers are not reachable
            # here; their models' trend health is observable on the
            # worker processes' own /metrics.
            for shard in sorted(self.shard_plane.workers):
                worker = self.shard_plane.workers[shard]
                if worker.dead:
                    continue
                wa = (worker.engine.slo_analyzer
                      if analyzer_name == SLO_ANALYZER_NAME
                      else worker.engine.v2_analyzer)
                for key, st in wa.demand_trend_stats(now).items():
                    cur = stats.get(key)
                    if (cur is None or st.staleness_seconds
                            < cur.staleness_seconds):
                        stats[key] = st
        emitted: set[tuple] = set()
        for key, st in sorted(stats.items()):
            ns, _, model = key.partition("|")
            labels = {LABEL_MODEL_NAME: model, LABEL_NAMESPACE: ns}
            emitted.add((model, ns))
            registry.set_gauge(WVA_TREND_SERIES_SAMPLES, labels,
                               float(st.samples))
            if math.isfinite(st.staleness_seconds):
                registry.set_gauge(WVA_TREND_SERIES_STALENESS_SECONDS,
                                   labels, st.staleness_seconds)
        for model, ns in self._trend_gauge_keys - emitted:
            labels = {LABEL_MODEL_NAME: model, LABEL_NAMESPACE: ns}
            registry.remove(WVA_TREND_SERIES_SAMPLES, labels)
            registry.remove(WVA_TREND_SERIES_STALENESS_SECONDS, labels)
        self._trend_gauge_keys = emitted

    # --- input-health plane (docs/design/health.md) ---

    def _note_coverage(self, group_key: str, data: "_ModelData") -> None:
        """Capture this tick's scrape coverage for one analyzed model:
        distinct pods that answered the metrics queries vs the pods the
        ready fleet should expose (ready slices x hosts per slice). A
        partial label-subset response from the metrics backend looks like
        a SUCCESSFUL query with fewer pods — ages never move, but the
        analyzer would see half the load and scale down; coverage is the
        signal that catches it."""
        if self.health is None:
            return
        scraped = len({rm.pod_name for rm in data.replica_metrics
                       if rm.pod_name})
        # Expected floor in SLICES: every ready slice exposes at least one
        # scrapable pod (leader) regardless of hosts-per-slice, while a
        # host-count comparison would flag leader-only multi-host engines
        # as permanently partial.
        expected = sum(vs.ready_replicas for vs in data.variant_states)
        self._tick_coverage[group_key] = (scraped, expected)

    def _control_plane_staleness(self) -> float:
        """K8s-side input age BEYOND the informer's resync bound. A healthy
        informer store is never older than resync_seconds (the per-tick
        resync re-LISTs it), so only the excess counts — during an
        apiserver storm the re-LIST fails, events stop, and this grows.
        0 for non-informer clients (every tick LISTs live)."""
        stats_fn = getattr(self.client, "stats", None)
        if not callable(stats_fn) or not getattr(self.client,
                                                 "lists_are_local", False):
            return 0.0
        resync = float(getattr(self.client, "resync_seconds", 0.0) or 0.0)
        worst = 0.0
        for st in stats_fn().values():
            age = st.get("age_seconds", -1.0)
            if age >= 0:
                worst = max(worst, age - resync)
        return max(0.0, worst)

    def _assess_health(self, model_groups: dict,
                       collector: ReplicaMetricsCollector) -> None:
        """Classify every model's input trust this tick. Runs after the
        per-model analysis merge (the coverage signal needs this tick's
        scraped-pod counts) and BEFORE forecast floors and the decision
        gate consume the classification. Models that skipped analysis
        (clean fingerprint) still classify — their cache ages and the
        control-plane staleness are tick-global signals."""
        self._tick_health = {}
        self._tick_age_observed = set()
        if self.health is None:
            return
        now = self.clock.now()
        control_age = self._control_plane_staleness()
        age_fn = getattr(getattr(collector, "source", None),
                         "slice_age_seconds", None)
        for key in sorted(model_groups):
            vas = model_groups[key]
            age = None
            if callable(age_fn):
                try:
                    age = age_fn(HEALTH_AGE_QUERIES, {
                        PARAM_MODEL_ID: vas[0].spec.model_id,
                        PARAM_NAMESPACE: vas[0].metadata.namespace})
                except Exception:  # noqa: BLE001 — the probe must never
                    age = None     # fail the tick; unknown age degrades
            if age is not None:
                # A REAL backend observation exists for this model — the
                # boot ramp's proof-of-freshness signal. The monitor's
                # restart bootstrap ("never observed: start the clock
                # now") deliberately does NOT count: a restart into an
                # outage looks fresh to the age ladder for degraded_after
                # seconds, exactly the window the ramp covers.
                self._tick_age_observed.add(key)
            scraped, expected = self._tick_coverage.get(key, (None, None))
            self._tick_health[key] = self.health.observe(
                key, now, metrics_age=age, control_age=control_age,
                scraped=scraped, ready=expected)

    def _blackout_keys(self) -> frozenset[str]:
        """``ns|model`` keys (the forecast no-floor key shape) of models
        in BLACKOUT: proactive floors are withheld — a floor computed from
        history is still a capacity CHANGE, and blackout means no input
        justifies changing anything."""
        out = set()
        for key, h in self._tick_health.items():
            if h.state == BLACKOUT:
                model, _, ns = key.rpartition("|")
                out.add(f"{ns}|{model}")
        return frozenset(out)

    def _apply_health_gate(self, decisions: list[VariantDecision],
                           va_map: dict[str, VariantAutoscaling]) -> None:
        """The do-no-harm clamp on final decisions (docs/design/health.md):
        DEGRADED and recovery-window models keep scale-ups but hold the
        last-known-good floor; BLACKOUT models freeze desired outright and
        never scale a serving variant to zero. Clamps are flight-recorded
        (STAGE_HEALTH) so replay re-applies them via the shared
        health.apply path."""
        if self.health is None:
            self.last_tick_health = {}
            self._tick_hold_variants = frozenset()
            self._tick_ramp_holds = frozenset()
            # WVA_HEALTH=off leaves no ramp/clamp path, but a warm start
            # that recovered capacity/forecast/leadtime state still owes
            # its one STAGE_BOOT observability record.
            self._maybe_record_boot_stage(set())
            return
        now = self.clock.now()
        # Do-no-harm boot ramp (wva_tpu_torch/resilience): models still inside
        # the startup hold are DEGRADED-equivalent until their inputs
        # PROVE fresh — a FRESH classification backed by a real backend
        # age this tick releases the hold permanently; anything else
        # (restart-bootstrap freshness, degradation, no observation)
        # keeps it. In a fault-free world every model proves fresh on the
        # first tick and nothing is ever clamped — byte-identical to the
        # ramp being off.
        ramp_holds: set[str] = set()
        if self.boot_ramp is not None and self.boot_ramp.active:
            for key in sorted(self._tick_health):
                if not self.boot_ramp.holding(key):
                    continue
                h = self._tick_health[key]
                # Full scrape coverage is part of the proof: the ladder's
                # coverage signal needs cross-tick memory (a shortfall
                # classifies when it DROPPED below the last full pass or
                # persisted a second tick) — memory a freshly booted
                # process does not have, so a restart into a partial
                # window would look FRESH for exactly one tick. A
                # measured shortfall keeps the hold; the ladder takes
                # over on the next tick.
                scraped, expected = self._tick_coverage.get(
                    key, (None, None))
                covered = (scraped is None or not expected
                           or scraped >= expected)
                if (h.state == FRESH and h.allow_scale_down
                        and key in self._tick_age_observed and covered):
                    self.boot_ramp.release(key)
                else:
                    ramp_holds.add(key)
            self.boot_ramp.note_tick()
        self._tick_ramp_holds = frozenset(ramp_holds)
        # Rebalance ramp (wva_tpu_torch/shard): a model whose consistent-hash
        # owner just changed is held exactly like a boot-ramp model — its
        # new shard's analyzer state (trends, tuner filters, hysteresis
        # books) starts empty, so the first analyses after a move must not
        # be trusted with scale-downs until the inputs PROVE fresh (same
        # proof as the boot ramp: FRESH classification + a real backend
        # age + full measured coverage) or the hold expires.
        rebalance_holds: set[str] = set()
        if self.shard_plane is not None:
            for key in sorted(self.shard_plane.hold_keys()):
                h = self._tick_health.get(key)
                scraped, expected = self._tick_coverage.get(
                    key, (None, None))
                covered = (scraped is None or not expected
                           or scraped >= expected)
                if (h is not None and h.state == FRESH
                        and h.allow_scale_down
                        and key in self._tick_age_observed and covered):
                    self.shard_plane.release_hold(key)
                else:
                    rebalance_holds.add(key)
        stats = {"degraded": 0, "blackout": 0, "recovering": 0,
                 "clamped": 0, "boot_held": len(ramp_holds)}
        if self.shard_plane is not None:
            stats["rebalance_held"] = len(rebalance_holds)
        for h in self._tick_health.values():
            if h.state == BLACKOUT:
                stats["blackout"] += 1
            elif h.state != FRESH:
                stats["degraded"] += 1
            elif not h.allow_scale_down:
                stats["recovering"] += 1
        clamps: list[dict] = []
        for d in decisions:
            key = f"{d.model_id}|{d.namespace}"
            h = self._tick_health.get(key)
            if h is None:
                continue
            held = self.health.held_desired(d.namespace, d.variant_name)
            target = self.health.gate_target(h, d.target_replicas,
                                             d.current_replicas, held)
            state, verb = h.state, (
                "frozen" if h.state == BLACKOUT else "held")
            reason = h.reason
            if key in ramp_holds or key in rebalance_holds:
                # Ramp floor on top of the ladder's own gate: scale-ups
                # pass, nothing drops below max(last-known-good, current)
                # until this model's inputs prove fresh. Shared by the
                # boot ramp (process restart) and the rebalance ramp
                # (shard ownership move) — same do-no-harm semantics,
                # distinct trace states.
                floor = max(held if held is not None else 0,
                            d.current_replicas)
                if floor > target:
                    target = floor
                if target != d.target_replicas and h.state == FRESH:
                    if key in ramp_holds:
                        state, verb = "boot", "held"
                        reason = "inputs not yet proven fresh since restart"
                    else:
                        state, verb = "rebalance", "held"
                        reason = ("inputs not yet proven fresh since "
                                  "shard rebalance")
            if target != d.target_replicas:
                clamps.append({
                    "variant_name": d.variant_name,
                    "namespace": d.namespace,
                    "model_id": d.model_id,
                    "state": state,
                    "target_replicas": target,
                    "reason": (f"input health {state}: desired {verb} at "
                               f"{target} ({reason})"),
                })
        stats["clamped"] = apply_health_clamps(decisions, clamps, now=now)
        # Post-gate targets become the new last-known-good (BLACKOUT ticks
        # never move it — the frozen value IS the LKG); blacked-out
        # models' variants are collected for the capacity expiry hold.
        hold_variants: set[str] = set()
        for d in decisions:
            h = self._tick_health.get(f"{d.model_id}|{d.namespace}")
            if h is not None and h.state == BLACKOUT and d.accelerator_name:
                hold_variants.add(d.accelerator_name)
            self.health.note_emitted(d.namespace, d.variant_name,
                                     d.target_replicas,
                                     h.state if h is not None else FRESH)
        self._tick_hold_variants = frozenset(hold_variants)
        self.health.prune(
            set(self._tick_health),
            {(va.metadata.namespace, va.metadata.name)
             for va in va_map.values()})
        self.last_tick_health = stats
        self._maybe_record_boot_stage(ramp_holds)
        if self.flight is not None and (
                clamps or stats["degraded"] or stats["blackout"]
                or stats["recovering"] or stats["boot_held"]):
            states = []
            for key in sorted(self._tick_health):
                h = self._tick_health[key]
                model, _, ns = key.rpartition("|")
                states.append({
                    "model_id": model, "namespace": ns, "state": h.state,
                    "age_seconds": round(h.age_seconds, 3),
                    "allow_scale_down": h.allow_scale_down,
                })
            self.flight.record_stage(STAGE_HEALTH, {
                "states": states, "clamps": clamps})

    def _apply_federation_gate(self, decisions: list[VariantDecision]
                               ) -> None:
        """Multi-cluster federation tick (docs/design/federation.md):
        export this region's capture, arbitrate while holding the arbiter
        lease, then raise final decisions to the plan's spill floors via
        the shared federation.apply path. The stage is recorded only when
        the plan is non-trivial, so healthy fleets trace byte-identically
        to the plane being off."""
        now = self.clock.now()
        epoch = self._tick_epoch if self._tick_epoch is not None else -1
        try:
            directives, stage = self.federation.tick(
                decisions, self._tick_health, self.capacity, now,
                epoch=epoch)
        except Exception:  # noqa: BLE001 — federation must never fail a
            log.warning("federation gate failed", exc_info=True)  # tick
            return
        if directives:
            apply_federation_directives(decisions, directives, now=now)
        if self.flight is not None and stage is not None:
            self.flight.record_stage(STAGE_FEDERATION, stage)

    def _maybe_record_boot_stage(self, ramp_holds: set[str]) -> None:
        """STAGE_BOOT: one observability record on the first traced cycle
        after a boot worth talking about — warm start recovered state, or
        the ramp is still holding models. A fresh fault-free boot records
        nothing, keeping traces byte-identical to the plane being off."""
        if self._boot_recorded or self.flight is None:
            return
        recovered = (self.boot_report.recovered_anything()
                     if self.boot_report is not None else False)
        if not recovered and not ramp_holds:
            self._boot_recorded = True
            return
        self._boot_recorded = True
        self.flight.record_stage(STAGE_BOOT, {
            "recovered": (self.boot_report.to_dict()
                          if self.boot_report is not None else {}),
            "ramp_holding": sorted(ramp_holds),
            "ramp_ticks_remaining": (
                max(self.boot_ramp.hold_ticks - self.boot_ramp._ticks, 0)
                if self.boot_ramp is not None else 0),
            "epoch": self._tick_epoch if self._tick_epoch is not None
            else -1,
        })

    def _emit_health_metrics(self) -> None:
        """wva_input_health{model, namespace, state} one-hot gauges, swept
        for deleted models like the trend/forecast gauges."""
        registry = getattr(self.actuator, "registry", None)
        if registry is None or self.health is None:
            return
        emitted: set[tuple] = set()
        for key in sorted(self._tick_health):
            h = self._tick_health[key]
            model, _, ns = key.rpartition("|")
            labels = {LABEL_MODEL_NAME: model, LABEL_NAMESPACE: ns}
            emitted.add((model, ns))
            for state in HEALTH_STATES:
                registry.set_gauge(WVA_INPUT_HEALTH,
                                   {**labels, LABEL_STATE: state},
                                   1.0 if state == h.state else 0.0)
        for model, ns in self._health_gauge_keys - emitted:
            labels = {LABEL_MODEL_NAME: model, LABEL_NAMESPACE: ns}
            for state in HEALTH_STATES:
                registry.remove(WVA_INPUT_HEALTH,
                                {**labels, LABEL_STATE: state})
        self._health_gauge_keys = emitted

    # --- dirty-set incremental ticks (docs/design/informer.md) ---

    def _partition_clean(self, model_groups: dict, snap: KubeClient,
                         collector: ReplicaMetricsCollector,
                         analyzer_name: str,
                         ) -> tuple[set[str], dict[str, tuple | None]]:
        """Compute every model's input fingerprint and split the fleet into
        clean (skip prepare->analyze, re-emit the memoized decision) and
        dirty. A model is clean only when ALL hold: incremental is on, this
        is not a resync tick, the fingerprint is computable (grouped
        metrics view available), it equals last tick's, a decision memo
        exists, and the model is not routed through the fleet-wide global
        optimizer (whose solve couples every model's inputs — skipping one
        would change the others' assignments)."""
        self._tick_seq += 1
        fingerprints: dict[str, tuple | None] = {}
        clean: set[str] = set()
        resync_tick = (self.resync_ticks > 0
                       and self._tick_seq % self.resync_ticks == 0)
        gate_open = self.incremental_enabled and not resync_tick
        use_slo = analyzer_name == SLO_ANALYZER_NAME
        # Fingerprint exactly the metric surface the selected analyzer
        # consumes (fingerprinting input an analyzer never reads would
        # cost fleet-wide queries that cannot dirty anything).
        if analyzer_name == SLO_ANALYZER_NAME:
            fp_queries = FINGERPRINT_QUERIES_SLO
        elif analyzer_name == V2_ANALYZER_NAME:
            fp_queries = FINGERPRINT_QUERIES_V2
        else:
            fp_queries = FINGERPRINT_QUERIES
        # Tick-lazy pod shapes: listed per namespace only on the FIRST
        # selector-bearing model that needs them (an eager per-namespace
        # prefetch paid the walk even for fleets whose scale targets carry
        # no selectors), and — on the delta path — only when the
        # informer's pod-set epoch moved since the memoized walk.
        covers_pod = getattr(snap, "covers_kind", lambda k: False)("Pod")
        epoch_fn = getattr(self.client, "pod_epoch", None)
        # Epochs for EVERY namespace are captured up front, BEFORE any
        # snapshot Pod access: the snapshot fills its whole Pod kind cache
        # on the FIRST list, so a per-namespace lazy epoch read could pair
        # a post-event epoch with pre-event shapes for every namespace but
        # the first — and the memo would then silently stay fresh across a
        # real pod change. Capturing early is only ever conservative (an
        # event landing after capture makes next tick re-walk, never skip).
        versions = self._open_span("versions")
        tick_epochs: dict[str, int | None] = {}
        if self.incremental_enabled and callable(epoch_fn):
            for gkey in model_groups:
                gns = model_groups[gkey][0].metadata.namespace
                if gns not in tick_epochs:
                    tick_epochs[gns] = epoch_fn(gns)
        tick_shapes: dict[str, list[tuple] | None] = {}

        def pod_epoch(ns: str) -> int | None:
            return tick_epochs.get(ns)

        def pods_for_ns(ns: str) -> list[tuple] | None:
            if not covers_pod:
                return None
            if ns not in tick_shapes:
                tick_shapes[ns] = [
                    (pod.metadata.name, pod.metadata.labels,
                     getattr(pod.status, "phase", ""),
                     getattr(pod.status, "ready", False),
                     getattr(pod.status, "pod_ip", ""))
                    for pod in snap.list("Pod", namespace=ns)]
            return tick_shapes[ns]

        use_delta = (self.fp_delta_enabled
                     and isinstance(getattr(collector, "source", None),
                                    GroupedMetricsView))
        # Template-major bulk pass over the fleet's metric versions: each
        # fingerprint template is resolved once per tick, every model then
        # pays one dict lookup per template (instead of re-walking
        # template state per model — measurably super-linear at 480
        # models). A bulk failure degrades to the per-model path.
        bulk_metrics: dict | None = None
        if use_delta and self.incremental_enabled:
            try:
                bulk_metrics = collector.source.slice_versions_bulk(
                    fp_queries,
                    [(model_groups[key][0].spec.model_id,
                      model_groups[key][0].metadata.namespace)
                     for key in model_groups])
            except Exception as e:  # noqa: BLE001 — degrade per model
                log.debug("bulk slice versions failed: %s", e)
                bulk_metrics = None
        self._close_span(versions)
        # Scale-to-zero config resolves per NAMESPACE (a deepcopy), not
        # per model — hoisted out of the per-model loop.
        s2z_by_ns: dict[str, object] = {}

        def s2z_cfg_for(ns: str):
            if ns not in s2z_by_ns:
                s2z_by_ns[ns] = \
                    self.config.scale_to_zero_config_for_namespace(ns)
            return s2z_by_ns[ns]

        hashing = self._open_span("hash", models=len(model_groups))
        self._shadow_tick = {}
        for key in sorted(model_groups):
            model_vas = model_groups[key]
            fp = None
            if self.incremental_enabled:
                pair = (model_vas[0].spec.model_id,
                        model_vas[0].metadata.namespace)
                try:
                    fp = self._model_fingerprint(
                        model_vas, snap, collector,
                        queries=fp_queries,
                        pods_for_ns=pods_for_ns, pod_epoch=pod_epoch,
                        group_key=key, use_delta=use_delta,
                        metrics_fp=(bulk_metrics.get(pair)
                                    if bulk_metrics is not None else None),
                        s2z_cfg_for=s2z_cfg_for)
                except Exception as e:  # noqa: BLE001 — a fingerprint
                    # failure must degrade to "dirty", never fail the tick.
                    log.debug("fingerprint failed for %s: %s", key, e)
                    fp = None
                if use_delta and self.fp_assert:
                    self._assert_fp_equivalence(
                        key, fp, model_vas, snap, collector, fp_queries,
                        pods_for_ns)
            fingerprints[key] = fp
            if (gate_open and fp is not None
                    and key in self._decision_memo
                    and fp == self._fingerprints.get(key)
                    and not self._route_is_global(model_vas, use_slo)
                    and not self._tuner_active(model_vas, use_slo)):
                clean.add(key)
        self._close_span(hashing)
        return clean, fingerprints

    def _assert_fp_equivalence(self, key: str, fp: tuple | None, model_vas,
                               snap, collector, fp_queries,
                               pods_for_ns) -> None:
        """WVA_FP_ASSERT: recompute the legacy fingerprint alongside the
        versioned one and raise when their equality-vs-last-analyzed
        dynamics diverge (a missed dirtiness in the delta plane would
        freeze a model on stale decisions — fail loudly instead)."""
        try:
            shadow = self._model_fingerprint(
                model_vas, snap, collector, queries=fp_queries,
                pods_for_ns=pods_for_ns, pod_epoch=None,
                group_key=key, use_delta=False)
        except Exception:  # noqa: BLE001 — same degrade rule as the gate
            shadow = None
        self._shadow_tick[key] = shadow
        prev_fp = self._fingerprints.get(key)
        prev_shadow = self._fp_shadow.get(key)
        if (fp is None or shadow is None
                or prev_fp is None or prev_shadow is None):
            return
        if (fp == prev_fp) != (shadow == prev_shadow):
            raise AssertionError(
                f"fingerprint equivalence violated for {key}: versioned "
                f"{'clean' if fp == prev_fp else 'dirty'} vs recomputed "
                f"{'clean' if shadow == prev_shadow else 'dirty'}")

    def _model_fingerprint(self, model_vas: list[VariantAutoscaling],
                           snap: KubeClient,
                           collector: ReplicaMetricsCollector,
                           queries: tuple[str, ...] = FINGERPRINT_QUERIES,
                           pods_for_ns=None, pod_epoch=None,
                           group_key: str = "", use_delta: bool = False,
                           metrics_fp: tuple | None = None,
                           s2z_cfg_for=None,
                           ) -> tuple | None:
        """The model's decision inputs as a comparable tuple, or None when
        the metrics plane is not fingerprintable (no grouped view — the
        model then never skips). Components: config mutation epoch, per-VA
        spec identity (generation moves on spec edits, never on our own
        status writes) + labels + last written alloc, scale-target
        resourceVersion/replica shape, the pod set (when the snapshot
        covers Pods — informer-backed, so the read is free), and the
        tick's demuxed grouped metric slices including the scale-to-zero
        request count over the namespace's retention window.

        ``use_delta`` (WVA_FP_DELTA) keeps every component's VALUE
        identical but derives it incrementally: VA/target parts are
        memoized per frozen ``object_version`` (an unreplaced store object
        cannot have changed), per-model pod parts per informer pod-set
        epoch, and the metrics part records SliceVersionBook versions —
        which move iff the recomputed digest would — instead of the full
        value tuples."""
        source = getattr(collector, "source", None)
        if not isinstance(source, GroupedMetricsView):
            return None
        namespace = model_vas[0].metadata.namespace
        model_id = model_vas[0].spec.model_id
        parts: list[tuple] = [("epoch", self.config.mutation_epoch())]
        selectors: list[dict] = []
        for va in sorted(model_vas, key=lambda v: v.metadata.name):
            parts.append(self._va_part(va, use_delta))
            ref = va.spec.scale_target_ref
            if not ref.name:
                continue
            target = snap.try_get(ref.kind, va.metadata.namespace, ref.name)
            if target is None:
                parts.append(("target-missing", ref.kind, ref.name))
                continue
            tgt_part, selector = self._target_part(target, ref.kind,
                                                   use_delta)
            parts.append(tgt_part)
            if selector:
                selectors.append(selector)
        if selectors:
            parts.extend(self._pod_parts(group_key, namespace, selectors,
                                         pods_for_ns, pod_epoch, use_delta))
        params = {PARAM_MODEL_ID: model_id, PARAM_NAMESPACE: namespace}
        if metrics_fp is None:
            metrics_fp = (source.slice_versions(queries, params)
                          if use_delta
                          else source.slice_fingerprint(queries, params))
        parts.append(("metrics", metrics_fp))
        # The enforcer's scale-to-zero trigger is a request count over a
        # retention window SLIDING with time: after traffic stops, the
        # count keeps changing (decaying) with no other input moving, and
        # the model must stay dirty until it reaches zero — otherwise the
        # 0-request transition the enforcer acts on would wait for the
        # periodic resync.
        s2z_cfg = (s2z_cfg_for(namespace) if s2z_cfg_for is not None else
                   self.config.scale_to_zero_config_for_namespace(namespace))
        if is_scale_to_zero_enabled(s2z_cfg, model_id):
            retention = scale_to_zero_retention_seconds(s2z_cfg, model_id)
            s2z_params = {
                **params,
                PARAM_RETENTION_PERIOD: format_promql_duration(retention)}
            parts.append(("s2z", (source.slice_versions(
                (QUERY_MODEL_REQUEST_COUNT,), s2z_params) if use_delta
                else source.slice_fingerprint(
                    (QUERY_MODEL_REQUEST_COUNT,), s2z_params))))
        return tuple(parts)

    def _va_part(self, va: VariantAutoscaling, use_delta: bool) -> tuple:
        """The VA's fingerprint component, memoized per frozen
        object_version on the delta path: a store object that was not
        replaced cannot have changed, so the label sort and tuple build
        run once per actual write instead of once per tick."""
        if use_delta:
            ver = frz.object_version(va)
            if ver:
                key = (va.metadata.namespace, va.metadata.name)
                hit = self._va_part_memo.get(key)
                if hit is not None and hit[0] == ver:
                    return hit[1]
                part = self._va_part_value(va)
                self._va_part_memo[key] = (ver, part)
                return part
        return self._va_part_value(va)

    @staticmethod
    def _va_part_value(va: VariantAutoscaling) -> tuple:
        alloc = va.status.desired_optimized_alloc
        return (
            "va", va.metadata.namespace, va.metadata.name,
            va.metadata.generation,
            tuple(sorted((va.metadata.labels or {}).items())),  # fp-lint:
            alloc.num_replicas, alloc.accelerator)  # bounded (one VA)

    def _target_part(self, target, kind: str,
                     use_delta: bool) -> tuple[tuple, object]:
        """(fingerprint component, selector) for one scale target,
        memoized per frozen object_version on the delta path."""
        if use_delta:
            ver = frz.object_version(target)
            if ver:
                key = (target.metadata.namespace, target.metadata.name,
                       kind)
                hit = self._target_part_memo.get(key)
                if hit is not None and hit[0] == ver:
                    return hit[1], hit[2]
                part, selector = self._target_part_value(target, kind)
                self._target_part_memo[key] = (ver, part, selector)
                return part, selector
        return self._target_part_value(target, kind)

    @staticmethod
    def _target_part_value(target, kind: str) -> tuple[tuple, object]:
        status = getattr(target, "status", None)
        part = (
            "target", kind, target.metadata.name,
            target.metadata.resource_version,
            getattr(target, "replicas", None),
            getattr(status, "replicas", None),
            getattr(status, "ready_replicas", None))
        return part, getattr(target, "selector", None)

    def _pod_parts(self, group_key: str, namespace: str, selectors,
                   pods_for_ns, pod_epoch, use_delta: bool) -> tuple:
        """The model's selector-matched pod components. On the delta path
        the filtered tuple is memoized per (informer pod-set epoch,
        selector identity): an unchanged epoch proves the namespace's pod
        set did not move, so the per-model labels_match walk is skipped
        entirely — no pod listing, no matching, O(1) per model."""
        epoch = (pod_epoch(namespace)
                 if use_delta and pod_epoch is not None else None)
        sel_key: tuple = ()
        if epoch is not None:
            sel_key = tuple(  # fp-lint: bounded (a selector's few labels)
                tuple(sorted(s.items())) for s in selectors)  # fp-lint: ^
            hit = self._pod_parts_memo.get(group_key)
            if hit is not None and hit[0] == epoch and hit[1] == sel_key:
                return hit[2]
        shapes = pods_for_ns(namespace) if pods_for_ns is not None else None
        if shapes is None:
            return ()  # snapshot does not cover Pods: nothing to memoize
        out = tuple(
            ("pod", name, phase, ready, pod_ip)
            for name, labels, phase, ready, pod_ip in shapes
            if any(labels_match(sel, labels) for sel in selectors))
        if epoch is not None:
            # An EMPTY walk memoizes too (the scale-to-zero steady state:
            # selector-bearing targets with no pods) — otherwise those
            # namespaces would re-list Pods every tick forever.
            self._pod_parts_memo[group_key] = (epoch, sel_key, out)
        return out

    def _route_is_global(self, model_vas: list[VariantAutoscaling],
                         use_slo: bool) -> bool:
        if not use_slo:
            return False
        return self.config.saturation_optimizer_name_for_namespace(
            model_vas[0].metadata.namespace) == "global"

    def _tuner_active(self, model_vas: list[VariantAutoscaling],
                      use_slo: bool) -> bool:
        """Tuner-enabled namespaces never skip: the EKF extracts
        information from REPEATED observations of the same telemetry (its
        covariance tightens every step), so an unchanged-input skip would
        freeze profile refinement exactly when traffic is steady — the
        condition it learns best under."""
        if not use_slo:
            return False
        return self.config.slo_tuner_enabled_for_namespace(
            model_vas[0].metadata.namespace)

    def _reemit_memoized(self, group_key: str,
                         model_vas: list[VariantAutoscaling],
                         into: list[VariantDecision]) -> None:
        """Append isolated copies of the model's memoized pre-limiter
        decisions and record the skip as a trace stage (replay treats
        re-emitted models like no-record models — their decisions were
        verified the cycle they were computed)."""
        cached = [d.isolated_copy()
                  for d in self._decision_memo.get(group_key, [])]
        into.extend(cached)
        if self.flight is not None:
            self.flight.record_stage(STAGE_FINGERPRINT_SKIP, {
                "model_id": model_vas[0].spec.model_id,
                "namespace": model_vas[0].metadata.namespace,
                "reemitted_decisions": len(cached),
            })

    def _memoize_model(self, group_key: str, fingerprints: dict,
                       decisions: list[VariantDecision]) -> None:
        """Store a model's analyzed outcome for heartbeat re-emission.
        Decisions are memoized PRE-limiter (the limiter re-clamps the
        merged set each tick against current inventory)."""
        fp = fingerprints.get(group_key)
        if fp is None:
            # Not fingerprintable this tick: make sure no stale memo can
            # pair with a stale fingerprint later.
            self._decision_memo.pop(group_key, None)
            self._fingerprints.pop(group_key, None)
            self._fp_shadow.pop(group_key, None)
            return
        self._decision_memo[group_key] = [d.isolated_copy()
                                          for d in decisions]
        self._fingerprints[group_key] = fp
        if self.fp_assert:
            # The shadow baseline follows the same update discipline as
            # the real fingerprint (only analyzed models move it), so the
            # equivalence check compares like with like.
            shadow = self._shadow_tick.get(group_key)
            if shadow is not None:
                self._fp_shadow[group_key] = shadow
            else:
                self._fp_shadow.pop(group_key, None)

    def _invalidate_model(self, group_key: str) -> None:
        """Analysis failed (safety net): force re-analysis next tick."""
        self._decision_memo.pop(group_key, None)
        self._fingerprints.pop(group_key, None)
        self._fp_shadow.pop(group_key, None)

    def _prune_incremental_state(self, active_group_keys: set[str]) -> None:
        for book in (self._fingerprints, self._decision_memo,
                     self._fp_shadow, self._pod_parts_memo):
            for key in list(book):
                if key not in active_group_keys:
                    book.pop(key, None)
        # The per-object component memos are keyed by (ns, name[, kind]),
        # not group key; bound them against slow leaks from churned
        # VAs/targets by dropping the excess once they outgrow the live
        # fleet (2 VAs + 2 targets per model is the common shape).
        bound = 8 * max(len(active_group_keys), 1) + 64
        for memo in (self._va_part_memo, self._target_part_memo):
            if len(memo) > bound:
                memo.clear()

    def _emit_control_plane_metrics(self) -> None:
        """Dirty-set + informer-freshness gauges: operators alerting on
        staleness need to see a wedged watch stream (age past the resync
        interval) and how much of the fleet each tick actually analyzes."""
        registry = getattr(self.actuator, "registry", None)
        if registry is None:
            return
        registry.set_gauge(WVA_TICK_MODELS_ANALYZED, {},
                           float(self.last_tick_stats.get("analyzed", 0)))
        registry.set_gauge(WVA_TICK_MODELS_SKIPPED, {},
                           float(self.last_tick_stats.get("skipped", 0)))
        self._emit_resilience_metrics(registry)
        stats = getattr(self.client, "stats", None)
        if not callable(stats) or not getattr(self.client, "lists_are_local",
                                              False):
            return
        for kind, st in sorted(stats().items()):
            labels = {LABEL_KIND: kind}
            registry.set_gauge(WVA_INFORMER_SYNCED, labels, st["synced"])
            if st["age_seconds"] >= 0:
                registry.set_gauge(WVA_INFORMER_AGE_SECONDS, labels,
                                   st["age_seconds"])

    def _emit_resilience_metrics(self, registry) -> None:
        """wva_boot_* / wva_leader_epoch / wva_checkpoint_* gauges
        (wva_tpu_torch/resilience). Emitted only when the corresponding piece is
        wired — a resilience-off build exports no new series."""
        if self.boot_ramp is not None:
            registry.set_gauge(WVA_BOOT_RAMP_MODELS_HELD, {},
                               float(len(self._tick_ramp_holds)))
        if self.boot_report is not None:
            for source, count in (
                    ("held", self.boot_report.held_seeded),
                    ("orders", self.boot_report.orders_restored),
                    ("stockouts", self.boot_report.stockouts_restored),
                    ("health_books",
                     self.boot_report.health_books_restored),
                    ("trust", self.boot_report.trust_restored),
                    ("leadtime",
                     self.boot_report.leadtime_rings_restored)):
                registry.set_gauge(WVA_BOOT_RECOVERED_ITEMS,
                                   {LABEL_SOURCE: source}, float(count))
        if self._tick_epoch is not None:
            registry.set_gauge(WVA_LEADER_EPOCH, {},
                               float(self._tick_epoch))
        if self.checkpointer is not None:
            registry.set_gauge(WVA_CHECKPOINT_WRITES, {},
                               float(self.checkpointer.saves))
            if self.checkpointer.last_saved_at >= 0:
                registry.set_gauge(WVA_CHECKPOINT_LAST_SAVE_TIMESTAMP, {},
                                   self.checkpointer.last_saved_at)

    # --- V1 path ---

    def _optimize_v1(
        self, model_groups: dict[str, list[VariantAutoscaling]],
        snap: KubeClient,
        collector: ReplicaMetricsCollector | None = None,
        clean: set[str] | None = None,
        fingerprints: dict[str, tuple | None] | None = None,
    ) -> list[VariantDecision]:
        collector = collector or self.collector
        clean = clean or set()
        fingerprints = fingerprints or {}
        # Stage 1 — per-model prepare + analyze, fanned across the worker
        # pool. Workers only touch thread-safe state (snapshot reads,
        # collector refresh, the stateless V1 analyzer); exceptions from
        # data preparation stay isolated per model exactly as in the serial
        # loop (analysis errors still fail the tick into the retry loop).
        # Clean models (unchanged fingerprint) never reach a worker.
        def analyze_one(group_key: str, model_vas: list[VariantAutoscaling]):
            if group_key in clean:
                return ("clean", None)
            model_id = model_vas[0].spec.model_id
            namespace = model_vas[0].metadata.namespace
            with self._model_span(model_id, namespace):
                return analyze_one_inner(model_id, namespace, model_vas)

        def analyze_one_inner(model_id: str, namespace: str,
                              model_vas: list[VariantAutoscaling]):
            sat_cfg = self.config.saturation_config_for_namespace(
                namespace).get("default")
            if sat_cfg is None:
                log.info("No default saturation config for namespace %s; "
                         "skipping model %s", namespace, model_id)
                return ("skip", None)
            try:
                with self._obs_span("prepare"):
                    data = self._prepare_model_data(model_id, model_vas,
                                                    snap,
                                                    collector=collector)
            except Exception as e:  # noqa: BLE001 — per-model isolation
                return ("safety-net", e)
            if data is None:
                return ("skip", None)
            with self._obs_span("analyze"):
                analysis = self.v1_analyzer.analyze_model_saturation(
                    model_id, namespace, data.replica_metrics, sat_cfg)
                targets = self.v1_analyzer.calculate_saturation_targets(
                    analysis, data.variant_states)
            return ("ok", (data, analysis, targets, sat_cfg))

        outcomes = self._map_models(model_groups, analyze_one)

        # Stage 2 — enforcement, flight recording, and decision merge on the
        # engine thread in sorted model-key order: the per-model outputs are
        # order-independent, but the trace records, safety-net emissions and
        # decision list must be byte-deterministic at any pool width.
        all_decisions: list[VariantDecision] = []
        for group_key in sorted(model_groups):
            model_vas = model_groups[group_key]
            model_id = model_vas[0].spec.model_id
            namespace = model_vas[0].metadata.namespace
            status, value = outcomes[group_key]
            if status == "clean":
                self._reemit_memoized(group_key, model_vas, all_decisions)
                continue
            if status == "skip":
                # Recomputing next tick is as cheap as re-skipping and a
                # gated-out model's inputs may gate differently: memoize
                # "no decisions" so a clean fingerprint can skip it too.
                self._memoize_model(group_key, fingerprints, [])
                continue
            if status == "safety-net":
                log.error("Model data preparation failed for %s: %s",
                          model_id, value)
                self._invalidate_model(group_key)
                self._emit_safety_net_metrics(model_vas, snap)
                continue
            data, analysis, targets, sat_cfg = value
            self._note_coverage(group_key, data)
            saturation_targets = dict(targets)  # pre-enforcement snapshot

            s2z_cfg = self.config.scale_to_zero_config_for_namespace(namespace)
            targets, scaled_to_zero = self.enforcer.enforce_policy(
                model_id, namespace, targets, analysis.variant_analyses, s2z_cfg)
            if scaled_to_zero:
                log.info("Scale-to-zero enforcement applied for %s", model_id)

            if self.flight is not None:
                self.flight.record_model({
                    "model_id": model_id, "namespace": namespace,
                    "path": "v1",
                    "input": {
                        "replica_metrics": data.replica_metrics,
                        "variant_states": data.variant_states,
                        "config": sat_cfg,
                        "scheduler_queue": None,
                    },
                    "analysis": analysis,
                    "targets": saturation_targets,
                    "enforced_targets": dict(targets),
                    "scaled_to_zero": scaled_to_zero,
                })

            model_decisions = saturation_targets_to_decisions(
                targets, analysis, data.variant_states,
                enforcer_note=(SCALE_TO_ZERO_REASON
                               if scaled_to_zero else ""))
            all_decisions.extend(model_decisions)
            self._memoize_model(group_key, fingerprints, model_decisions)

        self._assess_health(model_groups, collector)
        self._apply_limiter(all_decisions)
        return all_decisions

    # --- V2 path ---

    def _optimize_v2(
        self, model_groups: dict[str, list[VariantAutoscaling]],
        snap: KubeClient,
        use_slo: bool = False,
        collector: ReplicaMetricsCollector | None = None,
        clean: set[str] | None = None,
        fingerprints: dict[str, tuple | None] | None = None,
    ) -> list[VariantDecision]:
        collector = collector or self.collector
        clean = clean or set()
        fingerprints = fingerprints or {}
        requests: list[ModelScalingRequest] = []
        # Clean models' memoized decisions, re-emitted after the fresh
        # models' optimizer/enforcer/forecast stages (they already carry
        # their own enforcement + floors from the cycle that computed them;
        # only the limiter re-runs over the merged set).
        cached_decisions: list[VariantDecision] = []
        # Optimizer route per (model, namespace), resolved ONCE from the
        # same sat_cfg snapshot the analysis used — the trace record and the
        # global/local split below must agree by construction, or a config
        # hot-reload mid-tick makes replay diverge from what actually ran.
        routes: dict[tuple[str, str], str] = {}
        slo_cfg_by_ns: dict[str, object] = {}
        if use_slo:
            slo_cfg_by_ns = self._sync_slo_config(model_groups)

        # Stage 1 — per-model prepare + analyze across the worker pool.
        # V2 runs its full (thread-safe, per-model-keyed) analysis in the
        # worker; the SLO path stops at a SizingPlan so every model's
        # candidates can be sized in ONE device dispatch below. The trend
        # update lives in finalize(), which stays on the engine thread.
        def analyze_one(group_key: str, model_vas: list[VariantAutoscaling]):
            if group_key in clean:
                return ("clean", None)
            model_id = model_vas[0].spec.model_id
            namespace = model_vas[0].metadata.namespace
            with self._model_span(model_id, namespace):
                return analyze_one_inner(model_id, namespace, model_vas)

        def analyze_one_inner(model_id: str, namespace: str,
                              model_vas: list[VariantAutoscaling]):
            sat_cfg = self.config.saturation_config_for_namespace(
                namespace).get("default")
            if sat_cfg is None:
                log.info("No default saturation config for namespace %s; "
                         "skipping model %s", namespace, model_id)
                return ("skip", None)
            sat_cfg.apply_defaults()
            try:
                with self._obs_span("prepare"):
                    data = self._prepare_model_data(model_id, model_vas,
                                                    snap,
                                                    collector=collector)
            except Exception as e:  # noqa: BLE001 — per-model isolation
                return ("safety-net", ("Model data preparation", e))
            if data is None:
                return ("skip", None)
            scheduler_queue = collector.collect_scheduler_queue_metrics(
                model_id)
            try:
                with self._obs_span("analyze"):
                    if use_slo:
                        out = self._prepare_slo_plan(
                            model_id, namespace, data, sat_cfg,
                            slo_cfg_by_ns.get(namespace), scheduler_queue,
                            collector=collector)
                    else:
                        out = self._run_v2_analysis(
                            model_id, namespace, data, sat_cfg,
                            scheduler_queue)
            except Exception as e:  # noqa: BLE001 — per-model isolation
                return ("safety-net",
                        (("SLO" if use_slo else "V2") + " analysis", e))
            return ("ok", (data, sat_cfg, scheduler_queue, out))

        # Same-model groups across namespaces share analyzer state (V2 k2
        # history, capacity records): chain them into one worker so their
        # state evolution is sorted-order deterministic.
        outcomes = self._map_models(
            model_groups, analyze_one,
            affinity=lambda key, vas: vas[0].spec.model_id)

        # Cross-model solver batching (SLO path): every model's candidate
        # set rides ONE padded, shape-bucketed jitted call — a 50-model tick
        # costs one device dispatch instead of 50. Per-plan slices are cut
        # back out in the same sorted order they were concatenated.
        sized: dict[str, list[float]] = {}
        sizing_errors: dict[str, Exception] = {}
        fused_prep = None
        if use_slo:
            # Worker outcome shape: ("ok", (data, sat_cfg, scheduler_queue,
            # SizingPlan)) — name the plans once instead of reaching through
            # tuple indices at every use site.
            plans = {k: value[3] for k, (status, value) in outcomes.items()
                     if status == "ok"}
            batch_keys = [k for k in sorted(plans)
                          if plans[k].needs_sizing]
            batched_ok = False
            if self.fused_enabled and batch_keys:
                # One-jitted-program decision plane (WVA_FUSED): sizing +
                # forecast fits in ONE dispatch; the fleet solve below
                # reuses the sized pairs. Grid build and dispatch degrade
                # separately: a dispatch failure KEEPS the prepared
                # forecast pass (whose learning mutations already ran) so
                # the staged fallback fits over the prepared grids
                # instead of re-observing this tick's demand — the
                # degradation path stays byte-identical to WVA_FUSED=off.
                grids = None
                try:
                    with self._obs_span("fused_grids"):
                        grids, fused_prep = self._fused_prepare(
                            plans, batch_keys, outcomes, slo_cfg_by_ns)
                except Exception as e:  # noqa: BLE001 — the lever must
                    # degrade to the staged path, never fail the tick.
                    log.warning("Fused grid build failed (%s); staged "
                                "dispatches this tick", e)
                    fused_prep = None
                if grids is not None:
                    try:
                        with self._obs_span("fused_dispatch",
                                            models=len(batch_keys),
                                            rows=grids.n_candidates):
                            sized = self._fused_dispatch(grids, fused_prep)
                        batched_ok = True
                    except Exception as e:  # noqa: BLE001 — same.
                        log.warning("Fused decision program failed (%s); "
                                    "falling back to staged dispatches",
                                    e)
                        sized = {}
                        self._tick_presized = None
            if not batched_ok and self.solver_batching and batch_keys:
                all_candidates = [c for k in batch_keys
                                  for c in plans[k].candidates]
                try:
                    per_replica = self.slo_analyzer.size_candidates(
                        all_candidates)
                    offset = 0
                    for k in batch_keys:
                        n = len(plans[k].candidates)
                        sized[k] = per_replica[offset:offset + n]
                        offset += n
                    batched_ok = True
                except Exception as e:  # noqa: BLE001 — one poisoned
                    # candidate must not fail the whole tick: fall back to
                    # per-model dispatches so only the bad model pays.
                    log.warning("Batched SLO sizing failed (%s); falling "
                                "back to per-model sizing", e)
            if not batched_ok:
                for k in batch_keys:
                    try:
                        sized[k] = self.slo_analyzer.size_candidates(
                            plans[k].candidates)
                    except Exception as e:  # noqa: BLE001 — per-model
                        sizing_errors[k] = e  # isolation (safety net below)

        # Stage 2 — finalize, record, and merge on the engine thread in
        # sorted model-key order (trend updates, trace records and the
        # request list stay byte-deterministic at any pool width).
        #
        # Vectorized decision stage (WVA_VEC_DECIDE): finalize's
        # supply/demand algebra runs as ONE fleet-wide numpy float64
        # column pass over the eligible models — in the SAME sorted order
        # the loop below walks, so the per-key trend estimators evolve
        # byte-identically. The loop then consumes the precomputed
        # results; an errored model degrades alone through the same
        # invalidate + safety-net path as a per-model finalize raise.
        decide = self._open_span("decide")
        finalize = self._open_span("finalize")
        vec_finalized: dict[str, object] = {}
        vec_finalize_errors: dict[str, Exception] = {}
        if self.vec_decide and use_slo:
            vec_items = []
            for group_key in sorted(model_groups):
                status, value = outcomes[group_key]
                if status != "ok" or group_key in sizing_errors:
                    continue
                plan = value[3]
                if not plan.needs_sizing:
                    continue
                vec_items.append((group_key, plan,
                                  sized.get(group_key, [])))
            if vec_items:
                with self._obs_span("vec_finalize",
                                    models=len(vec_items)):
                    vec_finalized, vec_finalize_errors = \
                        vectorized.finalize_fleet(
                            self.slo_analyzer, vec_items,
                            assert_mode=self.vec_assert)
        # The model records, encoded after the loop in its order, so their
        # encoding is one span and not one per model.
        to_record: list[dict] = []
        for group_key in sorted(model_groups):
            model_vas = model_groups[group_key]
            model_id = model_vas[0].spec.model_id
            namespace = model_vas[0].metadata.namespace
            status, value = outcomes[group_key]
            if status == "clean":
                self._reemit_memoized(group_key, model_vas, cached_decisions)
                continue
            if status == "skip":
                self._memoize_model(group_key, fingerprints, [])
                continue
            if status == "safety-net":
                stage, err = value
                log.error("%s failed for %s: %s", stage, model_id, err)
                self._invalidate_model(group_key)
                self._emit_safety_net_metrics(model_vas, snap)
                continue
            data, sat_cfg, scheduler_queue, out = value
            self._note_coverage(group_key, data)
            if group_key in sizing_errors:
                log.error("SLO sizing failed for %s: %s", model_id,
                          sizing_errors[group_key])
                self._invalidate_model(group_key)
                self._emit_safety_net_metrics(model_vas, snap)
                continue
            if use_slo:
                if not out.needs_sizing:
                    # Gated out before sizing (no config/targets/telemetry/
                    # candidates): the skeleton result is final, and the
                    # trend series must NOT be fed — same as the monolithic
                    # analyze() early returns.
                    result = out.result
                elif group_key in vec_finalized:
                    result = vec_finalized[group_key]
                else:
                    err = vec_finalize_errors.get(group_key)
                    result = None
                    if err is None:
                        try:
                            result = self.slo_analyzer.finalize(
                                out, sized.get(group_key, []))
                        except Exception as e:  # noqa: BLE001 — per-model
                            err = e  # isolation (handled just below)
                    if err is not None:
                        log.error("SLO analysis failed for %s: %s",
                                  model_id, err)
                        self._invalidate_model(group_key)
                        self._emit_safety_net_metrics(model_vas, snap)
                        continue
            else:
                result = out
            if use_slo and not result.variant_capacities:
                # No SLO targets/profiles for this model -> leave it to its
                # current replica count rather than emitting zero-capacity
                # decisions.
                log.debug("SLO analyzer produced no capacities for %s; skipped",
                          model_id)
                self._memoize_model(group_key, fingerprints, [])
                continue
            routes[(model_id, namespace)] = \
                ("global" if use_slo and sat_cfg.optimizer_name == "global"
                 else "cost-aware")
            if self.flight is not None:
                to_record.append({
                    "model_id": model_id, "namespace": namespace,
                    "path": "slo" if use_slo else "v2",
                    # The route the optimizer split below actually takes, so
                    # replay knows whether cost-aware replay is possible.
                    "optimizer": routes[(model_id, namespace)],
                    "input": {
                        "replica_metrics": data.replica_metrics,
                        "variant_states": data.variant_states,
                        "config": sat_cfg,
                        "scheduler_queue": scheduler_queue,
                    },
                    "result": result,
                })
            requests.append(ModelScalingRequest(
                model_id=model_id, namespace=namespace, result=result,
                variant_states=data.variant_states))
        self._close_span(finalize)
        if to_record:
            with self._obs_span("record", models=len(to_record)):
                for payload in to_record:
                    self.flight.record_model(payload)

        # Health classification needs this tick's coverage (captured in the
        # merge above) and must exist BEFORE forecast floors consume the
        # blackout set — and even on all-quiet ticks, for the status
        # condition and gauges.
        self._assess_health(model_groups, collector)

        if not requests and not cached_decisions:
            if self.capacity is not None:
                # The limiter (where the per-tick demand snapshot normally
                # resets) is skipped on this path: clear it explicitly or
                # the capacity pass would provision against LAST tick's
                # demand.
                self.capacity.note_demand([])
            # This path skips _apply_forecast (nothing to plan), but the
            # gauge sweep must still run: a worker whose LAST owned model
            # was deleted would otherwise export that model's forecast
            # gauges forever (live groups stay protected via active).
            self._sweep_forecast_gauges(
                set(), {(vas[0].spec.model_id, vas[0].metadata.namespace)
                        for vas in model_groups.values()})
            self._close_span(decide)
            return []

        decisions: list[VariantDecision] = []
        if requests:
            # Optimizer selection respects namespace-local config
            # (optimizerName is resolved per request's namespace, like every
            # other knob) — using the route resolved above, from the same
            # config snapshot the analysis and the trace record saw.
            global_reqs: list[ModelScalingRequest] = []
            local_reqs: list[ModelScalingRequest] = []
            for req in requests:
                if routes[(req.model_id, req.namespace)] == "global":
                    global_reqs.append(req)
                else:
                    local_reqs.append(req)
            if self.shard_ctx is not None and global_reqs:
                # Shard-worker role: fleet-solved models ship as compact
                # demand/latency/capacity arrays in the summary — the
                # solve couples every shard's models, so only the fleet
                # lease-holder may run it (docs/design/sharding.md).
                # Encoded with the rest of the capture, after the stage.
                self.shard_ctx.global_requests = global_reqs
                global_reqs = []
            optimize = self._open_span("optimize")
            if global_reqs:
                decisions.extend(
                    self._optimize_global(global_reqs, slo_cfg_by_ns))
            if local_reqs:
                self._trace_section("optimizer")
                # Vectorized decision stage (WVA_VEC_DECIDE): the
                # cost-aware greedy fills run as masked [M, V] column
                # passes across every request at once; custom optimizers
                # keep their per-request loop.
                if (self.vec_decide
                        and type(self.optimizer) is CostAwareOptimizer):
                    local_decisions = vectorized.cost_aware_fleet(
                        self.optimizer, local_reqs)
                    if self.vec_assert:
                        saved_fr = self.optimizer.flight_recorder
                        self.optimizer.flight_recorder = None
                        try:
                            shadow = self.optimizer.optimize(
                                local_reqs, None)
                        finally:
                            self.optimizer.flight_recorder = saved_fr
                        vectorized.assert_equal_decisions(
                            local_decisions, shadow, "optimizer")
                    decisions.extend(local_decisions)
                else:
                    decisions.extend(
                        self.optimizer.optimize(local_reqs, None))
            self._close_span(optimize)

            # Enforcer bridge per model (reference engine_v2.go:76-127) —
            # shared with the trace replay harness (pipeline.bridge_enforce).
            # A shard worker enforces only its locally-optimized models:
            # fleet-solved decisions do not exist yet — the fleet runs the
            # same bridge over them after the solve.
            enforce = self._open_span("enforce")
            self._trace_section("enforce")
            enforce_keys = [
                (req.model_id, req.namespace) for req in requests
                if not (self.shard_ctx is not None
                        and routes[(req.model_id, req.namespace)]
                        == "global")]
            if self.vec_decide:
                # WVA_VEC_DECIDE: one grouping pass + per-model slices
                # instead of rescanning the whole decision list per model
                # (O(decisions) total vs O(models x decisions)).
                # isolated_copy, not deepcopy: stages rebind scalars and
                # append (immutable) steps — the shadow enforce pass
                # needs no deeper isolation, and the hot-path lint
                # forbids deepcopy here.
                shadow_decisions = (
                    [d.isolated_copy() for d in decisions]
                    if self.vec_assert else None)
                vectorized.enforce_fleet(
                    decisions, enforce_keys, self.enforcer,
                    self.config.scale_to_zero_config_for_namespace,
                    now=self.clock.now,
                    optimizer_name=self.optimizer.name(),
                    on_scaled_to_zero=lambda mid, _ns: log.info(
                        "Scale-to-zero enforcement applied (V2) for %s",
                        mid))
                if shadow_decisions is not None:
                    saved_fr = self.enforcer.flight_recorder
                    self.enforcer.flight_recorder = None
                    try:
                        for model_id, namespace in enforce_keys:
                            bridge_enforce(
                                shadow_decisions, model_id, namespace,
                                self.enforcer,
                                self.config
                                .scale_to_zero_config_for_namespace(
                                    namespace),
                                now=self.clock.now(),
                                optimizer_name=self.optimizer.name())
                    finally:
                        self.enforcer.flight_recorder = saved_fr
                    vectorized.assert_equal_decisions(
                        decisions, shadow_decisions, "enforcer")
            else:
                for model_id, namespace in enforce_keys:
                    s2z_cfg = \
                        self.config.scale_to_zero_config_for_namespace(
                            namespace)
                    scaled_to_zero = bridge_enforce(
                        decisions, model_id, namespace, self.enforcer,
                        s2z_cfg, now=self.clock.now(),
                        optimizer_name=self.optimizer.name())
                    if scaled_to_zero:
                        log.info("Scale-to-zero enforcement applied (V2) "
                                 "for %s", model_id)
            self._close_span(enforce)
            self._trace_section("models")

        with self._obs_span("forecast"):
            self._apply_forecast(
                requests, decisions, routes,
                active_keys={(vas[0].spec.model_id,
                              vas[0].metadata.namespace)
                             for vas in model_groups.values()},
                prepared=fused_prep)

        # Memoize each analyzed model's PRE-limiter decisions (with their
        # enforcement + forecast floors baked in) for heartbeat re-emission,
        # then merge the clean models' cached decisions back; the limiter
        # re-clamps the whole merged set against current inventory.
        fresh_by_key: dict[str, list[VariantDecision]] = {}
        for d in decisions:
            fresh_by_key.setdefault(
                f"{d.model_id}|{d.namespace}", []).append(d)
        for req in requests:
            key = f"{req.model_id}|{req.namespace}"
            self._memoize_model(key, fingerprints,
                                fresh_by_key.get(key, []))
        decisions.extend(cached_decisions)
        with self._obs_span("limiter"):
            self._apply_limiter(decisions)
        self._close_span(decide)
        return decisions

    # --- sharded active-active engine (wva_tpu_torch/shard;
    # --- docs/design/sharding.md) ---

    def _trace_section(self, name: str) -> None:
        """Mark which ordered section of the unsharded in-cycle record
        stream the engine is currently emitting from. Only the shard
        worker's TraceBuffer implements it — the real FlightRecorder (and
        None) ignore sections, so the unsharded paths are untouched."""
        begin = getattr(self.flight, "begin_section", None)
        if begin is not None:
            begin(name)

    def _capture_global_requests(self, reqs: list[ModelScalingRequest]) -> None:
        """Shard-worker role: encode fleet-solved models' analysis outputs
        as compact arrays (the same blackbox codec replay trusts for
        bit-for-bit reproduction) into the tick's capture."""
        from wva_tpu_torch.blackbox.schema import encode as bb_encode
        from wva_tpu_torch.shard.summary import ENTRY_GLOBAL, ModelEntry

        cap = self.shard_ctx.capture
        # Each pair's throughput as this tick's fused program sized it,
        # so the fleet solve reuses the rates instead of sizing again.
        sized: dict[tuple[str, str], dict[str, float]] = {}
        for (model_id, namespace, acc), rate in \
                (self._tick_presized or {}).items():
            sized.setdefault((model_id, namespace), {})[acc] = rate
        for req in reqs:
            key = f"{req.model_id}|{req.namespace}"
            cap.entries[key] = ModelEntry(
                group_key=key, model_id=req.model_id,
                namespace=req.namespace, kind=ENTRY_GLOBAL,
                global_request={
                    "result": bb_encode(req.result),
                    "variant_states": [bb_encode(vs)
                                       for vs in req.variant_states],
                    "presized": sized.get((req.model_id, req.namespace),
                                          {})})

    @staticmethod
    def _decode_global_request(entry) -> ModelScalingRequest:
        from wva_tpu_torch.blackbox.schema import decode as bb_decode
        from wva_tpu_torch.interfaces import AnalyzerResult, VariantReplicaState

        gr = entry.global_request or {}
        return ModelScalingRequest(
            model_id=entry.model_id, namespace=entry.namespace,
            result=bb_decode(AnalyzerResult, gr.get("result")),
            variant_states=[bb_decode(VariantReplicaState, v)
                            for v in gr.get("variant_states", [])])

    def _replay_trace_records(self, records) -> None:
        """Append buffered shard-worker records to the live cycle in the
        given order. Payloads were encoded at capture time by the same
        codec the recorder uses, so re-recording them is byte-identical."""
        if self.flight is None:
            return
        for _section, _gk, _seq, kind, payload in records:
            if kind == "model":
                self.flight.record_model(payload)
            else:
                stage = payload.get("stage", "")
                self.flight.record_stage(
                    stage, {k: v for k, v in payload.items()
                            if k != "stage"})

    def forget_forecast_gauges(self, keys: set[tuple[str, str]]) -> None:
        """Rebalance bookkeeping: a model moved to another shard — drop it
        from THIS worker engine's forecast-gauge tracking set WITHOUT
        removing the registry series (the new owner keeps emitting them;
        a registry.remove here would blank live gauges for a tick)."""
        self._forecast_gauge_keys -= set(keys)
        self._trend_gauge_keys -= set(keys)

    def _shard_analyze(self, model_groups: dict, snap: KubeClient,
                       collector: ReplicaMetricsCollector,
                       prep_start: float) -> None:
        """Shard-worker analysis tick: the unsharded prepare → fingerprint
        → analyze pipeline over the owned consistent-hash partition only,
        ending in a ShardCapture instead of the limiter/apply phases. Every
        per-model quantity (analyzer state, fingerprints, decision memos,
        forecast learning, health classification) evolves exactly as the
        unsharded engine's would for these models — which is what makes
        the fleet's sorted-order merge byte-identical."""
        from wva_tpu_torch.shard.summary import (
            ENTRY_CACHED,
            ENTRY_GLOBAL,
            ENTRY_LOCAL,
            HealthSignals,
            ModelEntry,
        )

        ctx = self.shard_ctx
        owned = {k: v for k, v in model_groups.items()
                 if ctx.owns(v[0].spec.model_id)}
        active_keys = {
            f"{vas[0].metadata.namespace}|{vas[0].spec.model_id}"
            for vas in owned.values()}
        self.v2_analyzer.prune(active_keys)
        self.slo_analyzer.prune(active_keys)

        analyzer_name = ""
        global_cfg = self.config.saturation_config().get("default")
        if global_cfg is not None:
            global_cfg.apply_defaults()
            analyzer_name = global_cfg.analyzer_name

        fp_start = time.perf_counter()
        self._phase_seconds["prepare"] = (
            self._phase_seconds.get("prepare", 0.0) + fp_start - prep_start)
        self._begin_phase_span("fingerprint")
        clean, fingerprints = self._partition_clean(
            owned, snap, collector, analyzer_name)
        self._prune_incremental_state(set(owned))
        self.last_tick_stats = {
            "analyzed": len(owned) - len(clean),
            "skipped": len(clean)}
        analyze_start = time.perf_counter()
        self._phase_seconds["fingerprint"] = analyze_start - fp_start
        self._begin_phase_span("analyze")

        self._tick_coverage = {}
        if analyzer_name in (V2_ANALYZER_NAME, SLO_ANALYZER_NAME):
            decisions = self._optimize_v2(
                owned, snap, use_slo=analyzer_name == SLO_ANALYZER_NAME,
                collector=collector, clean=clean, fingerprints=fingerprints)
        else:
            decisions = self._optimize_v1(owned, snap, collector=collector,
                                          clean=clean,
                                          fingerprints=fingerprints)
        self._phase_seconds["analyze"] = \
            time.perf_counter() - analyze_start

        cap = ctx.capture
        if self.spans is not None:
            self.spans.annotate(self._span_root, owned=sum(
                len(vas) for vas in owned.values()))
        capture = self._open_span("shard_capture", shard=cap.shard_id)
        self._capture_global_requests(ctx.global_requests)
        by_key: dict[str, list[VariantDecision]] = {}
        for d in decisions:
            by_key.setdefault(f"{d.model_id}|{d.namespace}", []).append(d)
        for key in sorted(owned):
            if key in cap.entries:  # fleet-solved: encoded above
                continue
            vas = owned[key]
            cap.entries[key] = ModelEntry(
                group_key=key, model_id=vas[0].spec.model_id,
                namespace=vas[0].metadata.namespace,
                kind=ENTRY_CACHED if key in clean else ENTRY_LOCAL,
                decisions=by_key.get(key, []))
        # Health: the worker's own monitor classified its models inside
        # the analyzer path (_assess_health); ship classification + the
        # proof-of-freshness signals the fleet's gate and ramps consume.
        # The fleet monitor keeps the last-known-good desireds, so holds
        # survive rebalances; only classification state is shard-local.
        for key in sorted(self._tick_health):
            h = self._tick_health[key]
            scraped, ready = self._tick_coverage.get(key, (None, None))
            cap.health[key] = HealthSignals(
                state=h.state, age_seconds=h.age_seconds,
                allow_scale_down=h.allow_scale_down, reason=h.reason,
                age_observed=key in self._tick_age_observed,
                scraped=scraped, ready=ready)
        if self.health is not None:
            self.health.prune(
                set(self._tick_health),
                {(va.metadata.namespace, va.metadata.name)
                 for vas in owned.values() for va in vas})
        cap.analyzed = self.last_tick_stats["analyzed"]
        cap.skipped = self.last_tick_stats["skipped"]
        cap.tick_seq = self._tick_seq
        cap.control_age = self._control_plane_staleness()
        cap.published_at = self.clock.now()
        if capture is not None:
            self.spans.annotate(capture.span, **{
                kind: sum(e.kind == kind for e in cap.entries.values())
                for kind in (ENTRY_LOCAL, ENTRY_GLOBAL, ENTRY_CACHED)})
        self._close_span(capture)

    def _optimize_sharded(self, model_groups: dict, snap: KubeClient,
                          collector: ReplicaMetricsCollector,
                          analyzer_name: str) -> list[VariantDecision]:
        """Fleet role: merge this tick's shard captures in sorted model
        order, run the fleet-level solve over the shards' compact
        summaries, re-run the enforcer bridge for fleet-solved models, and
        hand the merged pre-limiter decision set to the shared limiter →
        health gate → apply pipeline. Models no live shard covered this
        tick produce no decision — the apply phase then holds their
        previous desired, the do-no-harm direction."""
        from wva_tpu_torch.shard.summary import (
            ENTRY_CACHED,
            ENTRY_GLOBAL,
            ENTRY_LOCAL,
            SECTION_ENFORCE,
            SECTION_MODELS,
            SECTION_OPTIMIZER,
            TraceBuffer,
        )
        from wva_tpu_torch.health import InputHealth

        use_slo = analyzer_name == SLO_ANALYZER_NAME
        with self._obs_span("shard_gather") as gather_span:
            tick = self.shard_plane.gather(model_groups, collector=collector,
                                           spans=self.spans,
                                           trace=self.flight is not None)
        if gather_span is not None:
            self.spans.annotate(
                gather_span, alive=len(tick.alive), moves=len(tick.moves),
                stale=len(tick.stale), uncovered=len(tick.uncovered))
        # Stitch: every worker's span subtree — stamped with (fleet tick
        # id, shard id) in its ShardCapture — grafts under THIS tick's
        # span, so a 4-shard fleet tick is still ONE trace.
        if self.spans is not None and tick.spans:
            self.spans.graft(tick.spans)
        merge = self._open_span("fleet_merge", shards=len(tick.alive))

        def section(records, name):
            return sorted((r for r in records if r[0] == name),
                          key=lambda r: (r[1], r[2]))

        # 1. Fleet-level solve over the shards' summaries, then the
        # enforcer bridge for the solved models (records buffered so the
        # merged enforcer stream below stays in sorted request order).
        # The solve records nothing, so the re-emission below keeps the
        # unsharded engine's record order.
        decisions: list[VariantDecision] = []
        keys = sorted(tick.entries)
        global_entries = [tick.entries[k] for k in keys
                          if tick.entries[k].kind == ENTRY_GLOBAL]
        fleet_enforce: list = []
        with self._obs_span("merge_decode", **{"global": len(global_entries)}):
            reqs = [self._decode_global_request(e) for e in global_entries]
            # The workers' fused programs sized every fleet-solved pair:
            # the solve reuses their rates, as the unsharded tick does.
            self._tick_presized = {
                (e.model_id, e.namespace, acc): rate
                for e in global_entries
                for acc, rate in (e.global_request or {}).get(
                    "presized", {}).items()} or None
        if reqs:
            slo_cfg_by_ns = (self._sync_slo_config(model_groups)
                             if use_slo else {})
            decisions.extend(self._optimize_global(reqs, slo_cfg_by_ns))
            buf = TraceBuffer()
            buf.begin_section(SECTION_ENFORCE)
            saved = self.enforcer.flight_recorder
            self.enforcer.flight_recorder = buf
            try:
                if self.vec_decide:
                    # WVA_VEC_DECIDE: one grouping pass over the solved
                    # decisions instead of a full rescan per model.
                    vectorized.enforce_fleet(
                        decisions,
                        [(req.model_id, req.namespace) for req in reqs],
                        self.enforcer,
                        self.config.scale_to_zero_config_for_namespace,
                        now=self.clock.now,
                        optimizer_name=self.optimizer.name(),
                        on_scaled_to_zero=lambda mid, _ns: log.info(
                            "Scale-to-zero enforcement applied "
                            "(fleet solve) for %s", mid))
                else:
                    for req in reqs:
                        s2z_cfg = \
                            self.config.scale_to_zero_config_for_namespace(
                                req.namespace)
                        scaled = bridge_enforce(
                            decisions, req.model_id, req.namespace,
                            self.enforcer, s2z_cfg, now=self.clock.now(),
                            optimizer_name=self.optimizer.name())
                        if scaled:
                            log.info("Scale-to-zero enforcement applied "
                                     "(fleet solve) for %s", req.model_id)
            finally:
                self.enforcer.flight_recorder = saved
            fleet_enforce = buf.records

        with self._obs_span("merge_reemit") as reemit:
            # 2. The per-model record stream, exactly as the unsharded
            # stage-2 merge loop would have emitted it: sorted by group
            # key (records within one group keep their shard-side
            # emission order). 3. + 4. Optimizer stages (shard-local
            # cost-aware passes), then the enforcer stream — shard-local
            # and fleet-solved records merged into one sorted-request-order
            # sequence.
            records = (section(tick.trace, SECTION_MODELS)
                       + section(tick.trace, SECTION_OPTIMIZER)
                       + section(list(tick.trace) + fleet_enforce,
                                 SECTION_ENFORCE))
            self._replay_trace_records(records)

            # 5. ONE merged forecast stage (plans in the planner's own
            # (namespace, model) order across every shard).
            if self.flight is not None and tick.plans:
                def plan_key(p):
                    return (p.get("namespace", ""), p.get("model_id", ""))
                self.flight.record_stage(STAGE_FORECAST, {
                    "plans": sorted(tick.plans, key=plan_key),
                    "floors": sorted(tick.floors, key=plan_key),
                    "raised": tick.raised})

            # 6. Topology-change observability: recorded ONLY when
            # ownership moved (steady-state sharded traces stay
            # byte-identical to the unsharded engine's).
            if self.flight is not None and (tick.moves or tick.stale):
                self.flight.record_stage(STAGE_SHARD, {
                    "moves": list(tick.moves),
                    "holds_opened": sorted(tick.holds_opened),
                    "alive_shards": sorted(tick.alive),
                    "stale_shards": sorted(tick.stale),
                    "uncovered_models": sorted(tick.uncovered),
                })
            if reemit is not None:
                self.spans.annotate(reemit, records=(
                    len(records) if self.flight is not None else 0))

        # 7. Merge decisions. The unsharded orders differ per path: V1
        # interleaves fresh and re-emitted decisions per sorted group; the
        # V2/SLO path appends fleet-solved, then fresh local, then cached.
        if analyzer_name in (V2_ANALYZER_NAME, SLO_ANALYZER_NAME):
            for k in keys:
                if tick.entries[k].kind == ENTRY_LOCAL:
                    decisions.extend(tick.entries[k].decisions)
            for k in keys:
                if tick.entries[k].kind == ENTRY_CACHED:
                    decisions.extend(tick.entries[k].decisions)
        else:
            for k in keys:
                decisions.extend(tick.entries[k].decisions)

        self.last_tick_stats = {"analyzed": tick.analyzed,
                                "skipped": tick.skipped}

        # 8. Per-model trust state from the owners' shipped signals: the
        # fleet gate, boot ramp, and rebalance ramp all consume these.
        self._tick_health = {}
        self._tick_age_observed = set()
        self._tick_coverage = {}
        if self.health is not None:
            for key in sorted(tick.health):
                hs = tick.health[key]
                self._tick_health[key] = InputHealth(
                    state=hs.state, age_seconds=hs.age_seconds,
                    allow_scale_down=hs.allow_scale_down,
                    reason=hs.reason)
                if hs.age_observed:
                    self._tick_age_observed.add(key)
                if hs.scraped is not None or hs.ready is not None:
                    self._tick_coverage[key] = (hs.scraped, hs.ready)

        if merge is not None:
            self.spans.annotate(merge.span, decisions=len(decisions))
        self._close_span(merge)
        self._apply_limiter(decisions)
        return decisions

    def _sync_slo_config(self, model_groups: dict) -> dict[str, object]:
        """Sync SLO profiles once per distinct namespace per tick (not per
        model), BEFORE the worker fan-out: the per-model resolved config is
        passed explicitly into analysis, and workers must never race a
        profile-store sync. The fetch+sync is gated on the config mutation
        epoch: an unchanged epoch means the resolved config is
        value-identical to last tick's, so re-deep-copying a fleet-sized
        profile list (and re-adopting equal profiles into the store) every
        tick is pure waste. The memoized cfg object is the one the analyzer
        already adopted; decision paths read service classes/targets from
        it (never mutated), and the tuner's refinements land on the SAME
        adopted profile objects the per-tick re-sync used to keep anyway —
        an epoch bump re-fetches a fresh copy either way. Shared by the
        per-model analysis path and the sharded fleet solve (which needs
        the resolved classes + profiles for ``_optimize_global``)."""
        slo_cfg_by_ns: dict[str, object] = {}
        epoch = self.config.mutation_epoch()
        for group_key in sorted(model_groups):
            ns = model_groups[group_key][0].metadata.namespace
            if ns not in slo_cfg_by_ns:
                hit = self._slo_sync_memo.get(ns)
                if hit is not None and hit[0] == epoch:
                    slo_cfg_by_ns[ns] = hit[1]
                    continue
                cfg = self.config.slo_config_for_namespace(ns)
                self.slo_analyzer.sync_from_config(cfg, namespace=ns)
                self._slo_sync_memo[ns] = (epoch, cfg)
                slo_cfg_by_ns[ns] = cfg
        # Namespaces whose models all disappeared must not pin a
        # fleet-sized resolved config forever.
        for ns in [n for n in self._slo_sync_memo
                   if n not in slo_cfg_by_ns]:
            del self._slo_sync_memo[ns]
        return slo_cfg_by_ns

    def _apply_forecast(self, requests: list[ModelScalingRequest],
                        decisions: list[VariantDecision],
                        routes: dict[tuple[str, str], str] | None = None,
                        active_keys: set[tuple[str, str]] | None = None,
                        prepared=None) -> None:
        """Predictive planning stage (V2/SLO paths): feed the planner this
        tick's demand + variant states, fit every model's forecasters in
        one batched call, and raise proactive floors on the decisions.
        Runs on the engine thread in sorted model order (the planner's
        learned state must evolve byte-deterministically at any analysis-
        pool width), BEFORE the limiter so inventory caps still bind.

        ``active_keys`` is the full set of live (model, namespace) groups
        this tick INCLUDING fingerprint-skipped ones: the gauge sweep must
        only drop series for DELETED models, never for a quiet model whose
        analysis was skipped (its last-emitted values are still the
        truth)."""
        if self.forecast is None:
            return
        if not requests:
            # All-quiet tick: no planning, but deleted models' gauges must
            # still be pruned (the sweep below).
            self._sweep_forecast_gauges(set(), active_keys or set())
            return
        # Fused path: the planner's learning pass already ran (and the
        # fits rode the tick's one dispatch) at the prepared timestamp —
        # the planning loop must score/stamp against the same instant.
        now = prepared.now if prepared is not None else self.clock.now()
        # Models routed through the fleet-wide global optimizer still get
        # the planner's learning pass (history, lead times, backtests) but
        # never a floor: the solver deliberately starves low-priority
        # models on constrained pools and sequences migrations — a
        # per-model floor would fight both. On fused ticks the set IS the
        # grid's global-routed mask column (same predicate over the same
        # models; it may additionally cover a model whose finalize failed
        # — that model has no plan, so the extra key is inert).
        if prepared is not None:
            no_floor = prepared.global_no_floor
        else:
            no_floor = frozenset(
                f"{ns}|{model}"
                for (model, ns), route in (routes or {}).items()
                if route == "global")
        # Blacked-out models get the planner's learning pass but never a
        # floor: a floor is a capacity CHANGE, and blackout means no
        # trusted input justifies changing anything (the health gate would
        # freeze it back anyway — withholding keeps the trace honest).
        no_floor = no_floor | self._blackout_keys()
        try:
            plans, floors = self.forecast.plan(requests, now,
                                               no_floor_keys=no_floor,
                                               prepared=prepared)
        except Exception as e:  # noqa: BLE001 — forecasting must never
            # fail a tick: reactive decisions stand as computed.
            log.error("Forecast planning failed, staying reactive: %s", e)
            return
        raised = apply_forecast_floors(decisions, floors, now)
        if raised:
            log.info("Forecast floors raised %d decision(s)", raised)
        if self.shard_ctx is not None:
            # Shard-worker role: the fleet records ONE merged forecast
            # stage across every shard's plans (sorted by namespace/model,
            # the planner's own order) — per-shard stage records would
            # break trace byte-identity with the unsharded engine. A
            # fleet that records no trace is shipped no plans.
            if self.flight is not None:
                from wva_tpu_torch.blackbox.schema import encode as bb_encode

                cap = self.shard_ctx.capture
                cap.plans = [bb_encode(p) for p in plans]
                cap.floors = list(floors)
                cap.floors_raised = raised
        elif self.flight is not None and plans:
            self.flight.record_stage(STAGE_FORECAST, {
                "plans": plans, "floors": floors, "raised": raised})
        registry = getattr(self.actuator, "registry", None)
        if registry is None:
            return
        emitted: set[tuple] = set()
        for plan in plans:
            labels = {LABEL_MODEL_NAME: plan.model_id,
                      LABEL_NAMESPACE: plan.namespace}
            emitted.add((plan.model_id, plan.namespace))
            registry.set_gauge(WVA_FORECAST_LEAD_TIME_SECONDS, labels,
                               plan.lead_time_seconds)
            registry.set_gauge(WVA_FORECAST_DEMAND, labels,
                               plan.forecast_demand)
            registry.set_gauge(WVA_FORECAST_DEMOTED, labels,
                               1.0 if plan.demoted else 0.0)
            for name, err in plan.errors.items():
                registry.set_gauge(WVA_FORECAST_ERROR,
                                   {**labels, LABEL_FORECASTER: name}, err)
        self._sweep_forecast_gauges(emitted, active_keys or emitted)

    def _sweep_forecast_gauges(self, emitted: set[tuple],
                               active: set[tuple]) -> None:
        """Deleted/renamed models: drop their gauges instead of exporting
        the last values forever. A quiet model whose analysis was
        fingerprint-skipped this tick (active but not emitted) keeps its
        gauges — its last-emitted values still describe a live model."""
        registry = getattr(self.actuator, "registry", None)
        if registry is None:
            return
        for model, ns in self._forecast_gauge_keys - emitted - active:
            labels = {LABEL_MODEL_NAME: model, LABEL_NAMESPACE: ns}
            for gauge in (WVA_FORECAST_LEAD_TIME_SECONDS,
                          WVA_FORECAST_DEMAND, WVA_FORECAST_DEMOTED):
                registry.remove(gauge, labels)
            for name in FORECASTERS:
                registry.remove(WVA_FORECAST_ERROR,
                                {**labels, LABEL_FORECASTER: name})
        self._forecast_gauge_keys = \
            (self._forecast_gauge_keys & active) | emitted

    def _apply_capacity(self) -> None:
        """Elastic capacity pass (WVA_CAPACITY): reconcile the ledger
        against discovery, retire/expire provisioning orders, submit
        requests for this tick's shortfalls, flight-record the stage, and
        emit the wva_capacity_* gauges. Runs AFTER decisions are applied:
        capacity never mutates decisions — its influence flows through the
        inventory pools the limiter already recorded, which keeps
        capacity-enabled traces replayable from the pool snapshot alone."""
        if self.capacity is None:
            return
        try:
            # Blacked-out models withhold capacity releases for THEIR
            # variants this tick: in-flight orders keep their planning
            # credit (an expiry surrenders capacity that would have to be
            # re-ordered on recovery) — per variant, so an unrelated
            # healthy variant's genuinely wedged order still expires on
            # its own trusted evidence.
            with self._obs_span("capacity"):
                event = self.capacity.tick(
                    slices=self._tick_slices,
                    hold_releases=self._tick_hold_variants)
        except Exception as e:  # noqa: BLE001 — capacity must never fail
            # the tick: decisions stand as computed.
            log.error("Capacity pass failed: %s", e)
            return
        if self.flight is not None and (
                event["ledger"] or event["requests"]
                or event["completed"] or event["expired"]):
            self.flight.record_stage(STAGE_CAPACITY, event)
        registry = getattr(self.actuator, "registry", None)
        if registry is None:
            return
        for entry in event["ledger"]:
            variant = entry["variant"]
            vlabel = {LABEL_ACCELERATOR_TYPE: variant}
            for state in ("ready", "provisioning", "preempted"):
                registry.set_gauge(WVA_CAPACITY_SLICES,
                                   {**vlabel, LABEL_STATE: state},
                                   float(entry[state]))
            registry.set_gauge(
                WVA_CAPACITY_CHIPS_EFFECTIVE, vlabel,
                float((entry["ready"] + entry["provisioning"])
                      * entry["chips_per_slice"]))
            stocked = set(entry["stocked_out_tiers"])
            for tier in self.capacity.tier_preference:
                registry.set_gauge(WVA_CAPACITY_STOCKED_OUT,
                                   {**vlabel, LABEL_TIER: tier},
                                   1.0 if tier in stocked else 0.0)
            delta = entry["preempted_total"] \
                - self._capacity_preempted_seen.get(variant, 0)
            if delta > 0:
                registry.inc_counter(WVA_CAPACITY_PREEMPTED_TOTAL, vlabel,
                                     float(delta))
            self._capacity_preempted_seen[variant] = entry["preempted_total"]
        for req in event["requests"]:
            registry.inc_counter(WVA_CAPACITY_PROVISION_TOTAL, {
                LABEL_ACCELERATOR_TYPE: req["variant"],
                LABEL_TIER: req["tier"],
                LABEL_OUTCOME: req["outcome"],
            })
        for done in event["completed"]:
            registry.set_gauge(WVA_CAPACITY_PROVISION_LEAD_SECONDS, {
                LABEL_ACCELERATOR_TYPE: done["variant"],
                LABEL_TIER: done["tier"],
            }, done["latency_seconds"])
        # Gauge sweep (same discipline as the trend/forecast/health
        # planes): a variant that left the ledger stops exporting its
        # capacity gauges instead of freezing at the last value.
        emitted_variants = {entry["variant"] for entry in event["ledger"]}
        for variant in self._capacity_gauge_keys - emitted_variants:
            vlabel = {LABEL_ACCELERATOR_TYPE: variant}
            for state in ("ready", "provisioning", "preempted"):
                registry.remove(WVA_CAPACITY_SLICES,
                                {**vlabel, LABEL_STATE: state})
            registry.remove(WVA_CAPACITY_CHIPS_EFFECTIVE, vlabel)
            for tier in self.capacity.tier_preference:
                registry.remove(WVA_CAPACITY_STOCKED_OUT,
                                {**vlabel, LABEL_TIER: tier})
                registry.remove(WVA_CAPACITY_PROVISION_LEAD_SECONDS,
                                {**vlabel, LABEL_TIER: tier})
            self._capacity_preempted_seen.pop(variant, None)
        self._capacity_gauge_keys = emitted_variants

    def _apply_limiter(self, decisions: list[VariantDecision]) -> None:
        """Optional slice limiter, applied on EVERY analysis path (the
        reference leaves this a V1-only stage with a limited-mode TODO,
        engine.go:120-127/363-395; on TPU, clamping desired to whole-slice
        inventory matters everywhere — unplaceable replicas otherwise sit
        pending forever and keep the anticipated-supply math inflated)."""
        if self.shard_ctx is not None:
            # Shard-worker role: slice inventory is a FLEET resource — only
            # the fleet lease-holder clamps the merged decision set against
            # it (and feeds the capacity plane's demand snapshot).
            return
        if self.capacity is not None:
            # PRE-limiter demand snapshot: the limiter clamps targets to
            # inventory, so only the un-clamped targets can express the
            # shortfall the provisioner should cover.
            self.capacity.note_demand(decisions)
        global_cfg = self.config.saturation_config().get("default")
        # Two switches, either enables: the hot-reloadable ConfigMap's
        # enableLimiter, or the process-level WVA_LIMITED_MODE (the
        # reference's limited-mode deployment flag, cmd flag surface) —
        # an env-only deployment must not need a ConfigMap edit to cap
        # allocations at inventory.
        enabled = ((global_cfg is not None and global_cfg.enable_limiter)
                   or self.config.limited_mode_enabled())
        if not enabled or self.limiter is None or not decisions:
            return
        try:
            self.limiter.limit(decisions)
        except Exception as e:  # noqa: BLE001
            log.error("Limiter failed, proceeding with original decisions: %s", e)
        if self.capacity is not None:
            # Hand the limiter's just-refreshed discovery snapshot to the
            # capacity pass (same tick, same world — a second node-fleet
            # list + parse would be pure waste).
            self._tick_slices = getattr(self.limiter.inventory,
                                        "last_slices", None)

    def _run_v2_analysis(self, model_id: str, namespace: str, data: _ModelData,
                         sat_cfg: SaturationScalingConfig,
                         scheduler_queue=None):
        # Pre-populate capacity store from deployment args (engine_v2.go:31-45).
        for key, va in data.variant_autoscalings.items():
            deploy = data.deployments.get(
                namespaced_key(va.metadata.namespace, va.spec.scale_target_ref.name))
            if deploy is None:
                continue
            accelerator = variant_utils.get_accelerator_type(va)
            chips = scale_target.chips_per_replica(
                scale_target.scale_target_state(deploy))
            self.capacity_store.load_from_deployment(
                namespace, model_id, va.metadata.name, accelerator, chips, deploy)

        return self.v2_analyzer.analyze(AnalyzerInput(
            model_id=model_id, namespace=namespace,
            replica_metrics=data.replica_metrics,
            variant_states=data.variant_states,
            config=sat_cfg,
            scheduler_queue=scheduler_queue,
        ))

    def _optimize_global(self, requests: list[ModelScalingRequest],
                         slo_cfg_by_ns: dict[str, object]) -> list[VariantDecision]:
        """Fleet-wide assignment (optimizerName "global", SLO path only):
        builds one FleetSystem across every model — servers with observed
        load, accelerators from the variants' slice specs, per-generation
        chip capacity from discovery — and solves the greedy priority /
        delta-regret assignment with transition penalties (the inferno
        successor; ``wva_tpu_torch.fleet``). Each model consolidates onto ONE slice
        variant per solve, like the reference's per-server Allocation."""
        from wva_tpu_torch.fleet import (
            AcceleratorSpec,
            CurrentAlloc,
            FleetSystem,
            ServerLoad,
            ServerSpec,
            SolverSpec,
            solve,
        )

        slices = {}
        try:
            slices = self.limiter.inventory.discovery.discover_slices() \
                if self.limiter is not None else {}
        except Exception as e:  # noqa: BLE001 — no inventory -> unlimited
            log.debug("Slice discovery unavailable for global optimizer: %s", e)

        accelerators: dict[str, AcceleratorSpec] = {}
        capacity_chips: dict[str, int] = {}
        servers: dict[str, ServerSpec] = {}
        service_classes = {}
        req_by_server: dict[str, ModelScalingRequest] = {}

        from wva_tpu_torch.config.slo import DEFAULT_SERVICE_CLASS_PRIORITY, ServiceClass

        counted_variants: set[str] = set()
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
                # Models covered only by defaultTargets still participate.
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
                    cap = slices.get(accel)
                    gen = accel.split("-")[0]
                    accelerators[accel] = AcceleratorSpec(
                        name=accel, type=gen,
                        # Per-variant chip count from pod TPU requests is
                        # authoritative; discovery confirms, never guesses.
                        chips_per_replica=(
                            cap.chips_per_slice if cap is not None
                            else chips_by_accel.get(accel, 1)),
                        cost=vc.cost,
                        # Reservation/spot-aware pricing: the pool's
                        # ready-slice tier blend scales per-replica cost
                        # (1.0 when the capacity plane is off).
                        tier_cost_weight=(
                            self.capacity.tier_cost_weight(accel)
                            if self.capacity is not None else 1.0))
                    if cap is not None and accel not in counted_variants:
                        # Whole schedulable slices only (partial slices are
                        # unplaceable; matches the limiter's pool sizing).
                        # Each variant's slices contribute once to its
                        # generation's pool.
                        counted_variants.add(accel)
                        chips = cap.total_slices * cap.chips_per_slice
                        if self.capacity is not None:
                            # Provisioning-in-flight capacity is solvable
                            # capacity — same pool extension the limiter
                            # applies (ready + arriving-within-lead-time).
                            chips += self.capacity.pool_credit_chips(accel)
                        capacity_chips[gen] = (
                            capacity_chips.get(gen, 0) + chips)
                if current is None and vc.replica_count > 0:
                    current = CurrentAlloc(
                        accelerator=accel, num_replicas=vc.replica_count,
                        cost=vc.cost * vc.replica_count)

            name = f"{req.namespace}/{req.model_id}"
            servers[name] = ServerSpec(
                name=name, namespace=req.namespace, model_id=req.model_id,
                service_class=qualified,
                load=ServerLoad(
                    # Size assignments for what scale-up must cover: the
                    # anticipated demand (trend over the provisioning
                    # horizon + backlog drain) plus the standing headroom /
                    # burst insurance — the same terms the per-model
                    # decision path bakes into required_capacity. Raw
                    # demand alone made the fleet solve lag every ramp by
                    # a provisioning horizon and strip the insurance from
                    # high-priority models mid-hold.
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
        # Unlimited only when no inventory could be discovered.
        spec = SolverSpec(unlimited=not capacity_chips)
        system = FleetSystem(
            accelerators=accelerators, servers=servers,
            service_classes=service_classes,
            profiles=self.slo_analyzer.profiles,
            capacity_chips=capacity_chips)
        # Fused tick: every (model, accelerator) pair was already sized
        # inside the tick's one dispatch — the solve reuses those rates
        # instead of re-dispatching (bitwise-identical sizing; see
        # fleet.allocation.build_candidates). None on staged ticks and on
        # the sharded fleet role (the workers sized their partitions) —
        # passed positionally-optional so test doubles of solve() keep
        # their two-argument shape.
        with self._obs_span("fleet_solve", servers=len(servers)):
            if self._tick_presized:
                solution = solve(system, spec, presized=self._tick_presized,
                                 device=self.device)
            else:
                solution = solve(system, spec, device=self.device)
        return self._allocations_to_decisions(req_by_server, solution)

    def _allocations_to_decisions(self, req_by_server, solution):
        """Fleet-solver allocations -> per-variant decisions, with
        readiness-aware migration holds (make-before-break)."""
        decisions: list[VariantDecision] = []
        active_holds: set[str] = set()
        for name, req in req_by_server.items():
            alloc = solution.allocations.get(name)
            # Exactly ONE variant receives the solution's replica count even
            # when several VariantAutoscalings share the chosen accelerator
            # (a legal config) — otherwise the chip budget the solver spent
            # once would be duplicated per variant. Winner = most READY
            # replicas (a variant wedged in provisioning must not outrank a
            # serving one), then most current, then name for determinism.
            winner = None
            if alloc is not None and alloc.accelerator:
                matching = [vs for vs in req.variant_states
                            if vs.accelerator_name == alloc.accelerator]
                if matching:
                    winner = max(matching, key=lambda vs: (
                        vs.ready_replicas, vs.current_replicas,
                        vs.variant_name))
            # Readiness-aware migration: TPU slices take minutes to become
            # ready, so a cross-variant consolidation must not zero the old
            # variant while the winner's replicas are still provisioning.
            # Losing variants decay proportionally to the winner's readiness
            # (hold all replicas at 0% ready, none at 100%), and a hold
            # timeout forces one-replica-per-tick drain so a pool too small
            # to host old + new simultaneously cannot wedge the migration
            # forever (the freed chips let the winner schedule).
            migration_ready = True
            winner_ready = 0
            if winner is not None:
                winner_ready = winner.ready_replicas
                migration_ready = winner_ready >= alloc.num_replicas
            if alloc is not None and alloc.accelerator and winner is None:
                # The solver chose an accelerator no live variant matches
                # (variant deleted between collection and solve, or a
                # solver/config accelerator-name mismatch). Consolidating
                # would zero EVERY variant with nothing to migrate onto —
                # exactly the capacity-destroying transition the hold
                # machinery exists to prevent. Hold the fleet steady and
                # surface the mismatch instead.
                log.warning(
                    "Global optimizer chose accelerator %r for model %s but "
                    "no variant serves it (variants: %s); holding replicas "
                    "steady", alloc.accelerator, name,
                    [vs.accelerator_name for vs in req.variant_states])
                alloc = None
            now = self.clock.now()
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
                    # Hold timers are scoped to one (variant -> target
                    # accelerator) migration: a retarget restarts the clock,
                    # and entries not refreshed this solve are pruned below
                    # (so a transient no-allocation tick or a deleted model
                    # can never leave a stale timer that would later charge
                    # elapsed time to a different migration).
                    held = self._migration_holds.get(hold_key)
                    if held is None or held[2] != alloc.accelerator:
                        held = (now, vs.current_replicas, alloc.accelerator)
                    self._migration_holds[hold_key] = held
                    active_holds.add(hold_key)
                    started, initial, _ = held
                    shortfall = 1.0 - winner_ready / max(alloc.num_replicas, 1)
                    decayed = math.ceil(initial * shortfall)
                    if now - started > MIGRATION_HOLD_TIMEOUT:
                        # Deadlock escape: drain one replica per tick even
                        # without winner progress, bounding the capacity dip.
                        target = max(0, vs.current_replicas - 1)
                        reason = ("global optimizer (migration hold timed "
                                  f"out after {MIGRATION_HOLD_TIMEOUT:.0f}s; "
                                  "draining to unblock the winner)")
                        log.warning(
                            "Migration of %s to %s stuck %ds (winner ready "
                            "%d/%d); force-draining %s", name,
                            alloc.accelerator, int(now - started),
                            winner_ready, alloc.num_replicas, vs.variant_name)
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
                            else ACTION_SCALE_DOWN if target < vs.current_replicas
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
        # Prune holds that did not re-assert themselves this solve (migration
        # completed, model unallocated/deleted, or retargeted under a new
        # key): keeps the map bounded and timers honest.
        self._migration_holds = {
            k: v for k, v in self._migration_holds.items() if k in active_holds}
        return decisions

    def _fused_prepare(self, plans: dict, batch_keys: list[str],
                       outcomes: dict, slo_cfg_by_ns: dict):
        """The one-jitted-program decision plane's grid build (WVA_FUSED;
        docs/design/fused-plane.md).

        Lays the tick out on fixed grids — the candidate axis exactly as
        ``size_candidates`` would batch it, the model axis from the
        forecast planner's prepared pass (demand observation, idle
        eviction, grid resampling, backtest scoring, trust selection all
        run BEFORE the dispatch; every input is prepare-stage data) with
        the per-model dynamics as mask columns. The entries the planner
        mutates on are built FIRST, so a lookup failure here degrades to
        the staged path before any planner state moved.

        Returns ``(FleetGrids, PreparedTick | None)``. The global-routed
        mask column becomes the prepared tick's no-floor partition (the
        set ``_apply_forecast`` would otherwise derive per-model from
        routes); tuner/zero columns describe the remaining dynamics and
        are asserted against the world by the property tests."""
        from wva_tpu_torch import fused

        prep = None
        if self.forecast is not None:
            now = self.clock.now()
            entries = []
            by_pkey = {}
            for key in batch_keys:
                data, sat_cfg, _sq, plan = outcomes[key][1]
                entries.append((plan.input.namespace, plan.input.model_id,
                                self.slo_analyzer.plan_demand(plan),
                                data.variant_states))
                by_pkey[self.forecast.key_for(
                    plan.input.namespace, plan.input.model_id)] = (
                        data, sat_cfg, plan)
            prep = self.forecast.prepare_tick(entries, now)
        grids = fused.FleetGrids(device=self.device)
        fused.build_candidate_axis(grids, plans, batch_keys)
        if prep is not None:
            global_routed, tuner_enabled, zero = [], [], []
            for pkey in prep.keys:
                data, sat_cfg, plan = by_pkey[pkey]
                global_routed.append(sat_cfg.optimizer_name == "global")
                slo_cfg = slo_cfg_by_ns.get(plan.input.namespace)
                tuner_enabled.append(bool(
                    slo_cfg is not None
                    and getattr(slo_cfg, "tuner_enabled", False)))
                # Zero READY supply: scaled to zero with lingering
                # telemetry, or freshly waking with every replica still
                # provisioning — a FULLY scaled-to-zero model without
                # metrics never reaches sizing at all (skip path).
                zero.append(not any(vs.ready_replicas > 0
                                    for vs in data.variant_states))
            fused.build_model_axis(
                grids, prep.grids, prep.keys, prep.trust_idx,
                prep.trusted, global_routed, tuner_enabled, zero)
            prep.global_no_floor = frozenset(
                k for k, g in zip(prep.keys, global_routed) if g)
        return grids, prep

    def _fused_dispatch(self, grids, prep) -> dict[str, list[float]]:
        """Run the fused program: ONE jitted dispatch computing every
        candidate's sizing bisection and every model's forecaster fits,
        one host transfer. Fills the prepared tick's fits/chosen and
        stashes the per-(model, ns, accelerator) sized pairs for this
        tick's fleet solve. All downstream host stages (finalize,
        optimizer, enforcer, floors, limiter) consume bitwise the values
        the staged dispatches produce — what keeps WVA_FUSED=off
        byte-identical."""
        from wva_tpu_torch import fused

        result = fused.run(grids, memo=self.solve_memo, spans=self.spans)
        if prep is not None:
            prep.fits = result.fits
            prep.chosen = result.chosen
        self._tick_presized = result.presized
        return result.per_replica

    def _prepare_slo_plan(self, model_id: str, namespace: str, data: _ModelData,
                          sat_cfg: SaturationScalingConfig, slo_cfg,
                          scheduler_queue=None, collector=None):
        """SLO path, worker half: attach the model's arrival-rate telemetry,
        feed the tuner, and prepare the sizing plan (candidates) with the
        namespace's resolved SLO config (profiles were synced once for the
        namespace at tick start). The device sizing call happens ONCE per
        tick across every model's plan (see ``_optimize_v2``), and
        ``finalize`` runs on the engine thread."""
        collector = collector or self.collector
        optimizer_metrics = collect_optimizer_metrics(
            collector.source, model_id, namespace)
        if slo_cfg is not None and slo_cfg.tuner_enabled:
            self._feed_slo_tuner(model_id, namespace, data, optimizer_metrics,
                                 collector=collector)
        return self.slo_analyzer.prepare(AnalyzerInput(
            model_id=model_id, namespace=namespace,
            replica_metrics=data.replica_metrics,
            variant_states=data.variant_states,
            config=sat_cfg,
            scheduler_queue=scheduler_queue,
            optimizer_metrics=optimizer_metrics,
            slo_config=slo_cfg,
        ))

    def _feed_slo_tuner(self, model_id: str, namespace: str, data: _ModelData,
                        optimizer_metrics, collector=None) -> None:
        """One EKF step per accelerator from live TTFT/ITL telemetry; the
        refined alpha/beta/gamma land in the shared PerfProfileStore.

        Heterogeneous fleets (the BASELINE config-4 v5e-vs-v5p scenario) are
        tuned from per-pod latency queries joined pod->accelerator, so each
        filter fits its own accelerator's latencies. Homogeneous fleets may
        fall back to the model-wide means (identical to the per-type mean
        when only one type serves) when per-pod rates are unavailable —
        e.g. a Prometheus without the per-pod histogram series."""
        if optimizer_metrics is None:
            return
        collector = collector or self.collector
        by_accel: dict[str, list[ReplicaMetrics]] = {}
        for rm in data.replica_metrics:
            if rm.accelerator_name:
                by_accel.setdefault(rm.accelerator_name, []).append(rm)
        per_accel = collect_accelerator_telemetry(
            collector.source, model_id, namespace,
            {rm.pod_name: rm.accelerator_name
             for rm in data.replica_metrics
             if rm.pod_name and rm.accelerator_name})
        # Key the homogeneity check on variant_states (the authoritative
        # fleet shape) — replica_metrics alone misses variants whose pods
        # exist but aren't scraped yet.
        fleet_accels = {vs.accelerator_name for vs in data.variant_states
                        if vs.accelerator_name and vs.current_replicas > 0}
        homogeneous = len(fleet_accels | set(by_accel)) <= 1
        # arrival_rate is model-wide: attribute per-replica load using the
        # authoritative ready-replica count from variant states (replicas
        # with missing metrics still serve traffic).
        total_replicas = max(
            sum(vs.ready_replicas for vs in data.variant_states), 1)
        for accelerator, rms in by_accel.items():
            profile = self.slo_analyzer.profiles.get(
                model_id, accelerator, namespace=namespace)
            if profile is None:
                continue
            ins = [rm.avg_input_tokens for rm in rms if rm.avg_input_tokens > 0]
            outs = [rm.avg_output_tokens for rm in rms if rm.avg_output_tokens > 0]
            if not ins or not outs:
                continue
            telemetry = per_accel.get(accelerator)
            if telemetry is not None:
                lambda_per_min = telemetry.arrival_rate_per_replica
                ttft_ms = telemetry.ttft_seconds * 1000.0
                itl_ms = telemetry.itl_seconds * 1000.0
            elif homogeneous:
                lambda_per_min = optimizer_metrics.arrival_rate / total_replicas
                ttft_ms = optimizer_metrics.ttft_seconds * 1000.0
                itl_ms = optimizer_metrics.itl_seconds * 1000.0
            else:
                # Model-wide latency is a cross-type blend; feeding it to a
                # per-accelerator filter would drag the profile toward the
                # mixture. Better no update than a corrupting one.
                log.debug("Model %s: no per-pod latency for %s in a "
                          "heterogeneous fleet; skipping its tuner step",
                          model_id, accelerator)
                continue
            # Decode-slot occupancy across this accelerator's replicas (KV
            # usage as the vLLM fallback): the tuner's identifiability gate
            # skips near-idle observations (TunerConfig.min_occupancy).
            slots_used = sum(rm.slots_used for rm in rms)
            slots_total = sum(rm.slots_total for rm in rms)
            occupancy = (slots_used / slots_total if slots_total > 0
                         else -1.0)
            # KV usage rides along as its OWN signal: when slot telemetry
            # is absent (vLLM collectors), the tuner gates on it as a
            # binary idle/non-idle check against min_kv_usage — never
            # compared to the slot-scale min_occupancy (the scales differ:
            # long-context/low-batch is KV-high/slots-low, short-request/
            # high-batch is KV-low/slots-high). All-zero KV with no slot
            # telemetry stays "no signal" (-1): a genuinely idle fleet
            # produces no valid tuner environment anyway (zero arrival
            # rate), so unknown keeps the gate from eating telemetry
            # whose collector doesn't export occupancy.
            kvs = [rm.kv_cache_usage for rm in rms]
            kv_occupancy = (sum(kvs) / len(kvs)
                            if any(kv > 0 for kv in kvs) else -1.0)
            env = TunerEnvironment(
                # Filter models one replica's queue: per-replica arrival rate.
                lambda_per_min=lambda_per_min,
                avg_input_tokens=sum(ins) / len(ins),
                avg_output_tokens=sum(outs) / len(outs),
                max_batch_size=profile.max_batch_size,
                max_queue_size=profile.max_queue_size,
                avg_ttft_ms=ttft_ms,
                avg_itl_ms=itl_ms,
                occupancy=occupancy,
                kv_occupancy=kv_occupancy,
            )
            with self._obs_span("tuner_step"):
                self.slo_tuner.observe(namespace, model_id, accelerator, env,
                                       spans=self.spans)

    # --- shared data preparation ---

    def _prepare_model_data(
        self, model_id: str, model_vas: list[VariantAutoscaling],
        client: KubeClient | None = None,
        collector: ReplicaMetricsCollector | None = None,
    ) -> _ModelData | None:
        """Collect metrics + build lookup maps (reference engine.go:677-803).
        Returns None when no metrics are available (skip the model).
        ``client`` is the tick's snapshot view and ``collector`` the tick's
        grouped-collection view (both fall back to the live objects for
        direct callers like the fast path)."""
        if not model_vas:
            raise ValueError(f"no VAs provided for model {model_id}")
        client = client or self.client
        collector = collector or self.collector
        namespace = model_vas[0].metadata.namespace

        # Targets of any scalable kind (Deployment, LeaderWorkerSet); keyed
        # like the reference's deployments map.
        deployments: dict[str, object] = {}
        variant_autoscalings: dict[str, VariantAutoscaling] = {}
        variant_costs: dict[str, float] = {}
        for va in model_vas:
            key = namespaced_key(va.metadata.namespace, va.metadata.name)
            variant_autoscalings[key] = va
            variant_costs[key] = va.spec.cost()
            try:
                target = scale_target.get_scale_target_with_backoff(
                    client, va.spec.scale_target_ref.kind,
                    va.spec.scale_target_ref.name, va.metadata.namespace)
            except NotFoundError:
                log.debug("No scale target for VA %s", va.metadata.name)
                continue
            except TypeError as e:
                log.warning("VA %s: %s", va.metadata.name, e)
                continue
            deployments[namespaced_key(va.metadata.namespace,
                                       target.metadata.name)] = target

        replica_metrics = collector.collect_replica_metrics(
            model_id, namespace, deployments, variant_autoscalings, variant_costs)
        if not replica_metrics:
            log.debug("No replica metrics for model %s", model_id)
            return None

        variant_states = self.build_variant_states(model_vas, deployments,
                                                   client=client)
        return _ModelData(
            model_id=model_id, namespace=namespace,
            replica_metrics=replica_metrics, deployments=deployments,
            variant_autoscalings=variant_autoscalings,
            variant_costs=variant_costs, variant_states=variant_states)

    def build_variant_states(
        self, vas: list[VariantAutoscaling],
        deployments: dict[str, object] | None = None,
        client: KubeClient | None = None,
    ) -> list[VariantReplicaState]:
        """Current/desired/pending replica counts per variant
        (reference engine.go:491-556). Pending counts replicas that exist but
        are not fully Ready — slice provisioning + model load take minutes on
        TPU, and for a multi-host slice one unready host keeps the whole
        replica pending (the scale-target adapter owns that math)."""
        client = client or self.client
        states = []
        for va in vas:
            key = namespaced_key(va.metadata.namespace, va.spec.scale_target_ref.name)
            target = (deployments or {}).get(key)
            if target is None:
                try:
                    target = scale_target.get_scale_target_with_backoff(
                        client, va.spec.scale_target_ref.kind,
                        va.spec.scale_target_ref.name, va.metadata.namespace)
                except (NotFoundError, TypeError):
                    log.debug("Could not get scale target for VA %s",
                              va.metadata.name)
                    continue
            st = scale_target.scale_target_state(target)
            # DECISION input, not a gauge: during the brief window where
            # spec is raised but pods aren't created yet, counting the
            # spec'd replicas keeps pending = current - ready positive so
            # anticipation credits provisioning capacity instead of
            # re-ordering it (cascade prevention). The emitted
            # wva_current_replicas gauge uses observed status only.
            current = st.status_replicas or st.desired_replicas
            states.append(VariantReplicaState(
                variant_name=va.metadata.name,
                accelerator_name=variant_utils.get_accelerator_type(va),
                current_replicas=current,
                desired_replicas=va.status.desired_optimized_alloc.num_replicas,
                pending_replicas=max(current - st.ready_replicas, 0),
                chips_per_replica=scale_target.chips_per_replica(st),
                hosts_per_slice=st.hosts_per_replica,
            ))
        return states

    # --- decision application ---

    def _apply_decisions(
        self,
        decisions: list[VariantDecision],
        va_map: dict[str, VariantAutoscaling],
        client: KubeClient | None = None,
    ) -> None:
        """Update VA status, emit metrics, publish cache + trigger
        (reference engine.go:805-1019). Iterates ALL active VAs so status and
        metric emission happen every tick even without decisions. Reads go
        through the tick snapshot (``client``); status WRITES go to the live
        client with conflict-refetch, since the snapshot's resourceVersions
        may be stale by write time.

        Batched per tick (PERF.md ~36 µs/VA apply residual): a pure
        MATERIALIZE pass computes every VA's outcome (target, conditions,
        would-be status material, observed replicas) from the frozen
        snapshot reads; the fleet's gauges then land in ONE registry lock
        pass; and only then does the per-VA write pass run — trace events,
        status PUTs (changed VAs only), audit events, and cache/trigger
        publication, in the same sorted order as before. Per-VA values,
        statuses, and trace records are byte-identical to the per-VA loop;
        only the locking/emission shape changes."""
        client = client or self.client
        decision_map = {namespaced_key(d.namespace, d.variant_name): d
                        for d in decisions}
        now = self.clock.now()
        # Per-namespace fast-actuation probe memo: the per-VA
        # saturation-config resolution is a fleet-sized deepcopy, paid
        # once per namespace per tick instead of once per VA.
        fast_by_ns: dict[str, bool] = {}

        # --- pass 1: materialize (pure; no writes, no registry) ---
        staged: list[dict] = []
        for va_key in sorted(va_map):
            va = va_map[va_key]
            decision = decision_map.get(va_key)

            try:
                update_va = variant_utils.get_va_with_backoff(
                    client, va.metadata.name, va.metadata.namespace)
            except NotFoundError:
                log.debug("VA %s disappeared; skipping", va_key)
                continue

            # ONE observed-target read serves both the no-decision
            # fallback and the gauge emission (the per-VA loop read the
            # same frozen snapshot object twice).
            tgt_state = None
            tgt_err: Exception | None = None
            try:
                tgt_state = scale_target.scale_target_state(client.get(
                    update_va.spec.scale_target_ref.kind or Deployment.KIND,
                    update_va.metadata.namespace,
                    update_va.spec.scale_target_ref.name))
            except Exception as e:  # noqa: BLE001 — degraded per VA below
                tgt_err = e

            if decision is not None:
                target_replicas = decision.target_replicas
                accelerator = decision.accelerator_name
                reason = decision.reason
            else:
                # No decision this tick (metrics gap / fresh VA): keep the
                # previous desired, else fall back to the deployment's CURRENT
                # replicas — never emit desired=0 for a serving deployment
                # (reference engine.go:866-877).
                target_replicas = update_va.status.desired_optimized_alloc.num_replicas
                if target_replicas <= 0:
                    target_replicas = (
                        (tgt_state.status_replicas
                         or tgt_state.desired_replicas)
                        if tgt_state is not None else 0)
                accelerator = update_va.status.desired_optimized_alloc.accelerator
                reason = "No scaling decision (optimization loop)"

            prev_material = _status_material(update_va)
            prev_run_time = update_va.status.desired_optimized_alloc.last_run_time

            if not accelerator:
                accelerator = variant_utils.get_accelerator_type(update_va)
            if not accelerator:
                # Can't produce a sensible status; still publish (in the
                # write pass, keeping trigger order) metrics-missing state
                # so the reconciler sets MetricsAvailable=False.
                staged.append({"kind": "noaccel", "va": va})
                continue

            old_alloc = update_va.status.desired_optimized_alloc
            # last_run_time == 0 means the status was never written: the
            # first population of a fresh VA is not a transition (a VA
            # created over an already-running deployment would otherwise
            # report a fictitious "0 -> N" scale-up).
            # Operators can see the horizon the planner ACTUALLY uses
            # (measured actuation->ready quantile); only measured estimates
            # are surfaced — the default constant would be noise dressed as
            # a measurement. Assigned unconditionally (0 clears the field):
            # with forecasting off or the measurement evicted, the status
            # must stop claiming a horizon nobody is using. Rounded, and it
            # only moves when a scale-up completes, so no write churn.
            lead_value = 0.0
            if self.forecast is not None:
                lead, measured = self.forecast.lead_time_for(
                    update_va.metadata.namespace, update_va.spec.model_id)
                if measured:
                    lead_value = round(lead, 1)

            # The gauges work from the frozen snapshot read plus the
            # computed decision values — the status mutation below is
            # skipped entirely on no-change ticks, so they must not
            # depend on it. A failed target read degrades this VA to
            # applied=False (previous per-VA emit semantics).
            applied = tgt_err is None
            if tgt_err is not None:
                log.error("Failed to emit metrics for %s: %s", va_key,
                          tgt_err)
            staged.append({
                "kind": "full", "va": va, "va_key": va_key,
                "update_va": update_va, "decision": decision,
                "target_replicas": target_replicas,
                "accelerator": accelerator, "reason": reason,
                "applied": applied,
                "current": tgt_state.status_replicas
                if tgt_state is not None else 0,
                "lead_value": lead_value,
                "prev_material": prev_material,
                "prev_run_time": prev_run_time,
                "old_alloc": old_alloc,
            })

        # --- pass 2: one batched gauge emission for the whole fleet ---
        try:
            # Emission never fails the loop (the per-VA loop's rule): a
            # registry/mirror failure here costs this tick's gauges, not
            # the status writes, cache publications, and triggers below.
            self.actuator.emit_metrics_batch(
                (s["va"].metadata.name, s["va"].metadata.namespace,
                 s["accelerator"], s["current"], s["target_replicas"])
                for s in staged if s["kind"] == "full" and s["applied"])
        except Exception as e:  # noqa: BLE001 — see above
            log.error("Batched replica-gauge emission failed: %s", e)

        # --- pass 3: writes, events, trace, cache/trigger (sorted order
        # --- preserved — identical per-VA record and trigger sequence) ---
        for s in staged:
            va = s["va"]
            if s["kind"] == "noaccel":
                common.DecisionCache.set(va.metadata.name, va.metadata.namespace,
                                         VariantDecision(
                                             variant_name=va.metadata.name,
                                             namespace=va.metadata.namespace,
                                             metrics_available=False,
                                             metrics_reason=METRICS_REASON_UNAVAILABLE,
                                             metrics_message=METRICS_MESSAGE_UNAVAILABLE),
                                         source=common.SOURCE_SATURATION,
                                         cycle=self.flight.current_cycle()
                                         if self.flight else 0)
                common.fire_trigger(va.metadata.name, va.metadata.namespace)
                continue

            va_key = s["va_key"]
            update_va = s["update_va"]
            decision = s["decision"]
            target_replicas = s["target_replicas"]
            accelerator = s["accelerator"]
            reason = s["reason"]
            applied = s["applied"]
            lead_value = s["lead_value"]
            prev_material = s["prev_material"]
            prev_run_time = s["prev_run_time"]
            old_alloc = s["old_alloc"]
            old_desired = old_alloc.num_replicas
            had_recorded_alloc = old_alloc.last_run_time > 0

            if (self.recorder is not None and decision is not None
                    and decision.was_limited
                    and decision.chips_allocated == 0
                    and decision.action == ACTION_SCALE_UP):
                # A FULLY blocked scale-up produces no status change, so
                # without this Warning it is invisible outside logs — and
                # zero placeable slices for a variant usually means a
                # config error (VA accelerator label vs node-pool
                # topology), not transient pressure. Recorder dedup
                # aggregates repeats into one event with a count.
                self.recorder.warning(
                    update_va, "ScaleUpBlocked",
                    f"scale-up blocked by "
                    f"{decision.limited_by or 'slice inventory'}: no "
                    f"placeable {decision.accelerator_name or 'TPU'} "
                    "slices (verify the node-pool topology derives this "
                    "variant and capacity exists)")

            self._maybe_fast_actuate(update_va, decision, fast_by_ns)

            if self.flight is not None:
                self.flight.record_stage("actuation", {
                    "variant": va.metadata.name,
                    "namespace": va.metadata.namespace,
                    "accelerator": accelerator,
                    "desired": target_replicas,
                    "applied": applied,
                    "had_decision": decision is not None,
                })

            # Persist the engine-owned status fields (OptimizationReady,
            # actuation.applied, desired alloc). Divergence from the
            # reference, whose engine-side condition writes are lost because
            # only the reconciler patches status; here the status write is a
            # cheap full-subresource put and the reconciler remains the
            # owner of MetricsAvailable/TargetResolved. The put is SKIPPED
            # when nothing material changed (only lastRunTime would move):
            # at a 5s tick with N VAs, unconditional writes are 2N API
            # requests per tick of no-op churn. A heartbeat bound keeps
            # lastRunTime from going permanently stale on quiet models.
            # The would-be material is computed WITHOUT mutating: the
            # snapshot read is a frozen shared object, and only an actual
            # write pays the copy-on-write clone (wva_tick_object_copies
            # stays ~0 on steady-state ticks).
            cond_reason = ("SaturationOnlyMode" if decision is not None
                           else REASON_OPTIMIZATION_SUCCEEDED)
            cond_message = (
                f"saturation decision: {reason} "
                f"(target: {target_replicas} replicas)"
                if decision is not None
                else "Optimization loop ran (no scaling change needed)")
            upserts = [(TYPE_OPTIMIZATION_READY, "True",
                        cond_reason, cond_message)]
            # Input-health condition (WVA_HEALTH): the status says when a
            # decision was made blind instead of degrading silently.
            # Content is keyed off the ladder state with STABLE messages,
            # so a steady health state never churns status writes; with
            # the health plane off the condition is never written
            # (pre-change status bytes).
            health_state = None
            drop_conds: tuple[str, ...] = ()
            if self.health is not None:
                h = self._tick_health.get(
                    f"{update_va.spec.model_id}|{update_va.metadata.namespace}")
                if h is not None:
                    health_state = (h.state if h.state != FRESH
                                    or h.allow_scale_down else "recovering")
                    upserts.append((TYPE_INPUTS_HEALTHY,)
                                   + HEALTH_CONDITIONS[health_state])
            elif update_va.get_condition(TYPE_INPUTS_HEALTHY) is not None:
                # Plane disabled after a condition was written (operator
                # turned WVA_HEALTH off mid-incident): remove it, or the
                # status would report frozen-on-untrusted-inputs forever
                # while decisions actually flow normally.
                drop_conds = (TYPE_INPUTS_HEALTHY,)
            new_material = (
                accelerator, target_replicas, applied, lead_value,
                _conditions_material_with(update_va, *upserts,
                                          drop=drop_conds))
            persisted = True
            if (new_material != prev_material
                    or now - prev_run_time >= STATUS_HEARTBEAT_SECONDS):
                # Copy-on-write builder: clone -> mutate -> write.
                update_va = clone(update_va)
                update_va.status.desired_optimized_alloc = OptimizedAlloc(
                    accelerator=accelerator,
                    num_replicas=target_replicas,
                    last_run_time=now,
                )
                update_va.status.actuation.applied = applied
                update_va.status.forecast_lead_time_seconds = lead_value
                update_va.set_condition(
                    TYPE_OPTIMIZATION_READY, "True", cond_reason,
                    cond_message, now=now)
                if health_state is not None:
                    status_v, h_reason, h_message = \
                        HEALTH_CONDITIONS[health_state]
                    update_va.set_condition(
                        TYPE_INPUTS_HEALTHY, status_v, h_reason,
                        h_message, now=now)
                elif drop_conds:
                    update_va.status.conditions = [
                        c for c in update_va.status.conditions
                        if c.type not in drop_conds]
                try:
                    # Writes always target the LIVE client: a 409 from a
                    # snapshot-stale resourceVersion refetches just the
                    # conflicted VA (targeted GET) and retries, instead of
                    # invalidating the tick's whole snapshot. old_alloc
                    # (the alloc we READ from the snapshot) anchors the
                    # stale-write guard — a decision newer than our read
                    # (mid-tick scale-from-zero wake) must win, not be
                    # reverted by this tick's pre-wake computation.
                    with self._obs_span("status_write",
                                        variant=update_va.metadata.name,
                                        namespace=update_va.metadata
                                        .namespace):
                        _, persisted = variant_utils\
                            .update_va_status_with_conflict_refetch(
                                self.client, update_va,
                                read_alloc=old_alloc)
                except NotFoundError:
                    continue
                if (persisted
                        and self.recorder is not None and decision is not None
                        and had_recorded_alloc
                        and target_replicas != old_desired):
                    # The audit trail where operators look first (kubectl
                    # describe va): one Normal Event per desired change
                    # with every pipeline stage's reason — recorded only
                    # AFTER the transition persisted, so a VA deleted
                    # mid-flight never gets an event for a write that
                    # never happened (same invariant as scale-from-zero).
                    trail = "; ".join(
                        f"{s.name}: {s.reason}"
                        for s in decision.decision_steps) or reason
                    self.recorder.normal(
                        update_va, "ScalingDecision",
                        f"desired replicas {old_desired} -> "
                        f"{target_replicas} on {accelerator}: {trail}")

            if not persisted:
                # The stale-write guard dropped this VA's status write in
                # favor of a newer concurrent decision. Publishing the
                # stale decision onward would defeat the guard: the
                # reconciler consumes DecisionCache from a FRESH read (no
                # conflict possible) and would re-apply exactly the value
                # the guard refused to write, flapping the just-woken
                # variant back down. Skip cache + trigger; the next tick
                # decides from the post-wake state.
                continue

            metrics_available = decision is not None
            common.DecisionCache.set(va.metadata.name, va.metadata.namespace,
                                     VariantDecision(
                                         variant_name=va.metadata.name,
                                         namespace=va.metadata.namespace,
                                         model_id=update_va.spec.model_id,
                                         accelerator_name=accelerator,
                                         target_replicas=target_replicas,
                                         # Full pipeline audit trail rides
                                         # along for "why did it scale?"
                                         # consumers (reference
                                         # DecisionSteps).
                                         decision_steps=list(
                                             decision.decision_steps)
                                         if decision else [],
                                         last_run_time=now,
                                         metrics_available=metrics_available,
                                         metrics_reason=(METRICS_REASON_AVAILABLE
                                                         if metrics_available
                                                         else METRICS_REASON_UNAVAILABLE),
                                         metrics_message=(METRICS_MESSAGE_AVAILABLE
                                                          if metrics_available
                                                          else METRICS_MESSAGE_UNAVAILABLE)),
                                     source=common.SOURCE_SATURATION,
                                     cycle=self.flight.current_cycle()
                                     if self.flight else 0)
            common.fire_trigger(va.metadata.name, va.metadata.namespace)

    def _maybe_fast_actuate(self, va: VariantAutoscaling,
                            decision: VariantDecision | None,
                            fast_by_ns: dict[str, bool] | None = None,
                            ) -> None:
        """When the namespace opts into ``fastActuation``, apply scale-UP
        decisions to the scale subresource immediately. On TPU the
        provisioning horizon dwarfs everything else, so the HPA sync period
        + stabilization window between "gauge moved" and "replicas moved" is
        pure added backlog; HPA still reads the same gauge and converges to
        the same value. Scale-down is never fast-tracked (stays HPA-paced
        with its down-stabilization damping), and failures only log — the
        metric path above remains the authoritative actuation channel."""
        if self.direct_actuator is None or decision is None:
            return
        if decision.target_replicas <= max(decision.current_replicas, 0):
            return
        # The per-namespace config resolution deep-copies a fleet-sized
        # section; the apply pass memoizes the probe per tick.
        ns = va.metadata.namespace
        if fast_by_ns is not None and ns in fast_by_ns:
            enabled = fast_by_ns[ns]
        else:
            cfg = self.config.saturation_config_for_namespace(
                ns).get("default")
            enabled = cfg is not None and cfg.fast_actuation
            if fast_by_ns is not None:
                fast_by_ns[ns] = enabled
        if not enabled:
            return
        try:
            changed = self.direct_actuator.scale_target_object(
                va.spec.scale_target_ref.kind, va.metadata.namespace,
                va.spec.scale_target_ref.name, decision.target_replicas,
                only_up=True)
        except NotFoundError:
            return
        except Exception as e:  # noqa: BLE001 — fast path is best-effort
            log.warning("Fast actuation failed for %s/%s: %s",
                        va.metadata.namespace, va.metadata.name, e)
            return
        if changed:
            log.info("Fast actuation: %s/%s scaled up to %d ahead of HPA",
                     va.metadata.namespace, va.metadata.name,
                     decision.target_replicas)

    def _emit_safety_net_metrics(self, model_vas: list[VariantAutoscaling],
                                 client: KubeClient | None = None) -> None:
        """On analysis failure, emit previous-desired or current replicas so
        the external HPA keeps a signal (reference engine.go:1022-1095).
        Scale targets come from the tick snapshot — the tick already LISTed
        them, so the safety net must not pay fresh per-VA GETs."""
        client = client or self.client
        for va in model_vas:
            current = 0
            try:
                tgt = scale_target.scale_target_state(client.get(
                    va.spec.scale_target_ref.kind, va.metadata.namespace,
                    va.spec.scale_target_ref.name))
                # OBSERVED replicas only, same rule as Actuator.emit_metrics
                # (both write the same gauges): a spec fallback here would
                # overwrite the 0->N ratio encoding with current=N whenever
                # the safety net fires during the scale-from-zero window.
                current = tgt.status_replicas
            except (NotFoundError, TypeError):
                log.debug("Safety net: scale target missing for %s",
                          va.metadata.name)

            if va.status.desired_optimized_alloc.num_replicas > 0:
                desired = va.status.desired_optimized_alloc.num_replicas
            else:
                desired = current

            accelerator = va.status.desired_optimized_alloc.accelerator or \
                variant_utils.get_accelerator_type(va)
            if not accelerator:
                log.info("Safety net: no accelerator for %s, skipping emission",
                         va.metadata.name)
                continue
            self.actuator.registry.emit_replica_metrics(
                va.metadata.name, va.metadata.namespace, accelerator,
                current, desired)
            log.info("Safety net: emitted fallback metrics for %s "
                     "(current=%d desired=%d)", va.metadata.name, current, desired)

