"""SLO (queueing-model) analyzer — successor of the reference's dormant
"inferno" model-based optimizer (``pkg/analyzer``, ``internal/modelanalyzer``),
re-built as a third first-class :class:`~wva_tpu_torch.interfaces.Analyzer` behind
the same ``analyzerName`` switch that selects V2 (reference engine.go:236-254),
so the whole engine → optimizer → enforcer → limiter pipeline is reused
unchanged.

Capacity semantics: a variant replica's capacity is the **max request rate
(req/s) it can sustain while meeting the model's SLO targets** (TTFT/ITL/TPS
from the service-class config), computed by sizing the M/M/1 state-dependent
queue model (``pkg/analyzer/queueanalyzer.go:183-258``). Demand is the model's
observed arrival rate. Required/spare capacity then use the same
scale-up-threshold / scale-down-boundary headroom algebra as V2
(``internal/interfaces/saturation_scaling.go:54-57``) so the
CostAwareOptimizer consumes the result directly.

Every variant of every model in the tick is sized in ONE batched call
(:func:`~wva_tpu_torch.analyzers.queueing.queue_model.size_batch`): on the
card the per-candidate chain setup runs as PyTorch ops and the 48-step
bisection as one launch of the CUDA sizing kernel.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np
import torch

from wva_tpu_torch.analyzers.queueing.params import (
    PerfProfile,
    PerfProfileStore,
    RequestSize,
    TargetPerf,
)
from wva_tpu_torch.analyzers.queueing.queue_model import (
    candidate_batch,
    size_batch_bucketed,
)
from wva_tpu_torch.analyzers.trend import DemandTrend
from wva_tpu_torch.api.v1alpha1 import DEFAULT_VARIANT_COST
from wva_tpu_torch.device import resolve_device

if TYPE_CHECKING:  # pragma: no cover — config.slo imports queueing.params
    from wva_tpu_torch.config.slo import SLOConfigData
from wva_tpu_torch.interfaces import (
    DEFAULT_SCALE_DOWN_BOUNDARY,
    DEFAULT_SCALE_UP_THRESHOLD,
    Analyzer,
    AnalyzerInput,
    AnalyzerResult,
    SaturationScalingConfig,
    VariantCapacity,
)
from wva_tpu_torch.interfaces.saturation_config import SLO_ANALYZER_NAME
from wva_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock

log = logging.getLogger(__name__)

# Fallback request mix when no fresh replica reports token averages — matches
# the V2 estimation defaults (reference saturation_v2/constants.go).
DEFAULT_AVG_INPUT_TOKENS = 512.0
DEFAULT_AVG_OUTPUT_TOKENS = 256.0
# Backlogged requests count as demand to be served within this horizon —
# short enough that the solver sizes recovery capacity after a saturation
# episode (sub-second TTFT SLOs cannot tolerate minutes-long drains), long
# enough not to thrash on transient queue blips (≈ one engine tick).
BACKLOG_DRAIN_HORIZON_SECONDS = 15.0

# Trend fit bounds. The fast-path monitor feeds demand samples every few
# seconds (in addition to one per engine tick), so a 10s span already holds
# several points and the least-squares fit is stable; the sparse
# engine-tick-only fallback is covered by min_samples.
TREND_MIN_SPAN_SECONDS = 10.0
TREND_MIN_SAMPLES = 3
# Window for the slope fit: short enough that a real ramp dominates the fit
# quickly (with a window of w, a ramp r seconds old reads as roughly
# slope x r^2(3w-2r)/w^3 — a 180s window would halve the apparent slope for
# 90s, sizing lag the SLO cannot afford), long enough that the fast-path
# feed (every ~5s) still averages ~a dozen points.
TREND_WINDOW_SECONDS = 60.0
# Recent-suffix fit (see DemandTrend.fast_window_seconds): halves the time
# for a fresh ramp to dominate the slope estimate.
TREND_FAST_WINDOW_SECONDS = 30.0
# Telemetry spin-up margin added to the arrival-rate window for the trend
# age gate (see DemandTrend.min_age_seconds).
TREND_MIN_AGE_MARGIN_SECONDS = 10.0


def _trend_min_age_seconds() -> float:
    """Age gate for new demand series: the arrival-rate query's rate()
    window plus margin — while the backing counter series is younger than
    its window, the measured rate climbs from 0 to the true value and the
    fit would read the climb as a real ramp."""
    from wva_tpu_torch.collector.registration.slo import arrival_rate_window_seconds

    return arrival_rate_window_seconds() + TREND_MIN_AGE_MARGIN_SECONDS


def demand_estimate(arrival_rate_per_min: float, backlog: float) -> float:
    """Demand (req/s) = completion rate + backlog drained within the recovery
    horizon. Shared by analyze() and the fast-path trend feed so the trend
    series mixes consistent units."""
    return (max(arrival_rate_per_min, 0.0) / 60.0
            + max(backlog, 0.0) / BACKLOG_DRAIN_HORIZON_SECONDS)


def finalize_algebra(
    demand: float,
    slope: float,
    supply: float,
    anticipated: float,
    best_headroom_capacity: float | None,
    scale_up: float,
    scale_down: float,
    horizon: float,
    headroom_replicas: float,
    burst_slope_rps: float,
) -> tuple[float, float, float, float, float]:
    """The scalar supply/demand headroom algebra of :meth:`finalize` as a
    pure function — the ONE source of truth shared by the per-model path
    and the vectorized fleet pass (``wva_tpu_torch.pipeline.vectorized``), whose
    WVA_VEC_ASSERT cross-check replays exactly these ops per row. Returns
    ``(scaling_demand, headroom_capacity, utilization, required_capacity,
    spare_capacity)``."""
    # Provisioning-horizon anticipation (growth only): scale-up sizes for
    # projected demand, scale-down keeps using current demand.
    scaling_demand = demand
    if horizon > 0:
        scaling_demand += max(slope, 0.0) * horizon
    # Deficit-aware anticipation: while demand is ramping, requests arriving
    # above the fleet's capacity accumulate as backlog until the ordered
    # replicas become ready — size the scale-up to DRAIN the backlog that
    # will exist at landing, not just for demand AT landing. Pending
    # replicas count (anticipated): once they land mid-horizon the real
    # remaining shortfall re-enters through the live backlog term.
    if horizon > 0 and slope > 0:
        t0 = 0.0 if demand >= anticipated else \
            min((anticipated - demand) / slope, horizon)
        deficit_requests = ((demand - anticipated) * (horizon - t0)
                            + slope * (horizon * horizon - t0 * t0) / 2.0)
        if deficit_requests > 0:
            scaling_demand += deficit_requests / BACKLOG_DRAIN_HORIZON_SECONDS
    # Standing spare-capacity floor (headroomReplicas / burstSlope): one
    # headroom replica = one replica of the variant the optimizer would add
    # first (best cost-efficiency — the caller resolves that pair).
    headroom_capacity = 0.0
    if headroom_replicas > 0 and best_headroom_capacity is not None:
        headroom_capacity = headroom_replicas * best_headroom_capacity
    if burst_slope_rps > 0 and horizon > 0:
        headroom_capacity = max(headroom_capacity, burst_slope_rps * horizon)
    utilization = demand / supply if supply > 0 else (1.0 if demand > 0 else 0.0)
    # Same anticipated-supply headroom algebra as V2
    # (saturation_v2/analyzer.go:104-138 via saturation_scaling.go:54-57).
    required_capacity = max(
        scaling_demand / scale_up + headroom_capacity - anticipated, 0.0)
    spare_capacity = max(
        supply - demand / scale_down - headroom_capacity, 0.0) \
        if supply > 0 else 0.0
    # Never remove capacity while demand is growing: a scale-down decided
    # mid-ramp cannot be corrected for a whole provisioning horizon.
    if horizon > 0 and slope > 0:
        spare_capacity = 0.0
    return (scaling_demand, headroom_capacity, utilization,
            required_capacity, spare_capacity)


def accumulate_capacities(
    result: AnalyzerResult,
    candidates: list["_Candidate"],
    per_replica: list[float],
    headroom_replicas: float,
) -> tuple[float, float, float | None]:
    """The candidate walk of :meth:`finalize`: append one VariantCapacity
    per sized candidate and return ``(supply, anticipated,
    best_headroom_capacity)``. The left-to-right scalar sums are kept —
    summation order is exactly where a numpy reduction would stop being
    bitwise-identical to the per-model path — and shared with the
    vectorized fleet pass so both paths run THIS walk."""
    supply = 0.0
    anticipated = 0.0
    for cand, cap in zip(candidates, per_replica):
        total = cap * cand.ready
        supply += total
        anticipated += cap * (cand.ready + cand.pending)
        result.variant_capacities.append(VariantCapacity(
            variant_name=cand.variant_name,
            accelerator_name=cand.accelerator,
            cost=cand.cost,
            replica_count=cand.ready,
            pending_replicas=cand.pending,
            per_replica_capacity=cap,
            total_capacity=total,
            total_demand=0.0,
            utilization=0.0,
        ))
    best_headroom_capacity = None
    if headroom_replicas > 0:
        # One headroom replica = one replica of the best cost-efficiency
        # variant (ties break on capacity via the tuple compare), so the
        # knob and the optimizer's fill order agree on what "a spare
        # replica" is.
        pairs = [(cand.cost / cap, cap)
                 for cand, cap in zip(candidates, per_replica) if cap > 0]
        if pairs:
            best_headroom_capacity = min(pairs)[1]
    return supply, anticipated, best_headroom_capacity


@dataclass
class _Candidate:
    """One (variant, accelerator) sizing candidate prepared for the batch."""

    variant_name: str
    accelerator: str
    cost: float
    ready: int  # Ready replicas actually serving (current - pending)
    pending: int  # exist-but-not-Ready pods (slice provisioning/model load)
    profile: PerfProfile
    targets: TargetPerf
    request_size: RequestSize = field(default_factory=RequestSize)


@dataclass
class SizingPlan:
    """One model's SLO analysis, prepared up to (but not including) the
    device sizing call.

    The engine collects every model's plan, concatenates the candidates,
    runs ONE padded shape-bucketed :meth:`QueueingModelAnalyzer.size_candidates`
    call for the whole tick, and then :meth:`finalize`\\ s each plan with its
    slice of the per-replica capacities — so a 50-model tick costs one
    device dispatch instead of 50. ``analyze`` composes the same three steps
    for single-model callers (replay, tests, fast path).

    ``needs_sizing`` False means the analysis short-circuited (no SLO
    config/targets/telemetry/candidates) and ``result`` is already final.
    """

    input: AnalyzerInput
    result: AnalyzerResult
    candidates: list[_Candidate] = field(default_factory=list)
    needs_sizing: bool = False


class QueueingModelAnalyzer(Analyzer):
    """interfaces.Analyzer implementation selected by ``analyzerName: "slo"``."""

    def __init__(self, profiles: PerfProfileStore | None = None,
                 clock: Clock | None = None, device=None,
                 impl: str | None = None) -> None:
        self.profiles = profiles or PerfProfileStore()
        self.clock = clock or SYSTEM_CLOCK
        # Where the sizing batch lives (None = the CUDA card). ``impl`` is
        # passed to size_batch: "plain" forces the kernel's plain version
        # on any device (tests and the on-card oracle); None lets the
        # device decide.
        self.device = resolve_device(device)
        self.impl = impl
        self._demand_trend = DemandTrend(
            window_seconds=TREND_WINDOW_SECONDS,
            min_span_seconds=TREND_MIN_SPAN_SECONDS,
            min_samples=TREND_MIN_SAMPLES,
            min_age_seconds=_trend_min_age_seconds(),
            fast_window_seconds=TREND_FAST_WINDOW_SECONDS)
        # Last-synced config per namespace scope ("" = global); analyze()
        # resolves namespace-local > global, never another namespace's.
        self._slo_by_ns: dict[str, SLOConfigData | None] = {}

    def name(self) -> str:
        return SLO_ANALYZER_NAME

    def prune(self, active_model_keys: set[str]) -> None:
        """Drop demand-trend series for models that no longer exist."""
        self._demand_trend.evict_missing(active_model_keys)

    def demand_trend_stats(self, now: float):
        """Per-key trend estimator health (engine surfaces it as
        ``wva_trend_*`` gauges)."""
        return self._demand_trend.stats(now)

    def observe_demand(self, namespace: str, model_id: str, now: float,
                       arrival_rate_per_min: float, backlog: float) -> None:
        """Feed an out-of-tick demand sample into the trend estimator (the
        fast-path monitor calls this every few seconds, so the anticipation
        slope is available within the first engine tick instead of after
        several)."""
        self._demand_trend.observe(
            f"{namespace}|{model_id}", now,
            demand_estimate(arrival_rate_per_min, backlog))

    def sync_from_config(self, cfg: SLOConfigData | None,
                         namespace: str = "") -> None:
        """Adopt service classes + profiles from the hot-reloaded SLO
        ConfigMap for one namespace scope ("" = global). Config-sourced
        profiles are replaced wholesale (updates and deletions both take
        effect); tuner-refined parameters survive re-syncs
        (:meth:`PerfProfileStore.sync_namespace`)."""
        self._slo_by_ns[namespace] = cfg
        self.profiles.sync_namespace(
            namespace, list(cfg.profiles) if cfg is not None else [])

    # -- analysis --

    def analyze(self, input: AnalyzerInput) -> AnalyzerResult:
        plan = self.prepare(input)
        if not plan.needs_sizing:
            return plan.result
        return self.finalize(plan, self.size_candidates(plan.candidates))

    def prepare(self, input: AnalyzerInput) -> SizingPlan:
        """Everything before the device sizing call: config/targets/telemetry
        gates and candidate prep. Pure reads of shared state (profile store,
        config) — safe to run concurrently across models; the stateful trend
        update happens in :meth:`finalize`."""
        result = AnalyzerResult(
            analyzer_name=self.name(),
            model_id=input.model_id,
            namespace=input.namespace,
            analyzed_at=self.clock.now(),
        )
        plan = SizingPlan(input=input, result=result)
        slo = input.slo_config
        if slo is None:
            # Namespace-local > global resolution; NEVER another namespace's
            # config (order-independence across the engine's model loop).
            slo = self._slo_by_ns.get(input.namespace)
            if slo is None:
                slo = self._slo_by_ns.get("")
        if slo is None:
            log.warning("SLO analyzer selected but no SLO config loaded; "
                        "model %s skipped", input.model_id)
            return plan
        targets, _priority = slo.targets_for_model(input.model_id)
        if targets is None:
            log.info("No SLO targets for model %s; skipped", input.model_id)
            return plan
        if input.optimizer_metrics is None:
            # Unknown demand must never read as zero demand — a Prometheus
            # outage would otherwise scale the fleet down while traffic
            # continues (fail-safe, same spirit as the V2 path skipping a
            # model with no metrics and enforcer.go:100-106).
            log.warning("Arrival-rate telemetry unavailable for model %s; "
                        "skipping SLO analysis this tick", input.model_id)
            return plan

        request_size = self._observed_request_size(input)
        result.avg_input_tokens = request_size.avg_input_tokens
        result.avg_output_tokens = request_size.avg_output_tokens
        plan.candidates = self._prepare_candidates(input, targets, request_size)
        plan.needs_sizing = bool(plan.candidates)
        return plan

    def plan_demand(self, plan: SizingPlan) -> float:
        """The demand (req/s) :meth:`finalize` will report as
        ``total_demand`` — a pure function of the prepared input, exposed
        so the fused decision plane can feed the forecast planner BEFORE
        the device dispatch (the value is bitwise what finalize computes
        from the same plan)."""
        return self._demand_per_s(plan.input)

    def finalize(self, plan: SizingPlan,
                 per_replica: list[float]) -> AnalyzerResult:
        """Turn sized candidates into the AnalyzerResult: supply/demand
        aggregation, trend anticipation, headroom algebra. MUST be called
        exactly once per sized plan and in a deterministic model order (it
        feeds the per-model demand-trend series)."""
        input, result, candidates = plan.input, plan.result, plan.candidates
        cfg = input.config if isinstance(input.config, SaturationScalingConfig) else SaturationScalingConfig()
        scale_up = cfg.scale_up_threshold or DEFAULT_SCALE_UP_THRESHOLD
        scale_down = cfg.scale_down_boundary or DEFAULT_SCALE_DOWN_BOUNDARY

        demand = self._demand_per_s(input)
        # The TREND series deliberately uses the same estimate the
        # fast-path monitor feeds (arrival rate + scheduler flow-control
        # backlog, NO per-replica queues): mixing two demand definitions at
        # different cadences would sawtooth the least-squares slope.
        # Per-replica queueing still counts in the sizing demand above.
        slope = self._demand_trend.observe(
            f"{input.namespace}|{input.model_id}", result.analyzed_at,
            self._trend_demand_per_s(input))
        supply, anticipated, best_headroom = accumulate_capacities(
            result, candidates, per_replica, cfg.headroom_replicas)
        (result.scaling_demand, result.headroom_capacity,
         result.utilization, result.required_capacity,
         result.spare_capacity) = finalize_algebra(
            demand, slope, supply, anticipated, best_headroom,
            scale_up, scale_down, cfg.anticipation_horizon_seconds,
            cfg.headroom_replicas, cfg.burst_slope_rps)
        result.total_supply = supply
        result.total_demand = demand
        return result

    # -- internals --

    def _observed_request_size(self, input: AnalyzerInput) -> RequestSize:
        ins: list[float] = []
        outs: list[float] = []
        for rm in input.replica_metrics:
            if rm.avg_input_tokens > 0:
                ins.append(rm.avg_input_tokens)
            if rm.avg_output_tokens > 0:
                outs.append(rm.avg_output_tokens)
        return RequestSize(
            avg_input_tokens=sum(ins) / len(ins) if ins else DEFAULT_AVG_INPUT_TOKENS,
            avg_output_tokens=max(sum(outs) / len(outs) if outs else DEFAULT_AVG_OUTPUT_TOKENS, 1.0),
        )

    def _demand_per_s(self, input: AnalyzerInput) -> float:
        """Observed demand (req/s). OptimizerMetrics carries req/min
        (reference metrics_collector.go:12-24) — but that telemetry is a
        COMPLETION rate: under saturation it caps at capacity and hides
        excess demand. The excess is visible as backlog — per-replica
        waiting queues (prefill backlog on JetStream) plus the scheduler
        flow-control queue (mirroring V2's queue-demand estimate,
        saturation_v2/analyzer.go:476-502) — counted here as demand to be
        drained within a short horizon: with sub-second TTFT SLOs, a
        backlog drained over a minute is a minute of misses, so the solver
        must size recovery capacity, not just steady-state capacity."""
        rate_per_min = (input.optimizer_metrics.arrival_rate
                        if input.optimizer_metrics is not None else 0.0)
        backlog = sum(max(rm.queue_length, 0) for rm in input.replica_metrics)
        if input.scheduler_queue is not None:
            backlog += max(input.scheduler_queue.queue_size, 0)
        return demand_estimate(rate_per_min, backlog)

    def _trend_demand_per_s(self, input: AnalyzerInput) -> float:
        """The trend-series demand: exactly what the fast-path monitor can
        observe at its cadence (see :meth:`observe_demand`)."""
        rate_per_min = (input.optimizer_metrics.arrival_rate
                        if input.optimizer_metrics is not None else 0.0)
        backlog = (max(input.scheduler_queue.queue_size, 0)
                   if input.scheduler_queue is not None else 0.0)
        return demand_estimate(rate_per_min, backlog)

    def _prepare_candidates(
        self, input: AnalyzerInput, targets: TargetPerf, request_size: RequestSize,
    ) -> list[_Candidate]:
        candidates: list[_Candidate] = []
        for vs in input.variant_states:
            profile = self.profiles.get(input.model_id, vs.accelerator_name,
                                        namespace=input.namespace)
            if profile is None or not profile.service_parms.valid():
                log.warning(
                    "No perf profile for (%s, %s); variant %s excluded from "
                    "SLO sizing", input.model_id, vs.accelerator_name,
                    vs.variant_name)
                continue
            cost = DEFAULT_VARIANT_COST
            for rm in input.replica_metrics:
                if rm.variant_name == vs.variant_name:
                    cost = rm.cost
                    break
            # Same ready/pending split as V2 (saturation_v2/analyzer.py:259):
            # not-yet-Ready slices are anticipated supply, not active supply.
            candidates.append(_Candidate(
                variant_name=vs.variant_name,
                accelerator=vs.accelerator_name,
                cost=cost,
                ready=vs.ready_replicas,
                pending=vs.pending_replicas,
                profile=profile,
                targets=targets,
                request_size=request_size,
            ))
        return candidates

    def size_candidates(self, candidates: list[_Candidate]) -> list[float]:
        """One batched sizing call across every candidate. The batch is
        padded to power-of-two buckets (min 8) so a fleet keeps a handful
        of shapes. ``size_batch_bucketed`` also trims the state axis to the
        fleet's largest occupancy bound — the ``k_host`` ints are already in
        hand, so no device sync is paid for the trim decision."""
        from wva_tpu_torch.utils import dispatch

        dispatch.note()
        n = len(candidates)
        cand, t_ttft, t_itl, t_tps, ks = build_sizing_batch(
            candidates, self.device)
        out = size_batch_bucketed(cand, t_ttft, t_itl, t_tps, k_host=ks,
                                  impl=self.impl)
        # ONE host transfer for the whole batch: iterating the device
        # tensor (`float(x) for x in ...`) would pay a device->host read per
        # element.
        return out["max_rate_per_s"][:n].cpu().numpy().astype(
            np.float64).tolist()


def build_sizing_batch(candidates: list[_Candidate], device=None):
    """THE sizing-batch construction: pad the candidate list to its
    power-of-two bucket (min 8, repeating the first candidate — padding
    rows are sliced off and row-independent) and lay the profiles /
    request mixes / targets out as tensors on ``device`` (None = the CUDA
    card). Returns ``(CandidateBatch, t_ttft, t_itl, t_tps, ks)`` with
    ``ks`` the padded occupancy bounds (host ints, for the state-axis
    trim)."""
    dev = resolve_device(device)
    n = len(candidates)
    bucket = max(8, 1 << (n - 1).bit_length())
    padded = candidates + [candidates[0]] * (bucket - n)
    ks = [c.profile.max_batch_size + c.profile.max_queue_size
          for c in padded]
    cand = candidate_batch(
        [c.profile.service_parms.alpha for c in padded],
        [c.profile.service_parms.beta for c in padded],
        [c.profile.service_parms.gamma for c in padded],
        [c.request_size.avg_input_tokens for c in padded],
        [c.request_size.avg_output_tokens for c in padded],
        [c.profile.max_batch_size for c in padded],
        ks,
        device=dev,
    )

    def targets(field: str) -> torch.Tensor:
        return torch.as_tensor(
            np.asarray([getattr(c.targets, field) for c in padded],
                       dtype=np.float32), device=dev)

    return (cand, targets("target_ttft_ms"), targets("target_itl_ms"),
            targets("target_tps"), ks)
