"""Scaling optimizers (reference ``pipeline/{optimizer_interfaces,
cost_aware_optimizer}.go``).

``CostAwareOptimizer`` (unlimited mode): per model, scale-up fills
required_capacity on variants sorted by cost/per-replica-capacity ascending;
scale-down removes floor(spare/per_replica) from most-expensive-first with the
cheapest protected at 1 only when it is the last variant with replicas.
"""

from __future__ import annotations

import abc
import logging
import math
from dataclasses import dataclass, field

from wva_tpu_torch.interfaces import (
    ACTION_NO_CHANGE,
    ACTION_SCALE_DOWN,
    ACTION_SCALE_UP,
    AnalyzerResult,
    ModelSaturationAnalysis,
    VariantCapacity,
    VariantDecision,
    VariantReplicaState,
)

log = logging.getLogger(__name__)


def saturation_targets_to_decisions(
    targets: dict[str, int],
    analysis: ModelSaturationAnalysis,
    variant_states: list[VariantReplicaState],
    enforcer_note: str = "",
) -> list[VariantDecision]:
    """Convert V1 saturation targets to decisions (reference
    engine.go:586-659). Module-level (not an engine method) so the trace
    replay harness re-runs the exact production code path offline.
    ``enforcer_note`` carries the already-applied enforcement outcome into
    the decision audit trail (the V1 path enforces on raw targets before
    decisions exist)."""
    analyses = {va.variant_name: va for va in analysis.variant_analyses}
    states = {s.variant_name: s for s in variant_states}
    decisions = []
    for variant_name in sorted(targets):
        target = targets[variant_name]
        state = states.get(variant_name,
                           VariantReplicaState(variant_name=variant_name))
        va = analyses.get(variant_name)
        if target > state.current_replicas:
            action = ACTION_SCALE_UP
        elif target < state.current_replicas:
            action = ACTION_SCALE_DOWN
        else:
            action = ACTION_NO_CHANGE
        decision = VariantDecision(
            variant_name=variant_name,
            namespace=analysis.namespace,
            model_id=analysis.model_id,
            current_replicas=state.current_replicas,
            target_replicas=target,
            original_target_replicas=target,
            desired_replicas=state.desired_replicas,
            action=action,
            saturation_based=True,
            saturation_only=True,
            reason=f"saturation-only mode: {action}",
            chips_per_replica=max(state.chips_per_replica, 1),
        )
        if va is not None:
            decision.accelerator_name = va.accelerator_name
            decision.cost = va.cost
            decision.spare_capacity = va.avg_spare_kv_capacity
        ts = analysis.analyzed_at or None
        decision.add_step(
            "analyzer:v1",
            (analysis.scale_up_reason if analysis.should_scale_up
             else "no saturation trigger"
             f" (spare kv {analysis.avg_spare_kv_capacity:.2f},"
             f" spare queue {analysis.avg_spare_queue_length:.1f})"),
            now=ts)
        decision.add_step("optimizer:percentage",
                          f"saturation-only mode: {action}", now=ts)
        decision.add_step("enforcer", enforcer_note or "no policy change",
                          was_constrained=bool(enforcer_note), now=ts)
        decisions.append(decision)
    return decisions


@dataclass
class ModelScalingRequest:
    """Analyzer result + variant state for one model."""

    model_id: str = ""
    namespace: str = ""
    result: AnalyzerResult | None = None
    variant_states: list[VariantReplicaState] = field(default_factory=list)


class ScalingOptimizer(abc.ABC):
    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def optimize(self, requests: list[ModelScalingRequest],
                 constraints: list | None = None) -> list[VariantDecision]:
        """Produce decisions for all models; constraints may be None
        (unlimited mode)."""


def _cost_efficiency(vc: VariantCapacity) -> float:
    if vc.per_replica_capacity <= 0:
        return math.inf
    return vc.cost / vc.per_replica_capacity


class CostAwareOptimizer(ScalingOptimizer):
    # Optional blackbox.FlightRecorder: when set, every optimize() call
    # records per-model targets into the current engine cycle's trace.
    flight_recorder = None

    def name(self) -> str:
        return "cost-aware"

    def optimize(self, requests: list[ModelScalingRequest],
                 constraints: list | None = None) -> list[VariantDecision]:
        decisions: list[VariantDecision] = []
        for req in requests:
            if req.result is None:
                continue
            states = {s.variant_name: s for s in req.variant_states}
            capacities = {vc.variant_name: vc for vc in req.result.variant_capacities}
            targets = {s.variant_name: s.current_replicas for s in req.variant_states}

            if req.result.required_capacity > 0:
                self._scale_up(req.result, targets)
            elif req.result.spare_capacity > 0:
                self._scale_down(req.result, targets)

            if self.flight_recorder is not None:
                self.flight_recorder.record_stage("optimizer", {
                    "name": self.name(),
                    "model_id": req.model_id,
                    "namespace": req.namespace,
                    "required_capacity": req.result.required_capacity,
                    "spare_capacity": req.result.spare_capacity,
                    "targets": dict(targets),
                })
            decisions.extend(self._build_decisions(req, states, capacities, targets))
        return decisions

    @staticmethod
    def _scale_up(result: AnalyzerResult, targets: dict[str, int]) -> None:
        """Fill required capacity cheapest-efficiency-first (reference
        :77-104). Pending replicas are NOT skipped — the analyzer already
        counted their capacity into anticipated supply."""
        remaining = result.required_capacity
        for vc in sorted(result.variant_capacities, key=_cost_efficiency):
            if remaining <= 0:
                break
            if vc.per_replica_capacity <= 0:
                continue
            needed = math.ceil(remaining / vc.per_replica_capacity)
            targets[vc.variant_name] = targets.get(vc.variant_name, 0) + needed
            remaining -= needed * vc.per_replica_capacity

    @staticmethod
    def _scale_down(result: AnalyzerResult, targets: dict[str, int]) -> None:
        """Remove whole replicas most-expensive-first while spare covers them
        (reference :111-167)."""
        capacities = result.variant_capacities
        cheapest = min(capacities, key=lambda vc: vc.cost).variant_name \
            if capacities else ""
        remaining = result.spare_capacity
        for vc in sorted(capacities, key=lambda v: -v.cost):
            if remaining <= 0:
                break
            if vc.per_replica_capacity <= 0:
                continue
            current = targets.get(vc.variant_name, 0)
            min_replicas = 0
            if vc.variant_name == cheapest:
                # Protect cheapest at 1 only when no other variant has replicas
                # (prevents scale-down deadlock).
                other_has = any(t > 0 for name, t in targets.items()
                                if name != cheapest)
                if not other_has:
                    min_replicas = 1
            removable = current - min_replicas
            if removable <= 0:
                continue
            to_remove = min(int(remaining // vc.per_replica_capacity), removable)
            if to_remove <= 0:
                continue
            targets[vc.variant_name] = current - to_remove
            remaining -= to_remove * vc.per_replica_capacity

    def _build_decisions(
        self,
        req: ModelScalingRequest,
        states: dict[str, VariantReplicaState],
        capacities: dict[str, VariantCapacity],
        targets: dict[str, int],
    ) -> list[VariantDecision]:
        decisions = []
        for name in sorted(targets):
            target = targets[name]
            state = states.get(name, VariantReplicaState(variant_name=name))
            vc = capacities.get(name, VariantCapacity(variant_name=name))
            if target > state.current_replicas:
                action = ACTION_SCALE_UP
                reason = (f"V2 scale-up (optimizer: cost-aware, "
                          f"required: {req.result.required_capacity:.0f})")
            elif target < state.current_replicas:
                action = ACTION_SCALE_DOWN
                reason = (f"V2 scale-down (optimizer: cost-aware, "
                          f"spare: {req.result.spare_capacity:.0f})")
            else:
                action = ACTION_NO_CHANGE
                reason = "V2 steady state"
            decision = VariantDecision(
                variant_name=name,
                model_id=req.model_id,
                namespace=req.namespace,
                accelerator_name=vc.accelerator_name,
                cost=vc.cost,
                current_replicas=state.current_replicas,
                target_replicas=target,
                chips_per_replica=state.chips_per_replica,
                action=action,
                reason=reason,
            )
            # Decision audit trail (reference saturation_analyzer.go:109-124
            # DecisionSteps): one entry per pipeline stage. Decisions
            # materialize here, so the analyzer's contribution is recorded
            # first, from its result.
            ts = req.result.analyzed_at or None
            decision.add_step(
                f"analyzer:{req.result.analyzer_name or 'saturation'}",
                f"demand={req.result.total_demand:.2f} "
                f"supply={req.result.total_supply:.2f} "
                f"required={req.result.required_capacity:.2f} "
                f"spare={req.result.spare_capacity:.2f}",
                now=ts)
            decision.add_step(f"optimizer:{self.name()}", reason, now=ts)
            decisions.append(decision)
        return decisions
