"""Pipeline decision state shared across analyzer -> optimizer -> enforcer ->
limiter stages (reference ``internal/interfaces/saturation_analyzer.go:74-243``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

from wva_tpu_torch.api.v1alpha1 import DEFAULT_VARIANT_COST, CrossVersionObjectReference
from wva_tpu_torch.interfaces.allocation import Allocation
from wva_tpu_torch.utils.clock import SYSTEM_CLOCK

# Scaling actions (reference :219-225).
ACTION_SCALE_UP = "scale-up"
ACTION_SCALE_DOWN = "scale-down"
ACTION_NO_CHANGE = "no-change"


@dataclass
class VariantSaturationAnalysis:
    """Saturation analysis for a single variant (reference :96-107)."""

    variant_name: str = ""
    accelerator_name: str = ""
    cost: float = DEFAULT_VARIANT_COST
    replica_count: int = 0
    non_saturated_count: int = 0
    max_kv_cache_usage: float = 0.0
    max_queue_length: int = 0
    avg_spare_kv_capacity: float = 0.0
    avg_spare_queue_length: float = 0.0
    saturated_replicas: list[str] = field(default_factory=list)


@dataclass
class ModelSaturationAnalysis:
    """Model-wide saturation analysis across variants (reference :74-93)."""

    model_id: str = ""
    namespace: str = ""
    analyzed_at: float = 0.0
    total_replicas: int = 0
    non_saturated_count: int = 0
    avg_spare_kv_capacity: float = 0.0
    avg_spare_queue_length: float = 0.0
    should_scale_up: bool = False
    scale_up_reason: str = ""
    scale_down_safe: bool = False
    variant_analyses: list[VariantSaturationAnalysis] = field(default_factory=list)


@dataclass
class DecisionStep:
    """One pipeline stage's contribution (reference :111-124)."""

    name: str
    action: str
    target_replicas: int
    reason: str
    was_constrained: bool = False
    timestamp: float = 0.0


@dataclass
class VariantReplicaState:
    """Current/desired/pending replica counts for a variant (reference :228-243).

    ``chips_per_replica`` replaces the reference's ``GPUsPerReplica``: the
    number of TPU chips one replica consumes, i.e. chips-per-host x hosts-per-
    slice for multi-host slices (derived from the pod template's
    ``google.com/tpu`` requests and the slice topology).
    """

    variant_name: str = ""
    # TPU slice variant serving this variant (VA accelerator label); lets
    # analyzers resolve per-(model, accelerator) profiles for variants that
    # currently have zero ready replicas.
    accelerator_name: str = ""
    current_replicas: int = 0
    desired_replicas: int = 0
    # Pods that exist but are not Ready (slice provisioning + model load can
    # take minutes on TPU node pools — used to block cascade scaling).
    pending_replicas: int = 0
    chips_per_replica: int = 1
    # Hosts per slice: a multi-host slice replica is hosts_per_slice pods that
    # become ready together (SURVEY.md section 7 "hard parts" #2).
    hosts_per_slice: int = 1

    @property
    def ready_replicas(self) -> int:
        """Replicas actually serving (slice provisioned + model loaded)."""
        return max(self.current_replicas - self.pending_replicas, 0)


@dataclass
class VariantDecision:
    """Scaling decision for a single variant — the shared state that flows
    through the pipeline (reference :136-194). Stages append to
    ``decision_steps`` via :meth:`add_step`."""

    variant_name: str = ""
    namespace: str = ""
    model_id: str = ""
    accelerator_name: str = ""
    cost: float = DEFAULT_VARIANT_COST

    action: str = ACTION_NO_CHANGE
    current_replicas: int = 0
    target_replicas: int = 0
    original_target_replicas: int = 0
    desired_replicas: int = 0

    chips_per_replica: int = 1
    spare_capacity: float = 0.0  # 0.0 saturated .. 1.0 idle
    scale_target_ref: CrossVersionObjectReference | None = None

    decision_steps: list[DecisionStep] = field(default_factory=list)
    reason: str = ""

    saturation_based: bool = False
    model_based_decision: bool = False
    safety_override: bool = False
    last_run_time: float = 0.0
    saturation_only: bool = True

    current_allocation: Allocation | None = None

    chips_allocated: int = 0
    was_limited: bool = False
    limited_by: str = ""

    metrics_available: bool = False
    metrics_reason: str = ""
    metrics_message: str = ""

    def add_step(self, name: str, reason: str, was_constrained: bool = False,
                 now: float | None = None) -> None:
        # Callers on the decision path pass the pipeline's injected clock
        # time; SYSTEM_CLOCK is the fallback for ad-hoc callers only (never
        # a bare time.time() — replay determinism, see utils/clock.py).
        self.decision_steps.append(
            DecisionStep(
                name=name,
                action=self.action,
                target_replicas=self.target_replicas,
                reason=reason,
                was_constrained=was_constrained,
                timestamp=SYSTEM_CLOCK.now() if now is None else now,
            )
        )

    def last_step(self) -> DecisionStep | None:
        return self.decision_steps[-1] if self.decision_steps else None

    def isolated_copy(self) -> "VariantDecision":
        """Cheap isolation copy for decision memoization/re-emission
        (the engine's fingerprint-skip heartbeat): everything the
        pipeline mutates after emission is either a scalar field
        (rebinds — a shallow copy isolates) or ``decision_steps``
        (append-only, steps themselves immutable — a fresh list
        isolates). Nested objects are never mutated in place by any
        pipeline stage, so sharing them is safe; a deepcopy here cost
        O(fleet) allocations per quiet tick."""
        d = copy.copy(self)
        d.decision_steps = list(self.decision_steps)
        return d
