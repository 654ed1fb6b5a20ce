"""Common analyzer interface (reference ``internal/interfaces/analyzer.go:15-113``).

Analyzers observe workload metrics and produce capacity signals
(required_capacity / spare_capacity); they do NOT build scaling plans — the
engine and optimizer do. Implementations in this repo:

- ``wva_tpu_torch.analyzers.saturation_v2.SaturationV2Analyzer`` (name "saturation")
- ``wva_tpu_torch.analyzers.queueing.QueueingModelAnalyzer`` (name "slo") — the
  successor of the reference's dormant inferno optimizer, JAX-vectorized.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field

from wva_tpu_torch.api.v1alpha1 import DEFAULT_VARIANT_COST
from wva_tpu_torch.interfaces.allocation import OptimizerMetrics
from wva_tpu_torch.interfaces.replica_metrics import ReplicaMetrics, SchedulerQueueMetrics
from wva_tpu_torch.interfaces.decision import VariantReplicaState


@dataclass
class VariantCapacity:
    """Per-variant capacity in analyzer-specific units (reference :93-113).
    Saturation V2: tokens. SLO analyzer: latency-constrained req/s."""

    variant_name: str = ""
    accelerator_name: str = ""
    cost: float = DEFAULT_VARIANT_COST
    replica_count: int = 0
    pending_replicas: int = 0
    per_replica_capacity: float = 0.0
    total_capacity: float = 0.0
    total_demand: float = 0.0
    utilization: float = 0.0


@dataclass
class AnalyzerResult:
    """Common analyzer output (reference :69-89)."""

    analyzer_name: str = ""
    model_id: str = ""
    namespace: str = ""
    analyzed_at: float = 0.0
    variant_capacities: list[VariantCapacity] = field(default_factory=list)
    total_supply: float = 0.0
    total_demand: float = 0.0
    utilization: float = 0.0
    # >0 means scale-up needed: demand/scale_up_threshold - anticipated supply.
    required_capacity: float = 0.0
    # >0 means scale-down possible: supply - demand/scale_down_boundary.
    spare_capacity: float = 0.0
    # Observed request mix (set by analyzers that compute it; consumed by the
    # global optimizer's queueing-model candidate sizing).
    avg_input_tokens: float = 0.0
    avg_output_tokens: float = 0.0
    # What a scale-up should size FOR (req/s): demand plus trend
    # anticipation over the provisioning horizon plus backlog-drain
    # projection. 0 when the analyzer doesn't compute it; consumers fall
    # back to total_demand. The fleet-wide (global) solve uses this so its
    # assignments anticipate the same way per-model decisions do.
    scaling_demand: float = 0.0
    # Standing spare capacity (req/s) the policy wants provisioned at all
    # times (headroomReplicas floor / derived burst insurance).
    headroom_capacity: float = 0.0


@dataclass
class AnalyzerInput:
    """Common analyzer input (reference :32-44)."""

    model_id: str = ""
    namespace: str = ""
    replica_metrics: list[ReplicaMetrics] = field(default_factory=list)
    variant_states: list[VariantReplicaState] = field(default_factory=list)
    config: object | None = None  # AnalyzerConfig (SaturationScalingConfig, ...)
    scheduler_queue: SchedulerQueueMetrics | None = None
    # Model-level rate/latency telemetry for the SLO analyzer family
    # (reference internal/interfaces/metrics_collector.go:12-24).
    optimizer_metrics: "OptimizerMetrics | None" = None
    # Resolved SLO config (service classes + profiles) for this model's
    # namespace — passed explicitly so analysis is not order-dependent on
    # which namespace the analyzer synced last. Typed as object to avoid an
    # interfaces -> config dependency (it is a config.slo.SLOConfigData).
    slo_config: object | None = None


class Analyzer(abc.ABC):
    """Common interface for all scaling analyzers (reference :15-22)."""

    @abc.abstractmethod
    def name(self) -> str:
        """Analyzer identifier, e.g. "saturation", "slo"."""

    @abc.abstractmethod
    def analyze(self, input: AnalyzerInput) -> AnalyzerResult:
        """Compute capacity signals for a model across all its variants."""
