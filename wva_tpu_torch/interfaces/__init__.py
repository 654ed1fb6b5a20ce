"""Shared cross-layer data types (reference ``internal/interfaces``)."""

from wva_tpu_torch.interfaces.replica_metrics import (
    FRESH,
    STALE,
    UNAVAILABLE,
    ReplicaMetrics,
    ReplicaMetricsMetadata,
    SchedulerQueueMetrics,
)
from wva_tpu_torch.interfaces.decision import (
    ACTION_NO_CHANGE,
    ACTION_SCALE_DOWN,
    ACTION_SCALE_UP,
    DecisionStep,
    ModelSaturationAnalysis,
    VariantDecision,
    VariantReplicaState,
    VariantSaturationAnalysis,
)
from wva_tpu_torch.interfaces.analyzer import (
    Analyzer,
    AnalyzerInput,
    AnalyzerResult,
    VariantCapacity,
)
from wva_tpu_torch.interfaces.saturation_config import (
    DEFAULT_SCALE_DOWN_BOUNDARY,
    DEFAULT_SCALE_UP_THRESHOLD,
    SaturationScalingConfig,
)
from wva_tpu_torch.interfaces.allocation import Allocation, LoadProfile

__all__ = [
    "FRESH",
    "STALE",
    "UNAVAILABLE",
    "ReplicaMetrics",
    "ReplicaMetricsMetadata",
    "SchedulerQueueMetrics",
    "ACTION_NO_CHANGE",
    "ACTION_SCALE_DOWN",
    "ACTION_SCALE_UP",
    "DecisionStep",
    "ModelSaturationAnalysis",
    "VariantDecision",
    "VariantReplicaState",
    "VariantSaturationAnalysis",
    "Analyzer",
    "AnalyzerInput",
    "AnalyzerResult",
    "VariantCapacity",
    "DEFAULT_SCALE_DOWN_BOUNDARY",
    "DEFAULT_SCALE_UP_THRESHOLD",
    "SaturationScalingConfig",
    "Allocation",
    "LoadProfile",
]
