"""Allocation + load-profile types (reference ``internal/interfaces/allocation.go:4-37``,
``metrics_collector.go:12-24``)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class LoadProfile:
    """Workload characteristics for the current allocation. String-typed for
    flexible formats, matching the reference CRD conventions."""

    arrival_rate: str = ""  # requests/min
    avg_input_tokens: str = ""
    avg_output_tokens: str = ""


@dataclass
class Allocation:
    """Current resource allocation for a model variant."""

    accelerator: str = ""  # TPU slice variant, e.g. "v5e-8"
    num_replicas: int = 0
    max_batch: int = 0
    itl_average: str = ""  # ms
    ttft_average: str = ""  # ms
    load: LoadProfile = field(default_factory=LoadProfile)


@dataclass
class MetricsValidationResult:
    available: bool = False
    reason: str = ""
    message: str = ""


@dataclass
class OptimizerMetrics:
    """Raw metrics for the SLO optimizer path (reference metrics_collector.go:12-24)."""

    arrival_rate: float = 0.0  # requests per minute
    avg_input_tokens: float = 0.0
    avg_output_tokens: float = 0.0
    ttft_seconds: float = 0.0
    itl_seconds: float = 0.0
