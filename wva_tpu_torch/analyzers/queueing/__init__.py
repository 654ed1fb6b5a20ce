"""SLO (queueing-model) analyzer family in PyTorch — counterpart of
``wva_tpu.analyzers.queueing`` without the tuner, which ports later."""

from wva_tpu_torch.analyzers.queueing.params import (
    AnalysisMetrics,
    PerfProfile,
    PerfProfileStore,
    QueueConfig,
    RequestSize,
    ServiceParms,
    TargetPerf,
    TargetRate,
)
from wva_tpu_torch.analyzers.queueing.queue_model import (
    CandidateBatch,
    QueueAnalyzer,
    analyze_batch,
    candidate_batch,
    k_cols_for,
    size_batch,
    size_batch_bucketed,
)
from wva_tpu_torch.analyzers.queueing.sizing_kernel import (
    sizing_bisection,
    sizing_bisection_plain,
)
from wva_tpu_torch.analyzers.queueing.analyzer import QueueingModelAnalyzer

__all__ = [
    "AnalysisMetrics",
    "PerfProfile",
    "PerfProfileStore",
    "QueueConfig",
    "RequestSize",
    "ServiceParms",
    "TargetPerf",
    "TargetRate",
    "CandidateBatch",
    "QueueAnalyzer",
    "analyze_batch",
    "candidate_batch",
    "k_cols_for",
    "size_batch",
    "size_batch_bucketed",
    "sizing_bisection",
    "sizing_bisection_plain",
    "QueueingModelAnalyzer",
]
