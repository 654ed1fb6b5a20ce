"""Decision pipeline stages: the cost-aware optimizer so far."""

from wva_tpu_torch.pipeline.optimizer import (
    CostAwareOptimizer,
    ModelScalingRequest,
    ScalingOptimizer,
    saturation_targets_to_decisions,
)

__all__ = [
    "CostAwareOptimizer",
    "ModelScalingRequest",
    "ScalingOptimizer",
    "saturation_targets_to_decisions",
]
