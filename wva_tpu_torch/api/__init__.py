"""CRD API types: the subset of ``v1alpha1`` the port uses so far."""

from wva_tpu_torch.api.v1alpha1 import (
    DEFAULT_VARIANT_COST,
    CrossVersionObjectReference,
)

__all__ = ["DEFAULT_VARIANT_COST", "CrossVersionObjectReference"]
