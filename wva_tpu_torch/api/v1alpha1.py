"""``VariantAutoscaling`` v1alpha1 resource types — the subset the SLO
sizing pass uses: the default per-replica cost and the scale-target
reference carried by decisions. The rest of the resource (metadata,
status, conditions) ports with the controller."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from wva_tpu_torch.utils.freeze import Freezable

# Default per-replica cost when spec.variantCost is unset
# (reference: internal/saturation/constants.go:13, api types :20-24).
DEFAULT_VARIANT_COST = 10.0


@dataclass
class CrossVersionObjectReference(Freezable):
    """HPA-style scale target reference (reference types :13)."""

    kind: str = "Deployment"
    name: str = ""
    api_version: str = "apps/v1"

    def to_dict(self) -> dict[str, Any]:
        return {"kind": self.kind, "name": self.name, "apiVersion": self.api_version}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "CrossVersionObjectReference":
        return cls(
            kind=d.get("kind", "Deployment"),
            name=d.get("name", ""),
            api_version=d.get("apiVersion", "apps/v1"),
        )
