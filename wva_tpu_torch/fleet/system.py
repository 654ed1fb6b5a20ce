"""Fleet system model — successor of the reference's inferno ``pkg/core``
(``system.go``, ``server.go``, ``accelerator.go``, ``serviceclass.go``),
re-designed as an explicit immutable-ish value passed to the solver instead of
a process-global singleton (``core.TheSystem``).

The TPU domain mapping:
- Accelerator = a TPU slice variant (e.g. "v5e-8": 8 chips, one host). Its
  ``type`` keys the capacity pool (chips of a generation available in the
  cluster's node pools); ``chips_per_replica`` is the whole-slice chip count —
  slices are atomic (SURVEY.md section 7 "hard parts" #1).
- Server = one autoscaled model workload (all VariantAutoscalings of a model
  in a namespace); candidate allocations place it on one slice variant.
- ServiceClass (priority + per-model SLO targets) is shared with the SLO
  analyzer config (``wva_tpu_torch.config.slo``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from wva_tpu_torch.analyzers.queueing.params import PerfProfileStore
from wva_tpu_torch.config.slo import ServiceClass

# Relative cost of switching accelerator type in a transition
# (reference pkg/config AccelPenaltyFactor semantics: allocation.go:283-292).
ACCEL_PENALTY_FACTOR = 0.1


@dataclass
class AcceleratorSpec:
    """A TPU slice variant (reference core/accelerator.go, with the
    GPU multiplicity concept collapsed into whole-slice chips)."""

    name: str = ""  # e.g. "v5e-8"
    type: str = ""  # capacity pool key, e.g. "v5e"
    chips_per_replica: int = 8  # chips consumed by one replica (whole slice)
    cost: float = 1.0  # cost of one replica (slice) per hour
    # Capacity-tier cost scaling (wva_tpu_torch.capacity.tiers): the ready-slice-
    # weighted blend of the pool's tier cost weights (reservation <
    # on-demand, spot cheapest). 1.0 = tier-agnostic (pre-capacity
    # behavior). The solver sees effective per-replica cost
    # ``cost * tier_cost_weight``, so a spot-backed pool genuinely
    # competes on price.
    tier_cost_weight: float = 1.0

    @property
    def effective_cost(self) -> float:
        return self.cost * self.tier_cost_weight
    # Piecewise-linear power model (idle->peak watts per chip), kept for
    # parity with the reference's accelerator power model
    # (core/accelerator.go:29-42); informational.
    power_idle_w: float = 0.0
    power_peak_w: float = 0.0


@dataclass
class ServerLoad:
    """Observed workload of a server (reference config.ServerLoadSpec)."""

    arrival_rate_per_min: float = 0.0
    avg_input_tokens: float = 0.0
    avg_output_tokens: float = 0.0


@dataclass
class CurrentAlloc:
    accelerator: str = ""
    num_replicas: int = 0
    cost: float = 0.0


@dataclass
class ServerSpec:
    """One autoscaled model workload (reference core/server.go:10-52)."""

    name: str = ""  # ns/model key
    namespace: str = ""
    model_id: str = ""
    service_class: str = "default"
    load: ServerLoad = field(default_factory=ServerLoad)
    min_replicas: int = 0
    max_batch_size: int = 0  # 0 = use profile's
    # Restrict candidates to the currently-used accelerator (sticky placement,
    # reference server.go:70-82).
    keep_accelerator: bool = False
    # When set, candidates are limited to these accelerator names (e.g. the
    # accelerators the model actually has deployed variants for — a fitted
    # profile alone does not make a placement actuatable).
    allowed_accelerators: frozenset[str] | None = None
    current: CurrentAlloc | None = None


@dataclass
class FleetSystem:
    """Everything the solver needs, as one explicit value."""

    accelerators: dict[str, AcceleratorSpec] = field(default_factory=dict)
    servers: dict[str, ServerSpec] = field(default_factory=dict)
    service_classes: dict[str, ServiceClass] = field(default_factory=dict)
    # Per-(namespace, model, accelerator-name) fitted queue parameters.
    profiles: PerfProfileStore = field(default_factory=PerfProfileStore)
    # Available chips per accelerator TYPE (pool), for the limited solver.
    capacity_chips: dict[str, int] = field(default_factory=dict)

    def priority(self, server: ServerSpec) -> int:
        sc = self.service_classes.get(server.service_class)
        return sc.priority if sc is not None else 10

    def targets_for(self, server: ServerSpec):
        sc = self.service_classes.get(server.service_class)
        return sc.model_targets.get(server.model_id) if sc is not None else None

    def candidate_accelerators(self, server: ServerSpec) -> list[AcceleratorSpec]:
        """Accelerators this server may run on: those with a fitted profile,
        narrowed to the current one under keep_accelerator
        (reference server.go:70-82)."""
        if server.keep_accelerator and server.current is not None \
                and server.current.accelerator:
            acc = self.accelerators.get(server.current.accelerator)
            return [acc] if acc is not None else []
        out = []
        for acc in self.accelerators.values():
            if server.allowed_accelerators is not None \
                    and acc.name not in server.allowed_accelerators:
                continue
            prof = self.profiles.get(server.model_id, acc.name,
                                     namespace=server.namespace)
            if prof is not None and prof.service_parms.valid():
                out.append(acc)
        return sorted(out, key=lambda a: a.name)
