"""Fleet-level global optimizer — the TPU-native successor of the
reference's dormant inferno stack (``pkg/core`` system model, ``pkg/solver``
assignment, ``pkg/manager`` facade, ``internal/modelanalyzer`` adapter;
SURVEY.md section 2 L(-1)).

Usage (the ``pkg/manager/manager.go:21-27`` facade shape, without the
singleton)::

    system = FleetSystem(accelerators=..., servers=..., service_classes=...,
                         profiles=..., capacity_chips=...)
    solution = solve(system, SolverSpec(unlimited=False))
    solution.allocations  # server -> FleetAllocation
    solution.diffs        # server -> AllocationDiff
"""

from wva_tpu_torch.fleet.system import (
    ACCEL_PENALTY_FACTOR,
    AcceleratorSpec,
    CurrentAlloc,
    FleetSystem,
    ServerLoad,
    ServerSpec,
)
from wva_tpu_torch.fleet.allocation import (
    AllocationDiff,
    FleetAllocation,
    build_candidates,
    diff_of,
    transition_penalty,
)
from wva_tpu_torch.fleet.solver import (
    SaturationPolicy,
    Solution,
    SolverSpec,
    solve,
)


def analyze_model(system: FleetSystem, server_name: str,
                  device=None) -> list[FleetAllocation]:
    """Candidate allocations for one server across all compatible
    accelerators — the ``internal/modelanalyzer/analyzer.go:13-34`` adapter
    surface (VA -> per-accelerator allocation estimates)."""
    server = system.servers.get(server_name)
    if server is None:
        return []
    sub = FleetSystem(
        accelerators=system.accelerators,
        servers={server_name: server},
        service_classes=system.service_classes,
        profiles=system.profiles,
        capacity_chips=system.capacity_chips,
    )
    return build_candidates(sub, device=device).get(server_name, [])


__all__ = [
    "ACCEL_PENALTY_FACTOR",
    "AcceleratorSpec",
    "CurrentAlloc",
    "FleetSystem",
    "ServerLoad",
    "ServerSpec",
    "AllocationDiff",
    "FleetAllocation",
    "build_candidates",
    "diff_of",
    "transition_penalty",
    "SaturationPolicy",
    "Solution",
    "SolverSpec",
    "solve",
    "analyze_model",
]
