"""Fleet assignment solver — successor of the reference's ``pkg/solver``
(``solver.go:32-80`` Solve/SolveUnlimited, ``greedy.go:37-165`` SolveGreedy +
allocate, ``greedy.go:168-260`` bestEffort policies), operating on an explicit
:class:`~wva_tpu_torch.fleet.system.FleetSystem` instead of the global singleton.

- **unlimited**: per-server minimum-value allocation (separable objective).
- **greedy**: servers ordered by (service-class priority, then delta-regret =
  value gap to their next-best allocation, largest first); each takes its
  best affordable allocation under per-accelerator-type chip capacity,
  falling to the next candidate when a pool is exhausted. Whole-slice
  quantization: a replica consumes chips_per_replica chips atomically.
- **best-effort** for servers whose SLO-sized allocation never fits:
  ``none`` (leave unallocated), ``priority-exhaustive`` (partial allocation,
  largest-first), ``round-robin`` / ``priority-round-robin`` (one replica at
  a time across the group).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum

from wva_tpu_torch.fleet.allocation import (
    AllocationDiff,
    FleetAllocation,
    build_candidates,
    diff_of,
)
from wva_tpu_torch.fleet.system import FleetSystem, ServerSpec


class SaturationPolicy(str, Enum):
    """What to do for servers whose SLO demand cannot fit
    (reference pkg/config/config.go:4-10)."""

    NONE = "none"
    PRIORITY_EXHAUSTIVE = "priority-exhaustive"
    PRIORITY_ROUND_ROBIN = "priority-round-robin"
    ROUND_ROBIN = "round-robin"


@dataclass
class SolverSpec:
    """Reference config.OptimizerSpec subset."""

    unlimited: bool = False
    saturation_policy: SaturationPolicy = SaturationPolicy.PRIORITY_EXHAUSTIVE
    # When True, allocate across ALL priorities first and best-effort once at
    # the end; when False, allocate + best-effort per priority group
    # (reference greedy.go:89-103 DelayedBestEffort).
    delayed_best_effort: bool = False


@dataclass
class Solution:
    """Solver output: chosen allocation + diff per server."""

    allocations: dict[str, FleetAllocation] = field(default_factory=dict)
    diffs: dict[str, AllocationDiff] = field(default_factory=dict)
    unallocated: list[str] = field(default_factory=list)


@dataclass
class _Entry:
    server: ServerSpec
    priority: int
    candidates: list[FleetAllocation]  # sorted by value asc
    cur_index: int = 0
    delta: float = 0.0

    def recompute_delta(self) -> None:
        nxt = self.cur_index + 1
        if nxt < len(self.candidates):
            self.delta = self.candidates[nxt].value - self.candidates[self.cur_index].value
        else:
            self.delta = math.inf

    def current(self) -> FleetAllocation:
        # Exhausted entries (cur_index past the end, parked in the
        # unallocated list) sort by their last candidate.
        return self.candidates[min(self.cur_index, len(self.candidates) - 1)]


def solve(system: FleetSystem, spec: SolverSpec | None = None,
          presized: dict | None = None, device=None) -> Solution:
    """Compute desired allocations for every server (reference
    solver.go:32-59). ``presized`` — the fused decision plane's per-pair
    sizing, passed through to :func:`build_candidates` so a fused tick's
    fleet solve re-dispatches nothing. ``device`` is where the
    candidates are sized (None: the CUDA card)."""
    spec = spec or SolverSpec()
    candidates = build_candidates(system, presized=presized,
                                  device=device)

    entries: list[_Entry] = []
    for name in sorted(candidates):
        server = system.servers[name]
        cands = sorted(candidates[name], key=lambda a: (a.value, a.accelerator))
        if not cands:
            continue
        e = _Entry(server=server, priority=system.priority(server),
                   candidates=cands)
        e.recompute_delta()
        entries.append(e)

    solution = Solution()
    if spec.unlimited:
        for e in entries:
            solution.allocations[e.server.name] = e.candidates[0]
    else:
        _solve_greedy(system, spec, entries, solution)

    # Servers that produced no candidates at all (no SLO targets / no fitted
    # profile) must still be visible to callers — report them unallocated so
    # a transient config gap can't silently drop a server from accounting.
    sized = {e.server.name for e in entries}
    for name in sorted(system.servers):
        if name not in sized and name not in solution.unallocated:
            solution.unallocated.append(name)

    for e in entries:
        name = e.server.name
        d = diff_of(name, e.server.current, solution.allocations.get(name))
        if d is not None:
            solution.diffs[name] = d
    return solution


def _order_key(e: _Entry):
    # Priority asc, then delta-regret desc, then current value desc
    # (reference greedy.go:75-85).
    return (e.priority, -e.delta, -e.current().value, e.server.name)


class _Capacity:
    """Per-accelerator-type chip budget with minimum-replica floor
    reservations.

    Without floors, a high-priority server whose (backlog-inflated) demand
    covers the whole pool starves every lower class to ZERO replicas — and
    because the engine holds unallocated servers at their current count, the
    pool deadlocks oversubscribed (nobody can schedule). Floors reserve
    ``min_replicas`` worth of chips per server up front (priority order, as
    capacity affords); a server's own floor is released the moment it
    receives any allocation."""

    def __init__(self, available: dict[str, int]) -> None:
        self.available = dict(available)
        self.reserved: dict[str, int] = {}
        self.floors: dict[str, tuple[str, int]] = {}  # server -> (type, chips)

    def reserve_floor(self, name: str, acc_type: str, chips: int) -> None:
        if self.headroom(name, acc_type) >= chips:
            self.floors[name] = (acc_type, chips)
            self.reserved[acc_type] = self.reserved.get(acc_type, 0) + chips

    def headroom(self, name: str, acc_type: str) -> int:
        """Chips ``name`` may claim: available minus others' floors."""
        res = self.reserved.get(acc_type, 0)
        own = self.floors.get(name)
        if own is not None and own[0] == acc_type:
            res -= own[1]
        return self.available.get(acc_type, 0) - res

    def take(self, name: str, acc_type: str, chips: int) -> bool:
        if self.headroom(name, acc_type) < chips:
            return False
        self.available[acc_type] = self.available.get(acc_type, 0) - chips
        own = self.floors.get(name)
        if own is None:
            return True
        if own[0] != acc_type:
            # Allocated on a different pool: the reservation there is moot
            # (replicas of one server never mix pools).
            self.release_floor(name)
        else:
            # Shrink the floor by what was just granted — NOT a full
            # release: a one-replica round-robin grant must not hand the
            # rest of this server's minimum to competitors (the floor
            # guarantees min_replicas, not min-one).
            remaining = own[1] - chips
            if remaining <= 0:
                self.release_floor(name)
            else:
                self.floors[name] = (acc_type, remaining)
                self.reserved[acc_type] -= chips
        return True

    def release_floor(self, name: str) -> None:
        own = self.floors.pop(name, None)
        if own is not None:
            self.reserved[own[0]] -= own[1]


def _solve_greedy(system: FleetSystem, spec: SolverSpec,
                  entries: list[_Entry], solution: Solution) -> None:
    cap = _Capacity(system.capacity_chips)
    # Floors in priority order: capacity permitting, every server keeps at
    # least min_replicas claimable on its best candidate's pool.
    for e in sorted(entries, key=_order_key):
        cand = next((c for c in e.candidates
                     if c.accelerator and c.chips_per_replica > 0), None)
        mn = max(e.server.min_replicas, 0)
        if cand is not None and mn > 0:
            cap.reserve_floor(e.server.name, cand.accelerator_type,
                              mn * cand.chips_per_replica)
    if spec.delayed_best_effort:
        unallocated = _allocate(entries, cap, solution)
        _best_effort(spec.saturation_policy, unallocated, cap, solution)
    else:
        for group in _priority_groups(entries):
            unallocated = _allocate(group, cap, solution)
            _best_effort(spec.saturation_policy, unallocated, cap, solution)
    solution.unallocated = [
        e.server.name for e in entries
        if e.server.name not in solution.allocations
    ]


def _priority_groups(entries: list[_Entry]) -> list[list[_Entry]]:
    groups: dict[int, list[_Entry]] = {}
    for e in entries:
        groups.setdefault(e.priority, []).append(e)
    return [groups[p] for p in sorted(groups)]


def _allocate(entries: list[_Entry], cap: _Capacity,
              solution: Solution) -> list[_Entry]:
    """Greedy full-SLO allocation round (reference greedy.go:107-165).
    Returns entries that could not be satisfied at any candidate."""
    pending = sorted(entries, key=_order_key)
    unallocated: list[_Entry] = []
    while pending:
        top = pending.pop(0)
        alloc = top.current()
        if not alloc.accelerator:  # zero-load empty allocation
            solution.allocations[top.server.name] = alloc
            cap.release_floor(top.server.name)
            continue
        need = alloc.num_replicas * alloc.chips_per_replica
        if cap.take(top.server.name, alloc.accelerator_type, need):
            solution.allocations[top.server.name] = alloc
            # The server received its (single) allocation for this solve: a
            # residual floor (full allocation smaller than the reserved
            # minimum's chip count) must not strand chips nobody will claim.
            cap.release_floor(top.server.name)
        else:
            top.cur_index += 1
            if top.cur_index >= len(top.candidates):
                unallocated.append(top)
                continue
            top.recompute_delta()
            pending.append(top)
            pending.sort(key=_order_key)
    return unallocated


def _best_effort(policy: SaturationPolicy, unallocated: list[_Entry],
                 cap: _Capacity, solution: Solution) -> None:
    """Partial allocation for servers whose full SLO sizing never fit
    (reference greedy.go:168-260)."""
    if policy == SaturationPolicy.PRIORITY_EXHAUSTIVE:
        for e in sorted(unallocated, key=_order_key):
            _allocate_maximally(e, cap, solution)
    elif policy == SaturationPolicy.ROUND_ROBIN:
        _allocate_equally(sorted(unallocated, key=_order_key), cap, solution)
    elif policy == SaturationPolicy.PRIORITY_ROUND_ROBIN:
        for group in _priority_groups(unallocated):
            _allocate_equally(sorted(group, key=_order_key), cap, solution)
    # Best-effort was these servers' last chance at capacity this solve
    # (under NONE they never had one): a floor still held by a server that
    # ends the pass without an allocation would strand chips no one can
    # claim — denying later priority groups allocations without the floored
    # server gaining anything. Release every such remainder.
    for e in unallocated:
        if e.server.name not in solution.allocations:
            cap.release_floor(e.server.name)


def _allocate_maximally(e: _Entry, cap: _Capacity,
                        solution: Solution) -> None:
    """As many replicas of the cheapest candidate as capacity affords
    (reference greedy.go:194-224 allocateMaximally)."""
    name = e.server.name
    for alloc in e.candidates:
        if not alloc.accelerator or alloc.chips_per_replica <= 0:
            continue
        max_replicas = min(
            cap.headroom(name, alloc.accelerator_type) // alloc.chips_per_replica,
            alloc.num_replicas)
        if max_replicas > 0:
            scaled = alloc.scaled_to(max_replicas)
            cap.take(name, scaled.accelerator_type, scaled.chips)
            solution.allocations[name] = scaled
            cap.release_floor(name)  # final allocation; no residual reserve
            return


def _allocate_equally(group: list[_Entry], cap: _Capacity,
                      solution: Solution) -> None:
    """One replica at a time round-robin across the group until nothing fits
    (reference greedy.go:240-260+ allocateEqually)."""
    granted: dict[str, int] = {e.server.name: 0 for e in group}
    chosen: dict[str, FleetAllocation] = {}

    def repoint(e: "_Entry") -> FleetAllocation | None:
        """Cheapest candidate whose pool can still grant one replica. A
        server with zero grants may switch pools at any time; once granted,
        it is pinned (replicas of one server never mix pools)."""
        for alloc in e.candidates:
            if (alloc.accelerator and alloc.chips_per_replica > 0
                    and cap.headroom(e.server.name, alloc.accelerator_type)
                    >= alloc.chips_per_replica):
                return alloc
        return None

    progress = True
    while progress:
        progress = False
        for e in group:
            name = e.server.name
            alloc = chosen.get(name)
            if granted[name] == 0:
                # Re-evaluate while nothing is granted: a competitor may have
                # drained the pool picked earlier while another pool has room.
                alloc = repoint(e)
                if alloc is not None:
                    chosen[name] = alloc
            if alloc is None:
                continue
            if granted[name] >= alloc.num_replicas:
                continue
            if cap.take(name, alloc.accelerator_type,
                        alloc.chips_per_replica):
                granted[name] += 1
                progress = True
    for e in group:
        n = granted.get(e.server.name, 0)
        alloc = chosen.get(e.server.name)
        if alloc is not None and n > 0:
            solution.allocations[e.server.name] = alloc.scaled_to(n)
        # Round-robin was this group's last chance at capacity this solve:
        # any floor remainder would be stranded, so release it.
        cap.release_floor(e.server.name)
