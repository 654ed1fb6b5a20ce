"""Fleet allocations and the batched candidate builder.

Successor of the reference's ``pkg/core/allocation.go`` (``CreateAllocation``
:27-155, ``TransitionPenalty`` :283-292, ``CreateAllocationDiff`` :345+).
The reference sizes one (server, accelerator) pair at a time through a scalar
queue analyzer; here ALL pairs across the fleet are sized in one batched
PyTorch call (``size_batch`` then ``analyze_batch``), so candidate generation
is two batched device passes regardless of fleet size: one sizing-kernel
launch, then the analysis.

PyTorch counterpart of ``wva_tpu/fleet/allocation.py``: the same candidates,
with the batches built on the ``device`` the caller gives.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from wva_tpu_torch.analyzers.queueing.params import TargetPerf
from wva_tpu_torch.analyzers.queueing.queue_model import (
    analyze_batch,
    candidate_batch,
    size_batch_bucketed,
)
from wva_tpu_torch.fleet.system import (
    ACCEL_PENALTY_FACTOR,
    AcceleratorSpec,
    FleetSystem,
    ServerSpec,
)
from wva_tpu_torch.device import resolve_device
from wva_tpu_torch.utils import dispatch as _dispatch


@dataclass
class FleetAllocation:
    """One candidate placement (reference core/allocation.go:10-25)."""

    accelerator: str = ""
    accelerator_type: str = ""
    num_replicas: int = 0
    max_batch: int = 0
    chips_per_replica: int = 0
    cost: float = 0.0  # total cost of the allocation
    itl_ms: float = 0.0
    ttft_ms: float = 0.0
    rho: float = 0.0
    max_rate_per_replica: float = 0.0  # req/s meeting the SLO
    value: float = 0.0  # solver objective (cost or transition penalty)

    @property
    def chips(self) -> int:
        return self.num_replicas * self.chips_per_replica

    def scaled_to(self, num_replicas: int) -> "FleetAllocation":
        """Copy with a reduced replica count, cost/value scaled pro-rata
        (reference greedy.go allocateMaximally:205-211)."""
        if self.num_replicas <= 0:
            return self
        factor = num_replicas / self.num_replicas
        out = FleetAllocation(**self.__dict__)
        out.num_replicas = num_replicas
        out.cost = self.cost * factor
        out.value = self.value * factor
        return out


@dataclass
class AllocationDiff:
    """Old vs new placement for one server (reference allocation.go:345+)."""

    server: str = ""
    old_accelerator: str = "none"
    new_accelerator: str = "none"
    old_num_replicas: int = 0
    new_num_replicas: int = 0
    old_cost: float = 0.0
    new_cost: float = 0.0


def transition_penalty(cur_accelerator: str, cur_cost: float,
                       new: FleetAllocation) -> float:
    """Value of moving from the current placement to ``new`` (reference
    allocation.go:283-292): same accelerator -> cost delta (0 if identical
    replica count); different accelerator -> switching penalty proportional to
    both costs plus the cost delta."""
    if cur_accelerator == new.accelerator:
        return new.cost - cur_cost if new.cost != cur_cost else 0.0
    return ACCEL_PENALTY_FACTOR * (cur_cost + new.cost) + (new.cost - cur_cost)


def build_candidates(
    system: FleetSystem,
    presized: dict[tuple[str, str, str], float] | None = None,
    device=None,
) -> dict[str, list[FleetAllocation]]:
    """Candidate allocations for every server on every compatible
    accelerator, sized against the server's SLO targets in one fleet-wide
    batch (reference ``Server.Calculate`` server.go:55-67 +
    ``CreateAllocation`` allocation.go:27-155, scalar per pair there).

    Servers with zero load get the reference's zero-load allocation
    (allocation.go:251-281): min_replicas on each accelerator at base cost.

    ``presized`` — the fused decision plane's per-pair sizing
    (``(model_id, namespace, accelerator) -> throughput_per_s`` at the
    binding rate): the tick's one fused dispatch already solved every
    (model, accelerator) pair this builder would size (same profiles,
    request mixes, targets, and occupancy bounds — sizing is
    row-independent and k_cols-invariant, so the values are bitwise what
    ``size_batch_bucketed`` returns here). When every pair is covered the
    sizing dispatch is skipped entirely; the informational per-allocation
    latency fields (itl/ttft/rho — consumed by nothing downstream of the
    solver) are left at 0 rather than paying a dispatch for them.

    ``device`` is where the batch is sized (None: the CUDA card; raises
    where there is none).
    """
    dev = resolve_device(device)
    pairs: list[tuple[ServerSpec, AcceleratorSpec, TargetPerf, object]] = []
    zero_load: dict[str, list[FleetAllocation]] = {}
    for name in sorted(system.servers):
        server = system.servers[name]
        targets = system.targets_for(server)
        if targets is None:
            continue
        accels = system.candidate_accelerators(server)
        if server.load.arrival_rate_per_min <= 0 or \
                server.load.avg_output_tokens <= 0:
            # Zero traffic (reference allocation.go:72-75): with
            # min_replicas == 0 the empty (scale-to-zero) allocation needs no
            # accelerator or profile at all; otherwise min_replicas on each
            # candidate accelerator with a fitted profile.
            if server.min_replicas <= 0:
                zero_load[name] = [FleetAllocation(accelerator="",
                                                   accelerator_type="",
                                                   num_replicas=0, value=0.0)]
                continue
            for acc in accels:
                prof = system.profiles.get(server.model_id, acc.name,
                                           namespace=server.namespace)
                if prof is None:
                    continue
                zero_load.setdefault(name, []).append(
                    _zero_load_allocation(server, acc, prof))
            continue
        for acc in accels:
            prof = system.profiles.get(server.model_id, acc.name,
                                       namespace=server.namespace)
            if prof is None:
                continue
            pairs.append((server, acc, targets, prof))

    out: dict[str, list[FleetAllocation]] = dict(zero_load)
    if not pairs:
        return out

    n = len(pairs)
    covered = presized is not None and all(
        (server.model_id, server.namespace, acc.name) in presized
        for server, acc, _targets, _prof in pairs)
    if covered:
        # The fused plane already sized every pair this tick: reuse its
        # one dispatch's results (bitwise identical — row-independent,
        # k_cols-invariant math) and skip both device passes here.
        rate_star = [presized[(server.model_id, server.namespace,
                               acc.name)]
                     for server, acc, _targets, _prof in pairs]
        padded = pairs
        max_b = [server.max_batch_size or prof.max_batch_size
                 for server, _acc, _targets, prof in pairs]
        itl_arr = ttft_arr = rho_arr = [0.0] * n
    else:
        # Power-of-two bucketing keeps a fleet to a handful of batch shapes.
        bucket = max(8, 1 << (n - 1).bit_length())
        padded = pairs + [pairs[0]] * (bucket - n)

        alphas, betas, gammas, avg_in, avg_out, max_b, ks = [], [], [], [], [], [], []
        t_ttft, t_itl, t_tps = [], [], []
        for server, acc, targets, prof in padded:
            mb = server.max_batch_size or prof.max_batch_size
            alphas.append(prof.service_parms.alpha)
            betas.append(prof.service_parms.beta)
            gammas.append(prof.service_parms.gamma)
            avg_in.append(server.load.avg_input_tokens)
            avg_out.append(max(server.load.avg_output_tokens, 1.0))
            max_b.append(mb)
            ks.append(mb + prof.max_queue_size)
            t_ttft.append(targets.target_ttft_ms)
            t_itl.append(targets.target_itl_ms)
            t_tps.append(targets.target_tps)

        cand = candidate_batch(alphas, betas, gammas, avg_in, avg_out, max_b,
                               ks, device=dev)
        # Bucketed entry: trims the state axis to the fleet's largest k
        # without a device sync (the ks ints are host-side already).
        _dispatch.note()
        sized = size_batch_bucketed(cand, _f32(t_ttft, dev),
                                    _f32(t_itl, dev), _f32(t_tps, dev),
                                    k_host=ks)
        # One bulk device->host transfer per array (per-element float()
        # would issue a blocking sync each).
        rate_star = sized["throughput_per_s"].cpu().numpy().tolist()

    # Replica counts + per-replica operating point, then one analyze pass for
    # the achieved latencies (reference allocation.go:125-150).
    replicas: list[int] = []
    per_replica_rate: list[float] = []
    for i, (server, acc, targets, prof) in enumerate(padded):
        if targets.target_tps > 0:
            total_rate = targets.target_tps / max(server.load.avg_output_tokens, 1.0)
        else:
            total_rate = server.load.arrival_rate_per_min / 60.0
        r = max(int(math.ceil(total_rate / rate_star[i])) if rate_star[i] > 0 else 1,
                server.min_replicas, 1)
        replicas.append(r)
        per_replica_rate.append(total_rate / r)

    if not covered:
        # Rates below a candidate's lam_min are clamped up inside
        # analyze_batch (metrics["valid"] is False there): the reported
        # latencies are then an UPPER bound on the true low-traffic
        # latency, which is conservative for the allocations'
        # informational itl/ttft fields — replica sizing comes from
        # rate_star above, never from these metrics.
        _dispatch.note()
        metrics = analyze_batch(_f32(per_replica_rate, dev), cand)
        host = {k: metrics[k].cpu().numpy() for k in (
            "avg_token_time_ms", "avg_wait_time_ms", "avg_prefill_time_ms",
            "rho")}
        itl_arr = host["avg_token_time_ms"].tolist()
        ttft_arr = (host["avg_wait_time_ms"]
                    + host["avg_prefill_time_ms"]).tolist()
        rho_arr = host["rho"].tolist()

    for i, (server, acc, targets, prof) in enumerate(padded[:n]):
        alloc = FleetAllocation(
            accelerator=acc.name,
            accelerator_type=acc.type,
            num_replicas=replicas[i],
            max_batch=max_b[i],
            chips_per_replica=acc.chips_per_replica,
            cost=acc.effective_cost * replicas[i],
            itl_ms=itl_arr[i],
            ttft_ms=ttft_arr[i],
            rho=rho_arr[i],
            max_rate_per_replica=rate_star[i],
        )
        alloc.value = _value_of(server, alloc)
        out.setdefault(server.name, []).append(alloc)
    return out


def _f32(values, device) -> torch.Tensor:
    """Host values as one float32 tensor on ``device`` (staged in numpy:
    the same double -> float32 cast per element)."""
    return torch.as_tensor(np.asarray(values, dtype=np.float32),
                           device=device)


def _value_of(server: ServerSpec, alloc: FleetAllocation) -> float:
    """Objective: cost for fresh placements; transition penalty when moving
    an existing placement (reference server.go:58-64)."""
    if server.current is not None and server.current.accelerator:
        return transition_penalty(server.current.accelerator,
                                  server.current.cost, alloc)
    return alloc.cost


def _zero_load_allocation(server: ServerSpec, acc: AcceleratorSpec,
                          prof) -> FleetAllocation:
    """Reference allocation.go:251-281: min_replicas at base cost; empty
    allocation when min_replicas == 0."""
    if server.min_replicas <= 0:
        return FleetAllocation(accelerator="", accelerator_type="",
                               num_replicas=0, value=0.0)
    alloc = FleetAllocation(
        accelerator=acc.name,
        accelerator_type=acc.type,
        num_replicas=server.min_replicas,
        max_batch=server.max_batch_size or prof.max_batch_size,
        chips_per_replica=acc.chips_per_replica,
        cost=acc.effective_cost * server.min_replicas,
    )
    alloc.value = _value_of(server, alloc)
    return alloc


def diff_of(server: str, old: Any, new: FleetAllocation | None) -> AllocationDiff | None:
    """Old/new placement difference; None when both are absent
    (reference allocation.go:345+)."""
    if old is None and new is None:
        return None
    d = AllocationDiff(server=server)
    if old is not None:
        d.old_accelerator = old.accelerator or "none"
        d.old_num_replicas = old.num_replicas
        d.old_cost = old.cost
    if new is not None and new.accelerator:
        d.new_accelerator = new.accelerator
        d.new_num_replicas = new.num_replicas
        d.new_cost = new.cost
    if (d.old_accelerator == d.new_accelerator
            and d.old_num_replicas == d.new_num_replicas):
        return None
    return d
