"""The fused decision program in PyTorch: one device pass per tick for the
whole numeric decision pipeline, and one host transfer
(docs/design/fused-plane.md).

Counterpart of ``wva_tpu/fused/program.py``. Where the reference jits one
XLA program around ``size_batch`` and ``_fit_grid``, the port runs, on one
stream, the same calls the staged path makes: ``size_batch`` (one launch of
the sizing-bisection kernel on the card) and ``forecasters.fit_grid`` (one
launch of the fit kernel). It then stacks every row it reads on the device
and copies them to the host in ONE transfer, the counterpart of the
reference's single ``jax.device_get``. Since both calls are the staged
path's own, fused and staged outputs are bitwise equal. The
trusted-forecast selection runs as a vectorized gather over the transferred
stack on the host, as in the reference.

Buffer donation has no counterpart in PyTorch and is dropped.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from wva_tpu_torch.analyzers.queueing.queue_model import size_batch
from wva_tpu_torch.forecast import forecasters as fc
from wva_tpu_torch.fused.grids import UNTRUSTED, FleetGrids
from wva_tpu_torch.utils import dispatch

# The (candidate bucket, k_cols, model bucket) shapes the program has run;
# the model bucket is 0 for the forecast-less form.
_SHAPES: set[tuple[int, int, int]] = set()


def program_cache_size() -> int:
    """Distinct (candidate bucket, k_cols, model bucket) shapes run — the
    recompile guard's instrument (one per padding bucket, ever)."""
    return len(_SHAPES)


# -- delta-sizing solve memo (WVA_SOLVE_MEMO, default on) --
#
# A candidate's sized rate/throughput is a pure function of its solve
# key (grids.solve_key: profile parms, request mix, batch/queue bounds,
# SLO targets). On a steady tick NO candidate row changes, yet the full
# bisection re-solves all of them; the memo keeps the transferred per-row
# outputs keyed by solve key, and a tick whose every row hits runs ONLY
# the forecast fits (one fit-kernel launch, still one dispatch). Any miss
# falls back to the full program (one dispatch) and refreshes the memo
# from its transfer. Values are the float64 conversions of the float32
# device outputs — the same conversion `run` applies — so hit ticks are
# byte-identical to solve ticks. memo=False skips both lookup and insert:
# every tick is a full solve.
_SOLVE_MEMO: dict[tuple, tuple[float, float]] = {}
_SOLVE_MEMO_MAX = 65536  # ~10 doubles/entry; clear-and-refill on overflow
_memo_counters = {"hit_ticks": 0, "solve_ticks": 0}


def solve_memo_size() -> int:
    return len(_SOLVE_MEMO)


def solve_memo_counters() -> dict[str, int]:
    """(hit_ticks, solve_ticks) since process start — bench/CI instrument."""
    return dict(_memo_counters)


def clear_solve_memo() -> None:
    _SOLVE_MEMO.clear()
    _memo_counters["hit_ticks"] = 0
    _memo_counters["solve_ticks"] = 0


@dataclass
class FusedResult:
    """Host-side view of one fused dispatch."""

    # group_key -> per-replica SLO capacities (req/s), the exact list
    # ``size_candidates`` would have returned for that model's plan.
    per_replica: dict[str, list[float]] = field(default_factory=dict)
    # (model_id, namespace, accelerator) -> sized row for the fleet
    # solve's candidate builder (throughput at the binding rate).
    presized: dict[tuple[str, str, str], float] = field(
        default_factory=dict)
    # Per-model forecaster fits + the gathered trusted forecast, in
    # model-axis order (the planner's prepared-tick key order).
    fits: list[dict[str, float]] = field(default_factory=list)
    chosen: list[float] = field(default_factory=list)


def _fits(grids: FleetGrids, impl: str | None) -> torch.Tensor:
    return fc.fit_grid(grids.fine, grids.fine_valid, grids.long,
                       grids.long_valid, grids.h_fine, grids.h_long,
                       grids.season, m=grids.m_bucket, impl=impl)


def run(grids: FleetGrids, memo: bool = True,
        impl: str | None = None) -> FusedResult:
    """Execute the fused program for one tick's grids: ONE dispatch, ONE
    host transfer. With ``memo`` a tick whose every candidate solve key is
    already memoized runs only the forecast fits and reads the sized rows
    from the memo, bitwise what the solve would return. ``impl="plain"``
    runs both kernels' plain versions on the grids' device (the card's
    oracle); None launches the kernels on CUDA grids."""
    if grids.n_candidates == 0:
        raise ValueError("fused program needs at least one candidate")
    n = grids.n_candidates
    rows = grids.cand_rows
    # The fits-only fast path needs a model axis to run (keeping the 1.0
    # dispatches/tick contract); forecast-off ticks always run the full
    # solve.
    if (memo and grids.m_bucket and len(rows) == n
            and all(k in _SOLVE_MEMO for k in rows)):
        _memo_counters["hit_ticks"] += 1
        dispatch.note()
        fits = _fits(grids, impl).cpu().numpy()
        rates = [_SOLVE_MEMO[k][0] for k in rows]
        throughput = [_SOLVE_MEMO[k][1] for k in rows]
        return _materialize(grids, rates, throughput, fits)

    _memo_counters["solve_ticks"] += 1
    dispatch.note()
    c = int(grids.cand.alpha.shape[0])
    _SHAPES.add((c, grids.k_cols, grids.m_bucket))
    sized = size_batch(grids.cand, grids.t_ttft, grids.t_itl, grids.t_tps,
                       k_cols=grids.k_cols, impl=impl)
    parts = [sized["max_rate_per_s"], sized["throughput_per_s"]]
    if grids.m_bucket:
        parts.append(_fits(grids, impl).reshape(-1))
    host = torch.cat(parts).cpu().numpy()  # the one host transfer
    fits = (host[2 * c:].reshape(len(fc.FORECASTERS), grids.m_bucket)
            if grids.m_bucket else None)

    # Same conversion as the staged reads: float64 python lists built
    # from the float32 device values (bit-preserving).
    rates = host[:n].astype(np.float64).tolist()
    throughput = host[c:c + n].tolist()
    if memo and len(rows) == n:
        if len(_SOLVE_MEMO) > _SOLVE_MEMO_MAX:
            _SOLVE_MEMO.clear()
        for key, r, t in zip(rows, rates, throughput):
            _SOLVE_MEMO[key] = (r, t)
    return _materialize(grids, rates, throughput, fits)


def _materialize(grids: FleetGrids, rates: list[float],
                 throughput: list[float], fits) -> FusedResult:
    """Slice the per-row outputs back into the host view (shared by the
    solve and memo-hit paths — one conversion rule, no drift). ``fits`` is
    the transferred ``[4, M]`` float32 stack, or None."""
    out = FusedResult()
    for key, (lo, hi) in grids.cand_slices.items():
        out.per_replica[key] = rates[lo:hi]
    for pair_key, idx in grids.cand_index.items():
        out.presized[pair_key] = throughput[idx]
    if fits is not None:
        nm = grids.n_models
        stack = fits[:, :nm]  # [F, nm]
        host = {name: [float(x) for x in stack[f]]
                for f, name in enumerate(fc.FORECASTERS)}
        out.fits = [{name: host[name][i] for name in fc.FORECASTERS}
                    for i in range(nm)]
        # The trusted-forecast mask column: one vectorized gather over
        # the transferred stack — each model's selected forecaster
        # (trust index; the linear floor for untrusted rows, exactly
        # what the planner's untrusted branch reports) picks its
        # forecast. Element selection is bit-preserving, so the chosen
        # value IS the plan's forecast_demand.
        idx = np.asarray(grids.trust_idx[:nm], dtype=np.int64)
        out.chosen = [float(x) for x in stack[idx, np.arange(nm)]]
    return out


__all__ = ["FusedResult", "run", "program_cache_size", "UNTRUSTED",
           "solve_memo_size", "solve_memo_counters", "clear_solve_memo"]
