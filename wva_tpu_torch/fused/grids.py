"""Fixed-grid builders for the fused decision program, in PyTorch.

Counterpart of ``wva_tpu/fused/grids.py``. One tick's numeric inputs —
every model's sizing candidates, forecast history grids, and per-model
dynamics — are laid out as padded, shape-bucketed struct-of-arrays on the
grids' ``device`` (None: the CUDA card), so the analyze phase runs on a
bounded set of shapes (docs/design/fused-plane.md):

- **Candidate axis** ``[C]``: the concatenation of every sized model's
  ``SizingPlan.candidates`` in sorted group-key order — byte-for-byte the
  batch :meth:`QueueingModelAnalyzer.size_candidates` would build, with
  the same power-of-two bucket (min 8) and the same state-axis trim
  (``k_cols``), so fused and staged sizing are bitwise identical.
- **Model axis** ``[M]``: the forecast planner's fine/long LOCF grids
  (``fit_batch``'s exact padding: power-of-two bucket from 1) plus the
  per-model dynamics as **mask columns** — tuner-enabled, global-routed,
  forecast-trusted (with the trusted forecaster as an index column the
  host gathers through), zero-ready-supply (scaled to zero with
  lingering telemetry / still provisioning). Padded rows are fully
  invalid and sliced off on the host.

The bucket policy bounds the shapes: a model joining or leaving changes
only the padding inside the current bucket, so the program runs at most one
shape per (candidate bucket, k_cols, model bucket) triple across any
fleet-size trajectory (``program.program_cache_size``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from wva_tpu_torch.analyzers.queueing.analyzer import build_sizing_batch
from wva_tpu_torch.analyzers.queueing.queue_model import (
    K_MAX,
    CandidateBatch,
    k_cols_for,
)
from wva_tpu_torch.device import resolve_device
from wva_tpu_torch.forecast import forecasters as fc

# Index column value for models with no trusted forecaster: the program
# gathers the registry floor ("linear") for them — exactly the value the
# planner's untrusted branch reports.
UNTRUSTED = -1
_LINEAR_IDX = fc.FORECASTERS.index("linear")


def candidate_bucket(n: int) -> int:
    """The sizing batch bucket: power of two, min 8 — the rule
    ``build_sizing_batch`` applies (exposed for the recompile-guard
    test's bucket arithmetic)."""
    return max(8, 1 << (n - 1).bit_length()) if n else 8


@dataclass
class FleetGrids:
    """One tick's padded device inputs + the host bookkeeping to slice
    results back out."""

    # Where the grids live: None is the CUDA card (the builders raise
    # where there is none); "cpu" the plain versions.
    device: object = None

    # -- candidate axis (sizing) --
    cand: CandidateBatch | None = None
    t_ttft: object = None  # [C_b] float32
    t_itl: object = None
    t_tps: object = None
    n_candidates: int = 0
    k_cols: int = K_MAX
    # group_key -> (start, end) slice of the candidate axis.
    cand_slices: dict[str, tuple[int, int]] = field(default_factory=dict)
    # (model_id, namespace, accelerator) -> candidate row (first
    # occurrence): the fleet solve's candidate builder reuses the fused
    # sizing through this index instead of re-dispatching.
    cand_index: dict[tuple[str, str, str], int] = field(default_factory=dict)
    # Per-row solve keys (the COMPLETE numeric input of one candidate's
    # sizing: profile parms, request mix, batch/queue bounds, SLO
    # targets) for the delta-sizing memo (WVA_SOLVE_MEMO; program.py).
    # Sizing is a pure per-row function of these values — padding rows
    # and the k_cols trim are bitwise-neutral by the batch contract — so
    # an unchanged key means an unchanged sized rate.
    cand_rows: list[tuple] = field(default_factory=list)

    # -- model axis (forecast + mask columns) --
    n_models: int = 0
    m_bucket: int = 0
    fine: object = None  # [M_b, N_GRID] float32
    fine_valid: object = None  # [M_b]
    long: object = None
    long_valid: object = None
    h_fine: object = None
    h_long: object = None
    season: object = None  # [M_b] int32
    # Host int array [n_models]: the selected forecaster's registry
    # index per model (UNTRUSTED rows carry the linear-floor index) —
    # applied as one vectorized gather over the transferred fit stack.
    trust_idx: object = None
    model_keys: list[str] = field(default_factory=list)  # planner keys

    # -- mask columns (host numpy, length n_models) — the per-model
    # dynamics that used to be Python branches. trusted + trust_idx
    # drive the forecast gather over the transferred fit stack;
    # global_mask becomes the prepared tick's no-floor partition
    # (PreparedTick.global_no_floor); tuner/zero describe the remaining
    # dynamics and are asserted against the world by the property tests.
    trusted_mask: object = None
    global_mask: object = None
    tuner_mask: object = None
    zero_mask: object = None


def solve_key(c) -> tuple:
    """The complete numeric input of one candidate's sizing solve, as a
    hashable key (exactly the values ``build_sizing_batch`` lays out for
    the row, pre-cast). Two candidates with equal keys size to bitwise
    the same rate/throughput — the delta-sizing memo's contract."""
    parms = c.profile.service_parms
    return (parms.alpha, parms.beta, parms.gamma,
            c.request_size.avg_input_tokens,
            c.request_size.avg_output_tokens,
            c.profile.max_batch_size,
            c.profile.max_batch_size + c.profile.max_queue_size,
            c.targets.target_ttft_ms, c.targets.target_itl_ms,
            c.targets.target_tps)


def build_candidate_axis(grids: FleetGrids, plans: dict, batch_keys) -> None:
    """Fill the candidate axis from the sized plans, mirroring
    ``size_candidates``'s padding byte-for-byte."""
    order: list[tuple[str, object]] = []
    for key in batch_keys:
        start = len(order)
        order.extend((key, c) for c in plans[key].candidates)
        grids.cand_slices[key] = (start, len(order))
    n = len(order)
    grids.n_candidates = n
    if not n:
        return
    grids.device = resolve_device(grids.device)
    grids.cand_rows = [solve_key(c) for _, c in order]
    # THE shared builder + trim rule (analyzers/queueing): the fused
    # candidate axis is byte-for-byte the staged sizing batch.
    (grids.cand, grids.t_ttft, grids.t_itl, grids.t_tps,
     ks) = build_sizing_batch([c for _, c in order], grids.device)
    grids.k_cols = k_cols_for(ks)
    for i, (key, c) in enumerate(order):
        model, _, ns = key.rpartition("|")
        grids.cand_index.setdefault((model, ns, c.accelerator), i)


def build_model_axis(grids: FleetGrids, series: list[fc.SeriesGrids],
                     model_keys: list[str], trust_idx: list[int],
                     trusted, global_routed, tuner_enabled,
                     scaled_to_zero) -> None:
    """Fill the model axis from the planner's prepared grids, mirroring
    ``fit_batch``'s padding byte-for-byte, plus the mask columns."""
    grids.device = resolve_device(grids.device)
    grids.n_models = len(series)
    grids.model_keys = list(model_keys)
    grids.trusted_mask = np.asarray(trusted, dtype=bool)
    grids.global_mask = np.asarray(global_routed, dtype=bool)
    grids.tuner_mask = np.asarray(tuner_enabled, dtype=bool)
    grids.zero_mask = np.asarray(scaled_to_zero, dtype=bool)
    if not series:
        return
    m = 1
    while m < len(series):
        m *= 2
    grids.m_bucket = m
    # THE shared staging rule (forecasters.grid_tensors): the model axis is
    # byte-for-byte fit_batch's padded input — numpy first, then one
    # tensor per grid on the device.
    (grids.fine, grids.fine_valid, grids.long, grids.long_valid,
     grids.h_fine, grids.h_long,
     grids.season) = fc.grid_tensors(series, m, grids.device)
    # The gather column: the trusted forecaster's registry index, or the
    # linear floor for untrusted models (what the planner's untrusted
    # branch reports as forecast_demand). Host-side: the gather runs
    # over the TRANSFERRED fit stack (program.run).
    grids.trust_idx = np.asarray(
        [i if i >= 0 else _LINEAR_IDX for i in trust_idx],
        dtype=np.int64)
