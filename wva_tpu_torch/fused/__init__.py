"""One-jitted-program decision plane (WVA_FUSED, default on;
docs/design/fused-plane.md): the analyze phase's numeric pipeline —
queueing-solve sizing for every candidate, forecast fit/predict for
every model, and the trusted-forecast selection — fused into ONE device
dispatch per tick on fixed padded grids, with per-model dynamics as mask
columns and a single host transfer of the result arrays.

Lazily imported by the engine's fused path only: the module pulls in JAX
at import, and the replay CLI must stay JAX-free (same discipline as
``wva_tpu_torch.forecast``).
"""

from wva_tpu_torch.fused.grids import (
    FleetGrids,
    build_candidate_axis,
    build_model_axis,
    candidate_bucket,
    k_cols_for,
)
from wva_tpu_torch.fused.program import (
    UNTRUSTED,
    FusedResult,
    clear_solve_memo,
    program_cache_size,
    run,
    solve_memo_counters,
    solve_memo_size,
)

__all__ = [
    "FleetGrids",
    "FusedResult",
    "UNTRUSTED",
    "build_candidate_axis",
    "build_model_axis",
    "candidate_bucket",
    "clear_solve_memo",
    "k_cols_for",
    "program_cache_size",
    "run",
    "solve_memo_counters",
    "solve_memo_size",
]
