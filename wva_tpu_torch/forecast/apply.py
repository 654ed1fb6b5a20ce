"""Forecast floor application — shared by the live engine and trace replay.

Kept free of JAX imports: the replay CLI applies RECORDED floors (the
``forecast`` stage event in the decision trace) without re-running the
planner, exactly like the limiter replay rebuilds from the recorded pool
snapshot — so a trace recorded with forecasting on replays to zero diffs.
"""

from __future__ import annotations

from wva_tpu_torch.interfaces import ACTION_SCALE_UP, VariantDecision

FORECAST_STEP_NAME = "forecast"


def apply_forecast_floors(decisions: list[VariantDecision],
                          floors: list[dict], now: float) -> int:
    """Raise each floored variant's target to its proactive floor (never
    lowers — the planner only ever ADDS capacity ahead of forecast demand;
    scale-down stays reactive). Runs BEFORE the limiter so inventory caps
    still bind. Returns how many decisions were raised."""
    if not floors:
        return 0
    by_variant = {(d.namespace, d.variant_name): d for d in decisions}
    raised = 0
    for f in floors:
        d = by_variant.get((f.get("namespace", ""), f.get("variant_name", "")))
        floor = int(f.get("floor_replicas", 0))
        if d is None or floor <= d.target_replicas:
            continue
        d.target_replicas = floor
        if floor > d.current_replicas:
            d.action = ACTION_SCALE_UP
        d.reason = f.get("reason", "") or d.reason
        d.add_step(FORECAST_STEP_NAME, f.get("reason", ""), now=now)
        raised += 1
    return raised
