"""Predictive capacity planner (docs/design/forecast.md).

The reactive engine sizes capacity for demand as observed NOW; on TPU a
replica decided now becomes ready one provisioning horizon later (2-7 min,
BASELINE.md), so a reactive decision is sized for stale demand by
construction. This package upgrades the single-slope ``DemandTrend``
anticipation into a real forecasting plane:

- :mod:`wva_tpu_torch.forecast.history` — per-model demand history store (the
  ring-buffer column layout from ``collector/source/promql.py``);
- :mod:`wva_tpu_torch.forecast.forecasters` — the forecaster registry (seasonal
  naive, Holt double / Holt-Winters triple exponential smoothing, linear
  trend floor), all models fitted in ONE padded jitted JAX call per tick;
- :mod:`wva_tpu_torch.forecast.leadtime` — measured actuation->ready lead times,
  per (accelerator, model) quantile, replacing the static provisioning-
  horizon constant;
- :mod:`wva_tpu_torch.forecast.planner` — forecast-at-(now + lead time) turned
  into a proactive replica floor + scale-from-zero pre-wake, with
  auto-demotion to reactive when the rolling backtest error exceeds the
  configured threshold;
- :mod:`wva_tpu_torch.forecast.backtest` — offline backtest CLI
  (``python -m wva_tpu_torch forecast backtest <trace.jsonl>``) scoring recorded
  decision traces against every candidate forecaster (MAPE + under/over-
  provision cost), gated by ``make backtest-golden``.
"""

from wva_tpu_torch.forecast.apply import apply_forecast_floors
from wva_tpu_torch.forecast.history import DemandHistoryStore
from wva_tpu_torch.forecast.leadtime import LeadTimeEstimator

__all__ = [
    "CapacityPlanner",
    "DemandHistoryStore",
    "ForecastPlan",
    "LeadTimeEstimator",
    "apply_forecast_floors",
]


def __getattr__(name):
    # The planner pulls in the JAX-backed forecaster registry; loading it
    # lazily keeps the package importable without paying (or requiring)
    # JAX — the offline replay CLI applies recorded floors with
    # ``apply_forecast_floors`` alone, which is pure-Python dict math.
    if name in ("CapacityPlanner", "ForecastPlan"):
        from wva_tpu_torch.forecast import planner

        return getattr(planner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
