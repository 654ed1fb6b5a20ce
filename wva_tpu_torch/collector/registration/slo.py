"""SLO-analyzer telemetry settings: the arrival-rate query window.

Only the window helpers the analyzer's demand-trend age gate reads are
ported so far; the query registrations and collectors port with the
collector."""

from __future__ import annotations

# Rate window for the arrival-rate query. During a ramp the measured rate is
# ~half a window stale, and with slices taking minutes to provision, 30s less
# telemetry lag is 30s less backlog to drain — but rate() needs >=2 samples
# in the window, so the window must stay >= 2x the Prometheus scrape
# interval. Default 1m tolerates the common 30s scrape; deployments scraping
# at 15s or faster (our chart's default) should set 30s.
ARRIVAL_RATE_WINDOW_ENV = "WVA_SLO_ARRIVAL_RATE_WINDOW"
DEFAULT_ARRIVAL_RATE_WINDOW = "1m"


def arrival_rate_window() -> str:
    import os
    import re

    raw = os.environ.get(ARRIVAL_RATE_WINDOW_ENV,
                         DEFAULT_ARRIVAL_RATE_WINDOW)
    return raw if re.fullmatch(r"\d+[smh]", raw) else DEFAULT_ARRIVAL_RATE_WINDOW


def arrival_rate_window_seconds() -> float:
    """The arrival-rate window as seconds (consumed by the demand-trend
    spin-up gate)."""
    raw = arrival_rate_window()
    return float(raw[:-1]) * {"s": 1.0, "m": 60.0, "h": 3600.0}[raw[-1]]
