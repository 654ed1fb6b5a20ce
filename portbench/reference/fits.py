"""The four demand forecasters, one model at a time, from their textbook
definitions.

Each model brings two grids of 160 samples, newest last, of which the
trailing ``valid`` are real: the fine grid (the recent window) and the long
grid (two seasons and more). The forecasts, at ``h_fine`` fine steps and
``h_long`` long steps past the newest sample:

- ``linear``: the least-squares line through the fine grid's valid
  samples (x the column index), read at ``159 + h_fine``;
- ``holt``: double exponential smoothing of the fine grid (level gain
  0.5, trend gain 0.2), started at the first valid sample with no trend;
- ``seasonal_naive``: the long grid's value one season before the target
  column ``159 + h_long`` (rounded); the newest value if that column is
  not valid;
- ``holt_winters``: additive triple smoothing of the long grid (gains
  0.35, 0.1, 0.35), one seasonal term per phase ``column mod season``,
  started at the first valid sample; read at the target column's phase.

A grid with fewer than 4 valid samples gives its newest value. Every
forecast is clamped at 0.
"""

from __future__ import annotations

import torch

N_GRID = 160
MIN_VALID = 4
HOLT = (0.5, 0.2)
HOLT_WINTERS = (0.35, 0.1, 0.35)
NAMES = ("linear", "holt", "seasonal_naive", "holt_winters")


def _linear(y, start, h, dtype):
    x = torch.arange(start, N_GRID, dtype=dtype)
    y = y[start:]
    n = torch.tensor(float(len(x)), dtype=dtype)
    sx, sy = x.sum(), y.sum()
    sxx, sxy = (x * x).sum(), (x * y).sum()
    denom = n * sxx - sx * sx
    slope = (n * sxy - sx * sy) / denom if denom > 0 else denom * 0
    intercept = (sy - slope * sx) / n
    return intercept + slope * (N_GRID - 1 + h)


def _holt(y, start, h):
    a, b = HOLT
    level, trend = y[start], y[start] * 0
    for i in range(start + 1, N_GRID):
        new = a * y[i] + (1 - a) * (level + trend)
        trend = b * (new - level) + (1 - b) * trend
        level = new
    return level + trend * h


def _holt_winters(y, start, h, season):
    a, b, g = HOLT_WINTERS
    seas = [y[start] * 0] * season
    level, trend = y[start], y[start] * 0
    for i in range(start + 1, N_GRID):
        s = seas[i % season]
        new = a * (y[i] - s) + (1 - a) * (level + trend)
        trend = b * (new - level) + (1 - b) * trend
        seas[i % season] = g * (y[i] - new) + (1 - g) * s
        level = new
    phase = round(N_GRID - 1 + float(h)) % season
    return level + trend * h + seas[phase]


def forecasts(fine, fine_valid, long_vals, long_valid, h_fine, h_long,
              season, dtype=torch.float64):
    """The four forecasts ``[4]`` of one model, in ``NAMES`` order:
    ``fine`` and ``long_vals`` ``[160]`` tensors of ``dtype``, the rest
    Python numbers."""
    fine, long_vals = fine.to(dtype), long_vals.to(dtype)
    h_fine = torch.tensor(h_fine, dtype=dtype)
    h_long = torch.tensor(h_long, dtype=dtype)
    season = max(1, min(int(season), N_GRID))
    out = []
    if fine_valid >= MIN_VALID:
        start = N_GRID - int(fine_valid)
        out += [_linear(fine, start, h_fine, dtype),
                _holt(fine, start, h_fine)]
    else:
        out += [fine[-1], fine[-1]]
    if long_valid >= MIN_VALID:
        start = N_GRID - int(long_valid)
        target = N_GRID - 1 + float(h_long)
        j = round(target - season)  # half to even, as the grid's rounding
        naive = long_vals[j] if start <= j <= N_GRID - 1 else long_vals[-1]
        out += [naive, _holt_winters(long_vals, start, h_long, season)]
    else:
        out += [long_vals[-1], long_vals[-1]]
    return torch.clamp(torch.stack(out), min=0.0)
