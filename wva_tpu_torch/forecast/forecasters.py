"""Forecaster registry: batched demand forecasts, in PyTorch.

Counterpart of ``wva_tpu/forecast/forecasters.py``. Four candidate
forecasters, Autopilot-style (fit several recommenders over sliding windows,
select by replayed error):

- ``linear``          — least-squares trend over the fine grid (the registry
                        floor).
- ``holt``            — double exponential smoothing (level + trend) over
                        the fine grid.
- ``seasonal_naive``  — demand one season ago (+ the forecast horizon) from
                        the long grid.
- ``holt_winters``    — additive triple exponential smoothing (level +
                        trend + per-phase seasonal terms) over the long grid.

Every model's series is resampled onto fixed-width grids (``N_GRID``
columns, LOCF), the model axis is padded to a power-of-two bucket, and ONE
call of :func:`fit_grid` computes every forecaster for every model. On CUDA
tensors that call is one launch of the hand-written kernel
(:mod:`wva_tpu_torch.forecast.fit_kernel`); on CPU tensors it is
:func:`fit_grid_plain`. Both walk each row's 160 columns in the same order
with the same roundings, and every row depends on nothing but itself, so
batched and serial fits are bitwise equal at any batch width.

Two grids per model: the **fine** grid (``grid_step_seconds``) covers the
recent window for the trend forecasters; the **long** grid spans >= 2
seasonal periods at ``period / (N_GRID/2)`` resolution for the seasonal
ones.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from wva_tpu_torch.device import resolve_device


FORECASTERS = ("linear", "holt", "seasonal_naive", "holt_winters")
SEASONAL_FORECASTERS = ("seasonal_naive", "holt_winters")

# Static grid width. 160 columns cover 40min of 15s fine steps and 2+
# seasonal periods on the long grid (step = period / 64).
N_GRID = 160
# Long-grid resolution: season length in steps (<= N_GRID / 2 so at least
# two full seasons fit the grid and the seasonal state can be learned).
SEASON_STEPS = 64
# A fit needs this many real samples before any forecaster output is
# trusted; below it every forecaster degrades to last-value persistence.
MIN_VALID = 4

# Smoothing constants (fixed, not per-model-tuned: the registry selects
# between FORMS by replayed error; tuning constants per model would need
# its own backtest loop for marginal gain).
HOLT_ALPHA = 0.5
HOLT_BETA = 0.2
HW_ALPHA = 0.35
HW_BETA = 0.1
HW_GAMMA = 0.35


@dataclass
class SeriesGrids:
    """One model's resampled inputs for the batched fit."""

    fine: list[float]  # N_GRID values, newest at index N_GRID-1
    fine_valid: int  # trailing valid count (0 = no data)
    long: list[float]
    long_valid: int
    h_fine_steps: float  # forecast horizon in fine steps
    h_long_steps: float  # forecast horizon in long steps
    season_steps: int  # seasonal period in long steps


def resample(window, now: float, step: float) -> tuple[list[float], int]:
    """Sample-and-hold a SeriesWindow onto ``N_GRID`` points ending at
    ``now`` (newest at the last index). Returns (values, valid_count):
    points before the first sample are invalid (zero-filled)."""
    vals = [0.0] * N_GRID
    n = len(window)
    if n == 0:
        return vals, 0
    ts0 = window.ts[window.lo]
    j = window.hi - 1  # walk newest -> oldest
    valid = 0
    for i in range(N_GRID - 1, -1, -1):
        t = now - (N_GRID - 1 - i) * step
        if t < ts0:
            break
        while j > window.lo and window.ts[j] > t:
            j -= 1
        if window.ts[j] > t:
            break
        vals[i] = window.vals[j]
        valid += 1
    return vals, valid



def fit_grid_plain(fine, fine_valid, long_vals, long_valid,
                   h_fine, h_long, season, m: int) -> torch.Tensor:
    """All four forecasters over ``m`` models, in PyTorch ops on any device:
    the CPU path, and the kernel's oracle on the card. Shapes: grids
    ``[m, N_GRID]`` float32, valid counts and horizons ``[m]`` float32,
    ``season`` ``[m]`` int32 in 1..N_GRID. Returns ``[4, m]`` float32, the
    forecasts at each model's horizon in ``FORECASTERS`` order, clamped
    >= 0 (reference ``_fit_grid``).

    The least-squares sums and both recurrences run as one loop over the
    columns, oldest first, each operation rounded once in the order the
    kernel (``csrc/fit_grid.cu``) computes it."""
    f32, dev = torch.float32, fine.device
    idx = torch.arange(N_GRID, dtype=f32, device=dev)
    fine_m = (idx[None, :] >= (N_GRID - fine_valid)[:, None]).to(f32)
    long_m = (idx[None, :] >= (N_GRID - long_valid)[:, None]).to(f32)
    rows = torch.arange(m, device=dev)
    season_l = season.to(torch.int64)
    phases = torch.remainder(
        torch.arange(N_GRID, dtype=torch.int64, device=dev)[None, :],
        season_l[:, None])  # [m, N]
    zeros = torch.zeros((m,), dtype=f32, device=dev)
    n = sx = sy = sxx = sxy = zeros
    h_level = h_trend = h_started = zeros
    w_level = w_trend = w_started = zeros
    seas = torch.zeros((m, N_GRID), dtype=f32, device=dev)
    for i in range(N_GRID):
        xi = float(i)
        # -- linear: the five masked sums --
        y, wf = fine[:, i], fine_m[:, i]
        wx = wf * xi
        n = n + wf
        sx = sx + wx
        sy = sy + wf * y
        sxx = sxx + wx * xi
        sxy = sxy + wx * y
        # -- holt: double exponential smoothing over the fine grid --
        nl = HOLT_ALPHA * y + (1 - HOLT_ALPHA) * (h_level + h_trend)
        nt = HOLT_BETA * (nl - h_level) + (1 - HOLT_BETA) * h_trend
        # The first valid sample initializes the level; invalid steps carry.
        started = h_started > 0
        apply = wf > 0
        h_level = torch.where(apply, torch.where(started, nl, y), h_level)
        h_trend = torch.where(apply, torch.where(started, nt, zeros), h_trend)
        h_started = torch.maximum(h_started, wf)
        # -- holt_winters: additive triple smoothing over the long grid --
        x, wl, phase = long_vals[:, i], long_m[:, i], phases[:, i]
        s = seas[rows, phase]
        nl = HW_ALPHA * (x - s) + (1 - HW_ALPHA) * (w_level + w_trend)
        nt = HW_BETA * (nl - w_level) + (1 - HW_BETA) * w_trend
        ns = HW_GAMMA * (x - nl) + (1 - HW_GAMMA) * s
        started = w_started > 0
        apply = wl > 0
        w_level = torch.where(apply, torch.where(started, nl, x), w_level)
        w_trend = torch.where(apply, torch.where(started, nt, zeros), w_trend)
        seas[rows, phase] = torch.where(apply, torch.where(started, ns, s), s)
        w_started = torch.maximum(w_started, wl)

    denom = n * sxx - sx * sx
    pos = denom > 0
    slope = torch.where(pos, (n * sxy - sx * sy)
                        / torch.where(pos, denom, 1.0), 0.0)
    some = n > 0
    intercept = torch.where(some, (sy - slope * sx)
                            / torch.where(some, n, 1.0), 0.0)
    linear = intercept + slope * (N_GRID - 1 + h_fine)
    holt = h_level + h_trend * h_fine

    # -- seasonal_naive: long-grid value one season before the target --
    target = N_GRID - 1 + h_long
    j = torch.round(target - season.to(f32))
    j_int = torch.clamp(j.to(torch.int32), 0, N_GRID - 1).to(torch.int64)
    j_valid = (j >= N_GRID - long_valid) & (j <= N_GRID - 1)
    seasonal_naive = torch.where(j_valid, long_vals[rows, j_int],
                                 long_vals[:, -1])
    f_phase = torch.remainder(torch.round(target).to(torch.int32)
                              .to(torch.int64), season_l)
    holt_winters = w_level + w_trend * h_long + seas[rows, f_phase]

    # Insufficient history (either grid): persistence, the only honest
    # answer; clamp everything at zero (demand is non-negative).
    enough_fine = fine_valid >= MIN_VALID
    enough_long = long_valid >= MIN_VALID

    def clamp(v, enough, fallback):
        v = torch.where(enough, v, fallback)
        return torch.where(v < 0, 0.0, v)

    return torch.stack([
        clamp(linear, enough_fine, fine[:, -1]),
        clamp(holt, enough_fine, fine[:, -1]),
        clamp(seasonal_naive, enough_long, long_vals[:, -1]),
        clamp(holt_winters, enough_long, long_vals[:, -1]),
    ])


def fit_grid(fine, fine_valid, long_vals, long_valid, h_fine, h_long,
             season, m: int, impl: str | None = None) -> torch.Tensor:
    """``[4, m]`` forecasts — counterpart of the reference's jitted
    ``_fit_grid``; arguments as :func:`fit_grid_plain`. CUDA tensors launch
    the kernel once (``fit_kernel.launch``, which counts the launch and
    raises on a failure); CPU tensors, or ``impl="plain"`` on any device,
    run :func:`fit_grid_plain`."""
    if impl not in (None, "plain"):
        raise ValueError(f"unknown fit impl {impl!r}; use None or 'plain'")
    if fine.shape[0] != m:
        raise ValueError(f"grids hold {fine.shape[0]} rows, expected {m}")
    if impl == "plain" or not fine.is_cuda:
        return fit_grid_plain(fine, fine_valid, long_vals, long_valid,
                              h_fine, h_long, season, m)
    from wva_tpu_torch.forecast import fit_kernel

    out = torch.empty((len(FORECASTERS), m), dtype=torch.float32,
                      device=fine.device)
    return fit_kernel.launch(fine, fine_valid, long_vals, long_valid,
                             h_fine, h_long, season, out)


def _bucket(m: int) -> int:
    b = 1
    while b < m:
        b *= 2
    return b


def grid_tensors(grids: list[SeriesGrids], m: int, device) -> tuple:
    """The :func:`fit_grid` inputs for ``grids`` padded to ``m`` rows on
    ``device``: staged in numpy (the same double -> float32 cast per
    element), then one tensor per input. Padding rows are fully invalid,
    with season 1."""
    pad = m - len(grids)

    def rows(vals, fill, dtype=np.float32):
        a = np.asarray(vals, dtype=dtype)
        if pad:
            a = np.concatenate([a, np.full((pad, *a.shape[1:]), fill,
                                            dtype=dtype)])
        return torch.as_tensor(a, device=device)

    return (rows([g.fine for g in grids], 0.0),
            rows([g.fine_valid for g in grids], 0),
            rows([g.long for g in grids], 0.0),
            rows([g.long_valid for g in grids], 0),
            rows([g.h_fine_steps for g in grids], 0.0),
            rows([g.h_long_steps for g in grids], 0.0),
            rows([max(1, min(g.season_steps, N_GRID)) for g in grids], 1,
                 dtype=np.int32))


def fit_batch(grids: list[SeriesGrids], device=None,
              ) -> list[dict[str, float]]:
    """ONE padded fit across every model on ``device`` (None: the CUDA
    card); returns one ``{forecaster: forecast}`` dict per input, in order,
    from one host transfer. Padding rows are fully invalid and sliced off —
    per-model results are independent of batch composition (batched ==
    serial, bitwise)."""
    dev = resolve_device(device)
    if not grids:
        return []
    from wva_tpu_torch.utils import dispatch

    dispatch.note()
    m = _bucket(len(grids))
    out = fit_grid(*grid_tensors(grids, m, dev), m=m)
    host = out[:, :len(grids)].cpu().numpy()
    return [{name: float(host[f, i]) for f, name in enumerate(FORECASTERS)}
            for i in range(len(grids))]


def fit_serial(grids: list[SeriesGrids], device=None,
               ) -> list[dict[str, float]]:
    """One fit call per model (the byte-equality oracle for
    :func:`fit_batch`)."""
    return [fit_batch([g], device)[0] for g in grids]
