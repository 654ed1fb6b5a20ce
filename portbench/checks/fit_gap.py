"""The forecaster fits: each sampled model's four forecasts, as the fused
program handed them to the planner, against the reference's fits of the
same grids. The gap of a forecast is measured against the larger of the
reference's forecast and the largest valid sample of its grids, so that a
forecast clamped near zero is judged on the demand's own scale. The
number is the widest gap over the sample.

The grids (the planner's resampled demand history and the horizons) are
the program's state at the tick: the reference takes them as they were.
"""

from __future__ import annotations

import torch

from portbench.reference import fits

LIMIT = 5e-3
CALLS = 4
MODELS = 16


def sample(rec, rng):
    """[(fine, fine_valid, long, long_valid, h_fine, h_long, season,
    program forecasts [4])]."""
    calls = [c for c in rec.calls["fused"] if c[0].n_models]
    if not calls:
        return []
    out = []
    for i in sorted(rng.choice(len(calls), min(CALLS, len(calls)),
                               replace=False)):
        grids, result = calls[i]
        n = grids.n_models
        host = [t.detach().cpu() for t in (
            grids.fine, grids.fine_valid, grids.long, grids.long_valid,
            grids.h_fine, grids.h_long, grids.season)]
        for m in sorted(rng.choice(n, min(MODELS, n), replace=False)):
            got = [result.fits[m][name] for name in fits.NAMES]
            out.append((host[0][m], float(host[1][m]), host[2][m],
                         float(host[3][m]), float(host[4][m]),
                         float(host[5][m]), int(host[6][m]), got))
    return out


def _scale(s):
    fine, fv, long_vals, lv = s[0], int(s[1]), s[2], int(s[3])
    vals = [fine[fits.N_GRID - fv:].abs(), long_vals[fits.N_GRID - lv:].abs()]
    vals = torch.cat([v for v in vals if len(v)] or [torch.zeros(1)])
    return float(vals.max())


def reading(rec, rng, device, control=False, cell=None):
    samples = sample(rec, rng)
    if not samples:
        return None
    widest = 0.0
    for s in samples:
        ref = fits.forecasts(*s[:7]).double()
        got = (fits.forecasts(*s[:7], dtype=torch.bfloat16).double()
               if control else torch.tensor(s[7], dtype=torch.float64))
        scale = torch.clamp(torch.abs(ref), min=max(_scale(s), 1e-30))
        widest = max(widest, float((torch.abs(got - ref) / scale).max()))
    return widest
