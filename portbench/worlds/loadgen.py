"""Load profiles of the benchmark's worlds: ``t_seconds -> requests/second``.

A frozen copy of the trapezoid of ``wva_tpu_torch/emulator/loadgen.py``
(its scalar closure, and the vectorized ``rate_at`` twin over numpy
arrays that the policy sweep's rate table samples), kept here so that the
traffic the benchmark offers cannot move with the program.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

LoadProfile = Callable[[float], float]


def trapezoid(base_rate: float, peak_rate: float, ramp_up: float,
              hold: float, ramp_down: float, tail: float = 0.0,
              delay: float = 0.0) -> LoadProfile:
    """``delay`` at base, a linear ramp to peak over ``ramp_up``, ``hold``
    at peak, a linear descent back to base over ``ramp_down``, ``tail`` at
    base, then 0."""

    def profile(t: float) -> float:
        t -= delay
        if t <= 0:
            return base_rate
        if t < ramp_up:
            return base_rate + (peak_rate - base_rate) * (t / ramp_up)
        t -= ramp_up
        if t < hold:
            return peak_rate
        t -= hold
        if t < ramp_down:
            return peak_rate - (peak_rate - base_rate) * (t / ramp_down)
        return base_rate if t < ramp_down + tail else 0.0

    def rate_at(t):
        t1 = np.asarray(t, dtype=np.float64) - delay
        t2 = t1 - ramp_up
        t3 = t2 - hold
        up = base_rate + (peak_rate - base_rate) * (t1 / ramp_up)
        down = peak_rate - (peak_rate - base_rate) * (t3 / ramp_down)
        r = np.where(t3 < ramp_down + tail, base_rate, 0.0)
        r = np.where(t3 < ramp_down, down, r)
        r = np.where(t2 < hold, peak_rate, r)
        r = np.where(t1 < ramp_up, up, r)
        return np.where(t1 <= 0, base_rate, r)

    profile.rate_at = rate_at
    return profile
