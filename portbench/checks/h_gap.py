"""The EKF step's predicted (TTFT, ITL) at the observed operating point:
each sampled step's h as the tuner read it back, against the reference's
queue at the same service parameters and environment. The number is the
widest relative gap.

The state ``x`` and the environment are the tuner's own at that step (the
filter's history and the collector's averages): the reference takes them
as they were.
"""

from __future__ import annotations

import torch

from portbench.checks import ekf

LIMIT = 5e-3


def reading(rec, rng, device, control=False, cell=None):
    samples = ekf.sample(rec, rng)
    if not samples:
        return None
    ref = ekf.reference(samples, torch.float64, device)
    got = (ekf.reference(samples, torch.bfloat16, device) if control
           else ekf.program(samples))
    return max(float((torch.abs(g[0] - r[0]) / torch.abs(r[0])).max())
               for g, r in zip(got, ref))
