"""The EKF step's jacobian H = dh/dx: each sampled step's H as the tuner
read it back, against the reference's forward-mode derivative at the same
point. Entries are compared as elasticities, ``H[i, j] * x[j] / h[i]``
(the relative change of an observation for a relative change of a
parameter), so that the three columns, whose scales differ by orders of
magnitude, weigh alike. The number is the widest gap of an elasticity.
"""

from __future__ import annotations

import torch

from portbench.checks import ekf

LIMIT = 7e-3


def reading(rec, rng, device, control=False, cell=None):
    samples = ekf.sample(rec, rng)
    if not samples:
        return None
    ref = ekf.reference(samples, torch.float64, device)
    got = (ekf.reference(samples, torch.bfloat16, device) if control
           else ekf.program(samples))
    widest = 0.0
    for (x, _, _), g, r in zip(samples, got, ref):
        scale = torch.abs(x)[None, :] / torch.abs(r[0])[:, None]
        widest = max(widest, float((torch.abs(g[1] - r[1]) * scale).max()))
    return widest
