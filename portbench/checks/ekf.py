"""The EKF step's observation, shared by ``h_gap`` and ``jac_gap``: the
sampled tuner steps' ``x`` and ``env`` as the step sent them to the
device, and the ``[2, 4]`` (h, H) it read back."""

from __future__ import annotations

import torch

from portbench.reference import queue

STEPS = 48  # tuner steps sampled a run


def sample(rec, rng):
    calls = rec.calls["observation"]
    if not calls:
        return []
    pick = sorted(rng.choice(len(calls), min(STEPS, len(calls)),
                             replace=False))
    return [tuple(t.detach().cpu().double() for t in calls[i]) for i in pick]


def reference(samples, dtype, device):
    """[(h [2], H [2, 3])] by the reference in ``dtype``."""
    out = []
    for x, env, _ in samples:
        h, jac = queue.observation_and_jacobian(
            x.to(dtype=dtype, device=device), env.to(dtype=dtype,
                                                     device=device))
        out.append((h.double().cpu(), jac.double().cpu()))
    return out


def program(samples):
    return [(got[:, 0], got[:, 1:]) for _, _, got in samples]
