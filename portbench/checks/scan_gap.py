"""The horizon scan: each sampled world's attainment, chip-seconds and
wrong-direction events, as the chunk handed them back to the search,
against the reference's fluid world over the same knobs, rates, arrivals
and fault windows. The number is the widest of the attainment's absolute
gap, the chip-seconds' relative gap and the events' gap over the larger of
the reference's count and 1.

The chunk's inputs (knob rows, true rates, seeded arrivals and fault
windows) are the search's own and are taken as they were; the world's
physics come from the configuration and the traffic file.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import scan

LIMIT = 5e-3
CHUNKS = 4  # chunks sampled a run
WORLDS = 16  # worlds sampled a chunk


def sample(rec, rng):
    calls = rec.calls["scan"]
    if not calls:
        return []
    out = []
    for i in sorted(rng.choice(len(calls), min(CHUNKS, len(calls)),
                               replace=False)):
        knob_rows, lam_t, arrivals, faults, init, res = calls[i]
        w = int(knob_rows.shape[0])
        pick = torch.as_tensor(sorted(rng.choice(w, min(WORLDS, w),
                                                 replace=False)))
        out.append((knob_rows.detach().cpu()[pick], lam_t.detach().cpu(),
                    arrivals.detach().cpu()[:, pick],
                    faults.detach().cpu()[:, pick], float(init),
                    [r.detach().cpu()[pick].double() for r in res[:3]]))
    return out


def reading(rec, rng, device, control=False, cell=None):
    samples = sample(rec, rng)
    if not samples:
        return None
    widest = 0.0
    for knob_rows, lam_t, arrivals, faults, init, got in samples:
        args = (cell["scenario"], knob_rows.to(device), lam_t, arrivals,
                faults, init)
        ref = [r.double().cpu() for r in scan.run(*args, dtype=torch.float32)]
        if control:
            got = [r.double().cpu()
                   for r in scan.run(*args, dtype=torch.bfloat16)]
        gaps = [torch.abs(got[0] - ref[0]),
                torch.abs(got[1] - ref[1]) / torch.clamp(torch.abs(ref[1]),
                                                         min=1.0),
                torch.abs(got[2] - ref[2]) / torch.clamp(ref[2], min=1.0)]
        gap = max(float(torch.nan_to_num(g, nan=np.inf).max()) for g in gaps)
        widest = max(widest, gap)
    return widest
