"""The sizing solve: each sampled candidate's rate (per s, the SLO capacity
of one replica) and its throughput at that rate, as the fused program
handed them to the engine, against the reference's sizing of the same
candidate. The number is the widest relative gap over the sample.

The candidate rows (profile parameters, request mix, batch and queue
bounds, SLO targets) are the program's state at the tick: the reference
takes them as they were and works out the sizing again.
"""

from __future__ import annotations

import torch

from portbench.reference import queue

LIMIT = 1e-3
CALLS = 8  # fused calls sampled a run
ROWS = 64  # candidates sampled a call


def sample(rec, rng):
    """[(rows, targets, program rate, program throughput or nan)]."""
    calls = [c for c in rec.calls["fused"] if c[0].n_candidates]
    if not calls:
        return []
    out = []
    for i in sorted(rng.choice(len(calls), min(CALLS, len(calls)),
                               replace=False)):
        grids, result = calls[i]
        n = grids.n_candidates
        rate = [0.0] * n
        for key, (lo, hi) in grids.cand_slices.items():
            rate[lo:hi] = result.per_replica[key]
        thr = [float("nan")] * n
        for pair, idx in grids.cand_index.items():
            thr[idx] = result.presized[pair]
        for r in sorted(rng.choice(n, min(ROWS, n), replace=False)):
            row = grids.cand_rows[r]
            out.append((row[:7], row[7:10], rate[r], thr[r]))
    return out


def _size(rows, dtype, device):
    c = queue.Candidates.from_rows([r[0] for r in rows], dtype, device)
    t = [torch.tensor([r[1][i] for r in rows], dtype=torch.float64)
         .to(dtype=dtype, device=device) for i in range(3)]
    out = queue.size(c, *t)
    return (out["rate_per_s"].double().cpu(),
            out["throughput_per_s"].double().cpu())


def reading(rec, rng, device, control=False, cell=None):
    rows = sample(rec, rng)
    if not rows:
        return None
    ref_rate, ref_thr = _size(rows, torch.float64, device)
    if control:
        got_rate, got_thr = _size(rows, torch.bfloat16, device)
    else:
        got_rate = torch.tensor([r[2] for r in rows], dtype=torch.float64)
        got_thr = torch.tensor([r[3] for r in rows], dtype=torch.float64)
    gap = torch.abs(got_rate - ref_rate) / torch.abs(ref_rate)
    has = ~torch.isnan(got_thr)
    gap_thr = torch.abs(got_thr - ref_thr)[has] / torch.abs(ref_thr)[has]
    return float(torch.cat([gap, gap_thr]).max())
