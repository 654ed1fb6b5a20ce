#!/usr/bin/env python3
"""The sharded plane's crash proof at fleet width (not a cell).

    python3 portbench/shard_crash.py --seed <n> [--models <n>] \\
        [--workload fleet-1000x2-shard4.sharded-busy] [--after <ticks>]

Builds the cell's world twice from ``--seed`` in this process, on the card
(``device`` None), and ticks each as the cell does, every tick recorded:
once undisturbed (the oracle: sharding changes who computes, never what
is decided), once with one shard worker killed at a seeded tick
(``emulator.faults.seeded_shard_crashes``: which shard, and whether its
lease is released or ridden out). Both worlds tick until ``--after``
ticks past the tick the ring moved the dead shard's models.

Prints one JSON line. What it holds the plane to:

- no wrong-direction scale event: no VariantAutoscaling's desired
  replicas fall at a tick where the oracle's stay at or above the value
  they fell from (the rebalance ramp's promise: scale-ups pass, nothing
  drops that the undisturbed system would keep);
- reconvergence within 5 fleet ticks of the rebalance: from then on
  every capture the merge takes comes from a worker that ran, no model
  is uncovered, no rebalance hold is open, and ``shard_gap`` and
  ``decision_gap`` are 0 on every tick;
- ``shard_gap`` 0 on every tick, and ``decision_gap`` 0 on every tick
  whose captures all come from workers that ran (the reference decides
  what the tick analyzed afresh: a capture read back from the bus
  re-solves a dead worker's fleet-solved models from its last arrays).

It also reports what it does not hold the plane to: the scale-ups
against the oracle, and each tick's count of desired replicas unequal
to the oracle's. A moved model's new owner starts with no demand trend,
and a lease ridden out leaves the planner's history of the dead shard's
models a hole, so their decisions may differ from the undisturbed
system's for as long as the trend's window and the planner's grids hold
the difference.

Exits non-zero unless it holds.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

WORKLOAD = "fleet-1000x2-shard4.sharded-busy"
RECONVERGE_TICKS = 5
# Ticks at most in a crashed world: the crash's window, a lease ridden
# out (its duration over the engine interval), and what follows.
MAX_TICKS = 64


def desired(mgr) -> dict[str, int]:
    return {f"{va.metadata.namespace}/{va.metadata.name}":
            va.status.desired_optimized_alloc.num_replicas
            for va in mgr.client.list("VariantAutoscaling")}


def crash_event(seed: int, shards: int, interval: float):
    """The seeded crash and the tick it happens before: one crash drawn
    over a 12-tick span."""
    from wva_tpu_torch.emulator.faults import seeded_shard_crashes

    event = seeded_shard_crashes(seed=seed, horizon=12 * interval,
                                 shards=shards, n=1, min_gap=interval,
                                 settle=interval)[0]
    return event, int(event.at // interval)


def run_world(config, traffic, seed, device, ticks=None, crash=None,
              after=8):
    """Tick a world; with ``crash`` (event, tick) kill that shard before
    that tick and tick on until ``after`` ticks past the rebalance.
    Returns (each tick's desired replicas, each tick's record, the
    rebalance tick, each tick's open hold count)."""
    from portbench import core
    from portbench.drivers import shard_plane

    rec = core.Record(seed, {"decisions": MAX_TICKS + 1})
    drv = shard_plane.Driver(config, traffic, seed, device, rec)
    plane = drv.mgr.engine.shard_plane
    trail, holds, rebalance = [], [], None
    try:
        drv.warm_up()
        rec.recording = True
        moved = plane.rebalance_total
        i = 0
        while i < (ticks or MAX_TICKS):
            if crash is not None and i == crash[1]:
                plane.kill_shard(crash[0].shard,
                                 release_lease=crash[0].clean)
            drv.tick()
            trail.append(desired(drv.mgr))
            holds.append(len(plane.hold_keys()))
            if rebalance is None and plane.rebalance_total > moved:
                rebalance = i
            i += 1
            if ticks is None and rebalance is not None \
                    and i > rebalance + after:
                break
    finally:
        rec.recording = False
        drv.close()
    return trail, rec.calls["decisions"], rebalance, holds


def against_oracle(trail, oracle, start):
    """(falls the oracle does not make, rises against the oracle's
    direction) from tick ``start`` on: (tick, VA, from, to, oracle)."""
    falls, rises = [], []
    for t in range(max(start, 1), len(trail)):
        prev, cur, want = trail[t - 1], trail[t], oracle[t]
        for va, value in sorted(cur.items()):
            if value < prev[va] <= want[va]:
                falls.append((t, va, prev[va], value, want[va]))
            elif value > prev[va] > want[va]:
                rises.append((t, va, prev[va], value, want[va]))
    return falls, rises


def settled(record, holds, gaps) -> bool:
    shards = record["shards"]
    covered = set().union(*shards["analyzed"].values())
    return (not shards["reread"] and not shards["stale"] and not holds
            and covered == set(shards["models"]) and not any(gaps))


def reconverged(records, holds, gaps, rebalance):
    """Ticks from the rebalance to the first tick from which every tick
    is settled; None if the last tick is not."""
    last_off = None
    for t, record in enumerate(records):
        if not settled(record, holds[t], gaps[t]):
            last_off = t
    if last_off is None or last_off < rebalance:
        return 0
    if last_off == len(records) - 1:
        return None
    return last_off + 1 - rebalance


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--workload", default=WORKLOAD)
    p.add_argument("--models", type=int, default=None)
    p.add_argument("--after", type=int, default=8)
    a = p.parse_args(argv)

    import torch

    from portbench import core
    from portbench.checks import decision_gap, shard_gap

    if device is None and not torch.cuda.is_available():
        print("portbench: the crash proof needs a CUDA card", file=sys.stderr)
        return 2
    _, config, traffic = core.cell(a.workload)
    if a.models is not None:
        config = dict(config, n_models=a.models)
    dev = device or "cuda"
    interval = config["engine_interval_s"]
    event, at = crash_event(a.seed, config["sharding"]["shards"], interval)
    trail, records, rebalance, holds = run_world(
        config, traffic, a.seed, dev, crash=(event, at), after=a.after)
    oracle, _, _, _ = run_world(config, traffic, a.seed, dev,
                                ticks=len(trail))
    profiles = decision_gap.fixed_profiles(config, traffic, a.seed)
    gaps = [(shard_gap.gaps(r["shards"]),
             0 if r["shards"]["reread"]
             else decision_gap.gaps(r, config, profiles)) for r in records]
    falls, rises = against_oracle(trail, oracle, at)
    out = {
        "event": {"shard": event.shard, "clean": event.clean,
                  "at_s": event.at},
        "crash_tick": at, "rebalance_tick": rebalance, "ticks": len(trail),
        "models": config["n_models"],
        "alive": [r["shards"]["alive"] for r in records],
        "reread": [r["shards"]["reread"] for r in records],
        "uncovered": [len(r["shards"]["models"])
                      - len(set().union(*r["shards"]["analyzed"].values()))
                      for r in records],
        "holds": holds,
        "equal_to_oracle_before_crash": trail[:at] == oracle[:at],
        "wrong_direction_events": len(falls),
        "falls_against_oracle": falls,
        "rises_against_oracle": len(rises),
        "unequal_to_oracle": [sum(v != want[va] for va, v in cur.items())
                              for cur, want in zip(trail, oracle)],
        "reconverged_ticks": (None if rebalance is None else
                              reconverged(records, holds, gaps, rebalance)),
        "shard_gap": float(sum(g[0] for g in gaps)),
        "decision_gap": float(sum(g[1] for g in gaps)),
        "decision_ticks": sum(not r["shards"]["reread"] for r in records),
    }
    ok = (out["equal_to_oracle_before_crash"]
          and out["wrong_direction_events"] == 0
          and out["reconverged_ticks"] is not None
          and out["reconverged_ticks"] <= RECONVERGE_TICKS
          and out["shard_gap"] == 0 and out["decision_gap"] == 0)
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
