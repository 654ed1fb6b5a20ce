"""The sharded plane's ownership and merge: on each kept tick, against the
plain consistent-hash ring (``portbench/reference/ring.py``) over the
shards the plane found live, the number of

- models whose entries came from a shard other than the one the plain
  ring names;
- models of the fleet that no capture the merge took holds, or that more
  than one holds;
- merged pre-limiter decisions that are not the union of the decisions
  in the workers' local and cached entries and the fleet solve's results
  (each decision's judged fields compared; counted where the two
  multisets differ).

Summed over the kept ticks. An exact comparison: its limit is 0.
"""

from __future__ import annotations

import collections

from portbench.reference import ring

LIMIT = 0


def gaps(shards: dict) -> int:
    owner = ring.assign(shards["models"], shards["alive"])
    holders = collections.defaultdict(set)
    for shard, models in shards["analyzed"].items():
        for model in models:
            holders[model].add(int(shard))
    wrong = sum(holders.get(model, set()) != {owner.get(model)}
                for model in shards["models"])
    wrong += sum(model not in owner for model in holders)
    expected = collections.Counter(shards["entry_decisions"])
    expected.update(shards["solved_decisions"])
    merged = collections.Counter(shards["merged_decisions"])
    wrong += sum(((expected - merged) + (merged - expected)).values())
    return wrong


def reading(rec, rng, device, control=False, cell=None):
    ticks = [t for t in rec.calls["decisions"] if t.get("shards")]
    if not ticks:
        return None
    if control:
        # Not a float computation: ownership has no lower precision.
        return None
    return float(sum(gaps(t["shards"]) for t in ticks))
