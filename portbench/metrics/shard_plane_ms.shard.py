"""The sharded plane's own work: the ms a tick spends in ``shard_gather``
outside the workers' analysis ticks (``shard_tick``) and outside the
fleet-wide queries it warms for them (``fleet_queries``: collection, read
with the workers' by ``query_ms.fleet``), plus the workers' capture
builds (``shard_capture``), plus ``fleet_merge`` outside the fleet solve
(``fleet_solve``, the decision stage's): the leases, the ring, the
captures, their decode and merge, the enforcer bridge and the
re-emission of the workers' records. Mean over the window's ticks; None
where the program records no ``shard_gather``."""

from portbench.program_spans import ends_in

PLUS = ("shard_gather", "shard_capture", "fleet_merge")
MINUS = ("fleet_queries", "fleet_solve")


def read(ctx):
    split = [t["spans"] for t in ctx.rec.ticks if "spans" in t]
    if not any(ends_in(p, "shard_gather") for s in split for p in s):
        return None
    total = 0.0
    for spans in split:
        for path, ms in spans.items():
            if any(ends_in(path, n) for n in PLUS):
                total += ms
            elif any(ends_in(path, n) for n in MINUS) or path == "shard_tick":
                total -= ms
    return total / len(split)
