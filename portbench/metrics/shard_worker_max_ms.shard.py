"""The sharded plane's workers: the ms of the slowest worker's analysis
tick (the program's ``shard_tick`` spans, one a worker, grafted under the
fleet tick), mean over the window's ticks. The in-process plane drives
its workers one after another; this is the wall time a tick would pay
with each worker in its own process."""


def read(ctx):
    ticks = [t["workers_ms"] for t in ctx.rec.ticks if t.get("workers_ms")]
    if not ticks:
        return None
    return sum(max(ms) for ms in ticks) / len(ticks)
