"""The fingerprint plane: the share of the fleet's models the engine
analyzed (``last_tick_stats``: analyzed over analyzed plus skipped), over
all the window's ticks, in %."""


def read(ctx):
    analyzed = sum(t.get("analyzed", 0) for t in ctx.rec.ticks)
    total = analyzed + sum(t.get("skipped", 0) for t in ctx.rec.ticks)
    return 100.0 * analyzed / total if total else None
