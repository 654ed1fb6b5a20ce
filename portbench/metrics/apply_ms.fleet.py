"""Apply: the ms a tick spends writing statuses and actuating, from the
program's span recorder (``phase:apply``), mean over the window's
ticks."""

SPAN = "phase:apply"


def read(ctx):
    ticks = [t for t in ctx.rec.ticks if "spans" in t]
    if not ticks:
        return None
    return sum(t["spans"].get(SPAN, 0.0) for t in ticks) / len(ticks)
