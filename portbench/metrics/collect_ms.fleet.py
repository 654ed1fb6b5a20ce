"""Collection: the ms a tick spends in the models' ``prepare`` (the
collector's queries under the engine's analyze phase), from the program's
span recorder (``phase:analyze/model/prepare``, summed over the tick's
models), mean over the window's ticks."""

SPAN = "phase:analyze/model/prepare"


def read(ctx):
    ticks = [t for t in ctx.rec.ticks if "spans" in t]
    if not ticks:
        return None
    return sum(t["spans"].get(SPAN, 0.0) for t in ticks) / len(ticks)
