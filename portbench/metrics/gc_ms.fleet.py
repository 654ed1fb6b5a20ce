"""The host runtime: ms a tick spends in the interpreter's garbage
collections (``gc.callbacks``), mean over the window's ticks."""


def read(ctx):
    ticks = [t for t in ctx.rec.ticks if "gc_ms" in t]
    if not ticks:
        return None
    return sum(t["gc_ms"] for t in ticks) / len(ticks)
