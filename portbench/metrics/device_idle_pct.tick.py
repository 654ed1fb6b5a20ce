"""The device during the ticks' window: the share of the traced window in
which no device activity ran, in %."""


def read(ctx):
    return ctx.idle_pct("ticks")
