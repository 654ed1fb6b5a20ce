"""The device during the searches' window: the share of the traced window
in which no device activity ran, in %."""


def read(ctx):
    return ctx.idle_pct("scan")
