"""The fused program's host grid build: the ms a tick spends laying the
candidates and models out on the program's grids (the program's span
``fused_grids``, before its dispatch), mean over the window's ticks."""

from portbench.program_spans import tick_mean


def read(ctx):
    return tick_mean(ctx.rec.ticks, "fused_grids")
