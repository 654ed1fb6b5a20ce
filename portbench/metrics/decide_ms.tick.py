"""The decision stage: the ms a tick spends from the models' finalize
through the limiter (the program's span ``decide`` under its analyze
phase: finalize, record, optimize with the fleet solve, enforce,
forecast, limiter), mean over the window's ticks."""

from portbench.program_spans import tick_mean


def read(ctx):
    return tick_mean(ctx.rec.ticks, "decide")
