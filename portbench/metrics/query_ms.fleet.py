"""Collection's backend queries: the ms a tick spends in fleet-wide
grouped queries, their demux and digest stamping (the program's spans
``backend_query``, wherever a phase runs them, summed), mean over the
window's ticks."""

from portbench.program_spans import tick_mean


def read(ctx):
    return tick_mean(ctx.rec.ticks, "backend_query")
