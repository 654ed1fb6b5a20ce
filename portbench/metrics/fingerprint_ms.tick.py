"""The fingerprint plane: the ms a tick spends in the engine's
fingerprint phase (the program's span ``phase:fingerprint``; below it
``versions``, the grouped queries and versions, and ``hash``, the
fingerprints model by model), mean over the window's ticks."""

from portbench.program_spans import tick_mean


def read(ctx):
    return tick_mean(ctx.rec.ticks, "phase:fingerprint")
