"""The sweep chunk: host-clock ms from a chunk's staging (knob rows and
tables to the device) to its outputs on the device (one launch of the
scan kernel, synchronised), mean over the window's chunks."""


def read(ctx):
    chunks = ctx.rec.timers.get("chunk", [])
    return sum(chunks) / len(chunks) if chunks else None
