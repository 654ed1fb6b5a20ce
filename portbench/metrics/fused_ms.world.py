"""The fused program: host-clock ms of each ``fused.run`` (the
benchmark's wrapper; the sizing, chain and fit kernels and the one host
transfer), mean over the window's runs."""


def read(ctx):
    runs = ctx.rec.timers.get("fused", [])
    return sum(runs) / len(runs) if runs else None
