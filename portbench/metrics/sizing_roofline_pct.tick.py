"""The sizing-bisection kernel's share of its roofline in the ticks, in %:
the work of its launches in the window (``kernels/sizing_bisection.py``)
at the card's float32 peak or memory bandwidth, whichever takes longer,
over their device time in the profiler's trace."""


def read(ctx):
    return ctx.roofline_pct("sizing_bisection")
