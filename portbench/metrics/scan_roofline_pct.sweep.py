"""The horizon-scan kernel's share of its roofline, in %
(``kernels/world_scan.py``), as the sizing kernel's."""


def read(ctx):
    return ctx.roofline_pct("world_scan")
