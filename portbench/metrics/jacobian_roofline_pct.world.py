"""The EKF observation-and-jacobian kernel's share of its roofline, in %
(``kernels/chain_jacobian.py``), as the sizing kernel's."""


def read(ctx):
    return ctx.roofline_pct("chain_jacobian")
