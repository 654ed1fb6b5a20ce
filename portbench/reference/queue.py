"""The state-dependent M/M/1/k queue of one inference server, and the
sizing solve over it.

A server holding ``n`` requests runs batches of ``min(n, B)``; one
decode iteration at batch ``b`` takes ``T(b) = alpha + b*(beta*tc +
gamma*tm)`` ms, with ``tc = (in + out) / (out + 1)`` and ``tm = in +
out/2`` tokens. A request's prefill takes ``T(b) + (beta + gamma)*in``
(nothing without a prompt) and each of its ``out`` tokens ``T(b) + beta +
gamma*(in + out/2)``, so the server completes requests at ``mu(n) = b /
(prefill(b) + out*decode(b))`` per ms. Arrivals at ``lam`` per ms give the
birth-death chain ``p(n) ~ lam**n / prod_{i<=n} mu(i)`` on ``0..k``.
From it: requests in the system and in service, the blocking probability
``p(k)``, throughput ``lam*(1 - p(k))``, response and service time by
Little's law, the queue wait, and TTFT = wait + prefill at the mean batch
+ one ITL.

Sizing finds, per candidate, the largest rate whose TTFT (and, apart,
whose ITL) stays under its target, by bisection on ``[eps*mu(1),
(1-eps)*mu(B)]``; a TPS target caps the rate at 90% of the upper bound;
the candidate's rate is the least of the three, and its throughput is
the chain's at that rate. Every function takes and returns tensors of
the caller's dtype and device.
"""

from __future__ import annotations

import torch

EPSILON = 1e-3  # the feasible-rate margin at both ends
K_MAX = 2048  # the longest chain, in states
MAX_BATCH = 512  # the largest batch a server runs
TPS_MARGIN = 0.1  # a TPS target keeps the rate this far under saturation
BISECTIONS = 64


class Candidates:
    """C candidate servers as ``[C]`` tensors: ``alpha``, ``beta``,
    ``gamma`` (ms), ``avg_in``, ``avg_out`` (tokens), ``batch`` (B) and
    ``k`` (batch plus queue), B and k as whole numbers in the dtype."""

    def __init__(self, alpha, beta, gamma, avg_in, avg_out, batch, k):
        self.alpha, self.beta, self.gamma = alpha, beta, gamma
        self.avg_in, self.avg_out = avg_in, avg_out
        self.batch, self.k = batch, k

    @classmethod
    def from_rows(cls, rows, dtype, device):
        """From host rows ``(alpha, beta, gamma, in, out, B, k)``; B is
        clamped to 1..MAX_BATCH and k to 1..K_MAX."""
        cols = list(zip(*rows))
        t = [torch.tensor(c, dtype=torch.float64) for c in cols[:7]]
        t[5] = torch.clamp(torch.round(t[5]), 1, MAX_BATCH)
        t[6] = torch.clamp(torch.round(t[6]), 1, K_MAX)
        return cls(*(x.to(dtype=dtype, device=device) for x in t))


def _per_batch_ms(c: Candidates):
    """``beta*tc + gamma*tm``: an iteration's ms per request in the batch."""
    tc = (c.avg_in + c.avg_out) / (c.avg_out + 1.0)
    tm = c.avg_in + c.avg_out / 2.0
    return c.beta * tc + c.gamma * tm


def prefill_ms(c: Candidates, b):
    """A request's prefill at batch ``b`` (broadcast against ``[C]``)."""
    t = c.alpha + b * _per_batch_ms(c) + (c.beta + c.gamma) * c.avg_in
    return torch.where(c.avg_in > 0, t, torch.zeros_like(t))


def service_rate(c: Candidates, n):
    """``mu(n)`` per ms for ``n`` requests in the server, ``n`` of shape
    ``[C, S]`` or ``[C]``."""
    expand = n.dim() > 1
    col = (lambda x: x[:, None]) if expand else (lambda x: x)
    b = torch.minimum(n, col(c.batch))
    it = col(c.alpha) + b * col(_per_batch_ms(c))
    pre = it + col((c.beta + c.gamma) * c.avg_in)
    pre = torch.where(col(c.avg_in) > 0, pre, torch.zeros_like(pre))
    dec = it + col(c.beta) + col(c.gamma * (c.avg_in + c.avg_out / 2.0))
    per_req = pre + col(c.avg_out) * dec
    return b / torch.clamp(per_req, min=1e-12)


def rate_bounds(c: Candidates):
    """(lowest, highest) feasible arrival rate per ms."""
    return (service_rate(c, torch.ones_like(c.batch)) * EPSILON,
            service_rate(c, c.batch) * (1.0 - EPSILON))


def _log_chain(c: Candidates):
    """``sum_{i<=n} log mu(i)`` for n = 1..S (S the largest k), ``[C,
    S]``, and the mask of states each candidate can hold."""
    s = int(torch.max(c.k).item())
    n = torch.arange(1, s + 1, dtype=c.alpha.dtype,
                     device=c.alpha.device)[None, :].expand(len(c.alpha), s)
    held = n <= c.k[:, None]
    log_mu = torch.log(torch.clamp(service_rate(c, n), min=1e-30))
    return torch.cumsum(torch.where(held, log_mu, torch.zeros_like(log_mu)),
                        dim=1), held, n


def chain(c: Candidates, lam, log_chain=None):
    """The stationary chain at ``lam`` per ms (``[C]``, or ``[L, C]`` for
    L rates a candidate): a dict of requests in the system and in service,
    the blocking probability and throughput per ms."""
    clm, held, n = log_chain if log_chain is not None else _log_chain(c)
    log_lam = torch.log(torch.clamp(lam, min=1e-30))[..., None]
    logp = torch.where(held, n * log_lam - clm,
                       torch.full_like(clm, -torch.inf))
    logp = torch.cat([torch.zeros_like(logp[..., :1]), logp], dim=-1)
    p = torch.exp(logp - torch.logsumexp(logp, dim=-1, keepdim=True))
    states = torch.cat([torch.zeros_like(n[:, :1]), n], dim=1)
    in_service = torch.minimum(states, c.batch[:, None])
    p_block = torch.gather(
        p, -1, c.k.to(torch.int64).expand(p.shape[:-1])[..., None])[..., 0]
    return {"in_system": torch.sum(states * p, dim=-1),
            "in_service": torch.sum(in_service * p, dim=-1),
            "p_block": p_block,
            "throughput": lam * (1.0 - p_block)}


def latencies(c: Candidates, lam, log_chain=None):
    """(TTFT, ITL) in ms at ``lam`` per ms."""
    st = chain(c, lam, log_chain)
    x = torch.clamp(st["throughput"], min=1e-30)
    resp, serv = st["in_system"] / x, st["in_service"] / x
    wait = torch.clamp(resp - serv, min=0.0)
    pre = prefill_ms(c, st["in_service"])
    itl = (serv - pre) / torch.clamp(c.avg_out, min=1.0)
    return wait + pre + itl, itl


def size(c: Candidates, ttft_ms, itl_ms, tps):
    """Per candidate: the largest rate (per s) meeting its targets (a
    target <= 0 is off) and the throughput (per s) there."""
    lo0, hi0 = rate_bounds(c)
    log_chain = _log_chain(c)
    targets = torch.stack([ttft_ms, itl_ms])
    lo, hi = torch.stack([lo0, lo0]), torch.stack([hi0, hi0])
    for _ in range(BISECTIONS):
        mid = 0.5 * (lo + hi)
        ttft, itl = latencies(c, mid, log_chain)
        below = torch.stack([ttft[0], itl[1]]) < targets
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    lam_star = 0.5 * (lo + hi)
    rate = torch.minimum(
        torch.where(ttft_ms > 0, lam_star[0], hi0),
        torch.where(itl_ms > 0, lam_star[1], hi0))
    rate = torch.minimum(rate, torch.where(tps > 0, hi0 * (1.0 - TPS_MARGIN),
                                           hi0))
    return {"rate_per_s": rate * 1000.0,
            "throughput_per_s": chain(c, rate, log_chain)["throughput"]
            * 1000.0}


def observation(x, env):
    """The EKF's observation: (TTFT, ITL) in ms predicted for service
    parameters ``x = (alpha, beta, gamma)`` at ``env = (lam per ms, in,
    out, B, k)``, the rate clipped to the feasible range first."""
    one = lambda v: v.reshape(1)  # noqa: E731
    c = Candidates(one(x[0]), one(x[1]), one(x[2]), one(env[1]), one(env[2]),
                   one(torch.round(env[3])), one(torch.round(env[4])))
    lo, hi = rate_bounds(c)
    lam = torch.minimum(torch.maximum(one(env[0]), lo), hi)
    ttft, itl = latencies(c, lam)
    return torch.cat([ttft, itl])


def observation_and_jacobian(x, env):
    """(h ``[2]``, H ``[2, 3]`` = dh/dx) by forward-mode differentiation."""
    return (observation(x, env),
            torch.func.jacfwd(lambda p: observation(p, env))(x))
