"""The plain reference against small cases worked by hand."""

from __future__ import annotations

import math

import pytest
import torch

from portbench.reference import fits, queue, scan

F64 = torch.float64


def one_server(alpha=10.0, beta=0.0, gamma=0.0, avg_in=0.0, avg_out=1.0,
               batch=1.0, k=4.0):
    t = lambda v: torch.tensor([v], dtype=F64)  # noqa: E731
    return queue.Candidates(t(alpha), t(beta), t(gamma), t(avg_in),
                            t(avg_out), t(batch), t(k))


def test_service_rate_by_hand():
    # No prompt, one output token, batch 1: a request takes
    # out * (alpha + 1*0 + beta + gamma*...) = 10 ms, so mu = 0.1 per ms.
    c = one_server()
    mu = queue.service_rate(c, torch.tensor([[1.0, 2.0, 3.0]], dtype=F64))
    assert torch.allclose(mu, torch.full((1, 3), 0.1, dtype=F64))


@pytest.mark.parametrize("lam", [0.02, 0.05, 0.09])
def test_chain_is_mm1k(lam):
    """Batch 1 makes mu constant: the M/M/1/k chain, p(n) ~ rho**n."""
    c = one_server(k=4.0)
    rho = lam / 0.1
    p = [rho ** n for n in range(5)]
    z = sum(p)
    st = queue.chain(c, torch.tensor([lam], dtype=F64))
    assert float(st["in_system"][0]) == pytest.approx(
        sum(n * q for n, q in enumerate(p)) / z, rel=1e-12)
    assert float(st["p_block"][0]) == pytest.approx(p[4] / z, rel=1e-12)
    assert float(st["in_service"][0]) == pytest.approx(1 - p[0] / z,
                                                       rel=1e-12)


def test_sizing_meets_its_target():
    c = one_server(alpha=5.0, beta=0.002, gamma=1e-5, avg_in=512.0,
                   avg_out=128.0, batch=96.0, k=480.0)
    t = lambda v: torch.tensor([v], dtype=F64)  # noqa: E731
    out = queue.size(c, t(1000.0), t(0.0), t(0.0))
    lam = out["rate_per_s"] / 1000.0
    ttft, _ = queue.latencies(c, lam)
    assert float(ttft[0]) == pytest.approx(1000.0, rel=1e-9)
    lo, hi = queue.rate_bounds(c)
    assert float(lo[0]) < float(lam[0]) < float(hi[0])
    # A TPS target caps the rate at 90% of the top of the range.
    capped = queue.size(c, t(1e9), t(0.0), t(1.0))
    assert float(capped["rate_per_s"][0]) == pytest.approx(
        900.0 * float(hi[0]), rel=1e-12)


def test_jacobian_matches_finite_differences():
    x = torch.tensor([36.0, 0.00534, 0.00004], dtype=F64)
    env = torch.tensor([0.005, 512.0, 253.0, 96.0, 480.0], dtype=F64)
    h, jac = queue.observation_and_jacobian(x, env)
    for j in range(3):
        step = torch.zeros(3, dtype=F64)
        step[j] = 1e-6 * x[j]
        fd = (queue.observation(x + step, env)
              - queue.observation(x - step, env)) / (2 * step[j])
        assert torch.allclose(jac[:, j], fd, rtol=1e-5)
    assert h.shape == (2,) and bool((h > 0).all())


def grid(values):
    g = torch.zeros(fits.N_GRID, dtype=F64)
    g[fits.N_GRID - len(values):] = torch.tensor(values, dtype=F64)
    return g


def test_fits_on_a_line_and_a_constant():
    line = [2.0 + 0.5 * i for i in range(20)]
    out = fits.forecasts(grid(line), 20, grid([7.0] * 20), 20, 4.0, 3.0, 5)
    # Least squares through an exact line extrapolates it: the newest is at
    # column 159 with 11.5; four steps on adds 2.0.
    assert float(out[0]) == pytest.approx(13.5, rel=1e-12)
    # Holt started on the line's first sample lags it, but a constant
    # grid's seasonal forecasts are the constant.
    assert float(out[2]) == pytest.approx(7.0)
    assert float(out[3]) == pytest.approx(7.0, rel=1e-12)


def test_seasonal_naive_reads_one_season_back():
    season = 4
    long_vals = [float(i % season) * 10 for i in range(40)]
    out = fits.forecasts(grid([1.0] * 8), 8, grid(long_vals), 40, 1.0, 2.0,
                         season)
    # Target column 161: one season back is column 157 (value of i=37).
    assert float(out[2]) == pytest.approx(long_vals[37])


def test_fits_fall_back_and_clamp():
    out = fits.forecasts(grid([5.0, 3.0, 1.0]), 3, grid([2.0]), 1, 1.0, 1.0,
                         4)
    assert out.tolist() == [1.0, 1.0, 2.0, 2.0]
    falling = [100.0 - 30.0 * i for i in range(4)]
    out = fits.forecasts(grid(falling), 4, grid([1.0]), 1, 10.0, 1.0, 4)
    assert float(out[0]) == 0.0


SCENE = dict(alpha_ms=18.0, beta_ms=0.00267, gamma_ms=0.00002,
             max_batch=96, chips_per_replica=8, slo_ttft_s=1.0,
             startup_s=120.0, down_stabilization_s=120.0,
             avg_input_tokens=512.0, avg_output_tokens=256.0, queue_bound=64,
             dt=5.0, horizon_s=1200.0, max_replicas=32)
KNOBS = [5.0, 1.0, 0.85, 0.15, 1.0, 15.0, 0.5, 0.2, 3.0, 0.35, 120.0, 300.0,
         3.0]


def test_idle_world_holds_its_headroom():
    """No arrivals and no burst insurance: the controller wants its one
    headroom replica, so one replica of 8 chips is paid for all 240 steps
    of 5 s, nothing is attained and no direction is wrong."""
    steps = 240
    knobs = torch.tensor([KNOBS], dtype=torch.float32)
    knobs[0, 3] = 0.0  # burst_slope_rps
    zeros = torch.zeros((steps, 1, 1), dtype=torch.float32)
    attain, chips, wd, total = scan.run(
        SCENE, knobs, torch.zeros((steps, 1)), zeros, zeros, 1.0)
    assert float(attain) == 0.0 and float(total) == 0.0
    assert float(chips) == pytest.approx(1 * 8 * 5.0 * steps)
    assert float(wd) == 0.0


def test_light_steady_load_is_served_within_the_slo():
    """One request a second against a replica that serves ~10 a second:
    every arrival is attained and the world never scales past headroom
    plus what the rate needs."""
    steps = 240
    knobs = torch.tensor([KNOBS], dtype=torch.float32)
    arrivals = torch.full((steps, 1, 1), 5.0)
    attain, chips, _, total = scan.run(
        SCENE, knobs, torch.ones((steps, 1)), arrivals,
        torch.zeros_like(arrivals), 1.0)
    assert float(total) == 5.0 * steps
    assert float(attain) == 1.0
    assert math.isfinite(float(chips)) and float(chips) >= 8 * 5.0 * steps
