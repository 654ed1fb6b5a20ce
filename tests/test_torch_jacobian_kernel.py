"""The EKF jacobian CUDA kernel (``wva_tpu_torch/analyzers/queueing/csrc/
ekf_jacobian.cu``) against its plain version, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit and skip without one.
On a machine with the card (where jax may be absent, hence no conftest):

    python -m pytest --noconftest tests/test_torch_jacobian_kernel.py -q

``tuner._observe_and_jacobian`` on CUDA tensors makes one launch of the
kernel; it is held to ``observe_and_jacobian_plain`` (``jacfwd``) on the
same CUDA tensors, and on the same values on the CPU, at the points of
``tests/test_torch_tuner.py`` (the same seeds and construction, with the
port's queueing model standing in for the reference's) and at
``chip_smoke.JACOBIAN_EDGES``: h at rtol 2e-3, each entry of H within 2e-3
of the largest entry of its row. The kernel sums in another order than the
plain version, so it is held to a tolerance, not bit for bit. A tuner on
the card takes the CPU tuner's accept flags over a seeded trajectory.
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
import wva_tpu_torch.analyzers.queueing as tq
from wva_tpu_torch.analyzers.queueing import jacobian_kernel
from wva_tpu_torch.analyzers.queueing import tuner

pytestmark = pytest.mark.cuda

RTOL_H = 2e-3
RTOL_X = 1e-3
REQ = (512, 256)
TRUE = (6.973, 0.027, 0.001)
TRUE_V5E = (14.0, 0.054, 0.002)
TRUE_V5P = (5.0, 0.018, 0.0007)
PRIOR = (9.0, 0.035, 0.0015)
HEADLINE = ((18.0, 0.00267, 2e-5), (36.0, 0.00534, 4e-5))  # truth, prior
# tests/test_torch_tuner.py's POINTS: (x, truth, seed), four draws each.
CASES = ((TRUE, TRUE, 1), ((10.0, 0.04, 0.002), TRUE, 2),
         ((50.0, 0.2, 0.01), TRUE, 3), ((12.0, 0.05, 0.002), TRUE, 11),
         (PRIOR, TRUE_V5E, 42), (PRIOR, TRUE_V5P, 43),
         (TRUE_V5E, TRUE_V5E, 44), (HEADLINE[1], HEADLINE[0], 20260730))


def draws(truth, seed, n, batch=64, queue=256, noise=0.02):
    """tests/test_torch_tuner.py's ``_draws`` on the port's queueing model:
    (rate/s, ttft ms, itl ms, batch, queue)."""
    qa = tq.QueueAnalyzer(
        tq.QueueConfig(max_batch_size=batch, max_queue_size=queue,
                       service_parms=tq.ServiceParms(*truth)),
        tq.RequestSize(*REQ), device="cpu")
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rate = float(rng.uniform(0.5, qa.max_rate_per_s * 0.9))
        m = qa.analyze(rate)
        out.append((rate, m.avg_ttft_ms * (1 + rng.normal(0, noise)),
                    m.avg_token_time_ms * (1 + rng.normal(0, noise)),
                    batch, queue))
    return out


def env_vec(draw):
    rate, _, _, batch, queue = draw
    return (rate / 1000.0, float(REQ[0]), float(REQ[1]), float(batch),
            float(min(batch + queue, 2048)))


@functools.cache
def tuner_points():
    return [(x, env_vec(d)) for x, truth, seed in CASES
            for d in draws(truth, seed, 4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def assert_rows_close(got, want):
    """Each entry of H within RTOL_H of its row's largest entry
    (tests/test_torch_tuner.py's rule), and every entry of h and H at rtol
    RTOL_H: the row's rule alone would not see an error in a column far
    smaller than the row's largest (dh/dalpha beside dh/dgamma)."""
    assert np.isfinite(want).all() and np.isfinite(got).all(), (got, want)
    scale = np.abs(want[:, 1:]).max(axis=1, keepdims=True)
    assert np.all(np.abs(got[:, 1:] - want[:, 1:]) <= RTOL_H * scale), (
        got, want)
    np.testing.assert_allclose(got, want, rtol=RTOL_H)


def check(x, env, device):
    """The kernel against the plain version on the same CUDA tensors and on
    the CPU; the kernel launched once, the plain version not at all."""
    xt = torch.tensor(x, dtype=torch.float32, device=device)
    et = torch.tensor(env, dtype=torch.float32, device=device)
    before = jacobian_kernel.launches
    h, jac = tuner._observe_and_jacobian(xt, et)
    assert jacobian_kernel.launches - before == 1
    assert h.device == jac.device == xt.device
    assert h.shape == (2,) and jac.shape == (2, 3)
    got = torch.cat([h[:, None], jac], dim=1).cpu().numpy()
    for dev in (device, torch.device("cpu")):
        want_h, want_jac = tuner.observe_and_jacobian_plain(xt.to(dev),
                                                            et.to(dev))
        assert_rows_close(got, torch.cat([want_h[:, None], want_jac],
                                         dim=1).cpu().numpy())
    assert jacobian_kernel.launches - before == 1


@pytest.mark.parametrize("i", range(len(CASES) * 4))
def test_kernel_matches_plain_at_the_tuner_points(cuda, i):
    x, env = tuner_points()[i]
    check(x, env, cuda)


@pytest.mark.parametrize("name", sorted(chip_smoke.JACOBIAN_EDGES))
def test_kernel_matches_plain_at_the_edges(cuda, name):
    check(chip_smoke.TUNER_X, chip_smoke.JACOBIAN_EDGES[name], cuda)


def test_launch_refuses_what_it_does_not_take(cuda):
    x = torch.tensor(chip_smoke.TUNER_X, dtype=torch.float32, device=cuda)
    env = torch.tensor(chip_smoke.TUNER_ENV, dtype=torch.float32,
                       device=cuda)
    before = jacobian_kernel.launches
    for bad in ((x.cpu(), env), (x, env.cpu()), (x.double(), env),
                (x, env[:4]), (torch.stack([x, x], dim=1)[:, 0], env)):
        with pytest.raises(ValueError):
            tuner._observe_and_jacobian(*bad)
    assert jacobian_kernel.launches == before


def test_tuner_on_the_card_takes_the_cpu_tuners_steps(cuda):
    """A KalmanTuner on the card (h and H by the kernel, one launch a step)
    takes the CPU tuner's accept flags over a seeded trajectory, its state
    at rtol 1e-3."""
    prior = (10.0, 0.04, 0.002)
    card = tq.KalmanTuner(tq.ServiceParms(*prior), device=cuda)
    cpu = tq.KalmanTuner(tq.ServiceParms(*prior), device="cpu")
    before = jacobian_kernel.launches
    steps = draws(TRUE, 1, 60)
    for i, (rate, ttft, itl, batch, queue) in enumerate(steps):
        env = dict(lambda_per_min=rate * 60, avg_input_tokens=REQ[0],
                   avg_output_tokens=REQ[1], max_batch_size=batch,
                   max_queue_size=queue, avg_ttft_ms=ttft, avg_itl_ms=itl)
        a = cpu.run(tq.TunerEnvironment(**env))
        b = card.run(tq.TunerEnvironment(**env))
        assert b.validation_failed == a.validation_failed, (i, a, b)
        np.testing.assert_allclose(card.x, cpu.x, rtol=RTOL_X, err_msg=str(i))
    assert jacobian_kernel.launches - before == len(steps)
    assert (card.steps, card.rejected) == (cpu.steps, cpu.rejected)
