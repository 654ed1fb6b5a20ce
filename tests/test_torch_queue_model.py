"""The port's queueing solver against the JAX package's, on the CPU.

The same seeded numpy populations go through ``wva_tpu``'s
``queue_model`` (XLA path, and the Pallas kernel in interpret mode) and
``wva_tpu_torch``'s (plain PyTorch path). Rates are held at rtol 2e-3, the
tolerance the JAX package itself applies between its two bisection
backends (tests/test_pallas_kernel.py); disabled targets at 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wva_tpu.analyzers.queueing import queue_model as jq
from wva_tpu.analyzers.queueing.params import (
    QueueConfig as JQueueConfig,
    RequestSize as JRequestSize,
    ServiceParms as JServiceParms,
    TargetPerf as JTargetPerf,
)
from wva_tpu.analyzers.queueing.pallas_kernel import sizing_bisection_pallas
from wva_tpu_torch.analyzers.queueing import queue_model as tq
from wva_tpu_torch.analyzers.queueing import sizing_kernel
from wva_tpu_torch.analyzers.queueing.convert import candidate_batch_from_numpy
from wva_tpu_torch.analyzers.queueing.params import (
    QueueConfig,
    RequestSize,
    ServiceParms,
    TargetPerf,
)

RATE_KEYS = ("max_rate_per_s", "rate_target_ttft_per_s",
             "rate_target_itl_per_s", "rate_target_tps_per_s")
RTOL = 2e-3
CPU = torch.device("cpu")


def _population(n, seed=0, k_hi=512):
    """Candidate fields (the test_pallas_kernel.py ranges) and targets."""
    rng = np.random.default_rng(seed)
    fields = {
        "alpha": rng.uniform(3.0, 30.0, n).astype(np.float32),
        "beta": rng.uniform(0.001, 0.05, n).astype(np.float32),
        "gamma": rng.uniform(0.00001, 0.002, n).astype(np.float32),
        "avg_input_tokens": rng.uniform(64, 2048, n).astype(np.float32),
        "avg_output_tokens": rng.uniform(32, 1024, n).astype(np.float32),
        "max_batch": rng.integers(8, 128, n).astype(np.int32),
        "k": rng.integers(128, k_hi, n).astype(np.int32),
    }
    targets = (rng.uniform(100, 3000, n).astype(np.float32),
               rng.uniform(5, 100, n).astype(np.float32),
               np.zeros(n, np.float32))
    return fields, targets


def _both(fields):
    jc = jq.candidate_batch(fields["alpha"], fields["beta"], fields["gamma"],
                            fields["avg_input_tokens"],
                            fields["avg_output_tokens"], fields["max_batch"],
                            fields["k"])
    return jc, candidate_batch_from_numpy(fields, device=CPU)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# Outputs that are a difference of two larger terms (wait = resp - serv):
# float32 cancellation leaves an absolute error proportional to the terms,
# so they are held at rtol times the larger term's magnitude.
_DIFFERENCES = {"avg_wait_time": "avg_resp_time",
                "avg_wait_time_ms": "avg_resp_time_ms"}


def _assert_stats_close(b, a, keys):
    for key in keys:
        if key in _DIFFERENCES:
            scale = np.abs(_np(a[_DIFFERENCES[key]]))
            assert np.all(np.abs(_np(b[key]) - _np(a[key]))
                          <= RTOL * scale + 1e-6), key
        else:
            np.testing.assert_allclose(_np(b[key]), _np(a[key]), rtol=RTOL,
                                       atol=1e-6, err_msg=key)


@pytest.mark.parametrize("n,seed,k_hi,k_cols", [
    (64, 1, 512, 512),     # random population
    (77, 2, 512, 512),     # not a multiple of any tile
    (1, 3, 512, 512),      # single candidate
    (40, 4, 250, 256),     # narrowest state axis
    (24, 5, 2048, 2048),   # full state axis
    (tq._SIZE_CHUNK + 64, 6, 192, 256),  # chunked plain bisection
])
def test_size_batch_matches_jax(n, seed, k_hi, k_cols):
    fields, (ttft, itl, tps) = _population(n, seed, k_hi)
    jc, tc = _both(fields)
    a = jq.size_batch(jc, jnp.asarray(ttft), jnp.asarray(itl),
                      jnp.asarray(tps), k_cols=k_cols, impl="xla")
    b = tq.size_batch(tc, ttft, itl, tps, k_cols=k_cols)
    assert set(b) == set(a)
    for key in a:
        assert b[key].shape == (n,) and b[key].dtype == torch.float32
        np.testing.assert_allclose(_np(b[key]), _np(a[key]), rtol=RTOL,
                                   err_msg=key)


def test_disabled_targets_yield_lam_max():
    fields, _ = _population(16, seed=7)
    jc, tc = _both(fields)
    zeros = np.zeros(16, np.float32)
    a = jq.size_batch(jc, jnp.asarray(zeros), jnp.asarray(zeros),
                      jnp.asarray(zeros), k_cols=512, impl="xla")
    b = tq.size_batch(tc, zeros, zeros, zeros, k_cols=512)
    for key in RATE_KEYS:
        np.testing.assert_allclose(_np(b[key]), _np(a[key]), rtol=1e-5,
                                   err_msg=key)


def test_tps_target_caps_at_stability_margin():
    fields, (ttft, itl, _) = _population(32, seed=8)
    tps = np.full(32, 100.0, np.float32)
    jc, tc = _both(fields)
    a = jq.size_batch(jc, jnp.asarray(ttft), jnp.asarray(itl),
                      jnp.asarray(tps), k_cols=512, impl="xla")
    b = tq.size_batch(tc, ttft, itl, tps, k_cols=512)
    for key in RATE_KEYS:
        np.testing.assert_allclose(_np(b[key]), _np(a[key]), rtol=RTOL,
                                   err_msg=key)


def test_size_batch_bucketed_and_k_cols_for():
    fields, (ttft, itl, tps) = _population(48, seed=9, k_hi=700)
    jc, tc = _both(fields)
    assert tq.k_cols_for(fields["k"]) == jq.k_cols_for(fields["k"]) == 1024
    for ks in ([1], [256], [257], [2048], [5000], []):
        assert tq.k_cols_for(ks) == jq.k_cols_for(ks), ks
    a = jq.size_batch_bucketed(jc, ttft, itl, tps)
    b = tq.size_batch_bucketed(tc, ttft, itl, tps)
    for key in RATE_KEYS:
        np.testing.assert_allclose(_np(b[key]), _np(a[key]), rtol=RTOL,
                                   err_msg=key)


def test_rate_bounds_match_jax():
    fields, _ = _population(77, seed=10)
    jc, tc = _both(fields)
    for a, b in zip(jq.rate_bounds_per_ms(jc), tq.rate_bounds_per_ms(tc)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-5)


@pytest.mark.parametrize("k_cols", [512, 2048])
def test_chain_stats_match_jax(k_cols):
    fields, _ = _population(77, seed=11)
    jc, tc = _both(fields)
    lo, hi = tq.rate_bounds_per_ms(tc)
    frac = np.random.default_rng(12).uniform(0.0, 1.0, 77).astype(np.float32)
    lam = (lo + torch.from_numpy(frac) * (hi - lo)).numpy()
    a = jq._chain_stats(jnp.asarray(lam), jc, jq._masked_log_mu(jc, k_cols))
    b = tq._chain_stats(torch.from_numpy(lam), tc,
                        tq._masked_log_mu(tc, k_cols))
    assert set(a) == set(b)
    _assert_stats_close(b, a, a)


def test_analyze_batch_matches_jax():
    fields, _ = _population(77, seed=13)
    jc, tc = _both(fields)
    lo, hi = (x.numpy() * 1000.0 for x in tq.rate_bounds_per_ms(tc))
    rng = np.random.default_rng(14)
    rates = (lo + rng.uniform(0.05, 0.95, 77) * (hi - lo)).astype(np.float32)
    rates[:5] = lo[:5] * 0.5    # below the feasible range: clamped, invalid
    rates[5:10] = hi[5:10] * 2  # above it
    a = jq.analyze_batch(jnp.asarray(rates), jc, k_cols=512)
    b = tq.analyze_batch(rates, tc, k_cols=512)
    assert set(a) == set(b)
    np.testing.assert_array_equal(_np(b["valid"]), _np(a["valid"]))
    assert not _np(b["valid"])[:10].any() and _np(b["valid"])[10:].all()
    _assert_stats_close(b, a, [key for key in a if key != "valid"])


@pytest.mark.parametrize("n,k_cols", [(77, 512), (8, 256)])
def test_plain_bisection_matches_pallas_interpret(n, k_cols):
    fields, (ttft, itl, _) = _population(n, seed=15, k_hi=k_cols)
    jc, tc = _both(fields)
    jlo, jhi = jq.rate_bounds_per_ms(jc)
    jclm = jq._cum_log_mu(jc, k_cols)
    jclm_at_k = jnp.take_along_axis(jclm, jc.k[:, None] - 1, axis=1)[:, 0]
    targets = np.stack([ttft, itl])
    a = sizing_bisection_pallas(
        jclm, jclm_at_k, jc, jnp.asarray(targets), jnp.stack([jlo, jlo]),
        jnp.stack([jhi, jhi]), interpret=True)

    lo, hi = tq.rate_bounds_per_ms(tc)
    clm = tq._cum_log_mu(tc, k_cols)
    clm_at_k = torch.gather(clm, 1, (tc.k[:, None] - 1).long())[:, 0]
    args = (clm, clm_at_k, tc, torch.from_numpy(targets),
            torch.stack([lo, lo]), torch.stack([hi, hi]))
    b = sizing_kernel.sizing_bisection_plain(*args)
    assert b.shape == (2, n) and b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL)
    # On CPU tensors the wrapper runs the plain version and launches nothing.
    before = sizing_kernel.launches
    assert torch.equal(sizing_kernel.sizing_bisection(*args), b)
    assert sizing_kernel.launches == before


def test_coefficients_match_pallas_wrapper_rows():
    fields, _ = _population(9, seed=16)
    _, tc = _both(fields)
    clm = tq._cum_log_mu(tc, 512)
    clm_at_k = torch.gather(clm, 1, (tc.k[:, None] - 1).long())[:, 0]
    coef = sizing_kernel.coefficients(clm_at_k, tc)
    assert coef.shape == (8, 9) and coef.dtype == torch.float32
    np.testing.assert_array_equal(coef[1].numpy(), fields["k"])
    np.testing.assert_array_equal(coef[2].numpy(), fields["max_batch"])
    np.testing.assert_array_equal(coef[6].numpy(), np.ones(9, np.float32))
    np.testing.assert_allclose(
        coef[7].numpy(), 1.0 / np.maximum(fields["avg_output_tokens"], 1.0),
        rtol=1e-6)


def test_size_batch_rejects_unknown_impl():
    fields, (ttft, itl, tps) = _population(4, seed=17)
    _, tc = _both(fields)
    with pytest.raises(ValueError, match="unknown solver impl"):
        tq.size_batch(tc, ttft, itl, tps, k_cols=512, impl="pallas")


def test_candidate_batch_clamps_bounds():
    cb = tq.candidate_batch([5.0], [0.01], [0.001], [100], [50], [9999],
                            [99999], device="cpu")
    assert cb.max_batch.dtype == torch.int32 and cb.k.dtype == torch.int32
    assert int(cb.max_batch[0]) == 512 and int(cb.k[0]) == 2048
    assert cb.alpha.device.type == "cpu"


def test_queue_analyzer_facade_matches_jax():
    parms = dict(alpha=6.973, beta=0.027, gamma=0.001)
    jqa = jq.QueueAnalyzer(
        JQueueConfig(max_batch_size=64, max_queue_size=448,
                     service_parms=JServiceParms(**parms)),
        JRequestSize(avg_input_tokens=512, avg_output_tokens=256))
    tqa = tq.QueueAnalyzer(
        QueueConfig(max_batch_size=64, max_queue_size=448,
                    service_parms=ServiceParms(**parms)),
        RequestSize(avg_input_tokens=512, avg_output_tokens=256),
        device="cpu")
    assert tqa.max_rate_per_s == pytest.approx(jqa.max_rate_per_s, rel=1e-5)
    assert tqa.min_rate_per_s == pytest.approx(jqa.min_rate_per_s, rel=1e-5)
    rate = 0.5 * jqa.max_rate_per_s
    ja, ta = jqa.analyze(rate), tqa.analyze(rate)
    for f in vars(ja):
        assert getattr(ta, f) == pytest.approx(getattr(ja, f), rel=RTOL), f
    jr, jm, jach = jqa.size(JTargetPerf(target_ttft_ms=1000.0,
                                        target_itl_ms=60.0))
    tr, tm, tach = tqa.size(TargetPerf(target_ttft_ms=1000.0,
                                       target_itl_ms=60.0))
    for j, t in ((jr, tr), (jm, tm), (jach, tach)):
        for f in vars(j):
            assert getattr(t, f) == pytest.approx(getattr(j, f), rel=RTOL), f
    with pytest.raises(ValueError):
        tqa.analyze(-1.0)
    with pytest.raises(ValueError):
        tq.QueueAnalyzer(QueueConfig(max_batch_size=0), RequestSize(),
                         device="cpu")
