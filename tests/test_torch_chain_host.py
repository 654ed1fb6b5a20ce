"""The chain-setup and chain-statistics kernels' arithmetic, run as host C++
on the CPU.

``tests/chain_host.py`` compiles the host-C++ part of
``wva_tpu_torch/analyzers/queueing/csrc/chain_setup.cu`` and
``chain_stats.cu`` (with ``chain_common.cuh``) and runs each kernel's warp
lane by lane in the kernel's own order: the segments of 256 states, each
lane's 8 in order, the Hillis-Steele scan, the carry, the butterflies. The
same seeded numpy inputs go through that, through the plain versions
(``chain_setup.chain_setup_plain``, ``chain_stats.size_tail_plain`` and
``analyze_plain``: the port's PyTorch functions) and through the JAX
package's ``queue_model`` on the CPU, at C in {1, 7, 64} and every k_cols
the sizing path uses, with edge rows at k = 1, k = k_cols, no prompt, and
disabled targets. Values are held at rtol 2e-3, the tolerance the JAX
package applies between its own two bisection backends
(tests/test_pallas_kernel.py); a difference of two larger terms (the wait,
resp - serv) at 2e-3 of the larger term, and the prefix sums at 2e-3 of the
sum of their terms' magnitudes (a sum's rounding error scales with its
terms, not with its value, which crosses zero). Integer and boolean
outputs are equal. A row's bits are the same alone and inside a batch, at
any position and at a wider k_cols. The kernels' schedules give the bits
of PR 12's, kept in ``tests/chain_host.py`` as the oracle, at max batch
1, 2, 32, 33, 96, 256, 257 and above k, k 1, 255, 256, 257 and k_cols,
k_cols 256 and 2048, and on the seeded populations. Needs ``g++``, no
card:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_chain_host.py -q
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chain_host
from chain_host import as_ptr, field_arrays, segments_for
from wva_tpu.analyzers.queueing import queue_model as jq
from wva_tpu_torch.analyzers.queueing import chain_setup, chain_stats
from wva_tpu_torch.analyzers.queueing import queue_model as qm
from wva_tpu_torch.analyzers.queueing import sizing_kernel
from wva_tpu_torch.analyzers.queueing.convert import candidate_batch_from_numpy

RTOL = 2e-3
ATOL = 1e-6
K_COLS = (256, 512, 1024, 2048)
ROWS = (1, 7, 64)
CPU = torch.device("cpu")
# Outputs that are a difference of two larger terms, and the larger term.
DIFFERENCES = {"avg_wait_time_ms": "avg_resp_time_ms"}


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return chain_host.build(tmp_path_factory.mktemp("chain_host"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def population(n, seed, k_cols):
    """Candidate fields (tests/test_pallas_kernel.py's ranges, k up to
    k_cols) and (ttft, itl, tps) targets, with the edge rows first: k = 1,
    k = k_cols, no prompt, TTFT off, ITL off, a TPS target."""
    rng = np.random.default_rng(seed)
    fields = {
        "alpha": rng.uniform(3.0, 30.0, n),
        "beta": rng.uniform(0.001, 0.05, n),
        "gamma": rng.uniform(0.00001, 0.002, n),
        "avg_input_tokens": rng.uniform(64, 2048, n),
        "avg_output_tokens": rng.uniform(32, 1024, n),
        "max_batch": rng.integers(8, 128, n),
        "k": rng.integers(max(1, k_cols // 4), k_cols + 1, n),
    }
    ttft = rng.uniform(100, 3000, n)
    itl = rng.uniform(5, 100, n)
    tps = np.where(rng.uniform(size=n) < 0.3, rng.uniform(10, 1000, n), 0.0)
    edges = [("k", 1), ("k", k_cols), ("avg_input_tokens", 0.0),
             ("ttft", 0.0), ("itl", 0.0), ("tps", 500.0)]
    targets = {"ttft": ttft, "itl": itl, "tps": tps}
    for i, (name, value) in enumerate(edges[(seed % len(edges)) if n == 1
                                            else 0:][:n]):
        (fields if name in fields else targets)[name][i] = value
    fields = {k: np.asarray(v, np.int32 if k in ("max_batch", "k")
                            else np.float32) for k, v in fields.items()}
    return fields, tuple(np.asarray(targets[t], np.float32)
                         for t in ("ttft", "itl", "tps"))


def cases():
    return [(n, k_cols, 100 * n + k_cols // 256)
            for n in ROWS for k_cols in K_COLS]


def host_setup(so, fields, k_cols, oracle=False):
    """The setup kernel's outputs in its schedule, or with ``oracle`` in
    PR 12's (each lane its own states' log mu)."""
    n = len(fields["k"])
    bounds = np.full((4, n), np.nan, np.float32)
    clm = np.full((n, k_cols), np.nan, np.float32)
    at_k = np.full(n, np.nan, np.float32)
    arrays = field_arrays(fields)
    so.host_setup(*map(as_ptr, arrays), as_ptr(bounds), as_ptr(clm),
                  as_ptr(at_k), n, k_cols, int(oracle))
    return bounds, clm, at_k


def host_stats(so, fields, k_cols, mode, rate=None, lam_star=None,
               targets=None, lam_max=None, oracle=False):
    """The kernel's rows (:data:`chain_stats.TAIL_KEYS` or ``ANALYZE_KEYS``)
    as a dict, and for mode 1 ``valid``: in the kernel's schedule, or with
    ``oracle`` in PR 12's (each lane its own states' log mu, every segment
    of the instantiation walked)."""
    n = len(fields["k"])
    keys = chain_stats.TAIL_KEYS if mode == 0 else chain_stats.ANALYZE_KEYS
    out = np.full((len(keys), n), np.nan, np.float32)
    valid = np.full(n, 7, np.uint8)
    inputs = [None if a is None else np.ascontiguousarray(a, np.float32)
              for a in (rate, lam_star, targets, lam_max)]
    so.host_stats(*map(as_ptr, field_arrays(fields)), *map(as_ptr, inputs),
                  as_ptr(out), as_ptr(valid), n, k_cols, mode,
                  segments_for(k_cols), int(oracle))
    got = dict(zip(keys, out))
    if mode == 1:
        got["valid"] = valid.astype(bool)
    return got


def np_dict(d):
    return {k: np.asarray(v) for k, v in d.items()}


def assert_close(got, want, keys, what=""):
    for key in keys:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        if key in DIFFERENCES:
            scale = np.abs(np.asarray(want[DIFFERENCES[key]]))
            assert np.all(np.abs(g - w) <= RTOL * scale + ATOL), (what, key)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {key}")


def assert_prefix_close(got, want, terms, k, what):
    """clm up to each row's k within RTOL of the running sum of its terms'
    magnitudes; past k (about 1e30 a state) at RTOL of its own value."""
    scale = np.cumsum(np.abs(terms.astype(np.float64)), axis=1)
    inside = np.arange(1, got.shape[1] + 1)[None, :] <= k[:, None]
    diff = np.abs(got.astype(np.float64) - want)
    assert np.all(diff[inside] <= RTOL * scale[inside]), what
    assert np.all(diff[~inside] <= RTOL * np.abs(want[~inside])), what


@pytest.mark.parametrize("n,k_cols,seed", cases())
def test_setup_matches_plain_and_reference(host, n, k_cols, seed):
    fields, _ = population(n, seed, k_cols)
    bounds, clm, at_k = host_setup(host, fields, k_cols)
    cand = candidate_batch_from_numpy(fields, device=CPU)
    plain = chain_setup.chain_setup_plain(cand, k_cols)
    terms = qm._masked_log_mu(cand, k_cols).numpy()
    k = fields["k"]
    np.testing.assert_allclose(bounds, plain.bounds.numpy(), rtol=RTOL)
    assert_prefix_close(clm, plain.clm.numpy(), terms, k, "plain")
    np.testing.assert_array_equal(at_k, clm[np.arange(n), k - 1])

    jc = jq.candidate_batch(*(fields[f] for f in chain_host.FIELDS))
    lo, hi = (np.asarray(x) for x in jq.rate_bounds_per_ms(jc))
    np.testing.assert_allclose(bounds, np.stack([lo, lo, hi, hi]), rtol=RTOL)
    assert_prefix_close(clm, np.asarray(jq._cum_log_mu(jc, k_cols)), terms,
                        k, "reference")


def reference_tail(fields, lam_star, targets, lam_max, k_cols):
    """The sizing path's tail by the JAX package's functions."""
    jc = jq.candidate_batch(*(fields[f] for f in chain_host.FIELDS))
    rate_ttft = np.where(targets[0] > 0, lam_star[0], lam_max)
    rate_itl = np.where(targets[1] > 0, lam_star[1], lam_max)
    rate_tps = np.where(targets[2] > 0,
                        lam_max * np.float32(1.0 - jq.STABILITY_SAFETY_FRACTION),
                        lam_max)
    lam = np.minimum(np.minimum(rate_ttft, rate_itl), rate_tps)
    stats = jq._chain_stats(jnp.asarray(lam), jc,
                            jq._masked_log_mu(jc, k_cols))
    _, itl, ttft = jq._derived_latencies(stats, jc)
    x = np.asarray(stats["throughput"]) * 1000.0
    return {
        "rate_target_ttft_per_s": rate_ttft * 1000.0,
        "rate_target_itl_per_s": rate_itl * 1000.0,
        "rate_target_tps_per_s": rate_tps * 1000.0,
        "max_rate_per_s": lam * 1000.0,
        "achieved_ttft_ms": np.asarray(ttft),
        "achieved_itl_ms": np.asarray(itl),
        "achieved_tps": x * fields["avg_output_tokens"],
        "throughput_per_s": x,
        "rho": np.clip(np.asarray(stats["avg_num_in_servers"])
                       / fields["max_batch"], 0.0, 1.0),
    }


def plain_bisection(fields, targets, k_cols):
    """lam_star and lambda_max from the plain setup and bisection."""
    cand = candidate_batch_from_numpy(fields, device=CPU)
    setup = chain_setup.chain_setup_plain(cand, k_cols)
    t = torch.from_numpy(np.stack(targets))
    lam_star = sizing_kernel.sizing_bisection_plain(
        setup.clm, setup.clm_at_k, cand, t[:2].contiguous(), setup.lo0,
        setup.hi0)
    return cand, lam_star, t, setup.bounds[2]


@pytest.mark.parametrize("n,k_cols,seed", cases())
def test_tail_matches_plain_and_reference(host, n, k_cols, seed):
    fields, targets = population(n, seed + 1, k_cols)
    cand, lam_star, t, lam_max = plain_bisection(fields, targets, k_cols)
    got = host_stats(host, fields, k_cols, 0, lam_star=lam_star.numpy(),
                     targets=t.numpy(), lam_max=lam_max.numpy())
    want = np_dict(chain_stats.size_tail_plain(cand, lam_star, t, lam_max,
                                               k_cols))
    assert_close(got, want, chain_stats.TAIL_KEYS, "plain")
    ref = reference_tail(fields, lam_star.numpy(), t.numpy(),
                         lam_max.numpy(), k_cols)
    assert_close(got, ref, chain_stats.TAIL_KEYS, "reference")
    off = np.stack(targets) <= 0
    for row, key in enumerate(("rate_target_ttft_per_s",
                               "rate_target_itl_per_s")):
        np.testing.assert_array_equal(
            got[key][off[row]], lam_max.numpy()[off[row]] * np.float32(1000))


@pytest.mark.parametrize("n,k_cols,seed", cases())
def test_analyze_matches_plain_and_reference(host, n, k_cols, seed):
    fields, _ = population(n, seed + 2, k_cols)
    cand = candidate_batch_from_numpy(fields, device=CPU)
    lo_ms, hi_ms = (x.numpy() for x in qm.rate_bounds_per_ms(cand))
    lo, hi = lo_ms * 1000.0, hi_ms * 1000.0
    rng = np.random.default_rng(seed)
    rates = (lo + rng.uniform(0.05, 0.95, n) * (hi - lo)).astype(np.float32)
    rates[0::5] = lo[0::5] * 0.5  # below the feasible range: clamped
    rates[1::5] = hi[1::5] * 2  # above it
    rates[2::5] = hi_ms[2::5] * np.float32(1000)  # on the bounds
    rates[3::5] = lo_ms[3::5] * np.float32(1000)
    got = host_stats(host, fields, k_cols, 1, rate=rates)
    want = np_dict(qm.analyze_batch(rates, cand, k_cols=k_cols))
    jc = jq.candidate_batch(*(fields[f] for f in chain_host.FIELDS))
    ref = np_dict(jq.analyze_batch(jnp.asarray(rates), jc, k_cols=k_cols))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    # A rate on a bound is valid or not by the bound's last bit, which the
    # reference's XLA program may round otherwise: held away from them.
    away = np.ones(n, bool)
    away[2::5] = away[3::5] = False
    np.testing.assert_array_equal(got["valid"][away], ref["valid"][away])
    for other, what in ((want, "plain"), (ref, "reference")):
        assert_close(got, other, chain_stats.ANALYZE_KEYS, what)
    assert not got["valid"][0::5].any() and not got["valid"][1::5].any()


@pytest.mark.parametrize("n,k_cols,seed", cases())
def test_size_batch_through_both_kernels(host, n, k_cols, seed):
    """The whole solve with the kernels' arithmetic around the plain
    bisection: the setup's bounds and chain into the bisection, its rates
    into the tail; against the plain size_batch and the reference's."""
    fields, targets = population(n, seed + 3, k_cols)
    bounds, clm, at_k = host_setup(host, fields, k_cols)
    cand = candidate_batch_from_numpy(fields, device=CPU)
    t = torch.from_numpy(np.stack(targets))
    b = torch.from_numpy(bounds)
    lam_star = sizing_kernel.sizing_bisection_plain(
        torch.from_numpy(clm), torch.from_numpy(at_k), cand,
        t[:2].contiguous(), b[:2], b[2:])
    got = host_stats(host, fields, k_cols, 0, lam_star=lam_star.numpy(),
                     targets=t.numpy(), lam_max=bounds[2])
    want = np_dict(qm.size_batch(cand, *targets, k_cols=k_cols))
    assert_close(got, want, chain_stats.TAIL_KEYS, "plain")
    jc = jq.candidate_batch(*(fields[f] for f in chain_host.FIELDS))
    ref = np_dict(jq.size_batch(jc, *(jnp.asarray(x) for x in targets),
                                k_cols=k_cols))
    assert_close(got, ref, chain_stats.TAIL_KEYS, "reference")


def test_a_row_past_k_cols_has_no_chain(host):
    """k beyond k_cols (which the plain version's gather refuses): clm at k
    and every statistic that needs p[k] are NaN, the other rows as they
    were."""
    fields, targets = population(7, 12, 512)
    bounds, clm, at_k = host_setup(host, fields, 512)
    tail_in = dict(lam_star=np.stack([bounds[0] * 20, bounds[2] * 0.5]),
                   targets=np.stack(targets), lam_max=bounds[2])
    tail = host_stats(host, fields, 512, 0, **tail_in)
    fields["k"][3] = 513
    b2, c2, a2 = host_setup(host, fields, 512)
    t2 = host_stats(host, fields, 512, 0, **tail_in)
    assert np.isnan(a2[3]) and np.isnan(t2["achieved_ttft_ms"][3])
    others = np.arange(7) != 3
    np.testing.assert_array_equal(a2[others], at_k[others])
    np.testing.assert_array_equal(c2[others], clm[others])
    for key in tail:
        np.testing.assert_array_equal(t2[key][others], tail[key][others])


def rows_of(fields, idx):
    return {k: np.ascontiguousarray(v[idx]) for k, v in fields.items()}


@pytest.mark.parametrize("k_cols,wider", [(256, 2048), (512, 1024),
                                          (1024, 2048)])
def test_a_rows_bits_depend_on_the_row_alone(host, k_cols, wider):
    """Each row alone, at its position in a batch of 64, in reversed order,
    and at a wider k_cols: the same bits from both kernels."""
    fields, targets = population(64, 77, k_cols)
    rates = np.random.default_rng(78).uniform(0.1, 50.0, 64).astype(
        np.float32)
    bounds, clm, at_k = host_setup(host, fields, k_cols)
    lam_star = np.stack([bounds[0] * 20, bounds[2] * 0.5])
    tgt = np.stack(targets)
    tail = host_stats(host, fields, k_cols, 0, lam_star=lam_star,
                      targets=tgt, lam_max=bounds[2])
    ana = host_stats(host, fields, k_cols, 1, rate=rates)
    wb, wclm, wat = host_setup(host, fields, wider)
    np.testing.assert_array_equal(wb, bounds)
    np.testing.assert_array_equal(wclm[:, :k_cols], clm)
    np.testing.assert_array_equal(wat, at_k)
    for key, v in host_stats(host, fields, wider, 0, lam_star=lam_star,
                             targets=tgt, lam_max=bounds[2]).items():
        np.testing.assert_array_equal(v, tail[key], err_msg=key)
    for key, v in host_stats(host, fields, wider, 1, rate=rates).items():
        np.testing.assert_array_equal(v, ana[key], err_msg=key)
    rev = np.arange(63, -1, -1)
    rb, rclm, rat = host_setup(host, rows_of(fields, rev), k_cols)
    np.testing.assert_array_equal(rclm, clm[rev])
    np.testing.assert_array_equal(rb, bounds[:, rev])
    for i in (0, 31, 63):
        one = rows_of(fields, [i])
        b1, c1, a1 = host_setup(host, one, k_cols)
        np.testing.assert_array_equal(c1[0], clm[i])
        np.testing.assert_array_equal(a1[0], at_k[i])
        t1 = host_stats(host, one, k_cols, 0, lam_star=lam_star[:, [i]],
                        targets=tgt[:, [i]], lam_max=bounds[2][[i]])
        a1 = host_stats(host, one, k_cols, 1, rate=rates[[i]])
        for key in tail:
            np.testing.assert_array_equal(t1[key][0], tail[key][i])
        for key in ana:
            np.testing.assert_array_equal(a1[key][0], ana[key][i])


def assert_bits(got, want, what):
    """Bit for bit: floats by their 32-bit patterns (so -0.0 is not 0.0 and
    every NaN's bits count), the rest by value."""
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_schedules_equal(so, fields, targets, k_cols, what):
    """The kernels' schedules (the own log mu dealt across the lanes, the
    statistics' walk limited to each row's segments) against PR 12's (each
    lane its own states, every segment walked): setup, tail and analyze
    bit for bit."""
    got, want = (host_setup(so, fields, k_cols, oracle=o)
                 for o in (False, True))
    for name, g, w in zip(("bounds", "clm", "clm_at_k"), got, want):
        assert_bits(g, w, f"{what} setup {name}")
    bounds = want[0]
    tail_in = dict(lam_star=np.stack([bounds[0] * 20, bounds[2] * 0.5]),
                   targets=np.stack(targets), lam_max=bounds[2])
    rates = np.random.default_rng(k_cols).uniform(
        0.1, 50.0, len(fields["k"])).astype(np.float32)
    for mode, kw in ((0, tail_in), (1, dict(rate=rates))):
        got, want = (host_stats(so, fields, k_cols, mode, oracle=o, **kw)
                     for o in (False, True))
        for key in want:
            assert_bits(got[key], want[key], f"{what} mode {mode} {key}")


EDGE_KS = (1, 255, 256, 257)


@pytest.mark.parametrize("batch", [1, 2, 32, 33, 96, 256, 257, "above k"])
@pytest.mark.parametrize("k_cols", [256, 2048])
def test_the_schedules_equal_pr12s_at_the_edges(host, k_cols, batch):
    """Every k of EDGE_KS and k_cols (257 past k_cols 256), three seeded
    rows each, at max batch B or at k + 1 (every state within k its own):
    the kernels' schedules give PR 12's bits."""
    ks = np.repeat(np.array([*EDGE_KS, k_cols]), 3)
    fields, targets = population(len(ks), 40 + k_cols // 256, k_cols)
    fields["k"] = ks.astype(np.int32)
    fields["max_batch"] = (ks + 1 if batch == "above k"
                           else np.full(len(ks), batch)).astype(np.int32)
    assert_schedules_equal(host, fields, targets, k_cols,
                           f"B={batch} k_cols={k_cols}")


@pytest.mark.parametrize("n,k_cols,seed", cases())
def test_the_schedules_equal_pr12s_on_the_populations(host, n, k_cols, seed):
    fields, targets = population(n, seed + 4, k_cols)
    assert_schedules_equal(host, fields, targets, k_cols,
                           f"C={n} k_cols={k_cols}")


def test_cpu_tensors_take_the_plain_versions():
    fields, targets = population(7, 5, 512)
    cand = candidate_batch_from_numpy(fields, device=CPU)
    chain_setup.launches = chain_stats.launches = 0
    sizing_kernel.launches = 0
    got = chain_setup.chain_setup(cand, 512)
    want = chain_setup.chain_setup_plain(cand, 512)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    sized = qm.size_batch(cand, *targets, k_cols=512)
    plain = qm.size_batch(cand, *targets, k_cols=512, impl="plain")
    assert sized.keys() == plain.keys() == set(chain_stats.TAIL_KEYS)
    for key in sized:
        assert torch.equal(sized[key], plain[key]), key
    rates = np.full(7, 3.0, np.float32)
    a = qm.analyze_batch(rates, cand, k_cols=512)
    b = qm.analyze_batch(rates, cand, k_cols=512, impl="plain")
    assert list(a) == ["valid", *chain_stats.ANALYZE_KEYS]
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert chain_setup.launches == chain_stats.launches == 0
    assert sizing_kernel.launches == 0


@pytest.mark.parametrize("devices", [("meta",), ("meta", "cpu")])
def test_tensors_off_the_cpu_go_to_the_kernels_or_raise(devices):
    """A batch on no CPU goes to the kernels' launches, which take only
    CUDA tensors on one card: they raise, and count no launch."""
    fields, targets = population(7, 6, 256)
    cand = candidate_batch_from_numpy(fields, device=CPU)
    cand = qm.CandidateBatch(*(f.to(devices[0]) for f in cand))
    rate = torch.ones(7, device=devices[-1])
    chain_setup.launches = chain_stats.launches = 0
    with pytest.raises(ValueError):
        chain_setup.chain_setup(cand, 256)
    with pytest.raises(ValueError):
        chain_stats.analyze(rate, cand, 256)
    with pytest.raises(ValueError):
        chain_stats.size_tail(cand, torch.ones(2, 7, device="meta"),
                              torch.ones(3, 7, device="meta"),
                              torch.ones(7, device="meta"), 256)
    assert chain_setup.launches == chain_stats.launches == 0


def test_the_bounds_are_counted_from_the_work():
    fields, _ = population(64, 9, 512)
    cand = candidate_batch_from_numpy(fields, device=CPU)
    setup = chain_setup.work(cand, 512, operations=0)
    assert setup.bytes == 4 * 64 * (7 + 4 + 512 + 1)
    assert setup.chain_ops == chain_setup.chain_ops(512) == 17 + 9
    terms = {"bytes": 1e3 * setup.bytes / 3.35e12,
             "chain": 1e3 * setup.chain_ops * 4 / 1.98e9, "operations": 0.0}
    assert setup.bound_terms_ms() == pytest.approx(terms)
    assert setup.bound() == (max(terms.values()), "chain")
    tail = chain_stats.work(cand, "tail", operations=0)
    assert tail.bytes == 4 * 64 * (7 + 2 + 3 + 1 + 9)
    ms, term = tail.bound()
    assert term == "chain" and ms == pytest.approx(
        chain_stats.CHAIN_OPS * 4 / 1.98e9 * 1e3)
    big = chain_stats.work(cand, "analyze", operations=10 ** 9)
    assert big.bound()[1] == "operations"
