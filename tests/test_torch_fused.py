"""The port's fused decision program.

- Against the JAX package's ``fused.run`` on the inputs of
  ``tests/test_fused_plane.py:263`` (13 seeded candidates, 5 seeded series,
  trust indices -1, 0, 2, 3, 1): sized rates and ``presized`` throughput at
  rtol 2e-3, the fits at rtol 2e-3 with an absolute floor of 1e-4 x (1 +
  the row's largest forecast), and the same forecaster chosen per model.
- Inside the port, bitwise: the fused program equals the staged calls
  (``size_candidates`` and ``fit_batch``); a tick whose every solve key hits
  the memo equals the solve tick; the forecast-less form equals the staged
  sizing.
- One ``dispatch.note()`` per ``run``, memo hit or not; ``program_cache_size``
  grows once per (candidate bucket, k_cols, model bucket) triple.
"""

import random

import pytest

import wva_tpu.analyzers.queueing as j_q
import wva_tpu.analyzers.queueing.analyzer as j_analyzer
import wva_tpu.forecast.forecasters as j_fc
import wva_tpu.fused as j_fused
import wva_tpu_torch.analyzers.queueing as t_q
import wva_tpu_torch.analyzers.queueing.analyzer as t_analyzer
import wva_tpu_torch.forecast.forecasters as t_fc
import wva_tpu_torch.fused as t_fused
import wva_tpu_torch.fused.program as t_program
from wva_tpu_torch.utils import dispatch

RTOL = 2e-3
TRUST_IDX = [-1, 0, 2, 3, 1]


def random_candidates(q, analyzer, rng, n, k_fixed=None):
    """``tests/test_fused_plane.py``'s ``_random_candidates`` in either
    package; ``k_fixed`` pins every occupancy bound (batch 64 + queue 100)."""
    out = []
    for i in range(n):
        prof = q.PerfProfile(
            model_id=f"m{i}", accelerator="v5e-8",
            service_parms=q.ServiceParms(
                alpha=rng.uniform(5, 50), beta=rng.uniform(0.001, 0.05),
                gamma=rng.uniform(0.0001, 0.01)),
            max_batch_size=rng.randrange(8, 96),
            max_queue_size=rng.randrange(16, 200))
        if k_fixed:
            prof.max_batch_size, prof.max_queue_size = 64, 100
        out.append(analyzer._Candidate(
            variant_name=f"v{i}", accelerator="v5e-8",
            cost=rng.uniform(1, 20), ready=rng.randrange(0, 4),
            pending=0, profile=prof,
            targets=q.TargetPerf(target_ttft_ms=rng.uniform(300, 2000),
                                 target_itl_ms=rng.uniform(0, 80),
                                 target_tps=0.0),
            request_size=q.RequestSize(
                avg_input_tokens=rng.uniform(64, 1024),
                avg_output_tokens=rng.uniform(16, 256))))
    return out


def random_series(fc, rng, m):
    """``tests/test_fused_plane.py``'s ``_random_series``."""
    return [fc.SeriesGrids(
        fine=[rng.uniform(0, 10) for _ in range(fc.N_GRID)],
        fine_valid=rng.randrange(0, fc.N_GRID),
        long=[rng.uniform(0, 10) for _ in range(fc.N_GRID)],
        long_valid=rng.randrange(0, fc.N_GRID),
        h_fine_steps=rng.uniform(0, 20),
        h_long_steps=rng.uniform(0, 5),
        season_steps=fc.SEASON_STEPS) for _ in range(m)]


def inputs(q, analyzer, fc, seed=11, n_cands=13, n_models=5, k_fixed=None):
    rng = random.Random(seed)
    return (random_candidates(q, analyzer, rng, n_cands, k_fixed),
            random_series(fc, rng, n_models))


def build(fused, cands, series, trust_idx=None, **grid_kw):
    grids = fused.FleetGrids(**grid_kw)
    plans = {"m|ns": type("Plan", (), {"candidates": cands})()}
    fused.build_candidate_axis(grids, plans, ["m|ns"])
    if series:
        n = len(series)
        fused.build_model_axis(
            grids, series, [f"k{i}" for i in range(n)],
            trust_idx or [-1] * n, [i % 2 == 1 for i in range(n)],
            [False] * n, [False] * n, [False] * n)
    return grids


@pytest.fixture(autouse=True)
def _fresh_memos():
    j_fused.clear_solve_memo()
    t_fused.clear_solve_memo()
    yield
    j_fused.clear_solve_memo()
    t_fused.clear_solve_memo()


def test_fused_run_matches_reference():
    want = j_fused.run(build(j_fused, *inputs(j_q, j_analyzer, j_fc),
                             TRUST_IDX))
    got = t_fused.run(build(t_fused, *inputs(t_q, t_analyzer, t_fc),
                            TRUST_IDX, device="cpu"))
    assert got.per_replica["m|ns"] == pytest.approx(
        want.per_replica["m|ns"], rel=RTOL)
    assert sorted(got.presized) == sorted(want.presized)
    for key, rate in want.presized.items():
        assert got.presized[key] == pytest.approx(rate, rel=RTOL)
    assert len(got.fits) == len(want.fits) == 5
    for g, w, idx, chosen in zip(got.fits, want.fits, TRUST_IDX, got.chosen):
        scale = 1.0 + max(w.values())
        for name in t_fc.FORECASTERS:
            assert g[name] == pytest.approx(w[name], rel=RTOL,
                                            abs=1e-4 * scale)
        assert chosen == g[t_fc.FORECASTERS[idx] if idx >= 0 else "linear"]
    assert got.chosen == pytest.approx(want.chosen, rel=RTOL, abs=1e-3)


def test_fused_equals_staged_bitwise():
    cands, series = inputs(t_q, t_analyzer, t_fc)
    result = t_fused.run(build(t_fused, cands, series, TRUST_IDX,
                               device="cpu"))
    staged_rates = t_analyzer.QueueingModelAnalyzer(
        device="cpu").size_candidates(cands)
    staged_fits = t_fc.fit_batch(series, "cpu")
    assert result.per_replica["m|ns"] == staged_rates
    assert result.fits == staged_fits
    for i, fit in enumerate(staged_fits):
        name = t_fc.FORECASTERS[TRUST_IDX[i]] if TRUST_IDX[i] >= 0 \
            else "linear"
        assert result.chosen[i] == fit[name]


def test_forecast_less_form_equals_staged_sizing():
    cands, _ = inputs(t_q, t_analyzer, t_fc)
    before = dispatch.count()
    result = t_fused.run(build(t_fused, cands, [], device="cpu"))
    assert dispatch.count() == before + 1
    assert result.fits == [] and result.chosen == []
    assert result.per_replica["m|ns"] == t_analyzer.QueueingModelAnalyzer(
        device="cpu").size_candidates(cands)


def test_memo_hit_tick_equals_solve_tick():
    cands, series = inputs(t_q, t_analyzer, t_fc)
    solve = t_fused.run(build(t_fused, cands, series, TRUST_IDX,
                              device="cpu"))
    assert t_fused.solve_memo_counters() == {"hit_ticks": 0,
                                             "solve_ticks": 1}
    assert t_fused.solve_memo_size() == len({
        t_fused.grids.solve_key(c) for c in cands})
    hit = t_fused.run(build(t_fused, cands, series, TRUST_IDX, device="cpu"))
    assert t_fused.solve_memo_counters() == {"hit_ticks": 1,
                                             "solve_ticks": 1}
    assert hit == solve
    off = t_fused.run(build(t_fused, cands, series, TRUST_IDX, device="cpu"),
                      memo=False)
    assert off == solve
    assert t_fused.solve_memo_counters()["solve_ticks"] == 2


def test_one_dispatch_per_run():
    cands, series = inputs(t_q, t_analyzer, t_fc)
    for expected_hits in (0, 1, 2):
        before = dispatch.count()
        t_fused.run(build(t_fused, cands, series, device="cpu"))
        assert dispatch.count() == before + 1
        assert t_fused.solve_memo_counters()["hit_ticks"] == expected_hits


def test_program_cache_grows_once_per_bucket_triple():
    """Fleet sizes inside one candidate bucket and one model bucket run one
    shape; each new (C bucket, k_cols, M bucket) triple adds one."""
    seen = set()
    for n, seed in ((4, 1), (5, 2), (8, 3), (9, 4), (16, 5), (30, 6),
                    (33, 7), (7, 8)):
        cands, series = inputs(t_q, t_analyzer, t_fc, seed=seed, n_cands=n,
                               n_models=n, k_fixed=True)
        grids = build(t_fused, cands, series, device="cpu")
        triple = (t_fused.candidate_bucket(n), grids.k_cols, grids.m_bucket)
        # Another test in this process may have run the triple already.
        new = triple not in t_program._SHAPES
        before = t_fused.program_cache_size()
        t_fused.run(grids, memo=False)
        assert t_fused.program_cache_size() - before == int(new), (n, triple)
        if triple in seen:
            assert not new
        seen.add(triple)
    assert len(seen) == 5  # C buckets 8, 16, 32, 64 over M buckets 4-64
