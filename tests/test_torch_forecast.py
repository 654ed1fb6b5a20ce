"""The port's forecaster registry and planner against the JAX package's.

- ``fit_grid_plain`` (the CPU path and the fit kernel's oracle) against the
  reference's jitted ``_fit_grid`` on seeded grids over the ranges of
  ``tests/test_fused_plane.py``'s ``_random_series``, and over every season
  length: rtol 2e-3 (the reference's own tolerance between backends) with
  an absolute floor of 1e-4 x (1 + the row's largest forecast), since the
  forecasts are clamped at 0 and the linear fit's slope is a difference of
  large sums. ``seasonal_naive`` is a pick and persistence a copy: those
  match bitwise.
- The port's ``fit_batch`` equals ``fit_serial`` bitwise at widths 2, 5, 8.
- Insufficient history falls back to persistence.
- The planner's ``prepare_tick`` then ``plan`` over a pre-filled history,
  several ticks in both packages: the same trust indices, the same floors,
  and forecasts at the tolerance above.
"""

import math
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wva_tpu.interfaces as j_if
import wva_tpu.pipeline.optimizer as j_opt
import wva_tpu_torch.interfaces as t_if
import wva_tpu_torch.pipeline.optimizer as t_opt
from wva_tpu.forecast import forecasters as jfc
from wva_tpu.forecast.planner import CapacityPlanner as JaxPlanner
from wva_tpu_torch.forecast import fit_kernel
from wva_tpu_torch.forecast import forecasters as tfc
from wva_tpu_torch.forecast.history import DemandHistoryStore
from wva_tpu_torch.forecast.planner import CapacityPlanner

RTOL = 2e-3
ATOL_SCALE = 1e-4


def random_inputs(seed, m, seasons=(tfc.SEASON_STEPS,)):
    """Seeded fit inputs as numpy arrays, in the order of ``fit_grid``."""
    rng = random.Random(seed)
    return (
        np.array([[rng.uniform(0, 10) for _ in range(tfc.N_GRID)]
                  for _ in range(m)], np.float32),
        np.array([rng.randrange(0, tfc.N_GRID) for _ in range(m)],
                 np.float32),
        np.array([[rng.uniform(0, 10) for _ in range(tfc.N_GRID)]
                  for _ in range(m)], np.float32),
        np.array([rng.randrange(0, tfc.N_GRID) for _ in range(m)],
                 np.float32),
        np.array([rng.uniform(0, 20) for _ in range(m)], np.float32),
        np.array([rng.uniform(0, 5) for _ in range(m)], np.float32),
        np.array([rng.choice(seasons) for _ in range(m)], np.int32))


def assert_fits_close(got, want, fine_valid, long_valid):
    """``got`` and ``want`` ``[4, m]``: the tolerance above, and bitwise
    where the reference picks or copies a value."""
    scale = 1.0 + np.abs(want).max(axis=0)  # per row
    diff = np.abs(got - want)
    assert (diff <= RTOL * np.abs(want) + ATOL_SCALE * scale).all(), \
        diff.max()
    sn = tfc.FORECASTERS.index("seasonal_naive")
    assert np.array_equal(got[sn], want[sn])
    short_fine = fine_valid < tfc.MIN_VALID
    short_long = long_valid < tfc.MIN_VALID
    assert np.array_equal(got[:2, short_fine], want[:2, short_fine])
    assert np.array_equal(got[2:, short_long], want[2:, short_long])


def reference_fits(inputs, m):
    out = jfc._fit_grid(*(jnp.asarray(a) for a in inputs), m=m)
    return np.stack([np.asarray(out[name]) for name in jfc.FORECASTERS])


@pytest.mark.parametrize("seed,m", [(0, 1), (1, 7), (2, 32), (3, 64)])
def test_fit_grid_plain_matches_reference(seed, m):
    inputs = random_inputs(seed, m)
    want = reference_fits(inputs, m)
    got = tfc.fit_grid_plain(*(torch.from_numpy(a) for a in inputs), m=m)
    assert got.dtype == torch.float32 and got.shape == (4, m)
    assert_fits_close(got.numpy(), want, inputs[1], inputs[3])


@pytest.mark.parametrize("seed", [10, 11])
def test_fit_grid_plain_matches_reference_at_every_season(seed):
    inputs = random_inputs(seed, 48, seasons=(1, 2, 7, 63, 64, 65, 159, 160))
    got = tfc.fit_grid(*(torch.from_numpy(a) for a in inputs), m=48)
    assert_fits_close(got.numpy(), reference_fits(inputs, 48), inputs[1],
                      inputs[3])


def test_fit_grid_on_cpu_runs_the_plain_version():
    inputs = [torch.from_numpy(a) for a in random_inputs(20, 8)]
    before = fit_kernel.launches
    assert torch.equal(tfc.fit_grid(*inputs, m=8),
                       tfc.fit_grid_plain(*inputs, m=8))
    assert torch.equal(tfc.fit_grid(*inputs, m=8, impl="plain"),
                       tfc.fit_grid_plain(*inputs, m=8))
    assert fit_kernel.launches == before
    with pytest.raises(ValueError):
        tfc.fit_grid(*inputs, m=8, impl="pallas")
    with pytest.raises(ValueError):
        fit_kernel.launch(*inputs, torch.empty(4, 8))


def _sinusoid_grids(n_models, period=600.0, lead=120.0):
    """``tests/test_forecast.py``'s sinusoids, through the port's history
    store and resampler."""
    grids = []
    long_step = period / tfc.SEASON_STEPS
    for m in range(n_models):
        store = DemandHistoryStore(window_seconds=long_step * tfc.N_GRID,
                                   fine_window_seconds=15.0 * tfc.N_GRID,
                                   long_gap_seconds=long_step / 2.0)
        phase = m * 37.0
        for i in range(161):
            t = 1000.0 + i * 15.0
            d = 10.0 + (4.0 + m) * 0.5 * (
                1 - math.cos(2 * math.pi * ((t - phase) % period) / period))
            store.observe("k", t, d)
        now = 1000.0 + 160 * 15.0
        w = store.windows("k")
        fine, nf = tfc.resample(w[0], now, 15.0)
        longg, nl = tfc.resample(w[1], now, long_step)
        grids.append(tfc.SeriesGrids(
            fine=fine, fine_valid=nf, long=longg, long_valid=nl,
            h_fine_steps=lead / 15.0, h_long_steps=lead / long_step,
            season_steps=tfc.SEASON_STEPS))
    return grids


@pytest.mark.parametrize("n_models", [2, 5, 8])
def test_batched_fits_byte_identical_to_serial(n_models):
    grids = _sinusoid_grids(n_models)
    assert tfc.fit_batch(grids, "cpu") == tfc.fit_serial(grids, "cpu")


def test_fit_batch_matches_reference_on_sinusoids():
    grids = _sinusoid_grids(6)
    got = tfc.fit_batch(grids, "cpu")
    want = jfc.fit_batch([jfc.SeriesGrids(**g.__dict__) for g in grids])
    for g, w in zip(got, want):
        for name in tfc.FORECASTERS:
            assert g[name] == pytest.approx(w[name], rel=RTOL,
                                            abs=ATOL_SCALE * 20)
        assert g["seasonal_naive"] == w["seasonal_naive"]


def test_insufficient_history_degrades_to_persistence():
    g = tfc.SeriesGrids(fine=[0.0] * (tfc.N_GRID - 1) + [7.0], fine_valid=1,
                        long=[0.0] * (tfc.N_GRID - 1) + [7.0], long_valid=1,
                        h_fine_steps=10.0, h_long_steps=2.0,
                        season_steps=tfc.SEASON_STEPS)
    out = tfc.fit_batch([g], "cpu")[0]
    for name in tfc.FORECASTERS:
        assert out[name] == 7.0


# --- the planner over a pre-filled history ---

T0 = 500_000.0
DAY = 86400.0


def _demand(m, t):
    noise = np.random.default_rng([m, int(round(t))]).uniform(0.97, 1.03)
    wave = math.sin(2 * math.pi * t / DAY + 0.7 * m)
    shape = (1.0 + 0.5 * wave, 1.0 + max(t - T0, 0.0) / 600.0,
             (1.0 + 0.5 * wave) * (1.0 + 4.0 * (t - T0 + DAY) / DAY))[m % 3]
    return (2.0 + 3.0 * m) * shape * noise


def _requests(i, opt, models, now):
    return [opt.ModelScalingRequest(
        model_id=f"m{m}", namespace="ns",
        result=i.AnalyzerResult(
            model_id=f"m{m}", namespace="ns", total_demand=_demand(m, now),
            variant_capacities=[i.VariantCapacity(
                variant_name=f"m{m}-v", accelerator_name="v5e-8", cost=1.0,
                replica_count=1, per_replica_capacity=4.0)]),
        variant_states=[i.VariantReplicaState(
            variant_name=f"m{m}-v", accelerator_name="v5e-8",
            current_replicas=1, desired_replicas=1)])
        for m in models]


def _planner_ticks(planner, i, opt, n_models, ticks):
    models = range(n_models)
    for m in models:
        if m % 6 == 5:
            continue  # no history before the first tick
        for t in np.arange(T0 - 160 * DAY / 64, T0, DAY / 128):
            planner.observe_demand("ns", f"m{m}", float(t), _demand(m, t))
        for k in range(160):
            t = T0 - (160 - k) * 15.0
            planner.observe_demand("ns", f"m{m}", t, _demand(m, t))
    out = []
    for tick in range(ticks):
        now = T0 + 15.0 * tick
        reqs = _requests(i, opt, models, now)
        prep = planner.prepare_tick(
            [(r.namespace, r.model_id, r.result.total_demand,
              r.variant_states) for r in reqs], now)
        plans, floors = planner.plan(reqs, now, prepared=prep)
        out.append((list(prep.trust_idx), plans, floors))
    return out


def test_planner_prepare_then_plan_matches_reference():
    got = _planner_ticks(CapacityPlanner(default_lead_time_seconds=45.0,
                                         device="cpu"),
                         t_if, t_opt, 12, 10)
    want = _planner_ticks(JaxPlanner(default_lead_time_seconds=45.0),
                          j_if, j_opt, 12, 10)
    for (g_idx, g_plans, g_floors), (w_idx, w_plans, w_floors) in zip(
            got, want):
        assert g_idx == w_idx
        assert g_floors == w_floors
        for p, q in zip(g_plans, w_plans):
            assert (p.model_id, p.forecaster, p.trusted, p.floor_replicas,
                    p.evals) == (q.model_id, q.forecaster, q.trusted,
                                 q.floor_replicas, q.evals)
            scale = 1.0 + max(q.forecasts.values())
            for name, v in q.forecasts.items():
                assert p.forecasts[name] == pytest.approx(
                    v, rel=RTOL, abs=ATOL_SCALE * scale)
    last = got[-1]
    assert any(i >= 0 for i in last[0]) and -1 in got[0][0]
    assert last[2], "the ramps raise forecast floors"
