"""The port's policy sweep (``wva_tpu_torch/sweep``) against the JAX
package's, on the CPU.

The scenario is the reference's smoke scenario
(``tests/test_sweep_world.py``): a 1200 s horizon, the bench trapezoid
4 -> 40 req/s, the smoke knob grid, seeds from 100.

- The host tables (rates, seeded arrivals, fault windows) equal the
  reference's bit for bit.
- The port's ``run_worlds`` agrees with the reference's ``run_worlds`` and
  with its own scalar oracle ``run_world_python`` at rel 5e-3, abs 1e-3
  (the reference's jit-vs-Python tolerance).
- Chunks of 1, 3 and 256 give bitwise-equal worlds; a NaN knob scores
  ``LOSS_SCORE`` without a crash; the dispatch counter notes one program a
  chunk.
- ``run_sweep`` on the smoke grid recommends the reference's knobs with
  the reference's trust verdict, and its JSON is byte-identical between
  chunks 1 and 256 and between reruns; ``sweep_cli`` writes the artifact
  ``tests/test_sweep_cli.py`` checks, with the reference CLI's
  recommendations.
- Without a card, ``device=None`` raises.
- ``chip_smoke.py`` phase 7 runs the sweep at ``make bench-sweep``'s full
  shape (bench.py's ``sweep_plane_bench``).
- ``run_worlds`` builds each distinct seed's tables and each distinct knob
  object's row once and gathers them: every output bitwise equal to
  per-world tables and rows, with repeated, NaN and ``-0.0`` points and
  repeated seeds; one build a table and at most two ``to_vector`` calls a
  point per call; the smoke search's JSON byte-identical to a golden taken
  before the reuse (``tests/goldens/sweep_smoke_recommendations_v1.json``).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from wva_tpu.emulator import loadgen as ref_loadgen
from wva_tpu.sweep import knobs as ref_kb
from wva_tpu.sweep import search as ref_search
from wva_tpu.sweep import world as ref_world
from wva_tpu_torch.emulator import loadgen
from wva_tpu_torch.sweep import knobs as kb
from wva_tpu_torch.sweep import search
from wva_tpu_torch.sweep import world
from wva_tpu_torch.sweep.cli import sweep_cli
from wva_tpu_torch.utils import dispatch

ROOT = Path(__file__).resolve().parents[1]
PARAMS = world.WorldParams(horizon_s=1200.0)
REF_PARAMS = ref_world.WorldParams(horizon_s=1200.0)
MODEL = "meta-llama/Llama-3.1-8B"
CPU = "cpu"
KEYS = ("attainment", "chip_seconds", "wrong_direction")
OUT_KEYS = KEYS + ("objective", "score")


def _profile(lg):
    return lg.trapezoid(4.0, 40.0, 300.0, 420.0, 180.0, tail=120.0,
                        delay=180.0)


@pytest.fixture(scope="module")
def scenario():
    lam = world.rate_table([_profile(loadgen)], PARAMS)
    points = kb.grid_points("smoke")
    seeds = list(range(100, 100 + len(points)))
    arr = world.arrivals_table(seeds, lam, PARAMS)
    flt = world.fault_table(seeds, lam.shape[0], PARAMS)
    return lam, points, seeds, arr, flt


@pytest.fixture(scope="module")
def wide(scenario):
    lam, points, seeds, arr, flt = scenario
    return world.run_worlds(PARAMS, points, seeds, lam, chunk=256,
                            arrivals=arr, faults=flt, device=CPU)


def test_params_and_grids_equal_the_reference():
    assert PARAMS.__dict__ == REF_PARAMS.__dict__
    assert (PARAMS.steps, PARAMS.lead_steps) == (240, 24)
    for grid in ("smoke", "default"):
        assert ([kb.to_vector(k) for k in kb.grid_points(grid)]
                == [ref_kb.to_vector(k) for k in ref_kb.grid_points(grid)])


def test_host_tables_equal_the_reference_bitwise(scenario):
    lam, _, seeds, arr, flt = scenario
    ref_lam = ref_world.rate_table([_profile(ref_loadgen)], REF_PARAMS)
    assert lam.dtype == ref_lam.dtype == np.float32
    np.testing.assert_array_equal(lam, ref_lam)
    np.testing.assert_array_equal(
        arr, ref_world.arrivals_table(seeds, ref_lam, REF_PARAMS))
    np.testing.assert_array_equal(
        flt, ref_world.fault_table(seeds, 1, REF_PARAMS))
    assert flt.any(), "the scenario has no fault window"


def test_worlds_match_the_reference(scenario, wide):
    lam, _, seeds, arr, flt = scenario
    ref = ref_world.run_worlds(REF_PARAMS, ref_kb.grid_points("smoke"),
                               seeds, lam, chunk=256, arrivals=arr,
                               faults=flt)
    for key in KEYS:
        np.testing.assert_allclose(wide[key], ref[key], rtol=5e-3,
                                   atol=1e-3, err_msg=key)
    assert wide["attainment"].dtype == np.float32
    assert np.array_equal(wide["degenerate"], ref["degenerate"])


def test_worlds_match_the_scalar_oracle(scenario, wide):
    lam, points, _, arr, flt = scenario
    for i, k in enumerate(points):
        want = world.run_world_python(PARAMS, k, lam, arr[i], flt[i])
        for key in KEYS:
            assert wide[key][i, 0] == pytest.approx(
                want[key][0], rel=5e-3, abs=1e-3), (key, i)


@pytest.mark.parametrize("chunk", [1, 3])
def test_chunk_width_is_bitwise_invisible(scenario, wide, chunk):
    lam, points, seeds, arr, flt = scenario
    narrow = world.run_worlds(PARAMS, points, seeds, lam, chunk=chunk,
                              arrivals=arr, faults=flt, device=CPU)
    for key in OUT_KEYS:
        assert np.array_equal(wide[key], narrow[key]), key


def test_nan_knob_scores_loss_without_crash(scenario):
    lam, points, seeds, *_ = scenario
    poisoned = points + [
        kb.PolicyKnobs(target_utilization=float("nan")),
        kb.PolicyKnobs(engine_interval_s=float("inf")),
        kb.PolicyKnobs(level_gain=float("nan"), grid_step_s=float("nan"))]
    res = world.run_worlds(PARAMS, poisoned, seeds + [991, 992, 993], lam,
                           device=CPU)
    assert (res["objective"][len(points):] == world.LOSS_SCORE).all()
    assert np.isfinite(res["objective"][:len(points)]).all()
    assert (res["objective"][:len(points)] > world.LOSS_SCORE).all()


def test_dispatch_noted_once_per_chunk(scenario):
    lam, points, seeds, arr, flt = scenario
    before = dispatch.count()
    world.run_worlds(PARAMS, points, seeds, lam, chunk=256, arrivals=arr,
                     faults=flt, device=CPU)
    assert dispatch.count() - before == 1
    before = dispatch.count()
    world.run_worlds(PARAMS, points, seeds, lam, chunk=3, arrivals=arr,
                     faults=flt, device=CPU)
    assert dispatch.count() - before == 3


def test_run_worlds_needs_a_card_without_device(scenario):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lam, points, seeds, arr, flt = scenario
    with pytest.raises(RuntimeError, match="CUDA device required"):
        world.run_worlds(PARAMS, points, seeds, lam, arrivals=arr,
                         faults=flt)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        search.run_sweep(PARAMS, lam, [MODEL], grid="smoke", n_train=1,
                         n_holdout=1)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        sweep_cli(["--smoke"])


SMOKE_SWEEP = dict(algo="grid", grid="smoke", n_train=2, n_holdout=3,
                   sweep_seed=7)


@pytest.fixture(scope="module")
def smoke_sweep(scenario):
    lam = scenario[0]
    return search.run_sweep(PARAMS, lam, [MODEL], chunk=256, device=CPU,
                            **SMOKE_SWEEP)


def test_sweep_recommends_as_the_reference(scenario, smoke_sweep):
    lam = scenario[0]
    ref = ref_search.run_sweep(REF_PARAMS, lam, [MODEL], chunk=256,
                               **SMOKE_SWEEP)
    got, want = (r["recommendations"][MODEL] for r in (smoke_sweep, ref))
    assert got["knobs"] == want["knobs"]
    assert got["applied_knobs"] == want["applied_knobs"]
    assert got["trust"]["trusted"] == want["trust"]["trusted"]
    assert got["trust"]["evals"] == want["trust"]["evals"]
    assert got["trust"]["ewma_regret"] == pytest.approx(
        want["trust"]["ewma_regret"], rel=5e-3, abs=1e-3)
    assert smoke_sweep["seeds"] == ref["seeds"]
    assert smoke_sweep["worlds_evaluated"] == ref["worlds_evaluated"]


def test_sweep_json_is_byte_identical_across_chunks(scenario, smoke_sweep):
    narrow = search.run_sweep(PARAMS, scenario[0], [MODEL], chunk=1,
                              device=CPU, **SMOKE_SWEEP)
    assert (search.dump_recommendations(smoke_sweep)
            == search.dump_recommendations(narrow))


def test_sweep_rerun_is_byte_identical(scenario):
    kwargs = dict(algo="cem", n_train=2, n_holdout=3, sweep_seed=3,
                  generations=2, population=6, device=CPU)
    a = search.run_sweep(PARAMS, scenario[0], [MODEL], **kwargs)
    b = search.run_sweep(PARAMS, scenario[0], [MODEL], **kwargs)
    assert search.dump_recommendations(a) == search.dump_recommendations(b)


def test_losing_candidate_not_trusted(scenario):
    bad = kb.PolicyKnobs(engine_interval_s=30.0, headroom_replicas=0.0,
                         target_utilization=0.95, burst_slope_rps=0.0)
    _, holdout = search.split_seeds(0, 4)
    gate = search.walk_forward(PARAMS, bad, kb.DEFAULT_KNOBS, holdout,
                               scenario[0], 0, device=CPU)
    assert gate["evals"] == 4
    assert not gate["trusted"]
    assert gate["ewma_regret"] > search.TRUST_MAX_REGRET


@pytest.fixture(scope="module")
def recs_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sweep") / "recs.json")
    assert sweep_cli(["--smoke", "--sweep-seed", "7", "--out", path],
                     device=CPU) == 0
    return path


def test_cli_writes_wellformed_artifact(recs_path):
    with open(recs_path, encoding="utf-8") as f:
        data = json.load(f)
    assert data["recommendations"], "empty recommendations"
    rec = next(iter(data["recommendations"].values()))
    assert rec["applied_knobs"]
    assert "trusted" in rec["trust"]
    assert data["seeds"]["train"] and data["seeds"]["holdout"]


def test_cli_artifact_byte_identical_at_batch_1(recs_path, tmp_path):
    narrow = str(tmp_path / "recs_narrow.json")
    assert sweep_cli(["--smoke", "--sweep-seed", "7", "--batch", "1",
                      "--out", narrow], device=CPU) == 0
    with open(recs_path, "rb") as a, open(narrow, "rb") as b:
        assert a.read() == b.read()


def test_cli_artifact_recommends_as_the_reference(recs_path, tmp_path):
    from wva_tpu.sweep.cli import sweep_cli as ref_sweep_cli

    path = str(tmp_path / "ref_recs.json")
    assert ref_sweep_cli(["--smoke", "--sweep-seed", "7", "--out",
                          path]) == 0
    with open(recs_path, encoding="utf-8") as f:
        got = json.load(f)
    with open(path, encoding="utf-8") as f:
        want = json.load(f)
    for key in ("algo", "dt_s", "grid", "horizon_s", "seeds", "trust_policy",
                "worlds_evaluated"):
        assert got[key] == want[key], key
    assert got["recommendations"].keys() == want["recommendations"].keys()
    for model, rec in want["recommendations"].items():
        mine = got["recommendations"][model]
        for key in ("knobs", "applied_knobs", "incumbent_knobs"):
            assert mine[key] == rec[key], (model, key)
        assert mine["trust"]["trusted"] == rec["trust"]["trusted"]
        assert mine["trust"]["evals"] == rec["trust"]["evals"]
        assert mine["trust"]["ewma_regret"] == pytest.approx(
            rec["trust"]["ewma_regret"], rel=5e-3, abs=1e-3)


def test_cli_rejects_unknown_algo():
    with pytest.raises(SystemExit):
        sweep_cli(["--algo", "annealing"], device=CPU)


class _Captured(Exception):
    pass


def test_chip_smoke_restates_the_bench_sweep_shape(monkeypatch):
    """chip_smoke.py cannot import bench.py (it imports the JAX package),
    so phase 7 restates ``sweep_plane_bench(smoke=False)``'s search: the
    world's parameters, its rates, the model, the grid, the seeds and the
    chunk must equal bench.py's."""
    sys.path.insert(0, str(ROOT))
    import bench
    import chip_smoke

    seen = {}

    def capture(params, lam, models, **kwargs):
        seen.update(params=params, lam=lam, models=models, kwargs=kwargs)
        raise _Captured

    monkeypatch.setattr(ref_search, "run_sweep", capture)
    with pytest.raises(_Captured):
        bench.sweep_plane_bench(smoke=False)
    assert seen["params"].__dict__ == chip_smoke.SWEEP_PARAMS.__dict__
    np.testing.assert_array_equal(seen["lam"], chip_smoke.sweep_rates())
    assert seen["models"] == [chip_smoke.MODEL]
    assert seen["kwargs"] == dict(
        algo="grid", grid=chip_smoke.SWEEP_GRID,
        n_train=chip_smoke.SWEEP_TRAIN, n_holdout=chip_smoke.SWEEP_HOLDOUT,
        chunk=chip_smoke.SWEEP_CHUNK)
    assert chip_smoke.SWEEP_TRAIN * len(kb.grid_points(
        chip_smoke.SWEEP_GRID)) >= chip_smoke.SWEEP_MIN_WORLDS


# -- each seed's tables and each point's row built once a call ------------

SHORT = world.WorldParams(horizon_s=600.0)


def _bits(a) -> tuple:
    a = np.asarray(a)
    return a.dtype.str, a.shape, a.tobytes()


def test_reused_tables_and_rows_are_bitwise_per_world_builds(monkeypatch):
    lam = world.rate_table([_profile(loadgen), loadgen.trapezoid(
        10.0, 60.0, 120.0, 180.0, 120.0, tail=60.0, delay=60.0)], SHORT)
    shared = kb.grid_points("smoke")[5]
    zero = kb.PolicyKnobs(trend_gain=0.0)
    negative_zero = kb.PolicyKnobs(trend_gain=-0.0)
    nan = kb.PolicyKnobs(level_gain=float("nan"))
    assert zero == negative_zero and zero is not negative_zero
    knobs = [shared, zero, nan, shared, negative_zero, kb.DEFAULT_KNOBS,
             shared, nan, zero]
    seeds = [907, 113, 907, 2**40 + 3, 113, 455, np.int64(455), 907, 113]
    staged = []
    inner = world.chunk_tensors

    def chunk_tensors(rows, *args, **kwargs):
        staged.append(np.array(rows))
        return inner(rows, *args, **kwargs)

    monkeypatch.setattr(world, "chunk_tensors", chunk_tensors)
    built = world.run_worlds(SHORT, knobs, seeds, lam, chunk=4, device=CPU)
    reused_rows = np.concatenate(staged)
    staged.clear()
    per_world = world.run_worlds(
        SHORT, knobs, seeds, lam, chunk=4, device=CPU,
        arrivals=world.arrivals_table(seeds, lam, SHORT),
        faults=world.fault_table(seeds, lam.shape[0], SHORT))
    assert world.fault_table(seeds, 2, SHORT).any()
    for key in ("attainment", "chip_seconds", "wrong_direction",
                "arrivals_total", "objective", "score", "degenerate"):
        assert _bits(built[key]) == _bits(per_world[key]), key
    want_rows = np.asarray([kb.to_vector(k) for k in knobs],
                           dtype=np.float32)
    assert _bits(reused_rows) == _bits(want_rows)
    assert np.signbit(reused_rows[4, kb.KNOB_FIELDS.index("trend_gain")])
    assert built["degenerate"].tolist() == [kb.is_degenerate(k)
                                            for k in knobs]
    assert built["degenerate"][[2, 7]].all()


def test_one_build_a_table_and_a_row_a_point_per_call(monkeypatch):
    params = world.WorldParams(horizon_s=300.0)
    lam = world.rate_table([_profile(loadgen)], params)
    table_seeds = {"arrivals": [], "faults": []}
    to_vector_calls = []
    calls = []
    inner = {"arrivals": world.arrivals_table, "faults": world.fault_table,
             "to_vector": kb.to_vector, "run_worlds": search.run_worlds}

    def arrivals_table(world_seeds, *args):
        table_seeds["arrivals"].append(list(world_seeds))
        return inner["arrivals"](world_seeds, *args)

    def fault_table(world_seeds, *args):
        table_seeds["faults"].append(list(world_seeds))
        return inner["faults"](world_seeds, *args)

    def to_vector(k):
        to_vector_calls.append(id(k))
        return inner["to_vector"](k)

    def run_worlds(params, knob_list, world_seeds, *args, **kwargs):
        to_vector_calls.clear()
        out = inner["run_worlds"](params, knob_list, world_seeds, *args,
                                  **kwargs)
        calls.append((list(knob_list), list(world_seeds),
                      list(to_vector_calls)))
        return out

    monkeypatch.setattr(world, "arrivals_table", arrivals_table)
    monkeypatch.setattr(world, "fault_table", fault_table)
    monkeypatch.setattr(kb, "to_vector", to_vector)
    monkeypatch.setattr(search, "run_worlds", run_worlds)
    search.run_sweep(params, lam, [MODEL], algo="grid", grid="smoke",
                     n_train=3, n_holdout=2, sweep_seed=7, chunk=4,
                     device=CPU)
    train, holdout = search.split_seeds(3, 2, 7)
    assert table_seeds["arrivals"] == table_seeds["faults"] == [train,
                                                                holdout]
    assert len(calls) == 2
    n_points = len(kb.grid_points("smoke"))
    for (knob_list, world_seeds, converted), points in zip(
            calls, (n_points, 2)):
        distinct = {id(k) for k in knob_list}
        assert len(distinct) == points
        assert set(converted) == distinct
        assert max(converted.count(i) for i in distinct) <= 2
    assert calls[0][1] == [s for _ in range(n_points) for s in train]


@pytest.mark.parametrize("chunk", [1, 4])
def test_smoke_sweep_json_equals_the_golden(scenario, chunk):
    report = search.run_sweep(PARAMS, scenario[0], [MODEL], chunk=chunk,
                              device=CPU, **SMOKE_SWEEP)
    golden = ROOT / "tests" / "goldens" / "sweep_smoke_recommendations_v1.json"
    assert search.dump_recommendations(report) == golden.read_text(
        encoding="utf-8")
