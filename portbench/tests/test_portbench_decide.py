"""The reference's decision stage against small cases worked by hand, and
the record's reservoir of kept calls."""

from __future__ import annotations

import collections

import pytest

from portbench import core
from portbench.reference import decide

KNOBS = {"scale_up_threshold": 0.5, "scale_down_boundary": 0.5,
         "anticipation_horizon_seconds": 0.0, "headroom_replicas": 0,
         "burst_slope_rps": 0.0, "optimizer_name": ""}
CONFIG = {"max_batch_size": 96, "max_queue_size": 384, "slo_ttft_ms": 1000.0,
          "slo_itl_ms": 50.0, "limiter": True}


def plan(rate_per_min, variants, caps, costs, **knobs):
    """One model: ``variants`` (name, accelerator, current, pending),
    each with a sized per-replica rate and a cost."""
    return {
        "namespace": "ns", "model_id": "m", "analyzer": "slo",
        "arrival_rate_per_min": rate_per_min,
        "replicas": [(v[0], cost, 0, 100.0, 50.0)
                     for v, cost in zip(variants, costs)],
        "scheduler_queue": None,
        "variants": [(*v, 8) for v in variants],
        "config": {**KNOBS, **knobs},
        "candidates": [v[0] for v in variants],
        "rows": [(1.0, 1.0, 1.0, 100.0, 50.0, 96, 384, 1000.0, 50.0, 0.0)
                 for _ in variants],
        "per_replica": list(caps)}


def tick(plans, floors=(), pools=None, solves=(), pre_limit=None):
    return {"now": 100.0, "holds": {}, "slopes": {}, "plans": list(plans),
            "floors": list(floors), "pools": pools, "solves": list(solves),
            "pre_limit": pre_limit, "decisions": []}


def by_variant(decisions):
    return {d.variant: d for d in decisions}


def test_demand_and_required_capacity_by_hand():
    # 600 req/min = 10 req/s; supply 2 ready x 3 = 6; at a threshold of
    # 0.5 the stage needs 10 / 0.5 = 20 of capacity: 14 more.
    p = plan(600.0, [("a", "v5e-8", 2, 0)], [3.0], [10.0])
    res = decide.analysis(p, 0.0)
    assert res["demand"] == 10.0
    assert res["required"] == pytest.approx(14.0)
    assert res["spare"] == 0.0


def test_scale_up_fills_the_cheapest_per_capacity_first():
    # b costs 30 for 8 of capacity (3.75 each), a 10 for 2 (5 each).
    # Supply 2 + 8 = 10 of the 20 needed: ceil(10 / 8) = 2 more on b.
    p = plan(600.0, [("a", "v5e-8", 1, 0), ("b", "v5p-8", 1, 0)],
             [2.0, 8.0], [10.0, 30.0])
    got = by_variant(decide.tick(tick([p], pools={"v5e-8": 64,
                                                  "v5p-8": 64}),
                                 CONFIG, {})[0])
    assert (got["a"].target, got["b"].target) == (1, 3)
    assert got["b"].action == decide.SCALE_UP
    assert got["b"].set_by() == "analyzer:slo"


def test_scale_down_keeps_the_cheapest_replica():
    # No demand: spare is the whole supply; b (dearer) goes to 0 first,
    # then a keeps one replica, the last with any.
    p = plan(0.0, [("a", "v5e-8", 2, 0), ("b", "v5p-8", 1, 0)],
             [5.0, 5.0], [10.0, 30.0])
    got = by_variant(decide.tick(tick([p], pools={}), CONFIG, {})[0])
    assert (got["a"].target, got["b"].target) == (1, 0)
    assert got["b"].action == decide.SCALE_DOWN


def test_floor_and_limiter():
    # The optimizer wants 2 (+1); a forecast floor raises it to 5; the
    # pool has 24 chips, 8 in use: two more replicas fit, not four.
    p = plan(600.0, [("a", "v5e-8", 1, 0)], [6.0], [10.0])
    got = by_variant(decide.tick(
        tick([p], floors=[("ns", "a", 5)], pools={"v5e-8": 24}),
        CONFIG, {})[0])
    assert got["a"].target == 3
    assert got["a"].action == decide.SCALE_UP
    assert got["a"].set_by() == decide.LIMITER_STEP


def test_fleet_solve_takes_the_least_value():
    # 6 req/s: v5e at 2 per replica needs 3 (cost 30), v5p at 4 needs 2
    # (cost 60). The current placement is one v5e replica (cost 10):
    # staying costs 30 - 10 = 20, moving 0.1 * 70 + 50 = 57.
    p = plan(360.0, [("a", "v5e-8", 1, 0), ("b", "v5p-8", 0, 0)],
             [2.0, 4.0], [10.0, 30.0], optimizer_name="global")
    solve = {"unlimited": True, "capacity_chips": {},
             "accelerators": {"v5e-8": ("v5e", 8, 10.0, 1.0),
                              "v5p-8": ("v5p", 8, 30.0, 1.0)},
             "servers": {"ns/m": {"priority": 1, "target_tps": 0.0,
                                  "accelerators": ["v5e-8", "v5p-8"],
                                  "rate_star": {"v5e-8": 2.0,
                                                "v5p-8": 4.0}}},
             "allocations": {}}
    decisions, allocs, wrong = decide.tick(tick([p], solves=[solve]),
                                           dict(CONFIG, limiter=False), {})
    assert wrong == 0
    assert allocs == {"ns/m": ("v5e-8", 3)}
    got = by_variant(decisions)
    assert (got["a"].target, got["b"].target) == (3, 0)


def test_rows_held_to_the_configuration():
    p = plan(600.0, [("a", "v5e-8", 1, 0)], [6.0], [10.0])
    assert decide.row_gaps(p, decide.analysis(p, 0.0), CONFIG,
                           {("m", "v5e-8"): (1.0, 1.0, 1.0)}) == 0
    assert decide.row_gaps(p, decide.analysis(p, 0.0), CONFIG,
                           {("m", "v5e-8"): (1.0, 1.0, 2.0)}) == 1
    p["rows"][0] = (1.0, 1.0, 1.0, 101.0, *p["rows"][0][4:])
    assert decide.row_gaps(p, decide.analysis(p, 0.0), CONFIG, {}) == 1


def kept(seed: int, n: int = 40) -> list:
    rec = core.Record(seed)
    for i in range(n):
        slot = rec.slot("scan")
        if slot is not None:
            rec.keep("scan", slot, i)
    return rec.calls["scan"]


def test_reservoir_keeps_a_bounded_uniform_sample():
    counts = collections.Counter()
    for seed in range(400):
        calls = kept(seed)
        assert len(calls) == core.KEEP["scan"]
        counts.update(calls)
    # Each of the 40 calls is kept with probability 4/40: 40 of 400 runs.
    assert min(counts.values()) > 15 and max(counts.values()) < 70
    assert kept(7) == kept(7)
