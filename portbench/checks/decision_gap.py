"""The decisions: on each kept tick, every decision the engine's decision
stage returned (target replicas, action, accelerator, and the stage that
set the target) and the fleet solve's allocation of every server (its
accelerator and replicas), against the reference's decision stage from
what the stage started from (``portbench/reference/decide.py``). The
number is how many differ over the kept ticks, with every decision the
reference cannot judge or finds missing counted as one that differs.
Each candidate row the tick sized from (profile, request size, batch and
queue bounds, targets) is held to the row the configuration and the
collected telemetry give; one that differs counts too. An exact
comparison: its limit is 0.

Each tick's inputs are the program's state at the tick (telemetry,
variant states, sized rates, the trend's slope, the forecast floors, the
limiter's pools, the migration holds): the reference takes them as they
were and works out the decisions again. The configuration states the
levers the reference applies (the limiter, scale-to-zero off).
"""

from __future__ import annotations

from portbench.reference import decide

LIMIT = 0


def gaps(record: dict, config: dict, profiles: dict) -> int:
    ref, allocs, wrong = decide.tick(record, config, profiles)
    want = {(d.namespace, d.variant): d for d in ref}
    fresh = {(p["namespace"], p["model_id"]) for p in record["plans"]}
    got = {(d["namespace"], d["variant"]): d for d in record["decisions"]}
    wrong += len(want.keys() ^ got.keys())
    for key in want.keys() & got.keys():
        r, g = want[key], got[key]
        same = (r.target == g["target"] and r.action == g["action"]
                and r.accelerator == g["accelerator"])
        if (r.namespace, r.model_id) in fresh:
            same = same and r.set_by() == g["set_by"]
        wrong += not same
    solved = {}
    for solve in record["solves"]:
        solved.update(solve["allocations"])
    wrong += len(allocs.keys() ^ solved.keys())
    wrong += sum(allocs[k] != solved[k] for k in allocs.keys()
                 & solved.keys())
    return wrong


def reading(rec, rng, device, control=False, cell=None):
    ticks = rec.calls["decisions"]
    if not ticks:
        return None
    if control:
        # Not a float computation: the reference has no lower precision.
        return None
    config = cell["config"]
    profiles = fixed_profiles(config, cell["traffic"], cell["seed"])
    return float(sum(gaps(t, config, profiles) for t in ticks))


def fixed_profiles(config, traffic, seed) -> dict:
    """(model, accelerator) -> (alpha, beta, gamma) where the
    configuration draws the profiles from the seed (a fleet); none where
    the program's tuner moves them."""
    if "profile_ranges" not in config:
        return {}
    from portbench.drivers.fleet_feed import fleet

    records, _ = fleet(config, traffic, seed)
    return {(r["model_id"], r["accelerator"]): (r["alpha"], r["beta"],
                                                r["gamma"])
            for r in records}
