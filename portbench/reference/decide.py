"""The decision stage, plainly: one engine tick's scaling decisions from
what the stage starts from.

For every model the tick analyzed afresh: the SLO analyzer's supply and
demand algebra (demand from the arrival rate and the backlog, the trend's
growth over the provisioning horizon, the deficit at landing, the
headroom), then either the cost-aware optimizer (fill the required
capacity cheapest-efficiency first, or remove whole spare replicas
most-expensive first) or, for models routed to the fleet solve, the
solve's allocation (each compatible accelerator sized to the server's
load, the least-value placement taken when the pools are unlimited) and
its migration holds; then the minimum-replica floor, the forecast floors,
and the slice limiter (scale-ups granted in order of spare capacity and
cost while the pool of their accelerator has whole replicas left).

Plain Python floats, each sum in the order the stage's definition gives
it. What the reference takes as given, from the tick: the telemetry and
variant states the models were collected with, the configuration's knobs,
each candidate's sized per-replica rate and each pair's sized throughput
(the sizing is judged by ``rate_gap``), the demand trend's slope, the
forecast planner's floors (the fits are judged by ``fit_gap``), which
accelerators have a fitted profile, the capacity tiers' cost weights, the
limiter's pool limits, the migration holds in progress at the tick's
start, and the decisions of models that the tick did not analyze afresh.
"""

from __future__ import annotations

import math

SCALE_UP, SCALE_DOWN, NO_CHANGE = "scale-up", "scale-down", "no-change"
DEFAULT_SCALE_UP_THRESHOLD = 0.85
DEFAULT_SCALE_DOWN_BOUNDARY = 0.70
DEFAULT_VARIANT_COST = 10.0
DEFAULT_AVG_INPUT_TOKENS = 512.0
DEFAULT_AVG_OUTPUT_TOKENS = 256.0
BACKLOG_DRAIN_S = 15.0
ACCEL_PENALTY_FACTOR = 0.1
MIGRATION_HOLD_TIMEOUT_S = 600.0
# The names the stages give their steps in a decision's audit trail.
OPTIMIZER_STEP = "optimizer:cost-aware"
GLOBAL_STEP = "optimizer:global"
ENFORCER_STEP = "enforcer"
FORECAST_STEP = "forecast"
LIMITER_STEP = "tpu-slice-limiter"


class Decision:
    def __init__(self, namespace, model_id, variant, accelerator, current,
                 target, chips, cost, first_step, second_step):
        self.namespace, self.model_id, self.variant = (namespace, model_id,
                                                       variant)
        self.accelerator, self.current, self.target = (accelerator, current,
                                                       target)
        self.chips, self.cost, self.spare = chips, cost, 0.0
        self.action = action_of(target, current)
        self.steps = [(first_step, target), (second_step, target)]

    def step(self, name):
        self.steps.append((name, self.target))

    def set_by(self) -> str:
        running, last = self.current, None
        for name, target in self.steps:
            if target != running:
                last = name
            running = target
        return last or (self.steps[0][0] if self.steps else "")


def action_of(target: int, current: int) -> str:
    return (SCALE_UP if target > current else
            SCALE_DOWN if target < current else NO_CHANGE)


def analysis(plan: dict, slope: float) -> dict:
    """The SLO analyzer's result for one model."""
    cfg = plan["config"]
    scale_up = cfg["scale_up_threshold"] or DEFAULT_SCALE_UP_THRESHOLD
    scale_down = cfg["scale_down_boundary"] or DEFAULT_SCALE_DOWN_BOUNDARY
    horizon = cfg["anticipation_horizon_seconds"]
    headroom = cfg["headroom_replicas"]
    burst = cfg["burst_slope_rps"]
    rate = plan["arrival_rate_per_min"] or 0.0
    backlog = sum(max(r[2], 0) for r in plan["replicas"])
    if plan["scheduler_queue"] is not None:
        backlog += max(plan["scheduler_queue"], 0)
    demand = max(rate, 0.0) / 60.0 + max(backlog, 0.0) / BACKLOG_DRAIN_S
    ins = [r[3] for r in plan["replicas"] if r[3] > 0]
    outs = [r[4] for r in plan["replicas"] if r[4] > 0]
    avg_in = sum(ins) / len(ins) if ins else DEFAULT_AVG_INPUT_TOKENS
    avg_out = max(sum(outs) / len(outs) if outs else
                  DEFAULT_AVG_OUTPUT_TOKENS, 1.0)
    states = {v[0]: v for v in plan["variants"]}
    caps = []
    for name, cap in zip(plan["candidates"], plan["per_replica"]):
        vs = states[name]
        ready, pending = max(vs[2] - vs[3], 0), vs[3]
        cost = next((r[1] for r in plan["replicas"] if r[0] == name),
                    DEFAULT_VARIANT_COST)
        caps.append({"variant": name, "accelerator": vs[1], "cost": cost,
                     "ready": ready, "pending": pending, "cap": cap})
    supply = anticipated = 0.0
    for c in caps:
        supply += c["cap"] * c["ready"]
        anticipated += c["cap"] * (c["ready"] + c["pending"])
    best = None
    if headroom > 0:
        pairs = [(c["cost"] / c["cap"], c["cap"]) for c in caps
                 if c["cap"] > 0]
        if pairs:
            best = min(pairs)[1]
    scaling = demand
    if horizon > 0:
        scaling += max(slope, 0.0) * horizon
    if horizon > 0 and slope > 0:
        t0 = 0.0 if demand >= anticipated else \
            min((anticipated - demand) / slope, horizon)
        deficit = ((demand - anticipated) * (horizon - t0)
                   + slope * (horizon * horizon - t0 * t0) / 2.0)
        if deficit > 0:
            scaling += deficit / BACKLOG_DRAIN_S
    head = 0.0
    if headroom > 0 and best is not None:
        head = headroom * best
    if burst > 0 and horizon > 0:
        head = max(head, burst * horizon)
    required = max(scaling / scale_up + head - anticipated, 0.0)
    spare = max(supply - demand / scale_down - head, 0.0) \
        if supply > 0 else 0.0
    if horizon > 0 and slope > 0:
        spare = 0.0
    return {"demand": demand, "scaling": scaling, "headroom": head,
            "required": required, "spare": spare, "caps": caps,
            "avg_in": avg_in, "avg_out": avg_out}


def row_gaps(plan: dict, res: dict, config: dict, profiles: dict) -> int:
    """How many of the model's candidate rows differ from the row the
    configuration and the collected telemetry give: the request size the
    analysis works out, the profile's batch and queue bounds, the SLO
    targets, and where the configuration fixes them (``profiles``, by
    model and accelerator) the profile's parameters."""
    wrong = 0
    accs = {v[0]: v[1] for v in plan["variants"]}
    for name, row in zip(plan["candidates"], plan["rows"]):
        want = (res["avg_in"], res["avg_out"], config["max_batch_size"],
                config["max_queue_size"], config["slo_ttft_ms"],
                config.get("slo_itl_ms", 0.0), 0.0)
        profile = profiles.get((plan["model_id"], accs.get(name)))
        wrong += tuple(row[3:]) != want or (
            profile is not None and tuple(row[:3]) != profile)
    return wrong


def cost_aware(plan: dict, res: dict) -> list[Decision]:
    """The cost-aware optimizer's decisions for one model."""
    targets = {v[0]: v[2] for v in plan["variants"]}
    caps = res["caps"]
    if res["required"] > 0:
        remaining = res["required"]
        for c in sorted(caps, key=lambda c: c["cost"] / c["cap"]
                        if c["cap"] > 0 else math.inf):
            if remaining <= 0:
                break
            if c["cap"] <= 0:
                continue
            needed = math.ceil(remaining / c["cap"])
            targets[c["variant"]] = targets.get(c["variant"], 0) + needed
            remaining -= needed * c["cap"]
    elif res["spare"] > 0:
        cheapest = min(caps, key=lambda c: c["cost"])["variant"] \
            if caps else ""
        remaining = res["spare"]
        for c in sorted(caps, key=lambda c: -c["cost"]):
            if remaining <= 0:
                break
            if c["cap"] <= 0:
                continue
            current = targets.get(c["variant"], 0)
            floor = 0
            if c["variant"] == cheapest and not any(
                    t > 0 for name, t in targets.items() if name != cheapest):
                floor = 1
            removable = current - floor
            if removable <= 0:
                continue
            remove = min(int(remaining // c["cap"]), removable)
            if remove <= 0:
                continue
            targets[c["variant"]] = current - remove
            remaining -= remove * c["cap"]
    states = {v[0]: v for v in plan["variants"]}
    by_name = {c["variant"]: c for c in caps}
    out = []
    for name in sorted(targets):
        vs = states.get(name, (name, "", 0, 0, 1))
        c = by_name.get(name)
        out.append(Decision(
            plan["namespace"], plan["model_id"], name,
            c["accelerator"] if c else "", vs[2], targets[name], vs[4],
            c["cost"] if c else DEFAULT_VARIANT_COST,
            f"analyzer:{plan['analyzer'] or 'saturation'}", OPTIMIZER_STEP))
    return out


def fleet_allocations(servers: dict, solve: dict) -> tuple[dict, int]:
    """The fleet solve's allocation ``{server: (accelerator, replicas)}``
    from each server's load, and the count of what cannot be judged (a
    pool-limited solve, a pair without a sized throughput)."""
    out, unjudged = {}, 0
    if not solve["unlimited"]:
        return out, len(servers)
    for name in sorted(servers):
        s = servers[name]
        rec = solve["servers"].get(name)
        if rec is None or rec["target_tps"] is None:
            continue
        cands = []
        for acc in rec["accelerators"]:
            _type, chips, cost, tier = solve["accelerators"][acc]
            if s["rate_per_min"] <= 0 or s["avg_out"] <= 0:
                replicas = s["min_replicas"]
            else:
                rate_star = rec["rate_star"].get(acc)
                if rate_star is None:
                    unjudged += 1
                    continue
                if rec["target_tps"] > 0:
                    total = rec["target_tps"] / max(s["avg_out"], 1.0)
                else:
                    total = s["rate_per_min"] / 60.0
                replicas = max(int(math.ceil(total / rate_star))
                               if rate_star > 0 else 1, s["min_replicas"], 1)
            price = cost * tier * replicas
            cur = s["current"]
            if cur is not None and cur[0]:
                if cur[0] == acc:
                    value = price - cur[2] if price != cur[2] else 0.0
                else:
                    value = (ACCEL_PENALTY_FACTOR * (cur[2] + price)
                             + (price - cur[2]))
            else:
                value = price
            cands.append((value, acc, replicas))
        if cands:
            value, acc, replicas = min(cands)
            out[name] = (acc, replicas)
    return out, unjudged


def global_decisions(plans, results, solve, holds, now):
    """The fleet solve's decisions for the models routed to it, with the
    allocation and the count of what cannot be judged."""
    servers = {}
    for plan, res in zip(plans, results):
        name = f"{plan['namespace']}/{plan['model_id']}"
        current = None
        for c in sorted(res["caps"], key=lambda c: -c["ready"]):
            if c["accelerator"] and current is None and c["ready"] > 0:
                current = (c["accelerator"], c["ready"],
                           c["cost"] * c["ready"])
        servers[name] = {
            "rate_per_min": (max(res["scaling"], res["demand"])
                             + res["headroom"]) * 60.0,
            "avg_out": res["avg_out"], "min_replicas": 1,
            "current": current}
    allocs, unjudged = fleet_allocations(servers, solve)
    decisions = []
    for plan, res in zip(plans, results):
        name = f"{plan['namespace']}/{plan['model_id']}"
        alloc = allocs.get(name)
        variants = plan["variants"]
        winner = None
        if alloc is not None:
            matching = [v for v in variants if v[1] == alloc[0]]
            if matching:
                winner = max(matching, key=lambda v: (
                    max(v[2] - v[3], 0), v[2], v[0]))
            else:
                alloc = None
        ready_ok, winner_ready = True, 0
        if winner is not None:
            winner_ready = max(winner[2] - winner[3], 0)
            ready_ok = winner_ready >= alloc[1]
        costs = {c["variant"]: c["cost"] for c in res["caps"]}
        for v in variants:
            current = v[2]
            if alloc is None:
                target = current
            elif v is winner:
                target = alloc[1]
            elif ready_ok or current == 0:
                target = 0
            else:
                held = holds.get(f"{name}|{v[0]}")
                if held is None or held[2] != alloc[0]:
                    held = (now, current, alloc[0])
                started, initial, _ = held
                shortfall = 1.0 - winner_ready / max(alloc[1], 1)
                if now - started > MIGRATION_HOLD_TIMEOUT_S:
                    target = max(0, current - 1)
                else:
                    target = min(current, math.ceil(initial * shortfall))
            decisions.append(Decision(
                plan["namespace"], plan["model_id"], v[0], v[1], current,
                target, v[4], costs.get(v[0], 0.0),
                f"analyzer:{plan['analyzer'] or 'slo'}", GLOBAL_STEP))
    return decisions, allocs, unjudged


def minimum_replica(decisions: list[Decision]) -> None:
    """Scale-to-zero off: a model whose targets sum to 0 keeps one replica,
    on its cheapest variant (the name breaks a tie)."""
    if sum(d.target for d in decisions) <= 0:
        cheapest = None
        for d in decisions:
            if cheapest is None or d.cost < cheapest.cost or (
                    d.cost == cheapest.cost and d.variant < cheapest.variant):
                cheapest = d
        if cheapest is not None and cheapest.target != 1:
            cheapest.target = 1
            cheapest.action = action_of(1, cheapest.current)
    for d in decisions:
        d.step(ENFORCER_STEP)


def limit(decisions: list[Decision], pools: dict) -> None:
    """The slice limiter: each accelerator's pool less what the current
    replicas use, granted in whole replicas to the scale-ups in order of
    spare capacity and cost; an accelerator without a pool grants none."""
    used = {}
    for d in decisions:
        if d.accelerator:
            used[d.accelerator] = (used.get(d.accelerator, 0)
                                   + d.current * max(d.chips, 1))
    left = {acc: max(chips - used.get(acc, 0), 0)
            for acc, chips in pools.items()}
    ups = sorted((d for d in decisions if d.target > d.current),
                 key=lambda d: (d.spare, d.cost))
    for d in ups:
        chips = d.chips if d.chips > 0 else 1
        want = (d.target - d.current) * chips
        granted = min(want, left[d.accelerator]) \
            if d.accelerator in left else 0
        if d.accelerator in left:
            left[d.accelerator] -= granted
        d.target = d.current + granted // chips
    for d in decisions:
        d.step(LIMITER_STEP)


def tick(record: dict, config: dict,
         profiles: dict) -> tuple[list, dict, int]:
    """The tick's decisions and fleet allocation by the reference, and the
    count of what it cannot judge or finds the program doing against the
    configuration, its candidate rows included (each counts as a wrong
    decision). ``profiles``: the profile parameters the configuration
    fixes, by (model, accelerator)."""
    limiter = bool(config.get("limiter"))
    plans = record["plans"]
    results = [analysis(p, record["slopes"].get(
        f"{p['namespace']}|{p['model_id']}", 0.0)) for p in plans]
    unjudged = sum(row_gaps(p, r, config, profiles)
                   for p, r in zip(plans, results))
    glob = [(p, r) for p, r in zip(plans, results)
            if p["config"]["optimizer_name"] == "global"]
    local = [(p, r) for p, r in zip(plans, results)
             if p["config"]["optimizer_name"] != "global"]
    decisions, allocs = [], {}
    if glob:
        if len(record["solves"]) != 1:
            return [], {}, unjudged + len(glob)
        g, allocs, solve_unjudged = global_decisions(
            [p for p, _ in glob], [r for _, r in glob], record["solves"][0],
            record["holds"], record["now"])
        unjudged += solve_unjudged
        decisions.extend(g)
    for plan, res in local:
        decisions.extend(cost_aware(plan, res))
    for plan, _ in [*glob, *local]:
        minimum_replica([d for d in decisions
                         if (d.namespace, d.model_id)
                         == (plan["namespace"], plan["model_id"])])
    by_variant = {(d.namespace, d.variant): d for d in decisions}
    glob_keys = {(p["namespace"], p["model_id"]) for p, _ in glob}
    for namespace, variant, floor in record["floors"]:
        d = by_variant.get((namespace, variant))
        if d is not None and (d.namespace, d.model_id) in glob_keys:
            unjudged += 1  # the fleet solve's models take no floor
        if d is None or floor <= d.target:
            continue
        d.target = floor
        if floor > d.current:
            d.action = SCALE_UP
        d.step(FORECAST_STEP)
    fresh = {(d.namespace, d.variant) for d in decisions}
    for p in record["pre_limit"] or []:
        if (p["namespace"], p["variant"]) not in fresh:
            d = Decision(p["namespace"], p["model_id"], p["variant"],
                         p["accelerator"], p["current"], p["target"],
                         p["chips"], p["cost"], "", "")
            d.action, d.spare, d.steps = p["action"], p["spare"], []
            decisions.append(d)
    if limiter and decisions:
        if record["pools"] is None:
            unjudged += 1  # the configuration's limiter did not run
        else:
            limit(decisions, record["pools"])
    elif record["pools"] is not None:
        unjudged += 1  # a limiter ran that the configuration does not have
    return decisions, allocs, unjudged
