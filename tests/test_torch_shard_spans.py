"""The sharded engine plane's spans and merge in the port
(``wva_tpu_torch/obs/SPANS.md``, docs/design/sharding.md).

- At 24 models x 2 variants over 4 shard workers, each tick's tree holds
  the plane's spans once (once a worker where the span is a worker's) with
  their counts: ``shard_gather`` with ``fleet_queries``, ``shard_leases``
  and ``ring`` under it; ``fleet_merge`` with ``merge_decode``,
  ``fleet_solve`` and ``merge_reemit``; each worker's ``shard_capture``;
  the workers' ``owned`` counts sum to the VariantAutoscalings; the
  workers' subtrees are grafted under the fleet tick.
- Under the torch profiler the workers' spans are ``wva:`` ranges too,
  nested.
- The fleet solve takes the rates the workers' fused programs sized
  (shipped in the global entries, also through the ConfigMap bus's
  JSON) and sizes nothing itself.
- Statuses and trace cycles byte-identical at 0, 1, 2 and 4 shards, with
  spans on and off; with no flight recorder (the benchmark's fleet) the
  workers buffer no records and ship no plans, and statuses and forecast
  gauges equal the unsharded engine's.
- The fleet warms the shared view with the templates the last tick's
  workers asked for: every template on the first tick, then no per-pod
  rate the tuner alone reads (the fleet's tuner is off), while the
  workers' own requests stay what the first tick's were.
- A decoded dataclass equals its original, and each class's type hints
  are resolved once.
- ``portbench/reference/ring.py``, written plainly, agrees with
  ``wva_tpu_torch/shard/hashring.py`` on 10,000 sequential and random
  model ids at 1-8 live shards.

Worlds run on the CPU, torch on one thread.
"""

import json
import random

import pytest
import torch

from wva_tpu_torch.blackbox.schema import encode
from wva_tpu_torch.obs import spans as spans_mod

MODELS = 24
TICKS = 5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _world(shards, spans=True):
    """``chip_smoke.fleet_world`` (a quarter of the models fleet-solved,
    forecasting on) at ``shards`` (0: unsharded)."""
    import chip_smoke
    from wva_tpu_torch import config, fused
    from wva_tpu_torch.config.config import ShardingConfig

    fused.clear_solve_memo()
    inner = config.new_test_config

    def levers():
        cfg = inner()
        if shards:
            cfg.set_sharding(ShardingConfig(enabled=True, shards=shards))
        if not spans:
            cfg.set_obs(config.ObsConfig(spans=False))
        return cfg

    config.new_test_config = levers
    try:
        return chip_smoke.fleet_world(MODELS, device="cpu")
    finally:
        config.new_test_config = inner


def _tick(mgr, clock, feed):
    mgr.engine.executor.tick()
    clock.advance(5.0)
    feed(clock.now())


def _named(node, name):
    return [c for c in node.get("children", ()) if c["name"] == name]


def _all(node, name):
    out = []
    for child in node.get("children", ()):
        if child["name"] == name:
            out.append(child)
        out.extend(_all(child, name))
    return out


@pytest.fixture(scope="module")
def sharded_tree():
    mgr, clock, feed, _ = _world(4)
    try:
        for _ in range(2):
            _tick(mgr, clock, feed)
        tree = mgr.spans.last_tree()
        groups = {(va.metadata.namespace, va.spec.model_id)
                  for va in mgr.client.list("VariantAutoscaling")}
        vas = len(mgr.client.list("VariantAutoscaling"))
    finally:
        mgr.shutdown()
    return tree, len(groups), vas


def test_the_plane_spans_appear_once_a_tick_with_their_counts(sharded_tree):
    tree, n_groups, _ = sharded_tree
    (analyze,) = _named(tree, "phase:analyze")
    (gather,) = _named(analyze, "shard_gather")
    assert gather["attrs"] == {"alive": 4, "moves": 0, "stale": 0,
                               "uncovered": 0}
    assert [c["name"] for c in gather["children"]] == [
        "fleet_queries", "shard_leases", "ring"]
    assert _named(gather, "shard_leases")[0]["attrs"] == {"shards": 4}
    (merge,) = _named(analyze, "fleet_merge")
    assert merge["attrs"]["shards"] == 4
    assert [c["name"] for c in merge["children"]] == [
        "merge_decode", "fleet_solve", "merge_reemit"]
    workers = _named(tree, "shard_tick")
    captures = [c for w in workers for c in _all(w, "shard_capture")]
    assert len(captures) == 4
    assert sorted(c["attrs"]["shard"] for c in captures) == [0, 1, 2, 3]
    assert sum(c["attrs"]["local"] + c["attrs"]["global"]
               + c["attrs"]["cached"] for c in captures) == n_groups
    globals_ = sum(c["attrs"]["global"] for c in captures)
    assert globals_ > 0
    assert _named(merge, "merge_decode")[0]["attrs"] == {"global": globals_}
    assert _named(merge, "merge_reemit")[0]["attrs"]["records"] > 0
    for name in ("shard_gather", "shard_leases", "ring", "fleet_queries",
                 "fleet_merge", "merge_decode", "merge_reemit",
                 "fleet_solve"):
        assert len(_all(tree, name)) == 1, name


def test_owned_counts_sum_to_the_vas_and_workers_graft_under_the_tick(
        sharded_tree):
    tree, _, vas = sharded_tree
    workers = _named(tree, "shard_tick")
    assert sorted(w["attrs"]["shard"] for w in workers) == [0, 1, 2, 3]
    assert sum(w["attrs"]["owned"] for w in workers) == vas == 2 * MODELS
    for w in workers:
        prefix = f"sh{w['attrs']['shard']}:"
        assert w["span_id"].startswith(prefix)
        assert all(c["span_id"].startswith(prefix)
                   for c in _all(w, "phase:analyze"))
        (phase,) = _named(w, "phase:analyze")
        assert _named(phase, "shard_capture")


def test_worker_spans_are_nested_profiler_ranges():
    mgr, clock, feed, _ = _world(4)
    try:
        _tick(mgr, clock, feed)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _tick(mgr, clock, feed)
    finally:
        mgr.shutdown()
    ranges = sorted(
        ((e.name, e.time_range.start, e.time_range.end)
         for e in prof.events()
         if e.name.startswith(spans_mod.RANGE_PREFIX)),
        key=lambda r: (r[1], -r[2]))
    names = [n for n, _, _ in ranges]
    for name, count in (("shard_tick", 4), ("shard_capture", 4),
                        ("shard_gather", 1), ("shard_leases", 1),
                        ("ring", 1), ("fleet_queries", 1),
                        ("fleet_merge", 1), ("merge_decode", 1),
                        ("merge_reemit", 1)):
        assert names.count(spans_mod.RANGE_PREFIX + name) == count, name
    for i, (_, a0, a1) in enumerate(ranges):
        for _, b0, b1 in ranges[i + 1:]:
            assert not (b0 < a1 < b1)


def test_the_fleet_solve_reuses_the_workers_sizing(monkeypatch):
    from wva_tpu_torch import fleet
    from wva_tpu_torch.fleet import allocation

    solves, sized = [], []
    inner_solve, inner_size = fleet.solve, allocation.size_batch_bucketed

    def solve(system, spec=None, **kwargs):
        solves.append((sorted(system.servers), kwargs.get("presized")))
        return inner_solve(system, spec, **kwargs)

    def size_batch_bucketed(*args, **kwargs):
        sized.append(1)
        return inner_size(*args, **kwargs)

    monkeypatch.setattr(fleet, "solve", solve)
    monkeypatch.setattr(allocation, "size_batch_bucketed",
                        size_batch_bucketed)
    mgr, clock, feed, _ = _world(4)
    try:
        for _ in range(2):
            _tick(mgr, clock, feed)
    finally:
        mgr.shutdown()
    assert len(solves) == 2 and not sized
    for servers, presized in solves:
        assert servers and presized
        assert {f"{ns}/{model}" for model, ns, _ in presized} == set(servers)


def test_global_entries_carry_the_sizing_through_the_configmap_codec():
    from wva_tpu_torch.shard.summary import (
        ENTRY_GLOBAL,
        capture_to_payload,
        payload_to_capture,
    )

    mgr, clock, feed, _ = _world(4)
    try:
        _tick(mgr, clock, feed)
        plane = mgr.engine.shard_plane
        caps = [plane.bus.read(shard) for shard in sorted(plane.workers)]
    finally:
        mgr.shutdown()
    shipped = 0
    for cap in caps:
        back = payload_to_capture(json.loads(json.dumps(
            capture_to_payload(cap), sort_keys=True)))
        for key, entry in cap.entries.items():
            if entry.kind != ENTRY_GLOBAL:
                continue
            sized = entry.global_request["presized"]
            assert set(sized) == {"v5e-8", "v5p-8"}
            assert back.entries[key].global_request["presized"] == sized
            shipped += 1
    assert shipped


def _run(shards, spans):
    mgr, clock, feed, _ = _world(shards, spans=spans)
    try:
        for _ in range(TICKS):
            _tick(mgr, clock, feed)
        mgr.flight_recorder.flush()
        cycles = mgr.flight_recorder.snapshot()
        assert cycles and cycles[-1]["decisions"]
        statuses = {f"{va.metadata.namespace}/{va.metadata.name}":
                    encode(va.status)
                    for va in mgr.client.list("VariantAutoscaling")}
        return (json.dumps(statuses, sort_keys=True),
                json.dumps(cycles, sort_keys=True))
    finally:
        mgr.shutdown()


@pytest.fixture(scope="module")
def unsharded():
    torch.set_num_threads(1)
    return _run(0, True)


@pytest.mark.parametrize("shards,spans", [
    (0, False), (1, True), (1, False), (2, True), (2, False), (4, True),
    (4, False)])
def test_statuses_and_cycles_byte_identical(unsharded, shards, spans):
    assert _run(shards, spans) == unsharded


def _cell_run(sharded):
    """The benchmark's fleet (no flight recorder) at MODELS models, with
    and without the plane: statuses and forecast gauges after TICKS
    ticks, and with the plane the last tick's captures and tree."""
    from portbench import core
    from portbench.drivers import fleet_feed, shard_plane

    name = ("fleet-1000x2-shard4.sharded-busy" if sharded
            else "fleet-1000x2.busy")
    _, config, traffic = core.cell(name)
    build = shard_plane.build if sharded else fleet_feed.build
    mgr, clock, feed = build(dict(config, n_models=MODELS), traffic,
                             2900000017, "cpu")
    try:
        assert mgr.engine.flight is None
        for _ in range(TICKS):
            _tick(mgr, clock, feed)
        statuses = {f"{va.metadata.namespace}/{va.metadata.name}":
                    encode(va.status)
                    for va in mgr.client.list("VariantAutoscaling")}
        gauges = sorted(
            line for line in
            mgr.engine.actuator.registry.render_text().splitlines()
            if line.startswith("wva_forecast"))
        plane = mgr.engine.shard_plane
        caps = ([plane.bus.read(shard) for shard in sorted(plane.workers)]
                if plane is not None else [])
        return (json.dumps(statuses, sort_keys=True), gauges), caps, \
            mgr.spans.last_tree()
    finally:
        mgr.shutdown()


def test_a_fleet_recording_no_trace_ships_no_records_and_decides_alike():
    sharded, caps, tree = _cell_run(True)
    unsharded, _, _ = _cell_run(False)
    assert sharded == unsharded
    assert sharded[1]
    assert len(caps) == 4 and all(c.entries for c in caps)
    assert not any(c.trace or c.plans for c in caps)
    workers = _named(tree, "shard_tick")
    assert len(workers) == 4
    assert not any(_all(w, "record") for w in workers)


def test_the_warm_up_runs_only_the_templates_the_workers_asked_for():
    from wva_tpu_torch.collector.source import grouped

    warmed, requested = [], []
    inner_serve = grouped.GroupedMetricsView._serve_grouped
    inner_warm = grouped.GroupedMetricsView.warm_fleet_queries
    state = {"warm": False}

    def serve(self, name, params):
        if state["warm"]:
            warmed[-1].add(name)
        return inner_serve(self, name, params)

    def warm(self, params, names=None):
        warmed.append(set())
        state["warm"] = True
        try:
            return inner_warm(self, params, names)
        finally:
            state["warm"] = False
            requested.append(self)

    grouped.GroupedMetricsView._serve_grouped = serve
    grouped.GroupedMetricsView.warm_fleet_queries = warm
    mgr, clock, feed, _ = _world(4)
    try:
        for _ in range(3):
            _tick(mgr, clock, feed)
    finally:
        grouped.GroupedMetricsView._serve_grouped = inner_serve
        grouped.GroupedMetricsView.warm_fleet_queries = inner_warm
        mgr.shutdown()
    asked = [view.requested() for view in requested]
    assert len(warmed) == 3
    pod = {n for n in warmed[0] if n.startswith("model_pod_")}
    assert pod, "the first tick warms every template"
    assert asked[0] == asked[1] == asked[2]
    assert not pod & asked[0]
    assert warmed[1] == warmed[2] == warmed[0] & asked[0]


def test_decode_resolves_each_class_once_and_round_trips(monkeypatch):
    from wva_tpu_torch.blackbox import schema
    from wva_tpu_torch.interfaces import (
        AnalyzerResult,
        VariantCapacity,
        VariantReplicaState,
    )

    calls = []
    inner = schema.get_type_hints
    monkeypatch.setattr(schema, "get_type_hints",
                        lambda cls: calls.append(cls) or inner(cls))
    monkeypatch.setattr(schema, "_FIELD_HINTS", {})
    state = VariantReplicaState(variant_name="v", current_replicas=2,
                                desired_replicas=3)
    for _ in range(3):
        assert schema.decode(VariantReplicaState,
                             schema.encode(state)) == state
    assert calls == [VariantReplicaState]
    result = AnalyzerResult(model_id="m", namespace="ns", total_demand=1.5,
                            variant_capacities=[VariantCapacity(
                                variant_name="v", replica_count=2,
                                per_replica_capacity=0.75)])
    assert schema.decode(AnalyzerResult, schema.encode(result)) == result


def _ids():
    rng = random.Random(20)
    sequential = [f"model-{i:04d}" for i in range(10_000)]
    drawn = [f"org-{rng.randrange(10**6)}/m{rng.getrandbits(40):x}"
             for _ in range(10_000)]
    return sequential, drawn


@pytest.mark.parametrize("live", range(1, 9))
def test_plain_ring_agrees_with_the_port(live):
    from portbench.reference import ring
    from wva_tpu_torch.shard.hashring import HashRing

    rng = random.Random(live)
    for shards in (list(range(live)), rng.sample(range(16), live)):
        port = HashRing(shards)
        for ids in _ids():
            plain = ring.assign(ids, shards)
            assert plain == {m: port.owner(m) for m in ids}, shards
