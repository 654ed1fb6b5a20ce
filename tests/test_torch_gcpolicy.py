"""The port's collector policy (``wva_tpu_torch/utils/gcpolicy.py``).

- It engages after two ticks in a row heavy in net tracked allocations,
  not after light ticks nor after one heavy tick alone; engaged, it sizes
  threshold 0 to the tick between the interpreter's threshold and its cap,
  and leaves thresholds 1 and 2 alone.
- It collects and freezes once per process, however many policies engage.
- Two Managers share it by the owner count: the first shutdown leaves the
  heap frozen, the last restores the thresholds and hands every frozen
  object back (CPython parks its immortal objects in the frozen generation
  again at the next full collection, so the freeze count is back to what
  it was).
- Each tick's span carries ``gc_young``, ``gc_full`` and ``gc_frozen``,
  engaged or not.
- The benchmark's fleet at 24 models (``portbench/tests/small.py``) with
  a flight recorder decides alike with the policy engaged and held off:
  decisions, VariantAutoscaling statuses and cycle records byte for byte.
- Engaged for 60 ticks, the fleet keeps few objects in the collector's
  view and runs almost no full collections.

Worlds run on the CPU, torch on one thread.
"""

import gc
import json

import pytest
import torch

from wva_tpu_torch.blackbox.schema import encode
from wva_tpu_torch.utils import gcpolicy
from wva_tpu_torch.utils.gcpolicy import GcPolicy

SEED = 2900000017
NEVER = 10 ** 12


@pytest.fixture(autouse=True)
def _collector_as_found():
    """Each test starts with no policy engaged and leaves none engaged, the
    thresholds as it found them."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert gcpolicy.owners() == 0
    thresholds = gc.get_threshold()
    yield
    torch.set_num_threads(torch_threads)
    assert gcpolicy.owners() == 0
    assert gc.get_threshold() == thresholds


def _tick(policy, allocations):
    """One tick under ``policy`` that keeps ``allocations`` tracked objects
    alive until it ends."""
    policy.begin_tick()
    kept = [[] for _ in range(allocations)]
    policy.after_tick()
    return len(kept)


def _heavy():
    """Net allocations of a heavy tick at the interpreter's threshold
    (read before any policy engages)."""
    return gcpolicy.ENGAGE_YOUNG * gc.get_threshold()[0] * 3 // 2


def test_engages_after_two_heavy_ticks_not_after_light_ones():
    default, heavy = gc.get_threshold(), _heavy()
    policy = GcPolicy()
    try:
        for _ in range(5):
            _tick(policy, 100)
        assert not policy.engaged
        _tick(policy, heavy)
        _tick(policy, 100)
        _tick(policy, heavy)
        assert not policy.engaged and gc.get_threshold() == default
        _tick(policy, heavy)
        assert policy.engaged and gcpolicy.owners() == 1
        # Sized to the heavy tick: about TARGET_YOUNG young collections.
        threshold0 = gc.get_threshold()[0]
        assert default[0] < threshold0 <= gcpolicy.YOUNG_CAP
        assert abs(threshold0 * gcpolicy.TARGET_YOUNG - heavy) < 0.1 * heavy
        assert gc.get_threshold()[1:] == default[1:]
        # A light tick brings it back to the floor, a huge one to the cap.
        _tick(policy, 100)
        assert gc.get_threshold() == default
        _tick(policy, 12 * gcpolicy.TARGET_YOUNG * gcpolicy.YOUNG_CAP // 10)
        assert gc.get_threshold() == (gcpolicy.YOUNG_CAP, *default[1:])
    finally:
        policy.release()
    assert not policy.engaged and gc.get_threshold() == default
    # Released for good: later ticks leave the collector alone.
    for _ in range(gcpolicy.ENGAGE_TICKS):
        _tick(policy, heavy)
    assert not policy.engaged and gcpolicy.owners() == 0


def test_freezes_once_per_process(monkeypatch):
    calls = {"collect": 0, "freeze": 0}
    collect, freeze = gc.collect, gc.freeze

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(gc, "collect", counted("collect", collect))
    monkeypatch.setattr(gc, "freeze", counted("freeze", freeze))
    first, second, heavy = GcPolicy(), GcPolicy(), _heavy()
    try:
        for policy in (first, second):
            for _ in range(gcpolicy.ENGAGE_TICKS):
                _tick(policy, heavy)
        assert first.engaged and second.engaged
        assert gcpolicy.owners() == 2
        assert calls == {"collect": 1, "freeze": 1}
    finally:
        first.release()
        second.release()
    assert calls == {"collect": 1, "freeze": 1}


def _fleet(monkeypatch, trace=False):
    """(manager, clock, feed): the benchmark's busy fleet at 24 models,
    with a flight recorder when ``trace``."""
    from portbench import core
    from portbench.drivers import fleet_feed
    from portbench.tests import small
    from wva_tpu_torch import config

    if trace:
        inner = config.new_test_config

        def traced():
            cfg = inner()
            cfg.set_trace(config.TraceConfig(enabled=True, ring_size=64))
            return cfg

        monkeypatch.setattr(config, "new_test_config", traced)
    with small.cells():
        _, cfg, traffic = core.cell("fleet-1000x2.busy")
    mgr, clock, feed = fleet_feed.build(cfg, traffic, SEED, "cpu")
    if trace:
        monkeypatch.setattr(config, "new_test_config", inner)
    return mgr, clock, feed


def _step(mgr, clock, feed):
    mgr.engine.executor.tick()
    clock.advance(5.0)
    feed(clock.now())
    return mgr.spans.last_tree()["attrs"]


def test_two_managers_share_it_and_the_last_shutdown_restores(monkeypatch):
    monkeypatch.setattr(gcpolicy, "ENGAGE_YOUNG", 0)
    gc.collect()
    thresholds, frozen = gc.get_threshold(), gc.get_freeze_count()
    worlds = [_fleet(monkeypatch), _fleet(monkeypatch)]
    try:
        for world in worlds:
            for _ in range(gcpolicy.ENGAGE_TICKS):
                _step(*world)
        assert all(mgr.gc_policy.engaged for mgr, _, _ in worlds)
        assert gcpolicy.owners() == 2
        held = gc.get_freeze_count()
        assert held > frozen + 10_000
        first, _, _ = worlds.pop(0)
        first.shutdown()
        assert gcpolicy.owners() == 1
        assert gc.get_freeze_count() > frozen + 10_000
        _step(*worlds[0])
    finally:
        for mgr, _, _ in worlds:
            mgr.shutdown()
    assert gcpolicy.owners() == 0
    assert gc.get_threshold() == thresholds
    assert gc.get_freeze_count() <= frozen
    gc.collect()
    assert gc.get_freeze_count() == frozen


@pytest.mark.parametrize("engage", [False, True])
def test_the_tick_span_carries_the_counters(monkeypatch, engage):
    monkeypatch.setattr(gcpolicy, "ENGAGE_YOUNG", 0 if engage else NEVER)
    mgr, clock, feed = _fleet(monkeypatch)
    try:
        seen = [_step(mgr, clock, feed) for _ in range(4)]
        assert mgr.gc_policy.engaged is engage
    finally:
        mgr.shutdown()
    for attrs in seen:
        assert {"gc_young", "gc_full", "gc_frozen"} <= set(attrs)
        assert attrs["gc_young"] >= 0 and attrs["gc_full"] >= 0
    frozen = [a["gc_frozen"] for a in seen]
    if engage:
        # Frozen after the second tick: the third and fourth spans hold
        # the fleet's heap, the first two what the interpreter froze.
        assert min(frozen[2:]) > 10 * max(frozen[:2])
    else:
        assert max(frozen) < 10_000
    # The first tick of a fresh fleet runs young collections.
    assert seen[0]["gc_young"] > 0


def _decisions_statuses_cycles(monkeypatch, engage, ticks=6):
    monkeypatch.setattr(gcpolicy, "ENGAGE_YOUNG", 0 if engage else NEVER)
    # Engaged, threshold 0 follows every tick's allocations.
    monkeypatch.setattr(gcpolicy, "TARGET_YOUNG", 1 if engage else 10)
    default = gc.get_threshold()[0]
    mgr, clock, feed = _fleet(monkeypatch, trace=True)
    try:
        for _ in range(ticks):
            _step(mgr, clock, feed)
        assert mgr.gc_policy.engaged is engage
        assert (gc.get_threshold()[0] > default) is engage
        mgr.flight_recorder.flush()
        cycles = mgr.flight_recorder.snapshot()
        decisions = [c["decisions"] for c in cycles]
        assert len(cycles) == ticks and decisions[-1]
        statuses = {f"{va.metadata.namespace}/{va.metadata.name}":
                    encode(va.status)
                    for va in mgr.client.list("VariantAutoscaling")}
        return (json.dumps(decisions, sort_keys=True),
                json.dumps(statuses, sort_keys=True),
                json.dumps(cycles, sort_keys=True))
    finally:
        mgr.shutdown()


def test_decisions_statuses_and_cycles_byte_identical(monkeypatch):
    held_off = _decisions_statuses_cycles(monkeypatch, False)
    engaged = _decisions_statuses_cycles(monkeypatch, True)
    assert engaged[0] == held_off[0]
    assert engaged[1] == held_off[1]
    assert engaged[2] == held_off[2]


# Steadiness bounds for the 24-model fleet engaged: objects that enter the
# collector's view and stay (the world's Events and samples, the planner's
# history: about 150 a tick), against some 1,400-2,800 net tracked
# allocations a tick that must not stay; and full collections.
GROWTH_PER_TICK = 300
FULL_IN_40_TICKS = 4


def test_steady_with_the_policy_engaged(monkeypatch):
    monkeypatch.setattr(gcpolicy, "ENGAGE_YOUNG", 0)
    mgr, clock, feed = _fleet(monkeypatch)
    try:
        seen, unfrozen, frozen = [], {}, []
        for tick in range(60):
            seen.append(_step(mgr, clock, feed))
            if tick in (19, 59):
                unfrozen[tick] = len(gc.get_objects())
            if tick >= 2:
                frozen.append(gc.get_freeze_count())
        assert mgr.gc_policy.engaged
    finally:
        mgr.shutdown()
    assert unfrozen[59] - unfrozen[19] <= 40 * GROWTH_PER_TICK
    late = seen[20:]
    assert sum(a["gc_full"] for a in late) <= FULL_IN_40_TICKS
    assert max(a["gc_full"] for a in late) <= 1
    # Nothing is frozen after the engagement: the frozen set only shrinks,
    # from what the spans report as frozen.
    assert frozen == sorted(frozen, reverse=True)
    assert frozen[0] <= seen[2]["gc_frozen"]
    assert {a["gc_frozen"] for a in seen[2:]} == {seen[2]["gc_frozen"]}
