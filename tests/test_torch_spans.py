"""The port's spans (``wva_tpu_torch/obs/SPANS.md``).

- The recorder's bridge to the torch profiler: with no profiler recording
  no profiler range is entered; under ``torch.profiler.profile`` each span
  begun on the root's thread, but the leaves in ``TREE_ONLY``, is one
  ``wva:`` range, nested as in the tree, also after an abandoned or
  errored root and where a span is left open inside a closing one; spans
  of other threads are not mirrored. On the card the ranges stay off the
  device's timeline. The trees it commits, and its counts, are the JAX
  package recorder's.
- The engine's tick tree: the fingerprint pass's ``versions`` and ``hash``,
  the fused program's ``fused_grids`` and its parts, the decision stage's
  ``decide`` and its children, the tuner's ``tuner_step``/``h_jacobian``,
  the records, and the grouped view's counts on every phase span; spans on
  and off leave statuses and trace cycles byte-identical; a tick that
  raises inside the decision stage leaves its ranges nested.

Worlds run on the CPU, torch on one thread.
"""

import json
import threading

import pytest
import torch

from wva_tpu_torch.blackbox.schema import encode
from wva_tpu_torch.obs import spans as spans_mod
from wva_tpu_torch.obs.spans import SpanRecorder, scoped


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _names(tree, path=""):
    """Every span of a committed tree as (path of names, node)."""
    for child in tree.get("children", ()):
        here = f"{path}/{child['name']}" if path else child["name"]
        yield here, child
        yield from _names(child, here)


def _paths(tree) -> set[str]:
    return {p for p, _ in _names(tree)}


def _wva_ranges(prof):
    """The profiler's ``wva:`` events: (name, start, end), by start."""
    return sorted(
        ((e.name, e.time_range.start, e.time_range.end)
         for e in prof.events() if e.name.startswith(spans_mod.RANGE_PREFIX)),
        key=lambda r: (r[1], -r[2]))


def _nests(ranges) -> bool:
    """Each range lies wholly inside or wholly outside each earlier one."""
    for i, (_, a0, a1) in enumerate(ranges):
        for _, b0, b1 in ranges[i + 1:]:
            if b0 < a1 and b1 > a1:
                return False
    return True


# --- 1. the recorder's bridge to the profiler ---


class _Counting:
    """Stands in for the profiler's range: counts entries."""
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return None


def _small_tree(rec):
    rec.begin_tick(engine="e")
    with rec.span("phase"):
        with rec.span("inner", k=1):
            pass
        s = rec.begin_span("open")
        rec.end_span(s, n=2)


def test_no_profiler_enters_no_range(monkeypatch):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _Counting)
    _Counting.entered = 0
    rec = SpanRecorder()
    for _ in range(3):
        _small_tree(rec)
        rec.end_tick()
    rec.begin_tick()
    with rec.span("x"):
        pass
    rec.abandon_tick()
    assert _Counting.entered == 0
    assert rec.ticks_total == 3
    assert not rec._ranges


@pytest.mark.parametrize("ending", ["success", "error", "abandon"])
def test_root_thread_spans_are_nested_ranges(ending):
    rec = SpanRecorder()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _small_tree(rec)
        # Left open: the root's end closes it.
        rec.begin_span("left_open")
        with rec.span("pushed"):
            # In the tree, but no range of its own.
            with rec.span("backend_query"):
                pass
            if ending == "abandon":
                rec.abandon_tick()
            else:
                rec.end_tick(ending)
        assert not rec._ranges
        # A root after an abandoned or errored one mirrors afresh.
        rec.begin_tick()
        with rec.span("again"):
            pass
        rec.end_tick()
    ranges = _wva_ranges(prof)
    names = [n for n, _, _ in ranges]
    assert sorted(names) == sorted(
        f"wva:{n}" for n in ("tick", "phase", "inner", "open", "left_open",
                             "pushed", "tick", "again"))
    assert _nests(ranges)
    by = {n: (a, b) for n, a, b in ranges if n != "wva:tick"}
    # Both roots are ticks: the first and the one after it, by start.
    by["wva:tick"], by["wva:second tick"] = sorted(
        (a, b) for n, a, b in ranges if n == "wva:tick")
    for outer, inner in (("tick", "phase"), ("phase", "inner"),
                         ("phase", "open"), ("tick", "left_open"),
                         ("second tick", "again")):
        (o0, o1), (i0, i1) = by[f"wva:{outer}"], by[f"wva:{inner}"]
        assert o0 <= i0 and i1 <= o1, (outer, inner)


@pytest.mark.parametrize("leaf", sorted(spans_mod.TREE_ONLY))
def test_tree_only_leaves_have_no_range(leaf):
    rec = SpanRecorder()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rec.begin_tick()
        with rec.span("parent"):
            with rec.span(leaf):
                pass
        tree = rec.end_tick()
    assert f"parent/{leaf}" in _paths(tree)
    assert [n for n, _, _ in _wva_ranges(prof)] == ["wva:tick",
                                                    "wva:parent"]


def test_a_closing_range_closes_the_ranges_left_open_inside_it():
    """A stage entered by hand and left open by an exception: its span's
    parent closing first closes its range, so the ranges still nest."""
    rec = SpanRecorder()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rec.begin_tick()
        phase = rec.begin_span("phase")
        rec.span("decide").__enter__()
        rec.span("finalize").__enter__()
        rec.end_span(phase)
        assert [s.name for s in rec._ranges] == ["tick"]
        with rec.span("after"):
            pass
        rec.end_tick("error")
    ranges = _wva_ranges(prof)
    assert [n for n, _, _ in ranges] == ["wva:tick", "wva:phase",
                                         "wva:decide", "wva:finalize",
                                         "wva:after"]
    assert _nests(ranges)
    by = {n: (a, b) for n, a, b in ranges}
    assert by["wva:decide"][1] <= by["wva:phase"][1]
    assert by["wva:phase"][1] <= by["wva:after"][0]


def test_worker_thread_spans_are_in_the_tree_not_mirrored():
    rec = SpanRecorder()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rec.begin_tick()
        phase = rec.begin_span("phase:analyze")
        rec.set_default_parent(phase)

        def work():
            with rec.span("worker"):
                pass

        t = threading.Thread(target=work)
        t.start()
        t.join()
        rec.end_span(phase)
        tree = rec.end_tick()
    assert "phase:analyze/worker" in _paths(tree)
    assert [n for n, _, _ in _wva_ranges(prof)] == ["wva:tick",
                                                    "wva:phase:analyze"]


def test_spans_begun_before_a_profiler_starts_are_not_mirrored():
    rec = SpanRecorder()
    rec.begin_tick()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("inside"):
            pass
        rec.end_tick()
    assert _wva_ranges(prof) == []


def _script(spans, clocks):
    """One run of a package's recorder: a span outside a tick, four ticks
    through a ring of three, a default parent, a shard worker's adopted
    tick grafted under the fleet's, an abandoned tick. Returns what it
    committed and counted, durations left out."""
    def timeless(tree):
        return {k: [timeless(c) for c in v] if k == "children" else v
                for k, v in tree.items() if k != "dur_ms"}

    clock = clocks.FakeClock(100.0)
    rec = spans.SpanRecorder(clock=clock, ring_size=3, engine="fleet")
    rec.begin_span("outside")
    for i in range(4):
        rec.begin_tick(engine="e" if i else "", n=i)
        with rec.span("phase", k=i) as phase:
            clock.advance(1.0)
            rec.end_span(rec.begin_span("open"), rows=i)
            rec.annotate(phase, done=True)
        rec.set_default_parent(phase)
        rec.end_span(rec.begin_span("late"))
        rec.end_tick("success" if i % 2 else "error")
    worker = spans.SpanRecorder(clock=clock, engine="worker")
    worker.adopt(rec.trace_id, 2)
    worker.begin_tick(owned=3)
    with worker.span("shard_capture"):
        clock.advance(0.5)
    worker.end_tick()
    trees, context = worker.take_capture_spans()
    rec.begin_tick()
    rec.graft(trees)
    rec.end_tick()
    rec.begin_tick()
    with rec.span("retried"):
        rec.abandon_tick()
    return ([timeless(t) for t in rec.snapshot()], context,
            rec.ticks_total, rec.dropped_total, worker.ticks_total)


def test_recorder_commits_the_references_trees():
    from wva_tpu.obs import spans as ref_spans
    from wva_tpu.utils import clock as ref_clock
    from wva_tpu_torch.utils import clock

    got = _script(spans_mod, clock)
    assert got == _script(ref_spans, ref_clock)
    trees = got[0]
    assert [t["trace_id"] for t in trees] == ["t00000003", "t00000004",
                                              "t00000005"]
    assert "shard_tick" in json.dumps(trees[-1])


def test_scoped_without_a_recorder_records_nothing():
    with scoped(None, "x", a=1) as span:
        assert span is None
    rec = SpanRecorder()
    rec.begin_tick()
    with scoped(rec, "x", a=1) as span:
        assert span.name == "x"
    tree = rec.end_tick()
    assert [c["name"] for c in tree["children"]] == ["x"]


@pytest.mark.cuda
def test_ranges_stay_off_the_device_timeline():
    """On the card the ranges are host events only: a device-side mirror
    would count as device work in a trace's busy time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rec = SpanRecorder()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        rec.begin_tick()
        with rec.span("fused_dispatch"):
            x = torch.ones(1 << 16, device="cuda") * 2.0
        with rec.span("decide"):
            x.cpu()
        rec.end_tick()
    wva = [e for e in prof.events() if e.name.startswith("wva:")]
    assert {e.name for e in wva} == {"wva:tick", "wva:fused_dispatch",
                                     "wva:decide"}
    assert all(str(e.device_type).endswith("CPU") for e in wva)


# --- 2. the engine's tick tree ---


def _fleet(n_models, spans=True, monkeypatch=None):
    import chip_smoke
    from wva_tpu_torch import config, fused

    fused.clear_solve_memo()
    if not spans:
        inner = config.new_test_config

        def without_spans():
            cfg = inner()
            cfg.set_obs(config.ObsConfig(spans=False))
            return cfg

        monkeypatch.setattr(config, "new_test_config", without_spans)
    return chip_smoke.fleet_world(n_models, device="cpu")


def _statuses(cluster):
    return {f"{va.metadata.namespace}/{va.metadata.name}": encode(va.status)
            for va in cluster.list("VariantAutoscaling")}


DECIDE = ("finalize", "record", "optimize", "enforce", "forecast", "limiter")


def test_fleet_tick_tree_and_phase_counts():
    mgr, clock, feed, _ = _fleet(6)
    try:
        for _ in range(2):
            mgr.engine.executor.tick()
            clock.advance(5.0)
            feed(clock.now())
        tree = mgr.spans.last_tree()
    finally:
        mgr.shutdown()
    paths = _paths(tree)
    for path in ("phase:fingerprint/versions", "phase:fingerprint/hash",
                 "phase:analyze/fused_grids",
                 "phase:analyze/fused_dispatch/launch",
                 "phase:analyze/fused_dispatch/readback",
                 "phase:analyze/fused_dispatch/materialize",
                 "phase:analyze/decide",
                 "phase:analyze/decide/finalize/vec_finalize",
                 "phase:analyze/decide/optimize/fleet_solve",
                 "phase:analyze/record"):
        assert path in paths, path
    assert {f"phase:analyze/decide/{c}" for c in DECIDE} <= paths
    nodes = dict(_names(tree))
    # A second tick of an unchanged world hits the solve memo.
    assert nodes["phase:analyze/fused_dispatch/launch"]["attrs"] == {
        "memo": "hit"}
    assert nodes["phase:analyze/fused_dispatch"]["attrs"] == {
        "models": 6, "rows": 12}
    assert nodes["phase:analyze/decide/record"]["attrs"] == {"models": 6}
    assert nodes["phase:fingerprint/hash"]["attrs"] == {"models": 6}
    analyze = nodes["phase:analyze"]["attrs"]
    assert set(analyze) == {"queries", "memo_hits", "demuxed"}
    assert analyze["queries"] + analyze["memo_hits"] > 0
    assert analyze["demuxed"] > 0
    for phase in ("phase:prepare", "phase:fingerprint", "phase:apply"):
        assert set(nodes[phase]["attrs"]) == {"queries", "memo_hits",
                                              "demuxed"}
    # O(1) spans a tick beyond the per-model ones: the decision stage's
    # record is one span for every model.
    assert sum(p.endswith("/record") for p in paths) == 2


def test_harness_tick_tree_holds_the_tuner_step():
    """The headline world's SLO tick (fused, the EKF tuner live): the tuner
    step and its h-and-H launch are spans under the model's analysis."""
    import chip_smoke
    from wva_tpu_torch import fused

    fused.clear_solve_memo()
    chip_smoke.drain_decision_bus()
    harness = chip_smoke.world_harness("cpu")
    engine = harness.manager.engine
    seen = set()

    def watch(h, t):
        tree = engine.spans.last_tree()
        if tree is not None:
            seen.update(_paths(tree))

    try:
        harness.run(400, on_step=watch)
    finally:
        harness.manager.shutdown()
    assert "phase:analyze/model/analyze/tuner_step/h_jacobian" in seen
    for path in ("phase:analyze/fused_grids", "phase:analyze/decide",
                 *(f"phase:analyze/decide/{c}" for c in DECIDE
                   if c != "record")):
        assert path in seen, path
    assert engine.slo_tuner._tuners


def test_spans_on_and_off_statuses_and_cycles_byte_identical(monkeypatch):
    def run(spans):
        mgr, clock, feed, _ = _fleet(5, spans=spans, monkeypatch=monkeypatch)
        try:
            for _ in range(5):
                mgr.engine.executor.tick()
                clock.advance(5.0)
                feed(clock.now())
            mgr.flight_recorder.flush()
            cycles = mgr.flight_recorder.snapshot()
            assert cycles and cycles[-1]["models"] and cycles[-1]["decisions"]
            return (json.dumps(_statuses(mgr.client), sort_keys=True),
                    json.dumps(cycles, sort_keys=True), mgr.spans)
        finally:
            mgr.shutdown()

    on_st, on_cy, on_spans = run(True)
    off_st, off_cy, off_spans = run(False)
    assert on_st == off_st
    assert on_cy == off_cy
    assert on_spans is not None and on_spans.ticks_total == 5
    assert off_spans is None


def test_a_tick_raising_in_the_decision_stage_leaves_nested_ranges(
        monkeypatch):
    """The decision stage opens ``decide`` and ``finalize`` by hand; an
    exception inside them fails the tick, whose phase and root close
    their ranges innermost first. The next tick records afresh."""
    from wva_tpu_torch.pipeline import vectorized

    class Stop(Exception):
        pass

    def finalize_fleet(*args, **kwargs):
        raise Stop

    mgr, clock, feed, _ = _fleet(3)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with monkeypatch.context() as m:
                m.setattr(vectorized, "finalize_fleet", finalize_fleet)
                # One attempt (the executor would retry it).
                with pytest.raises(Stop):
                    mgr.engine.executor.task()
            failed = mgr.spans.last_tree()
            assert not mgr.spans._ranges
            clock.advance(5.0)
            feed(clock.now())
            mgr.engine.executor.tick()
            tree = mgr.spans.last_tree()
    finally:
        mgr.shutdown()
    assert failed["outcome"] == "error"
    assert "phase:analyze/decide/finalize/vec_finalize" in _paths(failed)
    assert tree["outcome"] == "success"
    assert "phase:analyze/decide/limiter" in _paths(tree)
    ranges = _wva_ranges(prof)
    assert _nests(ranges)
    names = [n for n, _, _ in ranges]
    assert names.count("wva:tick") == 2
    assert names.count("wva:decide") == 2
    first_analyze = next(r for r in ranges if r[0] == "wva:phase:analyze")
    first_decide = next(r for r in ranges if r[0] == "wva:decide")
    assert first_analyze[1] <= first_decide[1]
    assert first_decide[2] <= first_analyze[2]


def test_engine_keeps_no_stage_timers():
    mgr, clock, feed, _ = _fleet(2)
    try:
        mgr.engine.executor.tick()
        assert not hasattr(mgr.engine, "last_tick_stage_seconds")
    finally:
        mgr.shutdown()
