"""The readers of the program's own spans, and the trace's reduction
beside the program's ``wva:`` profiler ranges.

- On a synthetic event list, ``reduce_trace`` reads the same busy time,
  kernels, device operations and idle split with and without host-side
  ``wva:`` ranges (the program's ranges are host events; the card test of
  the port, ``tests/test_torch_spans.py``, holds that none reaches the
  device's timeline).
- Each reader returns its value from a hand-built record, and None where
  its spans are missing (a program that does not record them)."""

from __future__ import annotations

import types

import pytest

from portbench import core

CPU, CUDA = "DeviceType.CPU", "DeviceType.CUDA"


def _event(name, start, end, device=CPU):
    return types.SimpleNamespace(
        name=name, device_type=device,
        time_range=types.SimpleNamespace(start=start, end=end))


BASE = [
    _event("portbench:window", 0, 1000),
    _event("portbench:tick", 10, 600),
    _event("portbench:phase:analyze", 50, 500),
    _event("sizing_bisection_kernel", 100, 150, CUDA),
    _event("fit_grid_kernel", 300, 320, CUDA),
    _event("Memcpy DtoH", 330, 335, CUDA),
    _event("portbench:world step", 650, 900),
]
PROGRAM = [
    _event("wva:tick", 12, 598),
    _event("wva:phase:analyze", 49, 501),
    _event("wva:decide", 200, 450),
    _event("wva:finalize", 210, 260),
    _event("wva:fused_dispatch", 90, 340),
    _event("wva:launch", 95, 160),
]


def test_reduce_trace_reads_alike_beside_program_ranges():
    plain = core.reduce_trace(BASE, 1e-3)
    traced = core.reduce_trace(sorted(BASE + PROGRAM,
                                      key=lambda e: e.time_range.start),
                               1e-3)
    assert traced == plain
    assert plain["busy_s"] == pytest.approx(75e-6)
    assert set(plain["kernels"]) == {"sizing_bisection_kernel",
                                     "fit_grid_kernel", "Memcpy DtoH"}


def _ctx(ticks):
    rec = core.Record(0)
    rec.ticks = ticks
    return core.Context(rec, None, {})


TICK = {"phase:fingerprint": 6.0, "phase:fingerprint/versions": 4.0,
        "phase:fingerprint/versions/backend_query": 3.0,
        "phase:fingerprint/hash": 1.5,
        "phase:analyze": 40.0, "phase:analyze/fused_grids": 2.5,
        "phase:analyze/model/prepare/backend_query": 5.0,
        "phase:analyze/decide": 12.0, "phase:analyze/decide/record": 1.0,
        "phase:apply": 9.0}
PARENT = {"phase:fingerprint": 6.0, "phase:analyze": 40.0,
          "phase:analyze/model/prepare": 8.0, "phase:apply": 9.0}


@pytest.mark.parametrize("metric, want", [
    ("decide_ms.tick", (12.0 + 10.0) / 2),
    ("fingerprint_ms.tick", (6.0 + 4.0) / 2),
    ("fused_grids_ms.tick", (2.5 + 0.0) / 2),
    ("query_ms.fleet", (8.0 + 2.0) / 2),
])
def test_reader_means_its_spans_over_the_ticks(metric, want):
    second = {"phase:fingerprint": 4.0, "phase:analyze/decide": 10.0,
              "phase:fingerprint/versions/backend_query": 2.0}
    ticks = [{"ms": 50.0, "spans": TICK}, {"ms": 40.0, "spans": second},
             {"ms": 30.0}]
    read = core.load_module("metrics", metric).read
    assert read(_ctx(ticks)) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["decide_ms.tick", "fused_grids_ms.tick",
                                    "query_ms.fleet", "fingerprint_ms.tick"])
def test_reader_is_none_where_its_spans_are_missing(metric):
    read = core.load_module("metrics", metric).read
    assert read(_ctx([{"ms": 1.0}])) is None
    assert read(_ctx([])) is None
    parent = read(_ctx([{"ms": 1.0, "spans": PARENT}]))
    if metric == "fingerprint_ms.tick":
        assert parent == 6.0  # the phase span the parent records too
    else:
        assert parent is None


def test_readers_match_whole_names():
    from portbench.program_spans import ends_in

    assert ends_in("phase:analyze/decide", "decide")
    assert ends_in("decide", "decide")
    assert not ends_in("phase:analyze/undecide", "decide")
    assert not ends_in("phase:analyze/decide/record", "decide")
