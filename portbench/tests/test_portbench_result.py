"""The run's result line and its guards: the keys of the last line, the
trace's reduction, the look for forbidden modules, and the exits without a
card or without the program."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import core, run
from portbench.tests import small

CHECKOUT = Path(__file__).resolve().parents[2]


def test_forbidden_modules_compare_whole_top_level_names():
    found = core.forbidden_loaded(["wva_tpu_torch", "wva_tpu_torch.fused",
                                   "jaxtyping", "wva_tpu.fused", "jaxlib",
                                   "flax.linen", "numpy"])
    assert found == ["flax.linen", "jaxlib", "wva_tpu.fused"]


def event(name, start, end, device):
    kind = "DeviceType.CUDA" if device else "DeviceType.CPU"
    return SimpleNamespace(name=name, device_type=kind,
                           time_range=SimpleNamespace(start=start, end=end))


def test_trace_reduction():
    events = [event("portbench:tick", 0, 1000, False),
              event("portbench:fused program", 100, 300, False),
              event("k1", 120, 150, True), event("k2", 140, 170, True),
              event("k1", 250, 260, True), event("k3", 800, 900, True)]
    trace = core.reduce_trace(events, window_s=1e-3)
    # Busy is the union of device intervals: 120-170, 250-260, 800-900.
    assert trace["busy_s"] == pytest.approx(160e-6)
    assert trace["kernels"]["k1"] == pytest.approx([30e-6, 10e-6])
    # The gap 170-250 lies in the fused program; of 260-800, 260-300 lies
    # in the fused program and 300-800 in the tick around it.
    idle = dict(trace["idle_gaps"])
    assert idle["fused program"] == pytest.approx(120e-6)
    assert idle["tick"] == pytest.approx(500e-6)
    assert "outside" not in idle
    assert trace["device_ops"][0][0] == "k3"


def test_idle_outside_every_range():
    events = [event("portbench:tick", 0, 100, False),
              event("k1", 50, 60, True), event("k2", 150, 160, True)]
    idle = dict(core.reduce_trace(events, window_s=1e-3)["idle_gaps"])
    assert idle["tick"] == pytest.approx(40e-6)
    assert idle["outside"] == pytest.approx(50e-6)


def test_empty_trace_has_no_kernels():
    trace = core.reduce_trace([event("portbench:tick", 0, 10, False)], 1.0)
    assert trace["kernels"] == {} and trace["busy_s"] == 0.0


def cpu_run(workload, trace, **kwargs):
    with small.cells(**kwargs):
        args = run.parse(["--workload", workload, "--seed", "2700000001",
                          "--seconds", "3", "--trace", str(trace)])
        return run.run(args, device="cpu")


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(trace):
    result = cpu_run("fleet-1000x2.busy", trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(result) == keys + ["compared"]
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "collect_ms.fleet" in result["metrics"]
    else:
        assert set(result["metrics"]) == {"tick_ms", "setup_s"}
    assert result["correct"] is True
    for value in result["compared"].values():
        assert set(value) == {"value", "limit"}
    json.dumps(result)


def test_exits_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mixtral-8x7b-v5e8.ramp", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=CHECKOUT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_exits_with_only_the_benchmark_files(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mixtral-8x7b-v5e8.ramp", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_phase_ranges_hold_the_phases_work():
    """The engine's phases appear as host ranges around their work: the
    fused program runs inside ``phase:analyze``."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.drivers import fleet_feed

    with small.cells():
        _, config, traffic = core.cell("fleet-1000x2.busy")
        rec = core.Record()
        rec.recording = True
        drv = fleet_feed.Driver(config, traffic, 11, "cpu", rec)
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                drv.tick()
        finally:
            drv.close()
    spans = {e.name: e.time_range for e in prof.events()
             if e.name.startswith("portbench:")}
    analyze, fused = spans["portbench:phase:analyze"], \
        spans["portbench:fused program"]
    assert analyze.start <= fused.start and fused.end <= analyze.end
    assert {"portbench:phase:prepare", "portbench:phase:apply"} <= set(spans)
