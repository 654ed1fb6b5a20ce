"""The port stands alone: no ``jax``, no ``wva_tpu``, and no silent CPU.

- A subprocess that refuses to import ``jax`` and ``wva_tpu`` (but not
  ``wva_tpu_torch``) imports every port module and runs one engine tick of
  a small fleet through the Manager on the CPU.
- An AST lint finds no ``jax`` or ``wva_tpu`` import in any port file or in
  ``chip_smoke.py``.
- The host-only modules the port keeps as copies still equal their JAX
  package originals with the package name repointed; the copies the port
  has since edited keep the originals' public functions, classes and
  parameters.
- Entry points given ``device=None`` raise where there is no CUDA device,
  and ``chip_smoke.py`` fails without a card or without the repo.

The tick is ``chip_smoke.fleet_world``'s at two models: collection, the SLO
analyzer, the fused program, forecasting, the fleet solve for a model in a
"global" namespace, and actuation.
"""

import ast
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "wva_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


_BLOCKED_RUN = r'''
import importlib, importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "wva_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
for mod in MODULES:
    importlib.import_module(mod)

import chip_smoke

mgr, clock, feed, models = chip_smoke.fleet_world(2, device="cpu")
mgr.engine.executor.tick()
mgr.flight_recorder.flush()
(record,) = mgr.flight_recorder.snapshot()
decisions = chip_smoke.fleet_decisions(record)
mgr.shutdown()
assert len(decisions) == 4, decisions
assert {d[3] for d in decisions} & {"scale-up", "scale-down"}, decisions
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "wva_tpu")]
assert not bad, bad
print("OK", len(decisions))
'''


def test_port_imports_and_runs_with_jax_and_reference_blocked():
    code = f"MODULES = {_port_modules()!r}\n" + _BLOCKED_RUN
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK ")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "wva_tpu"), f"{path}: {name}"


# Each port module is one of three kinds:
# - a verbatim copy of the JAX package's module, held byte for byte with only
#   the package name repointed (``VERBATIM_COPIES``; ``LAZY_YAML_COPIES`` and
#   ``config/slo.py`` move their ``import yaml`` and nothing else);
# - a copy the port has since edited and owns (``OWNED_COPIES``), held by the
#   reference's interface and by tests that run both packages;
# - a hand port or a module written for the port (``PORT_MODULES``).
#
# Packages copied whole are listed by package: every module of the reference
# package (not of its subpackages) is held, but for the owned copies among
# them.
VERBATIM_PACKAGES = [
    "actuator", "analyzers", "analyzers/saturation", "analyzers/saturation_v2",
    "api", "blackbox", "capacity", "collector", "collector/registration",
    "collector/source", "constants", "datastore", "discovery", "engines",
    "engines/common", "engines/executor", "engines/scalefromzero",
    "federation", "health", "indexers", "interfaces", "metrics", "obs",
    "pipeline", "resilience", "shard",
]
VERBATIM_MODULES = [
    "leaderelection.py",
    "analyzers/queueing/params.py",
    "config/__init__.py", "config/config.py", "config/types.py",
    "config/validation.py",
    "controller/__init__.py", "controller/inferencepool_reconciler.py",
    "controller/predicates.py", "controller/va_reconciler.py",
    "emulator/__init__.py", "emulator/external_metrics.py",
    "emulator/faults.py", "emulator/gke_provisioner.py", "emulator/hpa.py",
    "emulator/kubelet.py", "emulator/profiles.py", "emulator/prom_pod.py",
    "emulator/prom_server.py", "emulator/server_sim.py",
    "emulator/sim_pod.py",
    "engines/saturation/__init__.py",
    "fleet/system.py",
    "forecast/__init__.py", "forecast/apply.py", "forecast/history.py",
    "forecast/leadtime.py",
    "fused/__init__.py",
    "k8s/__init__.py", "k8s/authz.py", "k8s/client.py", "k8s/events.py",
    "k8s/fake_apiserver.py", "k8s/informer.py", "k8s/objects.py",
    "k8s/rest.py", "k8s/serde.py", "k8s/snapshot.py",
    "serving.py",
    "sweep/__init__.py", "sweep/knobs.py",
    "tools/__init__.py",
    "utils/__init__.py", "utils/backoff.py", "utils/clock.py",
    "utils/dispatch.py", "utils/durations.py", "utils/freeze.py",
    "utils/oncemap.py", "utils/pool.py", "utils/scale_target.py",
    "utils/seeds.py", "utils/variant.py",
]

# Copies the port has edited and owns (the device it hands on, its spans,
# the collector policy, its speed-ups). A change to one is one diff, held by
# ``test_owned_copies_keep_the_reference_interface`` and by the tests that
# run the module beside the reference on the same inputs (B) or in the port
# alone (P):
#
# engines/saturation/engine.py, main.py, fleet/__init__.py, fleet/solver.py,
# forecast/planner.py:
#   B test_torch_fleet_tick.py (decisions, trace model records, plans),
#   B test_torch_emulator.py (decision golden, headline world),
#   B test_torch_device_plumbing.py (0/1/2/4 shards, federation),
#   P test_torch_spans.py, test_torch_shard_spans.py (spans on and off
#   byte-identical), P test_torch_gcpolicy.py
# emulator/harness.py, emulator/loadgen.py: B test_torch_emulator.py,
#   B test_torch_sweep.py (arrival tables), P test_loadgen_rate_at_on_torch_*
# shard/plane.py: B test_torch_golden_shard.py,
#   B test_torch_device_plumbing.py, P test_torch_shard_spans.py
# emulator/federation.py: B test_torch_golden_federation.py,
#   B test_torch_device_plumbing.py
# sweep/search.py, sweep/cli.py: B test_torch_sweep.py (the smoke search's
#   recommendations, the CLI's artifact), P its recommendations golden,
#   P test_torch_cli.py
# sweep/fidelity.py: B test_torch_fidelity.py
# forecast/backtest.py, tools/fit_profile.py: B test_torch_cli.py (the
#   backtest's report, fit_profile's verdicts), P its backtest golden gate
# __main__.py: B test_torch_replay.py (seven goldens), P test_torch_cli.py
# collector/source/grouped.py: B test_torch_fleet_tick.py (collected
#   inputs), P test_torch_shard_spans.py (the warm set)
# blackbox/schema.py: B test_torch_replay.py, P test_torch_shard_spans.py
# obs/spans.py: B test_torch_spans.py (committed trees), P its ranges
#
# A change that first edits a verbatim copy moves it here and names the
# tests that hold its behaviour.
OWNED_COPIES = [
    "__main__.py", "main.py", "blackbox/schema.py",
    "collector/source/grouped.py", "emulator/federation.py",
    "emulator/harness.py", "emulator/loadgen.py",
    "engines/saturation/engine.py", "fleet/__init__.py", "fleet/solver.py",
    "forecast/backtest.py", "forecast/planner.py", "obs/spans.py",
    "shard/plane.py", "sweep/cli.py", "sweep/fidelity.py", "sweep/search.py",
    "tools/fit_profile.py",
]
VERBATIM_COPIES = sorted(set(VERBATIM_MODULES) | {
    str(path.relative_to(ROOT / "wva_tpu"))
    for package in VERBATIM_PACKAGES
    for path in sorted((ROOT / "wva_tpu" / package).glob("*.py"))}
    - set(OWNED_COPIES))

# Copies whose module-level ``import yaml`` moved into the functions that
# parse YAML (how many, by module): the engine path parses none, and the
# card's machine has no PyYAML. ``config/slo.py`` is held by its own test
# below.
LAZY_YAML_COPIES = {
    "config/helpers.py": 1,
    "config/loader.py": 1,
    "config/scale_to_zero.py": 1,
    "controller/configmap_reconciler.py": 1,
    "k8s/kubeconfig.py": 1,
    "utils/helmlite.py": 3,
}

# Modules written for the port (hand ports of jax code, the kernels'
# wrappers and builds, the graft entry points that ``__graft_entry__.py``
# holds for the JAX package, the collector policy).
PORT_MODULES = [
    "__init__.py", "device.py", "cuda_build.py", "entry.py",
    "analyzers/queueing/__init__.py", "analyzers/queueing/_build.py",
    "analyzers/queueing/analyzer.py", "analyzers/queueing/chain_common.py",
    "analyzers/queueing/chain_setup.py",
    "analyzers/queueing/chain_stats.py", "analyzers/queueing/convert.py",
    "analyzers/queueing/jacobian_kernel.py",
    "analyzers/queueing/queue_model.py", "analyzers/queueing/sizing_kernel.py",
    "analyzers/queueing/tuner.py",
    "config/slo.py",
    "fleet/allocation.py",
    "forecast/fit_kernel.py", "forecast/forecasters.py",
    "fused/grids.py", "fused/program.py",
    "sweep/scan_kernel.py", "sweep/world.py",
    "utils/gcpolicy.py",
]


@pytest.mark.parametrize("rel", VERBATIM_COPIES)
def test_copies_match_reference(rel):
    want = re.sub(r"\bwva_tpu\b", "wva_tpu_torch",
                  (ROOT / "wva_tpu" / rel).read_text())
    assert (PORT / rel).read_text() == want


def _expr(node) -> str:
    return re.sub(r"\bwva_tpu\b", "wva_tpu_torch", ast.unparse(node))


def _params(fn):
    """A def's parameters in order: (name, kind, default's source or None)."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + a.defaults
    out = [(p.arg, "positional", d) for p, d in zip(pos, defaults)]
    out += [(p.arg, "*args", None) for p in (a.vararg,) if p]
    out += [(p.arg, "keyword-only", d)
            for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    out += [(p.arg, "**kwargs", None) for p in (a.kwarg,) if p]
    return [(name, kind, d and _expr(d)) for name, kind, d in out]


def _dataclass_init(cls):
    """The ``__init__`` a dataclass is given: its public annotated fields."""
    if not any(re.match(r"(dataclasses\.)?dataclass\b", _expr(d))
               for d in cls.decorator_list):
        return None
    return [("self", "positional", None)] + [
        (f.target.id, "positional", f.value and _expr(f.value))
        for f in cls.body
        if isinstance(f, ast.AnnAssign) and isinstance(f.target, ast.Name)
        and not f.target.id.startswith("_")]


def _interface(path):
    """A module's public top-level functions and classes, and each class's
    public methods and ``__init__``: ``name`` or ``Class.method`` -> (kind,
    parameters; None for a class)."""
    defs = (ast.FunctionDef, ast.AsyncFunctionDef)

    def kind(fn):
        marks = {_expr(d).split(".")[-1] for d in fn.decorator_list} & {
            "staticmethod", "classmethod", "property", "setter"}
        return " ".join([type(fn).__name__, *sorted(marks)])

    api = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, defs) and not node.name.startswith("_"):
            api[node.name] = (kind(node), _params(node))
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            api[node.name] = ("class", None)
            init = _dataclass_init(node)
            if init is not None:
                api[f"{node.name}.__init__"] = ("FunctionDef", init)
            api.update((f"{node.name}.{m.name}", (kind(m), _params(m)))
                       for m in node.body if isinstance(m, defs) and (
                           m.name == "__init__" or not m.name.startswith("_")))
    return api


def _extension_faults(ref, port):
    """How ``port``'s parameters fail to extend ``ref``'s: each reference
    parameter kept, in order, of the same kind and default; each added one
    defaulted, and after the reference's if it is positional."""
    at = {name: i for i, (name, _, _) in enumerate(port)}
    kept = [at[name] for name, _, _ in ref if name in at]
    faults = [f"{name} dropped" for name, _, _ in ref if name not in at]
    faults += [f"{port[at[p[0]]]} is {p} in the reference" for p in ref
               if p[0] in at and port[at[p[0]]] != p]
    if kept != sorted(kept):
        faults.append("the reference's parameters out of order")
    last = max((at[name] for name, kind, _ in ref
                if name in at and kind == "positional"), default=-1)
    for i, (name, kind, default) in enumerate(port):
        if name in {p[0] for p in ref}:
            continue
        if default is None:
            faults.append(f"{name} added without a default")
        if kind == "positional" and i < last:
            faults.append(f"{name} added before the reference's parameters")
    return faults


@pytest.mark.parametrize("rel", OWNED_COPIES)
def test_owned_copies_keep_the_reference_interface(rel):
    """What callers of an owned copy rely on stays: the reference's public
    functions and classes, of the same kind, and the parameters of each
    function, public method and ``__init__`` (a dataclass's public fields),
    which the port may only extend with defaulted ones. Read with ``ast``:
    neither module is imported."""
    ref = _interface(ROOT / "wva_tpu" / rel)
    port = _interface(PORT / rel)
    faults = []
    for name, (kind, params) in ref.items():
        if name not in port:
            faults.append(f"{name} missing")
        elif port[name][0] != kind:
            faults.append(f"{name} is a {port[name][0]}, not a {kind}")
        elif params is not None:
            faults += [f"{name}: {f}"
                       for f in _extension_faults(params, port[name][1])]
    assert ref and not faults, faults


_LAZY_YAML = (
    "    # PyYAML is imported here, not at module import: the sizing pass never\n"
    "    # parses YAML, and the port must import where PyYAML is not installed.\n"
    "    import yaml\n\n")


def test_slo_config_copy_differs_only_in_lazy_yaml_import():
    ref = re.sub(r"\bwva_tpu\b", "wva_tpu_torch",
                 (ROOT / "wva_tpu" / "config" / "slo.py").read_text())
    port = (PORT / "config" / "slo.py").read_text()
    assert _LAZY_YAML in port
    assert port.replace(_LAZY_YAML, "") == ref.replace("import yaml\n\n", "", 1)


@pytest.mark.parametrize("rel", sorted(LAZY_YAML_COPIES))
def test_lazy_yaml_copies_import_yaml_where_they_parse_it(rel):
    ref = re.sub(r"\bwva_tpu\b", "wva_tpu_torch",
                 (ROOT / "wva_tpu" / rel).read_text())
    port = (PORT / rel).read_text()
    assert "\nimport yaml\n" not in port
    assert (re.sub(r"(?m)^ +import yaml\n\n", "", port)
            == ref.replace("import yaml\n\n", "", 1))
    users = 0
    for fn in ast.walk(ast.parse(port)):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        uses = any(isinstance(n, ast.Name) and n.id == "yaml"
                   for n in ast.walk(fn))
        imports = any(isinstance(n, ast.Import)
                      and [a.name for a in n.names] == ["yaml"]
                      for n in ast.walk(fn))
        assert uses == imports, fn.name
        users += uses
    assert users == LAZY_YAML_COPIES[rel]


def test_loadgen_rate_at_on_torch_tensors_equals_numpy():
    from wva_tpu_torch.emulator import loadgen as lg

    profiles = [
        lg.constant(3.0),
        lg.step_profile([(10.0, 2.0), (50.0, 7.0)]),
        lg.ramp(2.0, 40.0, 120.0, hold=60.0, delay=5.0),
        lg.trapezoid(4.0, 90.0, 300.0, 1200.0, 300.0, tail=300.0, delay=180.0),
        lg.diurnal(5.0, 20.0, 600.0, phase=30.0),
        lg.regional(lg.diurnal(5.0, 20.0, 600.0), 1, 3, 600.0),
        lg.poisson_bursts(2.0, 30.0, 40.0, 15.0, seed=7),
        lg.SpikeProfile(idle_until=100.0, spike_rate=12.0,
                        spike_duration=30.0),
    ]
    t = np.arange(0.0, 2400.0, 0.5)
    for prof in profiles:
        want = np.asarray(prof.rate_at(t), dtype=np.float64)
        got = prof.rate_at(torch.as_tensor(t, dtype=torch.float64))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


def test_every_port_module_is_a_copy_or_a_port():
    copies = set(VERBATIM_COPIES) | set(LAZY_YAML_COPIES) | set(OWNED_COPIES)
    found = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert found == copies | set(PORT_MODULES)
    assert not copies & set(PORT_MODULES)
    for rel in copies:
        assert (ROOT / "wva_tpu" / rel).exists(), rel


def test_every_reference_module_has_a_port_counterpart():
    """The two packages' module lists differ only by the Pallas kernel,
    whose counterpart is the CUDA sizing kernel and its wrapper."""
    ref = {str(p.relative_to(ROOT / "wva_tpu"))
           for p in (ROOT / "wva_tpu").rglob("*.py")}
    port = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert ref - port == {"analyzers/queueing/pallas_kernel.py"}


class _Captured(Exception):
    pass


class _HarnessRecorder:
    """Stands in for ``EmulationHarness``: records how the world is built
    and stops at ``run``."""

    def __init__(self, record, variants, **kwargs):
        record.update(variants=variants, kwargs=kwargs,
                      window=os.environ.get("WVA_SLO_ARRIVAL_RATE_WINDOW"))
        self.config = types.SimpleNamespace(
            update_slo_config=lambda data: record.update(slo=data))
        self.record = record

    def run(self, duration, on_step=None):
        self.record["duration"] = duration
        raise _Captured


def _plain(x):
    """A dataclass tree as plain values (the two packages' classes differ)."""
    return json.loads(json.dumps(dataclasses.asdict(x), default=repr))


def test_chip_smoke_restates_the_bench_headline_world(monkeypatch):
    """chip_smoke.py cannot import bench.py (it imports the JAX package),
    so it restates ``run_policy("ours-realistic")``: the constants, the
    variant, its load, the saturation and SLO configs, the harness's
    arguments and the world's length must equal bench.py's."""
    monkeypatch.delenv("WVA_BENCH_SEED", raising=False)
    monkeypatch.delenv("WVA_BENCH_TRACE", raising=False)
    sys.path.insert(0, str(ROOT))
    import bench
    import chip_smoke

    for name in ("MODEL", "SLO_TTFT_SECONDS", "WARMUP_SECONDS",
                 "RAMP_SECONDS", "HOLD_SECONDS", "DOWN_SECONDS",
                 "TAIL_SECONDS", "BASE_RATE", "PEAK_RATE", "STARTUP_SECONDS",
                 "STOCHASTIC_SEED", "TOKEN_MIXTURE", "MISCAL_FACTOR",
                 "PROFILE_ALPHA_MS", "PROFILE_BETA", "PROFILE_GAMMA",
                 "TRUE_PARMS", "FAST_HPA"):
        assert getattr(chip_smoke, name) == getattr(bench, name), name
    ref, port = {}, {}
    monkeypatch.setattr(bench, "EmulationHarness",
                        lambda *a, **k: _HarnessRecorder(ref, *a, **k))
    with pytest.raises(_Captured):
        bench.run_policy("ours-realistic")
    monkeypatch.setattr(chip_smoke, "EmulationHarness",
                        lambda *a, **k: _HarnessRecorder(port, *a, **k))
    with pytest.raises(_Captured):
        chip_smoke.world_harness("cpu").run(chip_smoke.WORLD_SECONDS)
    assert "WVA_SLO_ARRIVAL_RATE_WINDOW" not in os.environ
    assert port["window"] == ref["window"] == "30s"
    assert port["duration"] == ref["duration"] == 2280.0
    assert _plain(port["slo"]) == _plain(ref["slo"])
    assert ref["slo"].tuner_enabled
    (pv,), (rv,) = port["variants"], ref["variants"]
    assert ({k: v for k, v in _plain(pv).items() if k != "load"}
            == {k: v for k, v in _plain(rv).items() if k != "load"})
    t = np.arange(0.0, 2400.0, 0.25)
    np.testing.assert_array_equal(pv.load.rate_at(t), rv.load.rate_at(t))
    pk, rk = dict(port["kwargs"]), dict(ref["kwargs"])
    assert (pk.pop("config"), pk.pop("device"), rk.pop("trace_path")) == (
        None, "cpu", None)
    assert _plain(pk.pop("saturation_config")) == _plain(
        rk.pop("saturation_config"))
    assert pk == rk


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_device_none_raises_without_cuda():
    _no_cuda()
    from wva_tpu_torch import resolve_device
    from wva_tpu_torch.analyzers.queueing.analyzer import QueueingModelAnalyzer
    from wva_tpu_torch.analyzers.queueing.params import (
        QueueConfig, RequestSize, ServiceParms)
    from wva_tpu_torch.analyzers.queueing.queue_model import (
        QueueAnalyzer, candidate_batch)

    msg = "CUDA device required"
    with pytest.raises(RuntimeError, match=msg):
        resolve_device(None)
    with pytest.raises(RuntimeError, match=msg):
        QueueingModelAnalyzer()
    with pytest.raises(RuntimeError, match=msg):
        candidate_batch([5.0], [0.01], [0.001], [100], [50], [8], [64])
    with pytest.raises(RuntimeError, match=msg):
        QueueAnalyzer(QueueConfig(max_batch_size=8, max_queue_size=56,
                                  service_parms=ServiceParms(
                                      alpha=5.0, beta=0.01, gamma=0.001)),
                      RequestSize(avg_input_tokens=100, avg_output_tokens=50))
    assert resolve_device("cpu") == torch.device("cpu")


def test_fused_fleet_and_fits_need_a_card_without_device():
    _no_cuda()
    from wva_tpu_torch import fused
    from wva_tpu_torch.fleet import FleetSystem, build_candidates, solve
    from wva_tpu_torch.forecast import forecasters as fc
    from wva_tpu_torch.forecast.planner import CapacityPlanner

    msg = "CUDA device required"
    with pytest.raises(RuntimeError, match=msg):
        build_candidates(FleetSystem())
    with pytest.raises(RuntimeError, match=msg):
        solve(FleetSystem())
    grids = fused.FleetGrids()
    with pytest.raises(RuntimeError, match=msg):
        fused.build_candidate_axis(grids, {"m|ns": type(
            "Plan", (), {"candidates": [object()]})()}, ["m|ns"])
    with pytest.raises(RuntimeError, match=msg):
        fused.build_model_axis(grids, [], [], [], [], [], [], [])
    g = fc.SeriesGrids(fine=[1.0] * fc.N_GRID, fine_valid=fc.N_GRID,
                       long=[1.0] * fc.N_GRID, long_valid=fc.N_GRID,
                       h_fine_steps=1.0, h_long_steps=0.1, season_steps=64)
    with pytest.raises(RuntimeError, match=msg):
        fc.fit_batch([g])
    with pytest.raises(RuntimeError, match=msg):
        fc.fit_serial([g])
    with pytest.raises(RuntimeError, match=msg):
        CapacityPlanner().plan([], 0.0)
    assert fc.fit_batch([g], "cpu")[0]["linear"] == 1.0


def test_control_loop_needs_a_card_without_device():
    _no_cuda()
    from wva_tpu_torch.analyzers.queueing import (
        KalmanTuner, PerfProfileStore, ServiceParms, TunerController)
    from wva_tpu_torch.collector.source import TimeSeriesDB
    from wva_tpu_torch.config import new_test_config
    from wva_tpu_torch.emulator import EmulationHarness
    from wva_tpu_torch.engines.saturation import SaturationEngine
    from wva_tpu_torch.k8s.client import FakeCluster
    from wva_tpu_torch.main import build_manager
    from wva_tpu_torch.utils.clock import FakeClock

    msg = "CUDA device required"
    clock = FakeClock(0.0)
    with pytest.raises(RuntimeError, match=msg):
        KalmanTuner(ServiceParms(alpha=6.973, beta=0.027, gamma=0.001))
    with pytest.raises(RuntimeError, match=msg):
        TunerController(PerfProfileStore())
    with pytest.raises(RuntimeError, match=msg):
        SaturationEngine(client=None, config=new_test_config(),
                         collector=None, actuator=None, enforcer=None,
                         clock=clock)
    with pytest.raises(RuntimeError, match=msg):
        build_manager(FakeCluster(clock=clock), new_test_config(),
                      clock=clock, tsdb=TimeSeriesDB(clock=clock))
    with pytest.raises(RuntimeError, match=msg):
        EmulationHarness([])


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=240)


def test_chip_smoke_fails_without_cuda():
    _no_cuda()
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
