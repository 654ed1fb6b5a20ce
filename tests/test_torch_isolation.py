"""The port stands alone: no ``jax``, no ``wva_tpu``, and no silent CPU.

- A subprocess that refuses to import ``jax`` and ``wva_tpu`` (but not
  ``wva_tpu_torch``) imports every port module and runs one engine tick of
  a small fleet through the Manager on the CPU.
- An AST lint finds no ``jax`` or ``wva_tpu`` import in any port file or in
  ``chip_smoke.py``.
- The host-only modules the port keeps as copies still equal their JAX
  package originals with the package name repointed.
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


# Host-only modules kept as copies of the JAX package's: only the package
# name differs. Packages copied whole are listed by package: every module of
# the reference package (not of its subpackages) is held, but for those that
# hand on a device (``DEVICE_COPIES``).
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
VERBATIM_COPIES = sorted(set(VERBATIM_MODULES) | {
    str(path.relative_to(ROOT / "wva_tpu"))
    for package in VERBATIM_PACKAGES
    for path in sorted((ROOT / "wva_tpu" / package).glob("*.py"))}
    - {"shard/plane.py"})

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
# holds for the JAX package, the collector policy), and the loadgen copy
# with its own array namespace.
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
    "emulator/loadgen.py",
    "fleet/allocation.py",
    "forecast/fit_kernel.py", "forecast/forecasters.py",
    "fused/grids.py", "fused/program.py",
    "sweep/scan_kernel.py", "sweep/world.py",
    "utils/gcpolicy.py",
]

# Copies that differ from their originals only where the port's device
# reaches the sizing, the fits and the tuner: the planner, the fleet solve,
# the engine, ``build_manager`` and the emulation harness take a ``device``
# (None: the CUDA card) and hand it on. Each pair is (the
# original's text, the port's), and each original text occurs once.
DEVICE_COPIES = {
    "forecast/planner.py": [
        ("                 batched: bool = True) -> None:\n",
         "                 batched: bool = True, device=None) -> None:\n"),
        ("        self.batched = batched\n",
         "        self.batched = batched\n"
         "        # Where the fits run: None is the CUDA card, \"cpu\" the plain\n"
         "        # version.\n"
         "        self.device = device\n"),
        ("                fits = (fc.fit_batch(grids) if self.batched\n"
         "                        else fc.fit_serial(grids))\n",
         "                fits = (fc.fit_batch(grids, self.device) if self.batched\n"
         "                        else fc.fit_serial(grids, self.device))\n"),
        ("            fits = (fc.fit_batch([g for g in grids]) if self.batched\n"
         "                    else fc.fit_serial([g for g in grids]))\n",
         "            fits = (fc.fit_batch([g for g in grids], self.device)\n"
         "                    if self.batched\n"
         "                    else fc.fit_serial([g for g in grids], self.device))\n"),
        ("        fit = fc.fit_batch([self._grids_for(key, now, lead)])[0]\n",
         "        fit = fc.fit_batch([self._grids_for(key, now, lead)],\n"
         "                           self.device)[0]\n"),
    ],
    "fleet/solver.py": [
        ("          presized: dict | None = None) -> Solution:\n",
         "          presized: dict | None = None, device=None) -> Solution:\n"),
        ("    fleet solve re-dispatches nothing.\"\"\"\n",
         "    fleet solve re-dispatches nothing. ``device`` is where the\n"
         "    candidates are sized (None: the CUDA card).\"\"\"\n"),
        ("    candidates = build_candidates(system, presized=presized)\n",
         "    candidates = build_candidates(system, presized=presized,\n"
         "                                  device=device)\n"),
    ],
    "fleet/__init__.py": [
        ("def analyze_model(system: FleetSystem, server_name: str) -> "
         "list[FleetAllocation]:\n",
         "def analyze_model(system: FleetSystem, server_name: str,\n"
         "                  device=None) -> list[FleetAllocation]:\n"),
        ("    return build_candidates(sub).get(server_name, [])\n",
         "    return build_candidates(sub, device=device).get(server_name, [])\n"),
    ],
    "engines/saturation/engine.py": [
        ('        checkpointer=None,\n'
         '    ) -> None:\n',
         '        checkpointer=None,\n'
         '        device=None,\n'
         '    ) -> None:\n'),
        ('        self.slo_analyzer = QueueingModelAnalyzer(clock=self.clock)\n'
         '        self.slo_tuner = TunerController(self.slo_analyzer.profiles)\n',
         "        # Where the sizing, the fits and the tuner's jacobian run: None\n"
         '        # is the CUDA card, "cpu" the kernels\' plain versions.\n'
         '        self.device = device\n'
         '        self.slo_analyzer = QueueingModelAnalyzer(clock=self.clock,\n'
         '                                                  device=device)\n'
         '        self.slo_tuner = TunerController(self.slo_analyzer.profiles,\n'
         '                                         device=device)\n'),
        ('            solution = solve(system, spec, presized=self._tick_presized)\n'
         '        else:\n'
         '            solution = solve(system, spec)\n',
         '            solution = solve(system, spec, presized=self._tick_presized,\n'
         '                             device=self.device)\n'
         '        else:\n'
         '            solution = solve(system, spec, device=self.device)\n'),
        ('        grids = fused.FleetGrids()\n',
         '        grids = fused.FleetGrids(device=self.device)\n'),
    ],
    "main.py": [
        ('    prom_api=None,\n'
         ') -> Manager:\n',
         '    prom_api=None,\n'
         '    device=None,\n'
         ') -> Manager:\n'),
        ('    with a fault injector); None derives it from ``tsdb``/config.\n',
         '    with a fault injector); None derives it from ``tsdb``/config.\n'
         "    ``device`` is where the engine's sizing, fits and tuner run (None:\n"
         '    the CUDA card).\n'),
        ('            prewake_min_demand=fc_cfg.prewake_min_demand)\n',
         '            prewake_min_demand=fc_cfg.prewake_min_demand,\n'
         '            device=device)\n'),
        ('        checkpointer=checkpointer)\n'
         '    engine.boot_report = boot_report\n',
         '        checkpointer=checkpointer,\n'
         '        device=device)\n'
         '    engine.boot_report = boot_report\n'),
        ('            registry=registry)\n',
         '            registry=registry, device=device)\n'),
    ],
    "emulator/harness.py": [
        ('        fault_plan=None,\n'
         '    ) -> None:\n'
         '        self.namespace = namespace\n',
         '        fault_plan=None,\n'
         '        device=None,\n'
         '    ) -> None:\n'
         '        self.namespace = namespace\n'
         "        # Where the manager's engine computes (None: the CUDA card).\n"
         '        self.device = device\n'),
        ('            prom_api=self._manager_prom_api)\n',
         '            prom_api=self._manager_prom_api, device=self.device)\n'),
    ],
    "shard/plane.py": [
        ("                      identity: str, registry=None) -> ShardPlane:\n",
         "                      identity: str, registry=None,\n"
         "                      device=None) -> ShardPlane:\n"),
        ("    when ``WVA_SHARDING`` is on.\"\"\"\n",
         "    when ``WVA_SHARDING`` is on. ``device`` is where every worker engine\n"
         "    sizes, fits and tunes (None: the CUDA card).\"\"\"\n"),
        ("            forecast_planner=forecast_planner, health=health)\n",
         "            forecast_planner=forecast_planner, health=health,\n"
         "            device=device)\n"),
    ],
    "emulator/federation.py": [
        ('    rides this (tests/test_federation.py)."""\n',
         "    rides this (tests/test_federation.py). ``device`` is where every\n"
         "    region's engine computes (None: the CUDA card).\"\"\"\n"),
        ("                 | None = None) -> None:\n",
         "                 | None = None, device=None) -> None:\n"),
        ("                fault_plan=rs.fault_plan)\n",
         "                fault_plan=rs.fault_plan, device=device)\n"),
    ],
    "sweep/search.py": [
        ("                    chunk: int = 256, arrivals=None, faults=None):\n",
         "                    chunk: int = 256, arrivals=None, faults=None,\n"
         "                    device=None):\n"),
        ("                     arrivals=arrivals, faults=faults)\n",
         "                     arrivals=arrivals, faults=faults, device=device)\n"),
        ("                chunk: int = 256) -> SweepResult:\n"
         "    points = kb.grid_points(grid, base)\n"
         "    scores, att, chips, n = evaluate_points(params, points, train_seeds,\n"
         "                                            lam, chunk)\n",
         "                chunk: int = 256, device=None) -> SweepResult:\n"
         "    points = kb.grid_points(grid, base)\n"
         "    scores, att, chips, n = evaluate_points(params, points, train_seeds,\n"
         "                                            lam, chunk, device=device)\n"),
        ("               elite_frac: float = 0.25, chunk: int = 256) -> SweepResult:\n",
         "               elite_frac: float = 0.25, chunk: int = 256,\n"
         "               device=None) -> SweepResult:\n"),
        ("for row in raw]\n"
         "        scores, att, chips, n = evaluate_points(params, pts, train_seeds,\n"
         "                                                lam, chunk)\n",
         "for row in raw]\n"
         "        scores, att, chips, n = evaluate_points(params, pts, train_seeds,\n"
         "                                                lam, chunk, device=device)\n"),
        ("              sigma_frac: float = 0.1, chunk: int = 256) -> SweepResult:\n",
         "              sigma_frac: float = 0.1, chunk: int = 256,\n"
         "              device=None) -> SweepResult:\n"),
        ("# elitism\n"
         "        scores, att, chips, n = evaluate_points(params, pts, train_seeds,\n"
         "                                                lam, chunk)\n",
         "# elitism\n"
         "        scores, att, chips, n = evaluate_points(params, pts, train_seeds,\n"
         "                                                lam, chunk, device=device)\n"),
        ("                 model_idx: int, chunk: int = 256) -> dict:\n",
         "                 model_idx: int, chunk: int = 256, device=None) -> dict:\n"),
        ("    res = run_worlds(params, knob_list, world_seeds, lam, chunk=chunk)\n",
         "    res = run_worlds(params, knob_list, world_seeds, lam, chunk=chunk,\n"
         "                     device=device)\n"),
        ("              incumbent: kb.PolicyKnobs | None = None) -> dict:\n",
         "              incumbent: kb.PolicyKnobs | None = None,\n"
         "              device=None) -> dict:\n"),
        ("                            m, chunk=chunk)\n",
         "                            m, chunk=chunk, device=device)\n"),
        ("              generations: int = 4, population: int = 32) -> dict:\n",
         "              generations: int = 4, population: int = 32,\n"
         "              device=None) -> dict:\n"),
        ("    recommendations report.\"\"\"\n",
         "    recommendations report. ``device`` is where every world runs (None:\n"
         "    the CUDA card).\"\"\"\n"),
        ("        result = grid_search(params, lam, train, grid=grid, chunk=chunk)\n",
         "        result = grid_search(params, lam, train, grid=grid, chunk=chunk,\n"
         "                             device=device)\n"),
        ("                            chunk=chunk)\n    elif algo == \"es\":\n",
         "                            chunk=chunk, device=device)\n"
         "    elif algo == \"es\":\n"),
        ("                           chunk=chunk)\n    else:\n",
         "                           chunk=chunk, device=device)\n    else:\n"),
        ("    report = recommend(params, result, holdout, lam, models, chunk=chunk)\n",
         "    report = recommend(params, result, holdout, lam, models, chunk=chunk,\n"
         "                       device=device)\n"),
    ],
    "sweep/fidelity.py": [
        ("def _event_run(sc: dict) -> dict:\n",
         "def _event_run(sc: dict, device=None) -> dict:\n"),
        ("            stochastic_seed=sc[\"event_seed\"])\n",
         "            stochastic_seed=sc[\"event_seed\"], device=device)\n"),
        ("def _fluid_run(sc: dict, chunk: int = 256) -> dict:\n",
         "def _fluid_run(sc: dict, chunk: int = 256, device=None) -> dict:\n"),
        ("                     chunk=chunk)\n",
         "                     chunk=chunk, device=device)\n"),
        ("def fidelity_check(scenario: dict | None = None, chunk: int = 256) -> dict:\n",
         "def fidelity_check(scenario: dict | None = None, chunk: int = 256,\n"
         "                   device=None) -> dict:\n"),
        ("    tolerances, pass verdict) for BENCH_LOCAL.json / PERF.md.\"\"\"\n",
         "    tolerances, pass verdict) for BENCH_LOCAL.json / PERF.md. Both\n"
         "    worlds run on ``device`` (None: the CUDA card).\"\"\"\n"),
        ("    event = _event_run(sc)\n    fluid = _fluid_run(sc, chunk=chunk)\n",
         "    event = _event_run(sc, device)\n"
         "    fluid = _fluid_run(sc, chunk=chunk, device=device)\n"),
    ],
    "sweep/cli.py": [
        ("def sweep_cli(argv: list[str]) -> int:\n",
         "def sweep_cli(argv: list[str], device=None) -> int:\n"
         "    \"\"\"The sweep runs its worlds on ``device`` (None: the CUDA card).\"\"\"\n"),
        ("        generations=args.generations, population=args.population)\n",
         "        generations=args.generations, population=args.population,\n"
         "        device=device)\n"),
    ],
    "forecast/backtest.py": [
        ("                    min_history: float) -> dict[str, dict]:\n",
         "                    min_history: float, device=None) -> dict[str, dict]:\n"),
        ("            season_steps=fc.SEASON_STEPS)])[0]\n",
         "            season_steps=fc.SEASON_STEPS)], device)[0]\n"),
        ("                 grid_step: float, min_history: float) -> dict:\n",
         "                 grid_step: float, min_history: float,\n"
         "                 device=None) -> dict:\n"),
        ("                                          grid_step, min_history)\n",
         "                                          grid_step, min_history, device)\n"),
        ("def backtest_cli(argv: list[str] | None = None) -> int:\n",
         "def backtest_cli(argv: list[str] | None = None, device=None) -> int:\n"),
        ("                              else args.min_history)\n",
         "                              else args.min_history, device)\n"),
        ("def forecast_cli(argv: list[str] | None = None) -> int:\n",
         "def forecast_cli(argv: list[str] | None = None, device=None) -> int:\n"),
        ("forecast <subcommand>`` dispatcher.\"\"\"\n",
         "forecast <subcommand>`` dispatcher; the\n"
         "    backtest's fits run on ``device`` (None: the CUDA card).\"\"\"\n"),
        ("        return backtest_cli(argv[1:])\n",
         "        return backtest_cli(argv[1:], device)\n"),
    ],
    "tools/fit_profile.py": [
        ("             max_batch: int, avg_in: float, avg_out: float) -> dict:\n"
         "    \"\"\"Replay the fit through the chain solver + the tuner's NIS gate.\"\"\"\n",
         "             max_batch: int, avg_in: float, avg_out: float,\n"
         "             device=None) -> dict:\n"
         "    \"\"\"Replay the fit through the chain solver + the tuner's NIS gate,\n"
         "    on ``device`` (None: the CUDA card).\"\"\"\n"),
        ("        RequestSize(avg_input_tokens=avg_in, avg_output_tokens=avg_out))\n"
         "    tuner = KalmanTuner(sp)\n",
         "        RequestSize(avg_input_tokens=avg_in, avg_output_tokens=avg_out),\n"
         "        device=device)\n"
         "    tuner = KalmanTuner(sp, device=device)\n"),
        ("def main(argv: list[str] | None = None) -> int:\n",
         "def main(argv: list[str] | None = None, device=None) -> int:\n"),
        ("            args.max_batch, args.avg_input_tokens, args.avg_output_tokens)\n"
         "        if mid_label",
         "            args.max_batch, args.avg_input_tokens, args.avg_output_tokens,\n"
         "            device)\n"
         "        if mid_label"),
    ],
    "__main__.py": [
        ("def main(argv: list[str] | None = None) -> int:\n",
         "def main(argv: list[str] | None = None, device=None) -> int:\n"
         "    \"\"\"The controller's CLI. The engine, the forecast backtest's fits\n"
         "    and the sweep run on ``device`` (None: the CUDA card).\"\"\"\n"),
        ("        return forecast_cli(argv[1:])\n",
         "        return forecast_cli(argv[1:], device)\n"),
        ("        return sweep_cli(argv[1:])\n",
         "        return sweep_cli(argv[1:], device)\n"),
        ("    mgr = build_manager(client, cfg)\n",
         "    mgr = build_manager(client, cfg, device=device)\n"),
    ],
}


# The port's spans (wva_tpu_torch/obs/SPANS.md), applied after the device
# edits: the recorder's bridge to the torch profiler and its ``scoped``
# helper, the grouped view's counts, the engine's spans (the fingerprint
# pass, the fused program's grids, the tuner step, the decision stage,
# which replace its stage timers, the records and the fleet solve) and the
# sweep search's root and recorder hand-on.
SPAN_EDITS = {
    "obs/spans.py": [
        ("(docs/design/observability.md).\n",
         "(docs/design/observability.md; the port's trees and profiler ranges:\n"
         "``wva_tpu_torch/obs/SPANS.md``).\n"),
        ("durations (immune to world-clock jumps).\n"
         '"""\n'
         "\n",
         "durations (immune to world-clock jumps).\n"
         "\n"
         "**One clock with the device trace.** When a torch profiler is recording\n"
         "as a root opens, every span begun on the root's own thread also opens a\n"
         "profiler range named ``wva:<span name>``, closed where the span closes,\n"
         "so the tree lands on the profiler's timeline beside the kernels it\n"
         "launched. The ranges are function-scoped: the profiler does not mirror\n"
         "them onto the device's timeline. Spans of other threads stay in the tree\n"
         "but are not mirrored (ranges of one thread nest), and so do the leaves\n"
         "named in ``TREE_ONLY``: their parent's range holds their time. A range\n"
         "closes every range opened inside it that is still open, so the ranges\n"
         "nest even where an exception left a stage open. With no profiler\n"
         "recording, a span pays one boolean test for this.\n"
         '"""\n'
         "\n"),
        ("import threading\n",
         "import sys\n"
         "import threading\n"),
        ("import time\n",
         "import time\n"
         "from contextlib import nullcontext\n"),
        ("\n"
         "\n"
         "class Span:\n",
         "\n"
         "# Prefix of the profiler ranges that mirror spans.\n"
         'RANGE_PREFIX = "wva:"\n'
         "\n"
         "# Spans kept in the tree but given no profiler range: each backend query\n"
         "# (about 20 a tick for one model) and the innermost parts of the launch\n"
         "# paths (the fused program's, the sweep chunk's, the EKF step's h and H).\n"
         "# Inside a real tick under the profiler a range costs some 5 us of host\n"
         "# time to open and close, several times its cost alone, so the ranges\n"
         "# stop at the spans that hold these; the parent's range carries their\n"
         "# time on the profiler's clock.\n"
         'TREE_ONLY = frozenset({"backend_query", "stage", "launch", "readback",\n'
         '                       "materialize", "h_jacobian"})\n'
         "\n"
         "\n"
         'def scoped(spans: "SpanRecorder | None", name: str, **attrs):\n'
         '    """``spans.span(name, **attrs)``, or a context that records nothing\n'
         '    without a recorder (callers that take an optional ``spans``)."""\n'
         "    if spans is None:\n"
         "        return nullcontext()\n"
         "    return spans.span(name, **attrs)\n"
         "\n"
         "\n"
         "def _profiler_recording() -> bool:\n"
         '    """Whether a torch profiler is recording in this process (False when\n'
         '    torch was never imported: then none can be)."""\n'
         '    torch = sys.modules.get("torch")\n'
         "    if torch is None:\n"
         "        return False\n"
         "    try:\n"
         "        return bool(torch._C._autograd._profiler_enabled())\n"
         "    except Exception:  # noqa: BLE001 — observability must not bite\n"
         "        return False\n"
         "\n"
         "\n"
         "class Span:\n"),
        ('                 "_t0")\n',
         '                 "_t0", "_range")\n'),
        ("        self._t0 = time.perf_counter()\n",
         "        self._t0 = time.perf_counter()\n"
         "        # The open profiler range mirroring this span, if any.\n"
         "        self._range = None\n"),
        ("        self.ticks_total = 0\n",
         "        # Profiler mirroring, decided once per root: the range type while\n"
         "        # a profiler records (else None), the root's thread, and the\n"
         "        # mirrored spans whose ranges are still open.\n"
         "        self._mirror = None\n"
         "        self._root_thread = 0\n"
         "        self._ranges: list[Span] = []\n"
         "        self.ticks_total = 0\n"),
        ('    def begin_tick(self, engine: str = "", **attrs) -> Span:\n',
         '    def begin_tick(self, engine: str = "", name: str = "tick",\n'
         "                   **attrs) -> Span:\n"
         '        """Open a root: an engine tick, or any other unit of work recorded\n'
         '        as one tree (the sweep opens one named ``search``)."""\n'
         '        mirror = (sys.modules["torch"]._C._profiler._RecordFunctionFast\n'
         "                  if _profiler_recording() else None)\n"),
        ('                name = "tick"\n'
         '            attrs = {**attrs, "engine": engine or self.engine}\n',
         '            attrs = {**attrs, "engine": engine or self.engine}\n'),
        ("            self._root = root\n"
         "            self._default_parent = None\n"
         "        # The engine thread's stack starts at the root; worker threads\n",
         "            self._root = root\n"
         "            self._default_parent = None\n"
         "            self._close_ranges()\n"
         "            self._mirror = mirror\n"
         "            self._root_thread = threading.get_ident()\n"
         "            if mirror is not None:\n"
         "                self._open_range(root)\n"
         "        # The engine thread's stack starts at the root; worker threads\n"),
        ("            root.dur_ms = (time.perf_counter() - root._t0) * 1000.0\n",
         "            root.dur_ms = (time.perf_counter() - root._t0) * 1000.0\n"
         "            self._close_ranges()\n"),
        ("            self._root = None\n"
         "        self._stack().clear()\n"
         "\n",
         "            self._root = None\n"
         "            self._close_ranges()\n"
         "        self._stack().clear()\n"
         "\n"),
        ("            return span\n",
         "            if (self._mirror is not None and name not in TREE_ONLY\n"
         "                    and threading.get_ident() == self._root_thread):\n"
         "                self._open_range(span)\n"
         "            return span\n"),
        ("            return\n"
         "        span.dur_ms = (time.perf_counter() - span._t0) * 1000.0\n"
         "        if attrs:\n",
         "            return\n"
         "        span.dur_ms = (time.perf_counter() - span._t0) * 1000.0\n"
         "        if span._range is not None:\n"
         "            self._close_range(span)\n"
         "        if attrs:\n"),
        ("        span.dur_ms = (time.perf_counter() - span._t0) * 1000.0\n"
         "        stack = self._stack()\n"
         "        if stack and stack[-1] is span:\n",
         "        span.dur_ms = (time.perf_counter() - span._t0) * 1000.0\n"
         "        if span._range is not None:\n"
         "            self._close_range(span)\n"
         "        stack = self._stack()\n"
         "        if stack and stack[-1] is span:\n"),
        ("            stack.pop()\n",
         "            stack.pop()\n"
         "\n"
         "    def _open_range(self, span: Span) -> None:\n"
         '        """Enter the profiler range mirroring ``span``."""\n'
         "        try:\n"
         "            rng = self._mirror(RANGE_PREFIX + span.name)\n"
         "            rng.__enter__()\n"
         "        except Exception:  # noqa: BLE001 — observability must not bite\n"
         "            return\n"
         "        span._range = rng\n"
         "        self._ranges.append(span)\n"
         "\n"
         "    def _close_range(self, span: Span) -> None:\n"
         "        \"\"\"Exit ``span``'s range, and first every range opened after it\n"
         "        and still open (a stage an exception left open), so the ranges\n"
         '        close innermost first."""\n'
         "        ranges = self._ranges\n"
         "        while span._range is not None and ranges:\n"
         "            inner = ranges.pop()\n"
         "            rng, inner._range = inner._range, None\n"
         "            try:\n"
         "                rng.__exit__(None, None, None)\n"
         "            except Exception:  # noqa: BLE001\n"
         "                pass\n"
         "\n"
         "    def _close_ranges(self) -> None:\n"
         "        \"\"\"Close every range still open, innermost first (the root's end,\n"
         '        an abandoned or errored root)."""\n'
         "        if self._ranges:\n"
         "            self._close_range(self._ranges[0])\n"),
    ],
    "collector/source/grouped.py": [
        ("        self._plan_gq: dict[tuple, tuple] = {}\n"
         "\n",
         "        self._plan_gq: dict[tuple, tuple] = {}\n"
         "        # What this tick's view did (the engine puts them on its phase\n"
         "        # spans): fleet-wide backend queries executed, executions served\n"
         "        # from the version book's memo, and model slices demuxed.\n"
         "        self._count_mu = threading.Lock()\n"
         '        self._counts = {"queries": 0, "memo_hits": 0, "demuxed": 0}\n'
         "\n"
         "    def counts(self) -> dict[str, int]:\n"
         '        """A copy of this view\'s counts so far."""\n'
         "        with self._count_mu:\n"
         "            return dict(self._counts)\n"
         "\n"
         "    def _count(self, key: str, n: int = 1) -> None:\n"
         "        with self._count_mu:\n"
         "            self._counts[key] += n\n"
         "\n"),
        ("                if memo is not None:\n"
         "                    return memo.versions\n",
         "                if memo is not None:\n"
         '                    self._count("memo_hits")\n'
         "                    return memo.versions\n"),
        ("            if memo is not None:\n"
         "                # Provably byte-identical evaluation (no writes/drops to\n",
         "            if memo is not None:\n"
         '                self._count("memo_hits")\n'
         "                # Provably byte-identical evaluation (no writes/drops to\n"),
        ("                 if self._spans is not None else None)\n"
         "        try:\n",
         "                 if self._spans is not None else None)\n"
         '        self._count("queries")\n'
         "        try:\n"),
        ('            demuxed["__versions__"] = versions\n'
         "        for (model, ns), values in slices.items():\n",
         '            demuxed["__versions__"] = versions\n'
         '        self._count("demuxed", len(slices))\n'
         "        for (model, ns), values in slices.items():\n"),
        # The shared view remembers the templates its callers asked for; the
        # sharded plane's warm-up runs only those.
        ('        self._count_mu = threading.Lock()\n'
         '        self._counts = {"queries": 0, "memo_hits": 0, "demuxed": 0}\n'
         '\n'
         '    def counts(self) -> dict[str, int]:\n'
         '        """A copy of this view\'s counts so far."""\n'
         '        with self._count_mu:\n'
         '            return dict(self._counts)\n',
         '        self._count_mu = threading.Lock()\n'
         '        self._counts = {"queries": 0, "memo_hits": 0, "demuxed": 0}\n'
         "        # Templates this tick's callers asked for (the fleet warm-up\n"
         '        # excluded): what the sharded plane warms on its next tick.\n'
         '        self._requested: set[str] = set()\n'
         '\n'
         '    def counts(self) -> dict[str, int]:\n'
         '        """A copy of this view\'s counts so far."""\n'
         '        with self._count_mu:\n'
         '            return dict(self._counts)\n'
         '\n'
         '    def requested(self) -> frozenset[str]:\n'
         '        """The templates this tick\'s collectors and fingerprints asked\n'
         '        for, whether or not :meth:`warm_fleet_queries` ran them first."""\n'
         '        return frozenset(self._requested)\n'),
        ('        names = list(spec.queries) or self._source.query_list().names()\n'
         '        results: dict[str, MetricResult] = {}\n',
         '        names = list(spec.queries) or self._source.query_list().names()\n'
         '        self._requested.update(names)\n'
         '        results: dict[str, MetricResult] = {}\n'),
        ('    def warm_fleet_queries(self, params: dict[str, str]) -> None:\n',
         '    def warm_fleet_queries(self, params: dict[str, str],\n'
         '                           names=None) -> None:\n'),
        ('        have done — decisions and fingerprints are byte-identical."""\n'
         '        for name in self._source.query_list().names():\n'
         '            try:\n',
         '        have done — decisions and fingerprints are byte-identical.\n'
         '        ``names`` limits the warm-up to those templates (the previous\n'
         "        tick's :meth:`requested`), so templates no caller reads — the\n"
         "        tuner's per-pod rates with the tuner off — are not run at all, as\n"
         '        the unsharded tick never runs them; a template first asked for\n'
         '        later is run by its first caller."""\n'
         '        for name in self._source.query_list().names():\n'
         '            if names is not None and name not in names:\n'
         '                continue\n'
         '            try:\n'),
        ('        parts: list[tuple] = []\n'
         '        for name in queries:\n'
         '            template = self._source.query_list().get(name)\n',
         '        parts: list[tuple] = []\n'
         '        self._requested.update(queries)\n'
         '        for name in queries:\n'
         '            template = self._source.query_list().get(name)\n'),
        ('        if not model:\n'
         '            return ()\n'
         '        for name in queries:\n',
         '        if not model:\n'
         '            return ()\n'
         '        self._requested.update(queries)\n'
         '        for name in queries:\n'),
        ('        if not pairs:\n'
         '            return {}\n'
         '        for name in queries:\n',
         '        if not pairs:\n'
         '            return {}\n'
         '        self._requested.update(queries)\n'
         '        for name in queries:\n'),
    ],
    "engines/saturation/engine.py": [
        ("        self.last_tick_phase_seconds: dict[str, float] = {}\n"
         "        # Host-stage breakdown of the v2 decision stage (bench-analyze's\n"
         "        # host_breakdown instrument): wall seconds the LAST tick spent in\n"
         "        # finalize / optimize / enforce / trace-materialize, under\n"
         "        # whichever decision-stage form (vectorized or per-model loop)\n"
         "        # ran — the A/B the bench reports.\n"
         "        self.last_tick_stage_seconds: dict[str, float] = {}\n"
         "        # Obs plane (WVA_SPANS; docs/design/observability.md): the span\n",
         "        self.last_tick_phase_seconds: dict[str, float] = {}\n"
         "        # Obs plane (WVA_SPANS; docs/design/observability.md): the span\n"),
        ("        self._span_phases: dict[str, object] = {}\n"
         "        # K8s object copies taken during the last tick (object plane\n",
         "        self._span_phases: dict[str, object] = {}\n"
         "        # The tick's grouped metrics view, whose counts (queries, memo\n"
         "        # hits, models demuxed) each phase span carries, and the counts\n"
         "        # at the open phase's start.\n"
         "        self._tick_view = None\n"
         "        self._phase_counts: dict[str, int] = {}\n"
         "        # K8s object copies taken during the last tick (object plane\n"),
        ("        self._cur_phase_span = span\n"
         "        # Helper threads (analysis pool, query warmers) with no open span\n",
         "        self._cur_phase_span = span\n"
         "        self._phase_counts = self._view_counts()\n"
         "        # Helper threads (analysis pool, query warmers) with no open span\n"),
        ("        if self.spans is not None and self._cur_phase_span is not None:\n"
         "            self.spans.end_span(self._cur_phase_span)\n"
         "            self._cur_phase_span = None\n"
         "            self.spans.set_default_parent(None)\n"
         "\n",
         "        if self.spans is not None and self._cur_phase_span is not None:\n"
         "            start = self._phase_counts\n"
         "            self.spans.end_span(self._cur_phase_span, **{\n"
         "                k: v - start.get(k, 0)\n"
         "                for k, v in self._view_counts().items()})\n"
         "            self._cur_phase_span = None\n"
         "            self.spans.set_default_parent(None)\n"
         "\n"
         "    def _view_counts(self) -> dict[str, int]:\n"
         "        view = self._tick_view\n"
         "        return view.counts() if view is not None else {}\n"
         "\n"),
        ("        return self.spans.span(name, **attrs)\n"
         "\n",
         "        return self.spans.span(name, **attrs)\n"
         "\n"
         "    def _open_span(self, name: str, **attrs):\n"
         '        """``_obs_span`` entered until ``_close_span``, for a stage too\n'
         "        long to indent under a ``with``. An exception between the two\n"
         "        fails the tick: the phase's end then closes the stage's profiler\n"
         "        range before its own (``SpanRecorder._close_range``), and the next\n"
         '        tick\'s root clears the thread\'s stack."""\n'
         "        if self.spans is None:\n"
         "            return None\n"
         "        ctx = self.spans.span(name, **attrs)\n"
         "        ctx.__enter__()\n"
         "        return ctx\n"
         "\n"
         "    @staticmethod\n"
         "    def _close_span(ctx) -> None:\n"
         "        if ctx is not None:\n"
         "            ctx.__exit__(None, None, None)\n"
         "\n"),
        ("                self.enforcer.metrics_source = collector.source\n"
         "            # Snapshot + collector construction, resync probe: the first\n",
         "                self.enforcer.metrics_source = collector.source\n"
         "            if isinstance(collector.source, GroupedMetricsView):\n"
         "                self._tick_view = collector.source\n"
         "            # Snapshot + collector construction, resync probe: the first\n"),
        ('                self.spans.end_tick("success" if tick_ok else "error")\n'
         "            if logjson.ACTIVE:\n",
         '                self.spans.end_tick("success" if tick_ok else "error")\n'
         "            self._tick_view = None\n"
         "            if logjson.ACTIVE:\n"),
        ("        if self.flight is not None:\n"
         "            self.flight.record_decisions(decisions)\n"
         "        apply_start = time.perf_counter()\n",
         "        if self.flight is not None:\n"
         '            with self._obs_span("record", decisions=len(decisions)):\n'
         "                self.flight.record_decisions(decisions)\n"
         "        apply_start = time.perf_counter()\n"),
        ("        # event landing after capture makes next tick re-walk, never skip).\n"
         "        tick_epochs: dict[str, int | None] = {}\n",
         "        # event landing after capture makes next tick re-walk, never skip).\n"
         '        versions = self._open_span("versions")\n'
         "        tick_epochs: dict[str, int | None] = {}\n"),
        ("                bulk_metrics = None\n"
         "        # Scale-to-zero config resolves per NAMESPACE (a deepcopy), not\n",
         "                bulk_metrics = None\n"
         "        self._close_span(versions)\n"
         "        # Scale-to-zero config resolves per NAMESPACE (a deepcopy), not\n"),
        ("\n"
         "        self._shadow_tick = {}\n",
         "\n"
         '        hashing = self._open_span("hash", models=len(model_groups))\n'
         "        self._shadow_tick = {}\n"),
        ("                clean.add(key)\n"
         "        return clean, fingerprints\n",
         "                clean.add(key)\n"
         "        self._close_span(hashing)\n"
         "        return clean, fingerprints\n"),
        ("                try:\n"
         "                    grids, fused_prep = self._fused_prepare(\n"
         "                        plans, batch_keys, outcomes, slo_cfg_by_ns)\n"
         "                except Exception as e:  # noqa: BLE001 — the lever must\n",
         "                try:\n"
         '                    with self._obs_span("fused_grids"):\n'
         "                        grids, fused_prep = self._fused_prepare(\n"
         "                            plans, batch_keys, outcomes, slo_cfg_by_ns)\n"
         "                except Exception as e:  # noqa: BLE001 — the lever must\n"),
        ('                        with self._obs_span("fused_dispatch",\n'
         "                                            models=len(batch_keys)):\n"
         "                            sized = self._fused_dispatch(grids, fused_prep)\n",
         '                        with self._obs_span("fused_dispatch",\n'
         "                                            models=len(batch_keys),\n"
         "                                            rows=grids.n_candidates):\n"
         "                            sized = self._fused_dispatch(grids, fused_prep)\n"),
        ("        # invalidate + safety-net path as a per-model finalize raise.\n"
         '        stage_s = {"finalize": 0.0, "optimize": 0.0, "enforce": 0.0,\n'
         '                   "trace_materialize": 0.0}\n'
         "        self.last_tick_stage_seconds = stage_s\n"
         "        vec_finalized: dict[str, object] = {}\n",
         "        # invalidate + safety-net path as a per-model finalize raise.\n"
         '        decide = self._open_span("decide")\n'
         '        finalize = self._open_span("finalize")\n'
         "        vec_finalized: dict[str, object] = {}\n"),
        ("            if vec_items:\n"
         "                _t0 = time.perf_counter()\n"
         '                with self._obs_span("vec_finalize",\n',
         "            if vec_items:\n"
         '                with self._obs_span("vec_finalize",\n'),
        ("                            assert_mode=self.vec_assert)\n"
         '                stage_s["finalize"] += time.perf_counter() - _t0\n'
         "        for group_key in sorted(model_groups):\n",
         "                            assert_mode=self.vec_assert)\n"
         "        # The model records, encoded after the loop in its order, so their\n"
         "        # encoding is one span and not one per model.\n"
         "        to_record: list[dict] = []\n"
         "        for group_key in sorted(model_groups):\n"),
        ("                    if err is None:\n"
         "                        _t0 = time.perf_counter()\n"
         "                        try:\n",
         "                    if err is None:\n"
         "                        try:\n"),
        ("                            err = e  # isolation (handled just below)\n"
         '                        stage_s["finalize"] += time.perf_counter() - _t0\n'
         "                    if err is not None:\n",
         "                            err = e  # isolation (handled just below)\n"
         "                    if err is not None:\n"),
        ("            if self.flight is not None:\n"
         "                _t0 = time.perf_counter()\n"
         "                self.flight.record_model({\n"
         '                    "model_id": model_id, "namespace": namespace,\n',
         "            if self.flight is not None:\n"
         "                to_record.append({\n"
         '                    "model_id": model_id, "namespace": namespace,\n'),
        ("                })\n"
         '                stage_s["trace_materialize"] += time.perf_counter() - _t0\n'
         "            requests.append(ModelScalingRequest(\n",
         "                })\n"
         "            requests.append(ModelScalingRequest(\n"),
        ("                variant_states=data.variant_states))\n"
         "\n",
         "                variant_states=data.variant_states))\n"
         "        self._close_span(finalize)\n"
         "        if to_record:\n"
         '            with self._obs_span("record", models=len(to_record)):\n'
         "                for payload in to_record:\n"
         "                    self.flight.record_model(payload)\n"
         "\n"),
        ("                        for vas in model_groups.values()})\n"
         "            return []\n",
         "                        for vas in model_groups.values()})\n"
         "            self._close_span(decide)\n"
         "            return []\n"),
        ("                global_reqs = []\n"
         "            if global_reqs:\n",
         "                global_reqs = []\n"
         '            optimize = self._open_span("optimize")\n'
         "            if global_reqs:\n"),
        ("            if local_reqs:\n"
         "                _t0 = time.perf_counter()\n"
         '                self._trace_section("optimizer")\n',
         "            if local_reqs:\n"
         '                self._trace_section("optimizer")\n'),
        ("                        self.optimizer.optimize(local_reqs, None))\n"
         '                stage_s["optimize"] += time.perf_counter() - _t0\n'
         "\n",
         "                        self.optimizer.optimize(local_reqs, None))\n"
         "            self._close_span(optimize)\n"
         "\n"),
        ("            # same bridge over them after the solve.\n"
         "            _t0 = time.perf_counter()\n"
         '            self._trace_section("enforce")\n',
         "            # same bridge over them after the solve.\n"
         '            enforce = self._open_span("enforce")\n'
         '            self._trace_section("enforce")\n'),
        ('                                 "for %s", model_id)\n'
         '            stage_s["enforce"] += time.perf_counter() - _t0\n'
         '            self._trace_section("models")\n'
         "\n"
         "        self._apply_forecast(\n"
         "            requests, decisions, routes,\n"
         "            active_keys={(vas[0].spec.model_id, vas[0].metadata.namespace)\n"
         "                         for vas in model_groups.values()},\n"
         "            prepared=fused_prep)\n"
         "\n",
         '                                 "for %s", model_id)\n'
         "            self._close_span(enforce)\n"
         '            self._trace_section("models")\n'
         "\n"
         '        with self._obs_span("forecast"):\n'
         "            self._apply_forecast(\n"
         "                requests, decisions, routes,\n"
         "                active_keys={(vas[0].spec.model_id,\n"
         "                              vas[0].metadata.namespace)\n"
         "                             for vas in model_groups.values()},\n"
         "                prepared=fused_prep)\n"
         "\n"),
        ("        decisions.extend(cached_decisions)\n"
         "        self._apply_limiter(decisions)\n"
         "        return decisions\n",
         "        decisions.extend(cached_decisions)\n"
         '        with self._obs_span("limiter"):\n'
         "            self._apply_limiter(decisions)\n"
         "        self._close_span(decide)\n"
         "        return decisions\n"),
        ("        # their two-argument shape.\n"
         "        if self._tick_presized:\n"
         "            solution = solve(system, spec, presized=self._tick_presized,\n"
         "                             device=self.device)\n"
         "        else:\n"
         "            solution = solve(system, spec, device=self.device)\n"
         "        return self._allocations_to_decisions(req_by_server, solution)\n",
         "        # their two-argument shape.\n"
         '        with self._obs_span("fleet_solve", servers=len(servers)):\n'
         "            if self._tick_presized:\n"
         "                solution = solve(system, spec, presized=self._tick_presized,\n"
         "                                 device=self.device)\n"
         "            else:\n"
         "                solution = solve(system, spec, device=self.device)\n"
         "        return self._allocations_to_decisions(req_by_server, solution)\n"),
        ("\n"
         "        result = fused.run(grids, memo=self.solve_memo)\n"
         "        if prep is not None:\n",
         "\n"
         "        result = fused.run(grids, memo=self.solve_memo, spans=self.spans)\n"
         "        if prep is not None:\n"),
        ("            )\n"
         "            self.slo_tuner.observe(namespace, model_id, accelerator, env)\n"
         "\n",
         "            )\n"
         '            with self._obs_span("tuner_step"):\n'
         "                self.slo_tuner.observe(namespace, model_id, accelerator, env,\n"
         "                                       spans=self.spans)\n"
         "\n"),
        # The sharded plane's spans, the capture built after the stage
        # and the fleet solve on the rates the workers sized.
        ("                # lease-holder may run it (docs/design/sharding.md).\n"
         "                self._capture_global_requests(global_reqs)\n"
         "                global_reqs = []\n",
         "                # lease-holder may run it (docs/design/sharding.md).\n"
         "                # Encoded with the rest of the capture, after the stage.\n"
         "                self.shard_ctx.global_requests = global_reqs\n"
         "                global_reqs = []\n"),
        ("        cap = self.shard_ctx.capture\n"
         "        for req in reqs:\n",
         "        cap = self.shard_ctx.capture\n"
         "        # Each pair's throughput as this tick's fused program sized it,\n"
         "        # so the fleet solve reuses the rates instead of sizing again.\n"
         "        sized: dict[tuple[str, str], dict[str, float]] = {}\n"
         "        for (model_id, namespace, acc), rate in \\\n"
         "                (self._tick_presized or {}).items():\n"
         "            sized.setdefault((model_id, namespace), {})[acc] = rate\n"
         "        for req in reqs:\n"),
        ('                    "variant_states": [bb_encode(vs)\n'
         "                                       for vs in req.variant_states]})\n"
         "\n",
         '                    "variant_states": [bb_encode(vs)\n'
         "                                       for vs in req.variant_states],\n"
         '                    "presized": sized.get((req.model_id, req.namespace),\n'
         "                                          {})})\n"
         "\n"),
        ("            ENTRY_CACHED,\n"
         "            ENTRY_LOCAL,\n",
         "            ENTRY_CACHED,\n"
         "            ENTRY_GLOBAL,\n"
         "            ENTRY_LOCAL,\n"),
        ("        cap = ctx.capture\n"
         "        by_key: dict[str, list[VariantDecision]] = {}\n",
         "        cap = ctx.capture\n"
         "        if self.spans is not None:\n"
         "            self.spans.annotate(self._span_root, owned=sum(\n"
         "                len(vas) for vas in owned.values()))\n"
         '        capture = self._open_span("shard_capture", shard=cap.shard_id)\n'
         "        self._capture_global_requests(ctx.global_requests)\n"
         "        by_key: dict[str, list[VariantDecision]] = {}\n"),
        ("        for key in sorted(owned):\n"
         "            if key in cap.entries:  # fleet-solved: captured at the split\n"
         "                continue\n",
         "        for key in sorted(owned):\n"
         "            if key in cap.entries:  # fleet-solved: encoded above\n"
         "                continue\n"),
        ("        cap.published_at = self.clock.now()\n"
         "\n",
         "        cap.published_at = self.clock.now()\n"
         "        if capture is not None:\n"
         "            self.spans.annotate(capture.span, **{\n"
         "                kind: sum(e.kind == kind for e in cap.entries.values())\n"
         "                for kind in (ENTRY_LOCAL, ENTRY_GLOBAL, ENTRY_CACHED)})\n"
         "        self._close_span(capture)\n"
         "\n"),
        ("        use_slo = analyzer_name == SLO_ANALYZER_NAME\n"
         "        tick = self.shard_plane.gather(model_groups, collector=collector,\n"
         "                                       spans=self.spans)\n"
         "        # Stitch: every worker's span subtree — stamped with (fleet tick\n",
         "        use_slo = analyzer_name == SLO_ANALYZER_NAME\n"
         '        with self._obs_span("shard_gather") as gather_span:\n'
         "            tick = self.shard_plane.gather(model_groups, collector=collector,\n"
         "                                           spans=self.spans,\n"
         "                                           trace=self.flight is not None)\n"
         "        if gather_span is not None:\n"
         "            self.spans.annotate(\n"
         "                gather_span, alive=len(tick.alive), moves=len(tick.moves),\n"
         "                stale=len(tick.stale), uncovered=len(tick.uncovered))\n"
         "        # Stitch: every worker's span subtree — stamped with (fleet tick\n"),
        ("            self.spans.graft(tick.spans)\n"
         '        merge_span = (self.spans.begin_span("fleet_merge",\n'
         "                                            shards=len(tick.alive))\n"
         "                      if self.spans is not None else None)\n"
         "\n",
         "            self.spans.graft(tick.spans)\n"
         '        merge = self._open_span("fleet_merge", shards=len(tick.alive))\n'
         "\n"),
        ("\n"
         "        # 1. The per-model record stream, exactly as the unsharded stage-2\n"
         "        # merge loop would have emitted it: sorted by group key (records\n"
         "        # within one group keep their shard-side emission order).\n"
         "        self._replay_trace_records(section(tick.trace, SECTION_MODELS))\n"
         "\n"
         "        # 2. Fleet-level solve over the shards' summaries, then the\n"
         "        # enforcer bridge for the solved models (records buffered so the\n"
         "        # merged enforcer stream below stays in sorted request order).\n"
         "        decisions: list[VariantDecision] = []\n",
         "\n"
         "        # 1. Fleet-level solve over the shards' summaries, then the\n"
         "        # enforcer bridge for the solved models (records buffered so the\n"
         "        # merged enforcer stream below stays in sorted request order).\n"
         "        # The solve records nothing, so the re-emission below keeps the\n"
         "        # unsharded engine's record order.\n"
         "        decisions: list[VariantDecision] = []\n"),
        ("        fleet_enforce: list = []\n"
         "        if global_entries:\n"
         "            slo_cfg_by_ns = (self._sync_slo_config(model_groups)\n"
         "                             if use_slo else {})\n"
         "            reqs = [self._decode_global_request(e) for e in global_entries]\n"
         "            decisions.extend(self._optimize_global(reqs, slo_cfg_by_ns))\n",
         "        fleet_enforce: list = []\n"
         '        with self._obs_span("merge_decode", **{"global": len(global_entries)}):\n'
         "            reqs = [self._decode_global_request(e) for e in global_entries]\n"
         "            # The workers' fused programs sized every fleet-solved pair:\n"
         "            # the solve reuses their rates, as the unsharded tick does.\n"
         "            self._tick_presized = {\n"
         "                (e.model_id, e.namespace, acc): rate\n"
         "                for e in global_entries\n"
         "                for acc, rate in (e.global_request or {}).get(\n"
         '                    "presized", {}).items()} or None\n'
         "        if reqs:\n"
         "            slo_cfg_by_ns = (self._sync_slo_config(model_groups)\n"
         "                             if use_slo else {})\n"
         "            decisions.extend(self._optimize_global(reqs, slo_cfg_by_ns))\n"),
        ("\n"
         "        # 3. + 4. Optimizer stages (shard-local cost-aware passes), then\n"
         "        # the enforcer stream — shard-local and fleet-solved records merged\n"
         "        # into one sorted-request-order sequence.\n"
         "        self._replay_trace_records(section(tick.trace, SECTION_OPTIMIZER))\n"
         "        self._replay_trace_records(\n"
         "            section(list(tick.trace) + fleet_enforce, SECTION_ENFORCE))\n"
         "\n"
         "        # 5. ONE merged forecast stage (plans in the planner's own\n"
         "        # (namespace, model) order across every shard).\n"
         "        if self.flight is not None and tick.plans:\n"
         "            def plan_key(p):\n"
         '                return (p.get("namespace", ""), p.get("model_id", ""))\n'
         "            self.flight.record_stage(STAGE_FORECAST, {\n"
         '                "plans": sorted(tick.plans, key=plan_key),\n'
         '                "floors": sorted(tick.floors, key=plan_key),\n'
         '                "raised": tick.raised})\n'
         "\n"
         "        # 6. Merge decisions. The unsharded orders differ per path: V1\n"
         "        # interleaves fresh and re-emitted decisions per sorted group; the\n",
         "\n"
         '        with self._obs_span("merge_reemit") as reemit:\n'
         "            # 2. The per-model record stream, exactly as the unsharded\n"
         "            # stage-2 merge loop would have emitted it: sorted by group\n"
         "            # key (records within one group keep their shard-side\n"
         "            # emission order). 3. + 4. Optimizer stages (shard-local\n"
         "            # cost-aware passes), then the enforcer stream — shard-local\n"
         "            # and fleet-solved records merged into one sorted-request-order\n"
         "            # sequence.\n"
         "            records = (section(tick.trace, SECTION_MODELS)\n"
         "                       + section(tick.trace, SECTION_OPTIMIZER)\n"
         "                       + section(list(tick.trace) + fleet_enforce,\n"
         "                                 SECTION_ENFORCE))\n"
         "            self._replay_trace_records(records)\n"
         "\n"
         "            # 5. ONE merged forecast stage (plans in the planner's own\n"
         "            # (namespace, model) order across every shard).\n"
         "            if self.flight is not None and tick.plans:\n"
         "                def plan_key(p):\n"
         '                    return (p.get("namespace", ""), p.get("model_id", ""))\n'
         "                self.flight.record_stage(STAGE_FORECAST, {\n"
         '                    "plans": sorted(tick.plans, key=plan_key),\n'
         '                    "floors": sorted(tick.floors, key=plan_key),\n'
         '                    "raised": tick.raised})\n'
         "\n"
         "            # 6. Topology-change observability: recorded ONLY when\n"
         "            # ownership moved (steady-state sharded traces stay\n"
         "            # byte-identical to the unsharded engine's).\n"
         "            if self.flight is not None and (tick.moves or tick.stale):\n"
         "                self.flight.record_stage(STAGE_SHARD, {\n"
         '                    "moves": list(tick.moves),\n'
         '                    "holds_opened": sorted(tick.holds_opened),\n'
         '                    "alive_shards": sorted(tick.alive),\n'
         '                    "stale_shards": sorted(tick.stale),\n'
         '                    "uncovered_models": sorted(tick.uncovered),\n'
         "                })\n"
         "            if reemit is not None:\n"
         "                self.spans.annotate(reemit, records=(\n"
         "                    len(records) if self.flight is not None else 0))\n"
         "\n"
         "        # 7. Merge decisions. The unsharded orders differ per path: V1\n"
         "        # interleaves fresh and re-emitted decisions per sorted group; the\n"),
        ("                decisions.extend(tick.entries[k].decisions)\n"
         "\n"
         "        # 7. Topology-change observability: recorded ONLY when ownership\n"
         "        # moved (steady-state sharded traces stay byte-identical to the\n"
         "        # unsharded engine's).\n"
         "        if self.flight is not None and (tick.moves or tick.stale):\n"
         "            self.flight.record_stage(STAGE_SHARD, {\n"
         '                "moves": list(tick.moves),\n'
         '                "holds_opened": sorted(tick.holds_opened),\n'
         '                "alive_shards": sorted(tick.alive),\n'
         '                "stale_shards": sorted(tick.stale),\n'
         '                "uncovered_models": sorted(tick.uncovered),\n'
         "            })\n"
         "\n",
         "                decisions.extend(tick.entries[k].decisions)\n"
         "\n"),
        ("\n"
         "        if self.spans is not None:\n"
         "            self.spans.end_span(merge_span, decisions=len(decisions))\n"
         "        self._apply_limiter(decisions)\n",
         "\n"
         "        if merge is not None:\n"
         "            self.spans.annotate(merge.span, decisions=len(decisions))\n"
         "        self._close_span(merge)\n"
         "        self._apply_limiter(decisions)\n"),
        ("            # the planner's own order) — per-shard stage records would\n"
         "            # break trace byte-identity with the unsharded engine.\n"
         "            from wva_tpu_torch.blackbox.schema import encode as bb_encode\n"
         "\n"
         "            cap = self.shard_ctx.capture\n"
         "            cap.plans = [bb_encode(p) for p in plans]\n"
         "            cap.floors = list(floors)\n"
         "            cap.floors_raised = raised\n"
         "        elif self.flight is not None and plans:\n",
         "            # the planner's own order) — per-shard stage records would\n"
         "            # break trace byte-identity with the unsharded engine. A\n"
         "            # fleet that records no trace is shipped no plans.\n"
         "            if self.flight is not None:\n"
         "                from wva_tpu_torch.blackbox.schema import encode as bb_encode\n"
         "\n"
         "                cap = self.shard_ctx.capture\n"
         "                cap.plans = [bb_encode(p) for p in plans]\n"
         "                cap.floors = list(floors)\n"
         "                cap.floors_raised = raised\n"
         "        elif self.flight is not None and plans:\n"),
    ],
    "sweep/search.py": [
        ("                    chunk: int = 256, arrivals=None, faults=None,\n"
         "                    device=None):\n"
         '    """Score every (point x seed) world in batched dispatches. Returns\n',
         "                    chunk: int = 256, arrivals=None, faults=None,\n"
         "                    device=None, spans=None):\n"
         '    """Score every (point x seed) world in batched dispatches. Returns\n'),
        ("    res = run_worlds(params, knob_list, world_seeds, lam, chunk=chunk,\n"
         "                     arrivals=arrivals, faults=faults, device=device)\n"
         '    m = res["objective"].shape[1]\n',
         "    res = run_worlds(params, knob_list, world_seeds, lam, chunk=chunk,\n"
         "                     arrivals=arrivals, faults=faults, device=device,\n"
         "                     spans=spans)\n"
         '    m = res["objective"].shape[1]\n'),
        ("                base: kb.PolicyKnobs | None = None,\n"
         "                chunk: int = 256, device=None) -> SweepResult:\n"
         "    points = kb.grid_points(grid, base)\n"
         "    scores, att, chips, n = evaluate_points(params, points, train_seeds,\n"
         "                                            lam, chunk, device=device)\n"
         '    return SweepResult(points, scores, att, chips, n, "grid")\n',
         "                base: kb.PolicyKnobs | None = None,\n"
         "                chunk: int = 256, device=None, spans=None) -> SweepResult:\n"
         "    points = kb.grid_points(grid, base)\n"
         "    scores, att, chips, n = evaluate_points(params, points, train_seeds,\n"
         "                                            lam, chunk, device=device,\n"
         "                                            spans=spans)\n"
         '    return SweepResult(points, scores, att, chips, n, "grid")\n'),
        ("               elite_frac: float = 0.25, chunk: int = 256,\n"
         "               device=None) -> SweepResult:\n"
         '    """Cross-entropy method: seeded Gaussian over the knob box, refit\n',
         "               elite_frac: float = 0.25, chunk: int = 256,\n"
         "               device=None, spans=None) -> SweepResult:\n"
         '    """Cross-entropy method: seeded Gaussian over the knob box, refit\n'),
        ("        pts = [kb.clip(kb.from_vector(row)) for row in raw]\n"
         "        scores, att, chips, n = evaluate_points(params, pts, train_seeds,\n"
         "                                                lam, chunk, device=device)\n"
         "        n_worlds += n\n"
         "        all_points += pts\n",
         "        pts = [kb.clip(kb.from_vector(row)) for row in raw]\n"
         "        scores, att, chips, n = evaluate_points(params, pts, train_seeds,\n"
         "                                                lam, chunk, device=device,\n"
         "                                                spans=spans)\n"
         "        n_worlds += n\n"
         "        all_points += pts\n"),
        ("              sigma_frac: float = 0.1, chunk: int = 256,\n"
         "              device=None) -> SweepResult:\n"
         '    """(mu, lambda) evolution strategy: perturb the running best with\n',
         "              sigma_frac: float = 0.1, chunk: int = 256,\n"
         "              device=None, spans=None) -> SweepResult:\n"
         '    """(mu, lambda) evolution strategy: perturb the running best with\n'),
        ("        pts[0] = kb.clip(kb.from_vector(best_vec))  # elitism\n"
         "        scores, att, chips, n = evaluate_points(params, pts, train_seeds,\n"
         "                                                lam, chunk, device=device)\n"
         "        n_worlds += n\n"
         "        all_points += pts\n",
         "        pts[0] = kb.clip(kb.from_vector(best_vec))  # elitism\n"
         "        scores, att, chips, n = evaluate_points(params, pts, train_seeds,\n"
         "                                                lam, chunk, device=device,\n"
         "                                                spans=spans)\n"
         "        n_worlds += n\n"
         "        all_points += pts\n"),
        ("                 incumbent: kb.PolicyKnobs, holdout_seeds, lam,\n"
         "                 model_idx: int, chunk: int = 256, device=None) -> dict:\n"
         '    """Walk the candidate forward over ordered held-out seeds it never\n',
         "                 incumbent: kb.PolicyKnobs, holdout_seeds, lam,\n"
         "                 model_idx: int, chunk: int = 256, device=None,\n"
         "                 spans=None) -> dict:\n"
         '    """Walk the candidate forward over ordered held-out seeds it never\n'),
        ("    res = run_worlds(params, knob_list, world_seeds, lam, chunk=chunk,\n"
         "                     device=device)\n"
         '    obj = res["objective"][:, model_idx].reshape(len(holdout_seeds), 2)\n',
         "    res = run_worlds(params, knob_list, world_seeds, lam, chunk=chunk,\n"
         "                     device=device, spans=spans)\n"
         '    obj = res["objective"][:, model_idx].reshape(len(holdout_seeds), 2)\n'),
        ("              incumbent: kb.PolicyKnobs | None = None,\n"
         "              device=None) -> dict:\n"
         '    """Per-model tuned-knob recommendations: the best train-seed point\n',
         "              incumbent: kb.PolicyKnobs | None = None,\n"
         "              device=None, spans=None) -> dict:\n"
         '    """Per-model tuned-knob recommendations: the best train-seed point\n'),
        ("        gate = walk_forward(params, cand, incumbent, holdout_seeds, lam,\n"
         "                            m, chunk=chunk, device=device)\n"
         "        recs[model] = {\n",
         "        gate = walk_forward(params, cand, incumbent, holdout_seeds, lam,\n"
         "                            m, chunk=chunk, device=device, spans=spans)\n"
         "        recs[model] = {\n"),
        ("              generations: int = 4, population: int = 32,\n"
         "              device=None) -> dict:\n"
         '    """End-to-end: split seeds, drive the chosen algorithm on train\n',
         "              generations: int = 4, population: int = 32,\n"
         "              device=None, spans=None) -> dict:\n"
         '    """End-to-end: split seeds, drive the chosen algorithm on train\n'),
        ("    recommendations report. ``device`` is where every world runs (None:\n"
         '    the CUDA card)."""\n'
         "    train, holdout = split_seeds(n_train, n_holdout, sweep_seed)\n"
         '    if algo == "grid":\n'
         "        result = grid_search(params, lam, train, grid=grid, chunk=chunk,\n"
         "                             device=device)\n"
         '    elif algo == "cem":\n'
         "        result = cem_search(params, lam, train, sweep_seed=sweep_seed,\n"
         "                            generations=generations, population=population,\n"
         "                            chunk=chunk, device=device)\n"
         '    elif algo == "es":\n'
         "        result = es_search(params, lam, train, sweep_seed=sweep_seed,\n"
         "                           generations=generations, population=population,\n"
         "                           chunk=chunk, device=device)\n"
         "    else:\n"
         '        raise ValueError(f"unknown sweep algo {algo!r}; "\n'
         '                         f"choose from {sorted(ALGOS)}")\n'
         "    report = recommend(params, result, holdout, lam, models, chunk=chunk,\n"
         "                       device=device)\n"
         '    report["seeds"] = {"sweep_seed": sweep_seed, "train": train,\n'
         '                       "holdout": holdout}\n'
         '    report["grid"] = grid if algo == "grid" else None\n'
         "    return report\n",
         "    recommendations report. ``device`` is where every world runs (None:\n"
         "    the CUDA card). With a span recorder (``obs.spans``) the search is\n"
         "    one tree, the root ``search`` with a ``run_worlds`` span a call\n"
         "    (:func:`~wva_tpu_torch.sweep.world.run_worlds`); an exception closes\n"
         '    it with outcome ``error``."""\n'
         "    if spans is not None:\n"
         '        spans.begin_tick(name="search", algo=algo, sweep_seed=sweep_seed)\n'
         '    outcome = "error"\n'
         "    try:\n"
         "        train, holdout = split_seeds(n_train, n_holdout, sweep_seed)\n"
         '        if algo == "grid":\n'
         "            result = grid_search(params, lam, train, grid=grid, chunk=chunk,\n"
         "                                 device=device, spans=spans)\n"
         '        elif algo == "cem":\n'
         "            result = cem_search(params, lam, train, sweep_seed=sweep_seed,\n"
         "                                generations=generations,\n"
         "                                population=population, chunk=chunk,\n"
         "                                device=device, spans=spans)\n"
         '        elif algo == "es":\n'
         "            result = es_search(params, lam, train, sweep_seed=sweep_seed,\n"
         "                               generations=generations,\n"
         "                               population=population, chunk=chunk,\n"
         "                               device=device, spans=spans)\n"
         "        else:\n"
         '            raise ValueError(f"unknown sweep algo {algo!r}; "\n'
         '                             f"choose from {sorted(ALGOS)}")\n'
         "        report = recommend(params, result, holdout, lam, models, chunk=chunk,\n"
         "                           device=device, spans=spans)\n"
         '        report["seeds"] = {"sweep_seed": sweep_seed, "train": train,\n'
         '                           "holdout": holdout}\n'
         '        report["grid"] = grid if algo == "grid" else None\n'
         '        outcome = "success"\n'
         "        return report\n"
         "    finally:\n"
         "        if spans is not None:\n"
         "            spans.end_tick(outcome)\n"),
    ],
    "shard/plane.py": [
        # The sharded plane's spans, the capture built after the stage
        # and the fleet solve on the rates the workers sized.
        (")\n"
         "from wva_tpu_torch.shard.hashring import HashRing, ownership_moves\n",
         ")\n"
         "from wva_tpu_torch.obs.spans import scoped\n"
         "from wva_tpu_torch.shard.hashring import HashRing, ownership_moves\n"),
        ("    capture: ShardCapture\n"
         "\n",
         "    capture: ShardCapture\n"
         "    # The tick's fleet-solved requests, encoded into the capture with its\n"
         "    # other entries once the worker's decision stage has run.\n"
         "    global_requests: list = field(default_factory=list)\n"
         "\n"),
        ("                clock: Clock, collector=None,\n"
         "                fleet_spans=None) -> ShardCapture:\n"
         "        \"\"\"One worker analysis tick over the owned partition. The engine's\n",
         "                clock: Clock, collector=None,\n"
         "                fleet_spans=None, trace: bool = True) -> ShardCapture:\n"
         "        \"\"\"One worker analysis tick over the owned partition. The engine's\n"),
        ("        tick — process-per-shard workers leave it None and the backend\n"
         '        computes it server-side per query instead."""\n'
         "        eng = self.engine\n"
         "        buf = TraceBuffer()\n"
         "        cap = ShardCapture(shard_id=self.shard_id, epoch=epoch)\n",
         "        tick — process-per-shard workers leave it None and the backend\n"
         "        computes it server-side per query instead. ``trace`` False (the\n"
         "        fleet records no trace) captures no records: the fleet would drop\n"
         '        them."""\n'
         "        eng = self.engine\n"
         "        buf = TraceBuffer() if trace else None\n"
         "        cap = ShardCapture(shard_id=self.shard_id, epoch=epoch)\n"),
        ("            eng.spans = None\n"
         "        cap.trace = buf.records\n"
         "        if wrec is not None:\n",
         "            eng.spans = None\n"
         "        cap.trace = buf.records if buf is not None else []\n"
         "        if wrec is not None:\n"),
        ("    def gather(self, model_groups: dict, collector=None,\n"
         "               spans=None) -> PlaneTick:\n"
         "        now = self.clock.now()\n",
         "    def gather(self, model_groups: dict, collector=None,\n"
         "               spans=None, trace: bool = True) -> PlaneTick:\n"
         "        now = self.clock.now()\n"),
        ("                first = model_groups[sorted(model_groups)[0]][0]\n"
         "                warm({PARAM_MODEL_ID: first.spec.model_id,\n"
         "                      PARAM_NAMESPACE: first.metadata.namespace})\n"
         "        held = self.leases.tick()\n"
         "        alive = sorted(held)\n",
         "                first = model_groups[sorted(model_groups)[0]][0]\n"
         '                with scoped(spans, "fleet_queries"):\n'
         "                    warm({PARAM_MODEL_ID: first.spec.model_id,\n"
         "                          PARAM_NAMESPACE: first.metadata.namespace})\n"
         '        with scoped(spans, "shard_leases", shards=self.leases.shards):\n'
         "            held = self.leases.tick()\n"
         "        alive = sorted(held)\n"),
        ("        self.last_alive = alive\n"
         "        model_ids = sorted({vas[0].spec.model_id\n",
         "        self.last_alive = alive\n"
         '        ring_span = spans.begin_span("ring") if spans is not None else None\n'
         "        model_ids = sorted({vas[0].spec.model_id\n"),
        ("            tick.uncovered = model_ids\n"
         "            self._emit_gauges({}, {}, now)\n",
         "            tick.uncovered = model_ids\n"
         "            if spans is not None:\n"
         "                spans.end_span(ring_span)\n"
         "            self._emit_gauges({}, {}, now)\n"),
        ("            owned_by_shard[shard].add(mid)\n"
         "\n",
         "            owned_by_shard[shard].add(mid)\n"
         "        if spans is not None:\n"
         "            spans.end_span(ring_span)\n"
         "\n"),
        ("                                         collector=collector,\n"
         "                                         fleet_spans=spans)\n"
         "                    self.bus.publish(cap)\n",
         "                                         collector=collector,\n"
         "                                         fleet_spans=spans, trace=trace)\n"
         "                    self.bus.publish(cap)\n"),
        # The warm-up takes the templates the last tick's workers asked for.
        ('        self.last_alive: list[int] = []\n'
         '\n'
         '    # --- fleet-tick entry point ---\n',
         '        self.last_alive: list[int] = []\n'
         "        # The templates the last tick's workers asked the shared view for:\n"
         '        # what the next tick warms (None, before a first tick: all).\n'
         '        self._warm_names: frozenset[str] | None = None\n'
         '\n'
         '    # --- fleet-tick entry point ---\n'),
        ('                          PARAM_NAMESPACE: first.metadata.namespace})\n',
         '                          PARAM_NAMESPACE: first.metadata.namespace},\n'
         '                         self._warm_names)\n'),
        ('            tick.skipped += cap.skipped\n'
         '\n'
         '        tick.moves = moves\n',
         '            tick.skipped += cap.skipped\n'
         '\n'
         '        requested = getattr(getattr(collector, "source", None),\n'
         '                            "requested", None)\n'
         '        if requested is not None and self.last_worker_seconds:\n'
         '            self._warm_names = requested()\n'
         '        tick.moves = moves\n'),
    ],
    "blackbox/schema.py": [
        # Each dataclass's fields and type hints resolved once, not per decode.
        ('def decode(cls, data):\n'
         '    """Reconstruct dataclass ``cls`` from :func:`encode` output. Unknown keys\n'
         '    are ignored (forward compatibility with newer trace schemas)."""\n'
         '    if data is None:\n'
         '        return None\n'
         '    hints = get_type_hints(cls)\n'
         '    kwargs = {}\n'
         '    for f in dataclasses.fields(cls):\n'
         '        if f.name in data:\n'
         '            kwargs[f.name] = _decode_value(hints.get(f.name), data[f.name])\n'
         '    return cls(**kwargs)\n',
         '# dataclass -> ((field name, resolved type hint), ...): resolving the hints\n'
         "# evaluates every string annotation, most of a decode's time; a class's\n"
         '# fields and hints never change, so each class resolves them once.\n'
         '_FIELD_HINTS: dict[type, tuple[tuple[str, object], ...]] = {}\n'
         '\n'
         '\n'
         'def _field_hints(cls) -> tuple[tuple[str, object], ...]:\n'
         '    out = _FIELD_HINTS.get(cls)\n'
         '    if out is None:\n'
         '        hints = get_type_hints(cls)\n'
         '        out = _FIELD_HINTS[cls] = tuple(\n'
         '            (f.name, hints.get(f.name)) for f in dataclasses.fields(cls))\n'
         '    return out\n'
         '\n'
         '\n'
         'def decode(cls, data):\n'
         '    """Reconstruct dataclass ``cls`` from :func:`encode` output. Unknown keys\n'
         '    are ignored (forward compatibility with newer trace schemas)."""\n'
         '    if data is None:\n'
         '        return None\n'
         '    kwargs = {}\n'
         '    for name, hint in _field_hints(cls):\n'
         '        if name in data:\n'
         '            kwargs[name] = _decode_value(hint, data[name])\n'
         '    return cls(**kwargs)\n'),
    ],
}


# The collector policy (``wva_tpu_torch/utils/gcpolicy.py``), applied after
# the span edits: the engine reads it as each tick starts and puts its
# counters on the tick's span; ``build_manager`` installs it on the engine
# and its executor's tick observer, and the Manager's shutdown releases it.
GC_POLICY_EDITS = {
    "engines/saturation/engine.py": [
        ("        self.spans = None\n"
         "        self._span_root = None\n",
         "        self.spans = None\n"
         "        # The collector policy build_manager installs\n"
         "        # (wva_tpu_torch/utils/gcpolicy.py): read as each tick starts, its\n"
         "        # counters on the tick's span. None: the engine never reads the\n"
         "        # collector.\n"
         "        self.gc_policy = None\n"
         "        self._span_root = None\n"),
        ('        """One optimization tick (reference engine.go:171-277)."""\n',
         '        """One optimization tick (reference engine.go:171-277)."""\n'
         "        if self.gc_policy is not None:\n"
         "            self.gc_policy.begin_tick()\n"),
        ("                self._end_phase_span()\n"
         "                self._span_root = None\n",
         "                self._end_phase_span()\n"
         "                if self.gc_policy is not None:\n"
         "                    self.spans.annotate(self._span_root,\n"
         "                                        **self.gc_policy.tick_attrs())\n"
         "                self._span_root = None\n"),
    ],
    "main.py": [
        ("from wva_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock\n",
         "from wva_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock\n"
         "from wva_tpu_torch.utils.gcpolicy import GcPolicy\n"),
        ('    spans: "object | None" = None\n',
         '    spans: "object | None" = None\n'
         "    # The engine's share of the collector policy (utils/gcpolicy.py).\n"
         '    gc_policy: "GcPolicy | None" = None\n'),
        ("        self.engine.close()\n",
         "        self.engine.close()\n"
         "        if self.gc_policy is not None:\n"
         "            self.gc_policy.release()\n"),
        ("        ex.on_overrun = registry.observe_tick_overrun\n\n",
         "        ex.on_overrun = registry.observe_tick_overrun\n"
         "    # The collector policy (utils/gcpolicy.py): after each engine tick it\n"
         "    # reads what the tick cost the interpreter's collector and, at fleet\n"
         "    # width, freezes the standing heap and sizes the young generation to\n"
         "    # the tick. The observer runs inside the executor's tick.\n"
         "    gc_policy = GcPolicy()\n"
         "    engine.gc_policy = gc_policy\n"
         "    engine.executor.on_tick = gc_policy.observe(engine.executor.on_tick)\n"
         "\n"),
        ("        elector=elector, flight_recorder=flight, spans=spans,\n"
         "    )\n",
         "        elector=elector, flight_recorder=flight, spans=spans,\n"
         "        gc_policy=gc_policy,\n"
         "    )\n"),
    ],
}


def _apply(want: str, edits) -> str:
    for original, port in edits:
        assert want.count(original) == 1, original
        want = want.replace(original, port)
    return want


@pytest.mark.parametrize("rel", VERBATIM_COPIES)
def test_copies_match_reference(rel):
    ref = (ROOT / "wva_tpu" / rel).read_text()
    want = re.sub(r"\bwva_tpu\b", "wva_tpu_torch", ref)
    assert (PORT / rel).read_text() == _apply(want, SPAN_EDITS.get(rel, ()))


@pytest.mark.parametrize("rel", sorted(DEVICE_COPIES))
def test_device_copies_differ_only_in_the_device(rel):
    want = re.sub(r"\bwva_tpu\b", "wva_tpu_torch",
                  (ROOT / "wva_tpu" / rel).read_text())
    want = _apply(want, DEVICE_COPIES[rel])
    want = _apply(want, SPAN_EDITS.get(rel, ()))
    assert (PORT / rel).read_text() == _apply(want,
                                              GC_POLICY_EDITS.get(rel, ()))


def test_span_edits_are_held_copies():
    assert set(SPAN_EDITS) <= set(VERBATIM_COPIES) | set(DEVICE_COPIES)


def test_gc_policy_edits_are_device_copies():
    assert set(GC_POLICY_EDITS) <= set(DEVICE_COPIES)


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


# The loadgen copy: its array namespace is torch's for torch tensors (the
# reference's is jax.numpy's for jax arrays), and the burst train is taken
# into that namespace. For numpy inputs both edits are the identity.
LOADGEN_EDITS = [
    ('    """Array namespace for ``t``: jax.numpy for JAX inputs (traced or\n'
     '    concrete), numpy otherwise — so ``rate_at`` stays importable and\n'
     '    byte-exact (float64) without JAX on the path, yet traces cleanly\n'
     '    inside ``jit``/``vmap`` when handed device arrays."""\n'
     '    if type(t).__module__.split(".")[0] in ("jax", "jaxlib"):\n'
     '        import jax.numpy as xp\n'
     '\n'
     '        return xp\n'
     '    return np\n',
     '    """Array namespace for ``t``: a float64 torch namespace on ``t``\'s\n'
     '    device for torch tensors, numpy otherwise — so ``rate_at`` stays\n'
     '    importable and byte-exact (float64) without torch on the path, yet runs\n'
     '    on the card when handed device tensors."""\n'
     '    if type(t).__module__.split(".")[0] == "torch":\n'
     '        from types import SimpleNamespace\n'
     '\n'
     '        import torch\n'
     '\n'
     '        def f64(x):\n'
     '            return torch.as_tensor(x, dtype=torch.float64, device=t.device)\n'
     '\n'
     '        return SimpleNamespace(\n'
     '            asarray=f64, cos=torch.cos,\n'
     '            zeros=lambda shape: torch.zeros(shape, dtype=torch.float64,\n'
     '                                            device=t.device),\n'
     '            where=lambda c, a, b: torch.where(c, f64(a), f64(b)),\n'
     '            maximum=lambda a, b: torch.maximum(f64(a), f64(b)))\n'
     '    return np\n'),
    ('        hit = ((tt[..., None] >= starts)\n'
     '               & (tt[..., None] < starts + burst_duration)).any(axis=-1)\n',
     '        train = xp.asarray(starts)\n'
     '        hit = ((tt[..., None] >= train)\n'
     '               & (tt[..., None] < train + burst_duration)).any(axis=-1)\n'),
]


def test_loadgen_differs_only_in_its_array_namespace():
    want = re.sub(r"\bwva_tpu\b", "wva_tpu_torch",
                  (ROOT / "wva_tpu" / "emulator" / "loadgen.py").read_text())
    for original, port in LOADGEN_EDITS:
        assert want.count(original) == 1, original
        want = want.replace(original, port)
    assert (PORT / "emulator" / "loadgen.py").read_text() == want


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
    held = (set(VERBATIM_COPIES) | set(LAZY_YAML_COPIES) | set(DEVICE_COPIES)
            | set(PORT_MODULES))
    found = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert found == held
    for rel in set(VERBATIM_COPIES) | set(LAZY_YAML_COPIES) | set(
            DEVICE_COPIES):
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
