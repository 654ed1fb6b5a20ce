"""The port stands alone: no ``jax``, no ``wva_tpu``, and no silent CPU.

- A subprocess that refuses to import ``jax`` and ``wva_tpu`` (but not
  ``wva_tpu_torch``) imports every port module and runs one CPU SLO pass.
- An AST lint finds no ``jax`` or ``wva_tpu`` import in any port file or in
  ``chip_smoke.py``.
- The host-only modules the port keeps as copies still equal their JAX
  package originals with the package name repointed.
- Entry points given ``device=None`` raise where there is no CUDA device,
  and ``chip_smoke.py`` fails without a card or without the repo.

The subprocess also runs one CPU ``run_fused_pass``, with forecasting on,
on the local route and on the fleet solve.
"""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

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

from wva_tpu_torch.analyzers.queueing.convert import profile_store_from_records
from wva_tpu_torch.analyzers.queueing.analyzer import QueueingModelAnalyzer
from wva_tpu_torch.analyzers.queueing.params import TargetPerf
from wva_tpu_torch.config.slo import SLOConfigData
from wva_tpu_torch.engines.slo_pass import run_slo_pass
from wva_tpu_torch.interfaces import (
    AnalyzerInput, ReplicaMetrics, SaturationScalingConfig,
    VariantReplicaState)
from wva_tpu_torch.interfaces.allocation import OptimizerMetrics
from wva_tpu_torch.pipeline.optimizer import CostAwareOptimizer
from wva_tpu_torch.utils.clock import FakeClock

store = profile_store_from_records([dict(
    model_id="m", accelerator="v5e-8", alpha=6.973, beta=0.027, gamma=0.001,
    max_batch_size=64, max_queue_size=448)])
cfg = SLOConfigData(default_targets=TargetPerf(target_ttft_ms=1000.0))
an = QueueingModelAnalyzer(profiles=store, clock=FakeClock(0.0), device="cpu")
inp = AnalyzerInput(
    model_id="m", namespace="ns",
    replica_metrics=[ReplicaMetrics(pod_name="p0", variant_name="va",
                                    accelerator_name="v5e-8", cost=10.0,
                                    avg_input_tokens=512,
                                    avg_output_tokens=256)],
    variant_states=[VariantReplicaState(variant_name="va",
                                        accelerator_name="v5e-8",
                                        current_replicas=1)],
    config=SaturationScalingConfig(analyzer_name="slo"),
    optimizer_metrics=OptimizerMetrics(arrival_rate=60000.0), slo_config=cfg)
(d,) = run_slo_pass(an, CostAwareOptimizer(), [inp])
assert d.action == "scale-up" and d.target_replicas > 1, d

from wva_tpu_torch.engines.slo_pass import FleetRoute, run_fused_pass
from wva_tpu_torch.forecast.planner import CapacityPlanner

planner = CapacityPlanner(device="cpu")
for t in range(8):
    planner.observe_demand("ns", "m", float(t), 1000.0)
(f,) = run_fused_pass(an, CostAwareOptimizer(), [inp], planner)
assert (f.action, f.target_replicas) == (d.action, d.target_replicas), f
inp.config.optimizer_name = "global"
(g,) = run_fused_pass(an, CostAwareOptimizer(), [inp], planner, FleetRoute())
assert g.action == "scale-up" and g.target_replicas > 1, g
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "wva_tpu")]
assert not bad, bad
print("OK", d.target_replicas)
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
# name differs.
VERBATIM_COPIES = [
    "analyzers/queueing/params.py",
    "analyzers/trend.py",
    "utils/clock.py",
    "interfaces/__init__.py",
    "interfaces/allocation.py",
    "interfaces/analyzer.py",
    "interfaces/decision.py",
    "interfaces/replica_metrics.py",
    "interfaces/saturation_config.py",
    "pipeline/optimizer.py",
    "utils/dispatch.py",
    "collector/source/promql.py",
    "forecast/history.py",
    "forecast/leadtime.py",
    "forecast/apply.py",
    "forecast/__init__.py",
    "fleet/system.py",
    "fused/__init__.py",
]

# Copies that differ from their originals only where the port's device
# reaches the sizing and the fits: the planner and the fleet solve take a
# ``device`` (None: the CUDA card) and hand it on. Each pair is (the
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
}


@pytest.mark.parametrize("rel", VERBATIM_COPIES)
def test_copies_match_reference(rel):
    ref = (ROOT / "wva_tpu" / rel).read_text()
    assert (PORT / rel).read_text() == re.sub(r"\bwva_tpu\b", "wva_tpu_torch",
                                              ref)


@pytest.mark.parametrize("rel", sorted(DEVICE_COPIES))
def test_device_copies_differ_only_in_the_device(rel):
    want = re.sub(r"\bwva_tpu\b", "wva_tpu_torch",
                  (ROOT / "wva_tpu" / rel).read_text())
    for original, port in DEVICE_COPIES[rel]:
        assert want.count(original) == 1, original
        want = want.replace(original, port)
    assert (PORT / rel).read_text() == want


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
