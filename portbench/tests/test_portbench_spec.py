"""BENCHMARK.json against the contract it is written to, and the files it
names found by name under ``portbench/``."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CHECKOUT = ROOT.parent
SPEC = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
FORBIDDEN = {"jax", "jaxlib", "flax", "wva_tpu", "bench", "chip_smoke"}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((CHECKOUT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128


def test_check_fits_the_time_allowed():
    """A full check at 24 cells fits its 43200 seconds."""
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert one_line(entry["source"]) and one_line(entry["why"])
    path = CHECKOUT / entry["file"]
    assert path == ROOT / "configs" / f"{entry['name']}.json"
    config = json.loads(path.read_text())
    assert config["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and key in config
        assert not key.endswith(("_dim", "_rank", "_size"))
    assert {"source", "assumed", "reduced", "guarantees",
            "precision"} <= set(config)


@pytest.mark.parametrize("work", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_files_found_by_name(work):
    assert set(work) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(work["name"]) and NAME.match(work["traffic"])
    assert work["chips"] == 1
    assert one_line(work["why"])
    assert work["config"] in {c["name"] for c in SPEC["configs"]}
    traffic = json.loads(
        (ROOT / "traffic" / f"{work['traffic']}.json").read_text())
    assert (ROOT / "drivers" / f"{traffic['generator']}.py").is_file()
    for check in traffic["checks"]:
        assert (ROOT / "checks" / f"{check}.py").is_file()


def test_names_are_unique_and_every_config_used():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in SPEC["configs"]} == {
        w["config"] for w in SPEC["workloads"]}


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_names_units_and_sources(metric):
    assert NAME.match(metric["name"])
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if metric in SPEC["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert one_line(metric["layer"])
        assert (ROOT / "metrics" / f"{metric['name']}.py").is_file()
        if metric["name"].endswith("_roofline_pct") or "_roofline" in \
                metric["name"]:
            assert metric["unit"] == "%"


def test_setup_and_every_cell_reports_enough():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for work in SPEC["workloads"]:
        name = work["name"]
        reports = [m for m in SPEC["end_to_end"]
                   if name in m.get("workloads", [name])]
        assert len(reports) >= 2
        assert any(name in m.get("workloads", [name])
                   for m in SPEC["per_layer"])


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_moves_names_a_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    moved = e2e[metric["moves"]]
    cells = metric.get("workloads", [w["name"] for w in SPEC["workloads"]])
    for cell in cells:
        assert cell in moved.get("workloads", [cell])


def test_layers_named_alike():
    """Metrics of one layer name it letter for letter the same."""
    layers = {m["layer"] for m in SPEC["per_layer"]}
    folded = {layer.lower().replace(" ", "") for layer in layers}
    assert len(folded) == len(layers)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


SOURCES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_of_the_jax_stack_or_package(path):
    """Top-level names compared whole: ``wva_tpu_torch`` is the port."""
    for name in _imports(path):
        assert name.split(".", 1)[0] not in FORBIDDEN, (path, name)


@pytest.mark.parametrize(
    "path", sorted((ROOT / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    for name in _imports(path):
        assert name.split(".", 1)[0] not in {"wva_tpu_torch"}, name
        assert name.split(".", 1)[0] in {"__future__", "torch", "numpy",
                                         "math"}, name


def test_paths_hold_only_the_benchmark():
    for path in ROOT.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(CHECKOUT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
