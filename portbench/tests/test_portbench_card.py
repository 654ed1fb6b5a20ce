"""A traced run of each cell on the card: it runs from the checkout as
the driver runs it, proves correct, and its trace holds the cell's
kernels. Skips without a CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
SPEC = json.loads((CHECKOUT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_traced_run_on_the_card(card, workload):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "3141592653", "--seconds", "5", "--trace", "1"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["compared"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert result["breakdown"]["device_ops"]
