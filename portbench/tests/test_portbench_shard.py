"""The sharded plane's cell, ``fleet-1000x2-shard4.sharded-busy``, at a
small size on the CPU: a sound run is correct; planted faults turn it
false (a ring without its fmix32 finalizer, one worker's entries
dropped, a flipped fleet-solve allocation); the two readers of the
plane's spans read what the spans hold and nothing where the program has
none. A ``cuda``-marked test runs the crash proof (``shard_crash.py``)
on the card at a small size."""

from __future__ import annotations

import json
import subprocess
import sys
import zlib
from pathlib import Path

import pytest

from portbench import core, run
from portbench.tests import small

CHECKOUT = Path(__file__).resolve().parents[2]
CELL = "fleet-1000x2-shard4.sharded-busy"


def run_cell(seconds=3):
    with small.cells():
        args = run.parse(["--workload", CELL, "--seed", "2900000017",
                          "--seconds", str(seconds), "--trace", "0"])
        return run.run(args, device="cpu")


def test_sound_run_is_correct():
    result = run_cell()
    assert result["correct"] is True, result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["compared"]["shard_gap"]["value"] == 0
    assert result["compared"]["decision_gap"]["value"] == 0


def ring_without_fmix32(mp):
    """The ring hashes with the raw CRC-32, which is linear in its input."""
    from wva_tpu_torch.shard import hashring

    mp.setattr(hashring, "_h32",
               lambda data: zlib.crc32(data.encode("utf-8")) & 0xFFFFFFFF)


def worker_entries_dropped(mp):
    """Shard 1's worker publishes a capture with no entries."""
    from wva_tpu_torch.shard import plane

    inner = plane.ShardWorker.analyze

    def analyze(self, *args, **kwargs):
        cap = inner(self, *args, **kwargs)
        if self.shard_id == 1:
            cap.entries.clear()
        return cap

    mp.setattr(plane.ShardWorker, "analyze", analyze)


def global_allocation_flipped(mp):
    """Every fleet-solved model placed on the other accelerator."""
    from wva_tpu_torch import fleet

    inner = fleet.solve

    def solve(*args, **kwargs):
        out = inner(*args, **kwargs)
        for a in out.allocations.values():
            a.accelerator = {"v5e-8": "v5p-8",
                             "v5p-8": "v5e-8"}.get(a.accelerator,
                                                   a.accelerator)
        return out

    mp.setattr(fleet, "solve", solve)


FAULTS = [
    (ring_without_fmix32, ("shard_gap",)),
    (worker_entries_dropped, ("shard_gap", "decision_gap")),
    (global_allocation_flipped, ("decision_gap",)),
]


@pytest.mark.parametrize("fault,numbers", FAULTS,
                         ids=[f.__name__ for f, _ in FAULTS])
def test_fault_turns_correct_false(monkeypatch, fault, numbers):
    fault(monkeypatch)
    result = run_cell()
    assert result["correct"] is False
    for number in numbers:
        got = result["compared"][number]
        assert got["value"] > got["limit"], (number, got)


def _ctx(ticks):
    rec = core.Record()
    rec.ticks = ticks
    return core.Context(rec, None, {})


def test_the_plane_readers():
    split = {"phase:analyze": 900.0,
             "phase:analyze/shard_gather": 700.0,
             "phase:analyze/shard_gather/fleet_queries": 40.0,
             "phase:analyze/shard_gather/ring": 2.0,
             "shard_tick": 600.0,
             "shard_tick/phase:analyze/shard_capture": 8.0,
             "phase:analyze/fleet_merge": 50.0,
             "phase:analyze/fleet_merge/fleet_solve": 30.0}
    ticks = [{"ms": 1.0, "spans": split, "workers_ms": [140.0, 160.0]},
             {"ms": 1.0, "spans": split, "workers_ms": [150.0, 170.0]}]
    worker = core.load_module("metrics", "shard_worker_max_ms.shard")
    plane = core.load_module("metrics", "shard_plane_ms.shard")
    assert worker.read(_ctx(ticks)) == 165.0
    assert plane.read(_ctx(ticks)) == pytest.approx(
        700.0 - 40.0 - 600.0 + 8.0 + 50.0 - 30.0)
    # A program without the plane's spans, an untraced run.
    old = {"phase:analyze": 900.0, "shard_tick": 600.0}
    assert plane.read(_ctx([{"ms": 1.0, "spans": old}])) is None
    assert worker.read(_ctx([{"ms": 1.0}])) is None


@pytest.mark.cuda
def test_crash_proof_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "portbench/shard_crash.py", "--seed", "2900000017",
         "--models", "48"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-4000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["wrong_direction_events"] == 0
    assert out["reconverged_ticks"] <= 5 and out["shard_gap"] == 0
