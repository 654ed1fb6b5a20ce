#!/usr/bin/env python3
"""Readings that set and prove the limits of a cell's compared numbers.

    python3 portbench/prove.py --workload <name> --seeds <n,n,...> \\
        --seconds <s> [--controls <k>] [--headline <seed>]

Runs the cell once a seed in this one process (each run builds its world
from its seed, warms up and measures for ``--seconds``) and prints one
JSON line a seed: its compared numbers and, for the first ``--controls``
seeds, each number's control reading: the reference computed in the
precision below the configuration's (bfloat16 for float32) put in the
program's place, held to the same limits as the run's own numbers
(``control_correct``). It exits non-zero if a seed's run is not correct
or a control is. With ``--headline`` it first runs one whole world of an
emulated-world cell on that seed and prints its outcome. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from portbench import run  # noqa: E402


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--headline", type=int, default=None)
    a = p.parse_args(argv)
    if a.headline is not None:
        print(json.dumps({"headline": headline(a.workload, a.headline,
                                               device)}), flush=True)
    failed = False
    for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
        args = run.parse(["--workload", a.workload, "--seed", str(seed),
                          "--seconds", str(a.seconds), "--trace", "0"])
        result = run.run(args, device, controls=i < a.controls)
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"],
                          "compared": result["compared"],
                          "control": result.get("control"),
                          "control_correct": result.get("control_correct"),
                          "metrics": result["metrics"],
                          "device": result["device"]}), flush=True)
        if not result["correct"] or result.get("control_correct"):
            failed = True
    return 1 if failed else 0


def headline(workload: str, seed: int, device) -> dict:
    """One whole world of the cell on ``seed``, unrecorded: its outcome."""
    import torch

    from portbench import core

    _, config, traffic = core.cell(workload)
    if device is None and not torch.cuda.is_available():
        run.fail("no CUDA device", 2)
    drv = core.driver(traffic["generator"]).Driver(
        config, traffic, seed, device or "cuda", core.Record())
    try:
        return drv.run_world(seed)
    finally:
        drv.close()


if __name__ == "__main__":
    sys.exit(main())
