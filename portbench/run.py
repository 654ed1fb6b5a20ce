#!/usr/bin/env python3
"""Run one cell of the benchmark on the card and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``wva_tpu_torch``). It builds the cell's world from its
configuration and traffic files and the seed, warms up every shape the
window will run (set-up), measures for ``--seconds``, then compares what
the window produced with the plain reference and prints, as its last line
on standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics; with ``--trace 1``
its per-layer metrics, from a profiler trace of the window), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``compared``: each number
compared beside its limit, which also end standard error.

It exits non-zero and prints no result without a CUDA card, without the
port, if the JAX stack or the JAX package was loaded, or if a traced
window shows no device activity.
"""

from __future__ import annotations

import time

_T_SCRIPT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import zlib  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this
    script's first line."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_SCRIPT


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(message: str, code: int = 1):
    print(f"portbench: {message}", file=sys.stderr)
    raise SystemExit(code)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def compare(checks, rec, seed, device, cell, control=False):
    """[(name, value or None, limit)] for the cell's compared numbers."""
    import numpy as np

    from portbench import core

    out = []
    for name in checks:
        mod = core.load_module("checks", name)
        rng = np.random.default_rng([seed % (1 << 63),
                                     zlib.crc32(name.encode())])
        value = mod.reading(rec, rng, device, control=control, cell=cell)
        out.append((name, value, mod.LIMIT))
    return out


def run(args, device=None, controls=False):
    """One run; returns the result's dict. ``device`` None is the card.
    With ``controls`` the result also holds each compared number's
    control reading (the reference in the precision below the
    configuration's, in the program's place) under ``control``."""
    import torch

    from portbench import core
    from portbench.drivers import probes

    work, config, traffic = core.cell(args.workload)
    on_card = device is None
    if on_card:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < work["chips"]:
            fail(f"{args.workload} needs {work['chips']} CUDA device(s); "
                 f"found {torch.cuda.device_count()}", 2)
        device = "cuda"
    import wva_tpu_torch  # noqa: F401  (the program under test)

    rec = core.Record(args.seed, traffic.get("keep"))
    rec.traced = bool(args.trace)
    drv = core.driver(traffic["generator"]).Driver(
        config, traffic, args.seed, device, rec)
    prof = None
    try:
        drv.warm_up()
        if on_card:
            torch.cuda.synchronize()
        if args.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)
            prof.__enter__()
        setup_s = process_age_s()
        rec.recording = True
        t0 = time.perf_counter()
        with probes.labelled("window"):
            drv.window(args.seconds)
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        rec.recording = False
        if rec.window == (0.0, 0.0):
            rec.window = (t0, t1)
        trace = None
        if prof is not None:
            prof.__exit__(None, None, None)
            trace = core.reduce_trace(prof.events(),
                                      rec.window[1] - rec.window[0])
            prof = None
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        e2e = drv.end_to_end()
        attempted, failed = drv.counts()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        drv.close()
    rec.launches = probes.host_values(rec.launches)

    found = core.forbidden_loaded(sys.modules)
    if found:
        fail(f"modules of the JAX stack or package were loaded: {found}")
    if args.trace and on_card and not trace["kernels"]:
        fail("the profiler's trace of the window holds no device activity")

    spec = core.benchmark()

    def applies(metric):
        return args.workload in metric.get("workloads", [args.workload])

    metrics = {}
    if args.trace:
        kind = torch.cuda.get_device_name(0) if on_card else "cpu"
        ctx = core.Context(rec, trace, core.card_peaks(kind)
                           if on_card else {})
        for m in spec["per_layer"]:
            if applies(m):
                value = core.load_module("metrics", m["name"]).read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**e2e, "setup_s": setup_s}
        for m in spec["end_to_end"]:
            if applies(m) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    cell = {"scenario": getattr(drv, "scene", None), "config": config,
            "traffic": traffic, "seed": args.seed}
    compared = compare(traffic["checks"], rec, args.seed, device, cell)
    ok = [v is not None and math.isfinite(v) and v <= limit
          for _, v, limit in compared]
    result = {
        "correct": bool(all(ok) and attempted > 0 and failed == 0),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card
                   else "cpu",
                   "count": work["chips"], "memory_peak_bytes": peak}}
    if trace is not None:
        result["device"].update(busy_s=trace["busy_s"],
                                window_s=trace["window_s"])
        result["breakdown"] = {
            "device_ops": [[core.shorten(n), s]
                           for n, s in trace["device_ops"]],
            "idle_gaps": trace["idle_gaps"]}
        if on_card:
            print(f"card: {power_limit()}", file=sys.stderr)
    if controls:
        # The same test as the run's own, over the numbers that have a
        # control reading: the control has to come out as not correct.
        control = compare(traffic["checks"], rec, args.seed, device, cell,
                          True)
        result["control"] = {name: value for name, value, _ in control}
        result["control_correct"] = all(
            math.isfinite(v) and v <= limit
            for _, v, limit in control if v is not None)
    result["compared"] = {
        name: {"value": value, "limit": limit}
        for name, value, limit in compared}
    if rec.ticks:
        print("portbench: tick ms " + json.dumps(
            [round(t["ms"], 3) for t in rec.ticks]), file=sys.stderr)
    for name, value, limit in compared:
        print(f"compared {name}: {value} limit {limit}", file=sys.stderr)
    return result


def main(argv=None, device=None) -> int:
    args = parse(argv)
    result = run(args, device)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
