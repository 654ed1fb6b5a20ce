"""What every cell shares: finding its files by name, the record a run
keeps, the reduction of a profiler trace, and what per-layer readers
see."""

from __future__ import annotations

import bisect
import collections
import gc
import importlib
import importlib.util
import json
import math
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
# Top-level module names that may not be loaded in a run's process: the
# JAX stack and the reference package the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "wva_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def cell(name: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic mix) of the cell ``name``."""
    spec = benchmark()
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(by_name)}")
    work = by_name[name]
    config = load_json(ROOT / "configs" / f"{work['config']}.json")
    traffic = load_json(ROOT / "traffic" / f"{work['traffic']}.json")
    return work, config, traffic


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}._{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(generator: str):
    return importlib.import_module(f"portbench.drivers.{generator}")


def forbidden_loaded(modules) -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is forbidden."""
    return sorted(m for m in modules
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def percentile(xs, q: float) -> float:
    """The q-th percentile of ``xs``, linear between order statistics."""
    xs = sorted(xs)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean(xs) -> float | None:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


class GcClock:
    """The interpreter's collections through ``gc.callbacks``: each one's
    start and end on the host clock."""

    def __init__(self):
        self.events, self._t0 = [], None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.events.append((self._t0, time.perf_counter()))
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def ms_within(self, t0: float, t1: float) -> float:
        return 1e3 * sum(b - a for a, b in self.events if t0 <= a <= t1)


# How many calls of each kind a run keeps for the comparison: the most
# that the compared numbers draw from them.
KEEP = {"fused": 8, "observation": 48, "scan": 4, "decisions": 4}


class Record:
    """What a run keeps in its measured window: the ticks (host-clock ms,
    outcome, span split, gc ms, models analyzed), host-clock timers of
    wrapped calls, each kernel launch's shapes (traced runs), and a sample
    of the calls the comparison judges: for each kind, ``KEEP[kind]``
    calls (or as many as the traffic file's ``keep`` names) drawn
    uniformly from all of the window's by a reservoir seeded from the
    run's seed, so what the run holds does not grow with the window."""

    def __init__(self, seed: int = 0, keep: dict | None = None):
        import numpy as np

        self.keep_counts = {**KEEP, **(keep or {})}
        self.ticks: list[dict] = []
        self.timers: dict[str, list[float]] = collections.defaultdict(list)
        self.launches: dict[str, list[dict]] = collections.defaultdict(list)
        self.calls: dict[str, list] = collections.defaultdict(list)
        self.offered: collections.Counter = collections.Counter()
        self.rng = np.random.default_rng([seed % (1 << 63), 0x5EED])
        self.window = (0.0, 0.0)
        self.recording = False
        self.traced = False

    def slot(self, kind: str) -> int | None:
        """Offer the window's next call of ``kind`` to its reservoir: the
        slot it takes in ``calls[kind]``, or None if it is not kept."""
        n = self.offered[kind]
        self.offered[kind] = n + 1
        k = self.keep_counts[kind]
        if n < k:
            return n
        j = int(self.rng.integers(n + 1))
        return j if j < k else None

    def keep(self, kind: str, slot: int, item) -> None:
        calls = self.calls[kind]
        if slot >= len(calls):
            calls.append(item)
        else:
            calls[slot] = item


class Context:
    """What a per-layer reader sees: the record, the reduced trace (or
    None), the card's peaks and the kernels' work counts."""

    def __init__(self, rec: Record, trace: dict | None, peaks: dict):
        self.rec, self.trace, self.peaks = rec, trace, peaks

    def roofline_pct(self, kernel: str) -> float | None:
        """The kernel's share of its roofline, in %: the least time the
        card could take for the work of its recorded launches (operations
        over the float32 peak, or bytes over the memory bandwidth,
        whichever is larger) over their device time in the trace."""
        if self.trace is None:
            return None
        count = load_module("kernels", kernel)
        launches = self.rec.launches.get(kernel, [])
        times = [d for name, ds in self.trace["kernels"].items()
                 if count.KERNEL in name for d in ds]
        if not launches or not times:
            return None
        ops = sum(count.work(call)[0] for call in launches)
        nbytes = sum(count.work(call)[1] for call in launches)
        least = max(ops / self.peaks["fp32_flops"],
                    nbytes / self.peaks["bytes_per_s"])
        # Launches recorded and kernels traced are the same launches; the
        # mean of each side keeps the share right if one count is off.
        return 100.0 * (least / len(launches)) / (sum(times) / len(times))


    def idle_pct(self, work: str) -> float | None:
        """The share of the traced window with no device activity, in %,
        where the window recorded ``work`` (``ticks``, or calls of that
        kind) and the trace holds device activity."""
        recorded = self.rec.ticks if work == "ticks" \
            else self.rec.calls.get(work)
        if self.trace is None or not recorded or not self.trace["kernels"]:
            return None
        return 100.0 * (1.0 - self.trace["busy_s"] / self.trace["window_s"])


def card_peaks(kind: str) -> dict:
    """The published peaks of the card ``kind`` from ``peaks.json``."""
    table = load_json(ROOT / "peaks.json")
    for name, peaks in table["cards"].items():
        if name in kind:
            return peaks
    raise SystemExit(f"no peaks for the card {kind!r} in portbench/peaks.json")


def reduce_trace(events, window_s: float, label_prefix: str = "portbench:"):
    """From a profiler's events: device time by kernel, the busy seconds
    (the union of every device activity), the ten device operations that
    took most time, and the idle time between device activities split by
    the innermost of the benchmark's host ranges over each moment of it."""
    device, ranges = [], []
    for e in events:
        kind = str(getattr(e, "device_type", ""))
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith(label_prefix):
            # The benchmark's host ranges; the profiler also mirrors them
            # on the device's timeline, where they are not device work.
            if not kind.endswith("CUDA"):
                ranges.append((start, end, e.name[len(label_prefix):]))
        elif kind.endswith("CUDA"):
            device.append((start, end, e.name))
    kernels = collections.defaultdict(list)
    by_op = collections.Counter()
    for start, end, name in device:
        kernels[name].append((end - start) * 1e-6)
        by_op[name] += (end - start) * 1e-6
    device.sort()
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for start, end, _ in device:
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, start))
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy += cur_e - cur_s
    idle = collections.Counter()
    segments = innermost_segments(ranges)
    starts = [a for a, _, _ in segments]
    for a, b in gaps:
        covered = 0.0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segments) and segments[i][0] < b:
            lo, hi = max(a, segments[i][0]), min(b, segments[i][1])
            if hi > lo:
                idle[segments[i][2]] += (hi - lo) * 1e-6
                covered += hi - lo
            i += 1
        if b - a > covered:
            idle["outside"] += (b - a - covered) * 1e-6
    return {"kernels": dict(kernels), "busy_s": busy * 1e-6,
            "window_s": window_s,
            "device_ops": [[n, s] for n, s in by_op.most_common(10)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(10)]}


def innermost_segments(ranges):
    """The timeline as ``(start, end, label)`` pieces, each labelled by
    the innermost of the host ranges over it. The ranges nest (one thread
    opens and closes them), so a stack of open ranges walks them in
    order."""
    segments, stack, cur = [], [], None

    def emit(a, b, label):
        if b > a:
            segments.append((a, b, label))

    for start, end, name in sorted(ranges):
        while stack and stack[-1][1] <= start:
            top = stack.pop()
            emit(cur, top[1], top[2])
            cur = top[1]
        if stack:
            emit(cur, start, stack[-1][2])
        stack.append((start, end, name))
        cur = start
    while stack:
        top = stack.pop()
        emit(cur, top[1], top[2])
        cur = top[1]
    return segments


def shorten(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."
