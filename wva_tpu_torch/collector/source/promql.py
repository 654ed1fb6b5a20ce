"""TSDB-lite + PromQL-subset evaluator.

The reference runs its e2e suites against a real Prometheus fed by a fake
inference server (SURVEY.md section 4). This module is the TPU build's
equivalent fidelity trick without a cluster: an in-memory time-series store
plus an evaluator for exactly the query shapes the autoscaler registers
(``internal/collector/registration/saturation.go:8-122``):

- aggregations:  sum | max | min | avg | count, with optional ``by (l1, l2)``
- range funcs:   rate | increase | max_over_time | avg_over_time
- selectors:     ``name{label="v",other!="w",re=~"x.*"}``
- binary ops:    vector / vector (label-matched), expr or expr
- literals:      numeric scalars

Prometheus semantics that matter for correctness are preserved: instant
lookback (5m), aggregation over an empty vector returns an EMPTY vector (not
0 — scale-to-zero safety depends on "no data" being distinguishable from 0),
division drops unmatched/zero-denominator series, and ``or`` keeps the right
side's series only when the left has no series with the same label set.

Storage is array-backed ring buffers per series (``array('d')`` timestamp +
value columns with a live-region offset): appends are O(1) amortized,
retention trims advance the offset instead of ``pop(0)``-ing objects, and
reads hand out :class:`SeriesWindow` views — bisect-sliced, zero-copy
snapshots — under striped per-series locks, so concurrent engine workers
never serialize on one store-wide mutex (docs/design/metrics-plane.md).
"""

from __future__ import annotations

import math
import re
import threading
from array import array
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field
from functools import lru_cache

from wva_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock

DEFAULT_LOOKBACK_SECONDS = 300.0
DEFAULT_RETENTION_SECONDS = 3600.0

_AGG_OPS = {"sum", "max", "min", "avg", "count"}
_RANGE_FUNCS = {"rate", "increase", "max_over_time", "avg_over_time"}

_DURATION_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m|h|d)$")
_DURATION_UNITS = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_promql_duration(s: str) -> float:
    m = _DURATION_RE.match(s)
    if not m:
        raise PromQLError(f"invalid duration {s!r}")
    return float(m.group(1)) * _DURATION_UNITS[m.group(2)]


def format_promql_duration(seconds: float) -> str:
    """Render seconds as a Prometheus range duration (reference
    utils.FormatPrometheusDuration)."""
    if seconds <= 0:
        return "0s"
    if seconds < 1:
        return f"{int(math.ceil(seconds * 1000))}ms"
    if seconds % 3600 == 0:
        return f"{int(seconds // 3600)}h"
    if seconds % 60 == 0:
        return f"{int(seconds // 60)}m"
    return f"{int(math.ceil(seconds))}s"


class PromQLError(ValueError):
    pass


@dataclass
class Sample:
    timestamp: float
    value: float


@dataclass
class SeriesPoint:
    """One evaluated output series."""

    labels: dict[str, str]
    value: float
    timestamp: float


@dataclass
class TrackMeta:
    """Validity metadata for one tracked evaluation (``query_tracked``) —
    the substrate of the grouped view's execution reuse
    (docs/design/informer.md §versioned-fingerprints).

    ``expiry_strict``: with NO further appends to the involved metrics,
    the result is byte-identical until this time (earliest point any
    included sample can leave its range window / instant lookback).

    ``expiry_b`` + ``uniform``: with only value-UNCHANGING appends, the
    result's VALUES (not timestamps) are identical until ``expiry_b`` —
    valid only when ``uniform`` (every matched series was included with a
    uniform window; an excluded or mixed-value series could change the
    result set without a value-version bump, so it disables this tier).
    """

    expiry_strict: float = float("inf")
    expiry_b: float = float("inf")
    uniform: bool = True


class SeriesWindow:
    """Zero-copy view over one series' samples in ``[lo, hi)``.

    Holds references to the backing timestamp/value arrays plus bounds taken
    under the series lock. Appends after the snapshot only extend the arrays
    past ``hi``; compaction replaces the arrays on the series (this view
    keeps the old ones) — so the window is immutable without copying a
    single sample. Supports ``len``/indexing/iteration yielding
    :class:`Sample` for compatibility with list-of-samples consumers."""

    __slots__ = ("ts", "vals", "lo", "hi", "series")

    def __init__(self, ts, vals, lo: int, hi: int, series=None) -> None:
        self.ts = ts
        self.vals = vals
        self.lo = lo
        self.hi = hi
        # Backing _Series (non-legacy reads only): the anchor for the
        # delta-maintained range-function memo. None on legacy windows
        # and sub-windows of anonymous callers — evaluation then scans.
        self.series = series

    def __len__(self) -> int:
        return self.hi - self.lo

    def __getitem__(self, i: int) -> Sample:
        n = self.hi - self.lo
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return Sample(self.ts[self.lo + i], self.vals[self.lo + i])

    def __iter__(self):
        for i in range(self.lo, self.hi):
            yield Sample(self.ts[i], self.vals[i])

    def latest_at_or_before(self, now: float) -> Sample | None:
        i = bisect_right(self.ts, now, self.lo, self.hi)
        if i <= self.lo:
            return None
        return Sample(self.ts[i - 1], self.vals[i - 1])

    def range_window(self, lo_ts: float, hi_ts: float) -> "SeriesWindow":
        """Sub-window of samples with ``lo_ts <= timestamp <= hi_ts``
        (bisect-sliced; no samples are touched)."""
        i = bisect_left(self.ts, lo_ts, self.lo, self.hi)
        j = bisect_right(self.ts, hi_ts, self.lo, self.hi)
        return SeriesWindow(self.ts, self.vals, i, j, series=self.series)


class _Series:
    """One series' column store: parallel timestamp/value arrays with a
    live-region start offset (the "ring"). Samples before ``start`` are
    retention-expired garbage awaiting compaction. The forecast plane's
    ``forecast/history.py`` ``RingColumns`` carries a twin of this layout
    and of ``_trim_locked``'s compaction heuristic (kept separate: its
    trim is per-ring-window on append, ours is store-retention under the
    stripe locks) — keep changes to the heuristic in sync.

    ``write_version`` is the store-wide monotonic stamp of this series'
    last append — the substrate of the versioned fingerprint plane
    (docs/design/informer.md §versioned-fingerprints): "no series of
    metric X stamped since T" plus the evaluation's validity bounds
    (:class:`TrackMeta`) prove a query over X evaluates identically."""

    __slots__ = ("labels", "ts", "vals", "start", "last_ts",
                 "write_version", "range_memo")

    def __init__(self, labels: dict[str, str]) -> None:
        self.labels = labels
        self.ts = array("d")
        self.vals = array("d")
        self.start = 0
        self.last_ts = float("-inf")
        self.write_version = 0
        # Delta-maintained range-function accumulators, keyed by
        # (func, window_len): (ts array ref, lo, hi, accumulator,
        # result). See _apply_range_func_delta — the rolling state that
        # makes a quiet series' rate/*_over_time evaluation free and a
        # live series' evaluation O(new samples) instead of O(window).
        # Entries are immutable tuples replaced atomically (GIL), so
        # concurrent readers race benignly.
        self.range_memo: dict[tuple, tuple] = {}

    def last_value_changed(self, value: float) -> bool:
        """Would appending ``value`` change this series' latest value?
        NaN-aware (NaN -> NaN is NOT a change): the per-name
        value-version must stay put under quiet re-scrapes of the same
        reading, including a stuck-NaN exporter."""
        n = len(self.vals)
        if n == 0:
            return True
        prev = self.vals[n - 1]
        if value != value and prev != prev:
            return False
        return value != prev


# Compiled-regex matcher cache: the registered query surface reuses a small
# fixed set of regex matchers, and compiling per evaluation dominated regex
# selector cost at fleet scale.
@lru_cache(maxsize=512)
def _compiled_re(pattern: str) -> "re.Pattern[str]":
    return re.compile(pattern)


class TimeSeriesDB:
    """Append-only store of samples keyed by full label set (incl __name__).

    Concurrency: one structure lock guards the series maps; sample appends
    and window snapshots take a striped per-series lock, so readers (the
    engine's analysis workers) and the emulator's ingest never contend on a
    single store-wide mutex. Timestamps per series are assumed
    non-decreasing (Prometheus rejects out-of-order appends; every producer
    here stamps a monotone clock)."""

    LOCK_STRIPES = 64
    # Time-gated global sweep: any ongoing ingest trims QUIESCENT series
    # too, so a series whose writes stopped cannot pin memory forever (the
    # old `len % 256` count gate never fired again once writes ceased).
    SWEEP_INTERVAL_SECONDS = 60.0
    # Compact a series' dead prefix once it dominates the array (amortized
    # O(1) per append; replaces the arrays so live zero-copy windows keep
    # their old snapshot).
    COMPACT_MIN_DEAD = 256

    def __init__(self, clock: Clock | None = None,
                 retention: float = DEFAULT_RETENTION_SECONDS) -> None:
        self.clock = clock or SYSTEM_CLOCK
        self.retention = retention
        self._mu = threading.Lock()
        self._stripes = [threading.Lock() for _ in range(self.LOCK_STRIPES)]
        self._series: dict[tuple, _Series] = {}
        # Metric-name index: __name__ -> series keys (insertion-ordered dict
        # so enumeration — and thus float-summation order in aggregations —
        # is deterministic). Every PromQL selector names its metric with an
        # equality matcher, so lookups touch only that metric's series — a
        # real Prometheus resolves selectors through its label index the
        # same way.
        self._by_name: dict[str, dict[tuple, None]] = {}
        # Per-metric-name write-versions: the store-wide monotonic counter
        # value of the last append to ANY series of that name (deletes
        # count too — a dropped series changes what a query can return).
        # Consumers (the grouped view's fingerprint plane) compare "max
        # version across the query's metric names" across ticks to prove
        # nothing was written — O(names) instead of O(series x samples).
        # _name_value_versions moves ONLY on value-CHANGING appends (and
        # first appends / drops): a quiet fleet re-scraping the same
        # readings every tick keeps it still, which is what lets the
        # fingerprint tier reuse uniform-window evaluations.
        self._ver_mu = threading.Lock()
        self._write_counter = 0
        self._name_versions: dict[str, int] = {}
        self._name_value_versions: dict[str, int] = {}
        self._last_sweep = float("-inf")
        # Compat levers for `make bench-tick` / `make bench-collect`:
        # - use_name_index=False reproduces the pre-index full-store scan;
        # - legacy_reads=True reproduces the pre-ring read path (one global
        #   lock held for the whole scan + a full copy of every matched
        #   series' samples), so the before/after numbers measure the real
        #   pre-change cost, not an already-optimized substrate.
        self.use_name_index = True
        self.legacy_reads = False
        # Delta-maintained range evaluation (ROADMAP item 1a): per-series
        # rolling accumulators make rate/*_over_time free for unchanged
        # windows and O(new samples) for appended ones, byte-identical to
        # the scanning evaluator (tests/test_promql.py). Off restores the
        # per-eval window scan.
        self.delta_range_eval = True
        # Introspection for the equality/cost tests: full window folds vs
        # suffix extensions vs memo hits since process start.
        self.range_scans = 0
        self.range_extends = 0
        self.range_hits = 0

    @staticmethod
    def _key(name: str, labels: dict[str, str]) -> tuple:
        return tuple(sorted({**labels, "__name__": name}.items()))

    def _lock_for(self, key: tuple) -> threading.Lock:
        return self._stripes[hash(key) % self.LOCK_STRIPES]

    def add_sample(self, name: str, labels: dict[str, str], value: float,
                   timestamp: float | None = None) -> None:
        ts = self.clock.now() if timestamp is None else timestamp
        key = self._key(name, labels)
        while True:
            s = self._series.get(key)
            if s is None:
                with self._mu:
                    s = self._series.get(key)
                    if s is None:
                        s = _Series({**labels, "__name__": name})
                        self._series[key] = s
                        self._by_name.setdefault(name, {})[key] = None
            with self._lock_for(key):
                # A concurrent sweep may have dropped this series between
                # the map read and taking the stripe lock; appending to the
                # orphaned object would silently lose the sample. Re-check
                # registration under the lock and retry (sweep only drops
                # fully-expired series, so one retry recreates it).
                if self._series.get(key) is not s:
                    continue
                value_changed = s.last_value_changed(value)
                s.ts.append(ts)
                s.vals.append(value)
                s.last_ts = ts
                s.write_version = self._bump_name_version(
                    name, value_changed)
                self._trim_locked(s, ts)
                break
        if ts - self._last_sweep >= self.SWEEP_INTERVAL_SECONDS:
            self.sweep(ts)

    set_gauge = add_sample  # gauges and counters are both just samples

    def _bump_name_version(self, name: str, value_changed: bool = True
                           ) -> int:
        # One store-wide lock for a 3-op critical section (int += and up
        # to two dict writes). Deliberately NOT striped: the version gate
        # is an equality compare, and lock-free/striped counters can lose
        # updates or publish out of order — a consumer could then read an
        # unchanged version across a real write and reuse a stale
        # evaluation. Correctness over a ~100ns uncontended lock.
        with self._ver_mu:
            self._write_counter += 1
            self._name_versions[name] = self._write_counter
            if value_changed:
                self._name_value_versions[name] = self._write_counter
            return self._write_counter

    def name_write_version(self, names) -> int:
        """Max write-version across ``names`` (0 = never written). Two
        equal reads bracket a window with NO appends/drops to any series
        of those metrics — the grouped fingerprint plane's evaluation-
        reuse gate (see :class:`~wva_tpu_torch.collector.source.grouped.
        SliceVersionBook`)."""
        with self._ver_mu:
            return max((self._name_versions.get(n, 0) for n in names),
                       default=0)

    def name_value_version(self, names) -> int:
        """Like :meth:`name_write_version` but moved only by
        value-CHANGING appends (and series creation/drops): quiet
        re-scrapes of the same readings keep it still, letting the
        fingerprint tier reuse uniform-window evaluations whose VALUES
        provably did not move (timestamps may have — which is why only
        the timestamp-free fingerprint tier may use this gate)."""
        with self._ver_mu:
            return max((self._name_value_versions.get(n, 0)
                        for n in names), default=0)

    def _trim_locked(self, s: _Series, now: float) -> None:
        """Advance the live-region start past retention (O(1) amortized —
        each sample is stepped over at most once) and compact when the dead
        prefix dominates. Caller holds the series' stripe lock."""
        cutoff = now - self.retention
        ts = s.ts
        start = s.start
        n = len(ts)
        while start < n and ts[start] < cutoff:
            start += 1
        s.start = start
        if start >= self.COMPACT_MIN_DEAD and start * 2 >= n:
            s.ts = ts[start:]
            s.vals = s.vals[start:]
            s.start = 0

    def sweep(self, now: float | None = None) -> int:
        """Trim every series to retention and drop series fully expired
        (no live samples and no write within retention). Called
        opportunistically from ``add_sample`` on a time gate; safe to call
        explicitly. Returns the number of series dropped."""
        now = self.clock.now() if now is None else now
        with self._mu:
            if self._last_sweep >= now:
                return 0
            self._last_sweep = now
            items = list(self._series.items())
        dead: list[tuple] = []
        for key, s in items:
            with self._lock_for(key):
                self._trim_locked(s, now)
                if s.start >= len(s.ts) and now - s.last_ts > self.retention:
                    dead.append(key)
        dropped = 0
        with self._mu:
            for key in dead:
                s = self._series.get(key)
                if s is None:
                    continue
                with self._lock_for(key):
                    if s.start < len(s.ts):  # raced a fresh append: keep
                        continue
                    del self._series[key]
                    dropped += 1
                    name = s.labels.get("__name__", "")
                    keys = self._by_name.get(name)
                    if keys is not None:
                        keys.pop(key, None)
                        if not keys:
                            del self._by_name[name]
        return dropped

    def live_sample_count(self) -> int:
        """Total retained (live-region) samples — the memory-bound guard
        the trim regression tests assert against."""
        with self._mu:
            items = list(self._series.items())
        total = 0
        for key, s in items:
            with self._lock_for(key):
                total += len(s.ts) - s.start
        return total

    def drop_series(self, name: str, labels: dict[str, str]) -> None:
        """Remove a series entirely (e.g. pod deleted — Prometheus staleness)."""
        with self._mu:
            key = self._key(name, labels)
            dropped = self._series.pop(key, None)
            keys = self._by_name.get(name)
            if keys is not None:
                keys.pop(key, None)
                if not keys:
                    del self._by_name[name]
        if dropped is not None:
            # An in-lookback series vanishing changes query results without
            # any append; the write-version must say so.
            self._bump_name_version(name)

    def matching_series(self, matchers: list[tuple[str, str, str]]):
        """Series whose labels satisfy all (label, op, value) matchers, as
        ``(labels, SeriesWindow)`` pairs. The windows are zero-copy
        snapshots; concurrent appends/compactions never mutate them. The
        label dicts are the STORE's own (never mutated after series
        creation) handed out by reference — evaluator outputs are
        read-only by contract, and the per-series dict copy was a
        measurable slice of fleet-wide queries at scale. Callers that
        publish labels onward must copy (the HTTP parse path and demux
        already build their own dicts)."""
        if self.legacy_reads:
            return self._matching_series_legacy(matchers)
        name_val = None
        if self.use_name_index:
            for lbl, op, val in matchers:
                if lbl == "__name__" and op == "=":
                    name_val = val
                    break
        with self._mu:
            if name_val is not None:
                keys = self._by_name.get(name_val)
                entries = ([] if keys is None
                           else [(k, self._series[k]) for k in keys])
            else:
                entries = list(self._series.items())
        # Pre-split the matchers once per query instead of re-dispatching
        # _match per (series, matcher): equality tests become direct dict
        # compares inside the loop, and the name matcher the index
        # already satisfied is dropped. At fleet scale the scan visits
        # thousands of series per select — the per-series function-call
        # fan-out was a measurable slice of every fleet-wide evaluation.
        eq: list[tuple[str, str]] = []
        rest: list[tuple[str, str, str]] = []
        for lbl, op, val in matchers:
            if lbl == "__name__" and op == "=" and val == name_val:
                continue  # every indexed entry carries this name
            if op == "=":
                eq.append((lbl, val))
            else:
                rest.append((lbl, op, val))
        out = []
        for key, s in entries:
            labels = s.labels
            ok = True
            for lbl, val in eq:
                if labels.get(lbl, "") != val:
                    ok = False
                    break
            if not ok or (rest and not all(
                    _match(labels.get(lbl, ""), op, val)
                    for lbl, op, val in rest)):
                continue
            with self._lock_for(key):
                window = SeriesWindow(s.ts, s.vals, s.start, len(s.ts),
                                      series=s)
            out.append((labels, window))
        return out

    def _matching_series_legacy(self, matchers):
        """Pre-ring read path for honest benchmarking: the whole scan holds
        ONE lock (readers serialize) and every matched series' samples are
        materialized into a fresh copy."""
        with self._mu:
            out = []
            for key, s in self._series.items():
                labels = s.labels
                if not all(_match(labels.get(lbl, ""), op, val)
                           for lbl, op, val in matchers):
                    continue
                with self._lock_for(key):
                    window = SeriesWindow(s.ts[s.start:], s.vals[s.start:],
                                          0, len(s.ts) - s.start)
                out.append((dict(labels), window))
            return out


def _match(actual: str, op: str, expected: str) -> bool:
    if op == "=":
        return actual == expected
    if op == "!=":
        return actual != expected
    if op == "=~":
        return _compiled_re(expected).fullmatch(actual) is not None
    if op == "!~":
        return _compiled_re(expected).fullmatch(actual) is None
    raise PromQLError(f"unknown matcher op {op!r}")


# --- AST ---

@dataclass
class Selector:
    name: str
    matchers: list[tuple[str, str, str]] = field(default_factory=list)
    range_seconds: float = 0.0  # >0 -> range selector


@dataclass
class FuncCall:
    func: str
    arg: Selector


@dataclass
class Aggregation:
    op: str
    by: list[str]
    arg: object


@dataclass
class BinaryOp:
    op: str  # "/" or "or"
    left: object
    right: object


@dataclass
class NumberLiteral:
    value: float


# --- Lexer/parser (recursive descent over the subset grammar) ---

_TOKEN_RE = re.compile(
    r"""
    (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<duration>\d+(?:\.\d+)?(?:ms|s|m|h|d)\b)
  | (?P<number>\d+(?:\.\d+)?)
  | (?P<ident>[a-zA-Z_:][a-zA-Z0-9_:]*)
  | (?P<op>=~|!~|!=|=|\{|\}|\(|\)|\[|\]|,|/)
  | (?P<ws>\s+)
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> list[tuple[str, str]]:
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise PromQLError(f"unexpected character {text[pos]!r} at {pos} in {text!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        tokens.append((kind, m.group()))
    return tokens


class _Parser:
    def __init__(self, text: str) -> None:
        self.text = text
        self.tokens = _tokenize(text)
        self.pos = 0

    def peek(self) -> tuple[str, str] | None:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> tuple[str, str]:
        tok = self.peek()
        if tok is None:
            raise PromQLError(f"unexpected end of query: {self.text!r}")
        self.pos += 1
        return tok

    def expect(self, value: str) -> None:
        tok = self.next()
        if tok[1] != value:
            raise PromQLError(f"expected {value!r}, got {tok[1]!r} in {self.text!r}")

    def parse(self):
        expr = self.parse_or()
        if self.peek() is not None:
            raise PromQLError(f"trailing tokens at {self.peek()} in {self.text!r}")
        return expr

    def parse_or(self):
        left = self.parse_div()
        while True:
            tok = self.peek()
            if tok and tok[0] == "ident" and tok[1] == "or":
                self.next()
                left = BinaryOp("or", left, self.parse_div())
            else:
                return left

    def parse_div(self):
        left = self.parse_primary()
        while True:
            tok = self.peek()
            if tok and tok[1] == "/":
                self.next()
                left = BinaryOp("/", left, self.parse_primary())
            else:
                return left

    def parse_primary(self):
        tok = self.peek()
        if tok is None:
            raise PromQLError(f"unexpected end of query: {self.text!r}")
        if tok[1] == "(":
            self.next()
            inner = self.parse_or()
            self.expect(")")
            return inner
        if tok[0] == "number":
            self.next()
            return NumberLiteral(float(tok[1]))
        if tok[0] == "ident":
            name = tok[1]
            if name in _AGG_OPS:
                return self.parse_aggregation()
            if name in _RANGE_FUNCS:
                return self.parse_func()
            if name == "vector":
                # vector(scalar) — Prometheus's connectivity-check idiom
                # ("vector(1)"), used by the startup validation.
                self.next()
                self.expect("(")
                num = self.next()
                if num[0] != "number":
                    raise PromQLError(
                        f"vector() expects a number, got {num[1]!r}")
                self.expect(")")
                return NumberLiteral(float(num[1]))
            return self.parse_selector()
        raise PromQLError(f"unexpected token {tok[1]!r} in {self.text!r}")

    def parse_aggregation(self):
        op = self.next()[1]
        by: list[str] = []
        tok = self.peek()
        if tok and tok[0] == "ident" and tok[1] == "by":
            self.next()
            self.expect("(")
            while True:
                t = self.next()
                if t[0] != "ident":
                    raise PromQLError(f"expected label name, got {t[1]!r}")
                by.append(t[1])
                t = self.next()
                if t[1] == ")":
                    break
                if t[1] != ",":
                    raise PromQLError(f"expected , or ) in by-clause, got {t[1]!r}")
        self.expect("(")
        arg = self.parse_or()
        self.expect(")")
        return Aggregation(op, by, arg)

    def parse_func(self):
        func = self.next()[1]
        self.expect("(")
        sel = self.parse_selector()
        self.expect(")")
        if sel.range_seconds <= 0:
            raise PromQLError(f"{func}() requires a range selector in {self.text!r}")
        return FuncCall(func, sel)

    def parse_selector(self) -> Selector:
        tok = self.next()
        if tok[0] != "ident":
            raise PromQLError(f"expected metric name, got {tok[1]!r}")
        sel = Selector(name=tok[1])
        nxt = self.peek()
        if nxt and nxt[1] == "{":
            self.next()
            while True:
                t = self.next()
                if t[1] == "}":
                    break
                if t[0] != "ident":
                    raise PromQLError(f"expected label name, got {t[1]!r}")
                label = t[1]
                op = self.next()[1]
                if op not in ("=", "!=", "=~", "!~"):
                    raise PromQLError(f"bad matcher op {op!r}")
                val_tok = self.next()
                if val_tok[0] != "string":
                    raise PromQLError(f"expected quoted value, got {val_tok[1]!r}")
                value = val_tok[1][1:-1].replace('\\"', '"').replace("\\\\", "\\")
                sel.matchers.append((label, op, value))
                t2 = self.peek()
                if t2 and t2[1] == ",":
                    self.next()
        nxt = self.peek()
        if nxt and nxt[1] == "[":
            self.next()
            dur = self.next()
            if dur[0] not in ("duration", "number"):
                raise PromQLError(f"expected duration, got {dur[1]!r}")
            sel.range_seconds = parse_promql_duration(dur[1]) \
                if dur[0] == "duration" else float(dur[1])
            self.expect("]")
        return sel


def parse_query(text: str):
    return _Parser(text).parse()


# --- AST -> PromQL serialization (the grouped-collection rewriter's other
# half: transformed ASTs must round-trip to query strings any Prometheus —
# real or this subset engine — accepts) ---

def _escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"')


def to_promql(node) -> str:
    """Serialize a (possibly transformed) AST back to PromQL text. Inverse
    of :func:`parse_query` up to whitespace/duration normalization."""
    if isinstance(node, NumberLiteral):
        v = node.value
        return str(int(v)) if float(v).is_integer() else repr(v)
    if isinstance(node, Selector):
        out = node.name
        if node.matchers:
            body = ",".join(f'{lbl}{op}"{_escape_label_value(val)}"'
                            for lbl, op, val in node.matchers)
            out += "{" + body + "}"
        if node.range_seconds > 0:
            out += f"[{format_promql_duration(node.range_seconds)}]"
        return out
    if isinstance(node, FuncCall):
        return f"{node.func}({to_promql(node.arg)})"
    if isinstance(node, Aggregation):
        by = f" by ({', '.join(node.by)})" if node.by else ""
        return f"{node.op}{by} ({to_promql(node.arg)})"
    if isinstance(node, BinaryOp):
        def operand(child) -> str:
            text = to_promql(child)
            return f"({text})" if isinstance(child, BinaryOp) else text
        joiner = " or " if node.op == "or" else " / "
        return operand(node.left) + joiner + operand(node.right)
    raise PromQLError(f"cannot serialize node {node!r}")


# --- Evaluator ---

def _series_identity(labels: dict[str, str]) -> tuple:
    return tuple(sorted((k, v) for k, v in labels.items() if k != "__name__"))


class PromQLEngine:
    # Parsed-AST cache bound: the query surface is a fixed template set with
    # per-(model, namespace) substitutions, so steady state holds a few
    # hundred distinct strings per fleet; the bound only guards pathological
    # callers. ASTs are immutable after parse, so sharing is safe.
    AST_CACHE_BOUND = 4096

    def __init__(self, db: TimeSeriesDB,
                 lookback: float = DEFAULT_LOOKBACK_SECONDS) -> None:
        self.db = db
        self.lookback = lookback
        self._ast_mu = threading.Lock()
        self._ast_cache: dict[str, object] = {}
        # Compat lever for `make bench-tick` (see TimeSeriesDB.use_name_index).
        self.cache_asts = True
        # Per-thread min-included-instant-sample tracking for
        # query_tracked (the grouped view's execution-reuse expiry bound).
        self._track = threading.local()

    def _parse_cached(self, text: str):
        if not self.cache_asts:
            return parse_query(text)
        with self._ast_mu:
            node = self._ast_cache.get(text)
        if node is None:
            node = parse_query(text)
            with self._ast_mu:
                if len(self._ast_cache) >= self.AST_CACHE_BOUND:
                    self._ast_cache.clear()
                self._ast_cache[text] = node
        return node

    def query(self, text: str, at: float | None = None) -> list[SeriesPoint]:
        now = self.db.clock.now() if at is None else at
        # Re-tokenizing the same template-rendered string every engine tick
        # cost more than evaluating it at fleet scale; parse once per
        # distinct string.
        return self._eval(self._parse_cached(text), now)

    def query_tracked(self, text: str, at: float | None = None
                      ) -> tuple[list[SeriesPoint], TrackMeta]:
        """``query`` plus the evaluation's validity metadata (see
        :class:`TrackMeta`) — how long the result provably stays current
        without writes (strict) or with only value-unchanging re-scrapes
        (the fingerprint tier's gate)."""
        self.begin_tracking()
        try:
            points = self.query(text, at)
        finally:
            meta = self.end_tracking()
        return points, meta

    def begin_tracking(self) -> None:
        """Start validity tracking on this thread (see query_tracked;
        split out so callers routing through an instance-level ``query``
        wrapper can still track)."""
        self._track.meta = TrackMeta()
        self._track.active = True

    def end_tracking(self) -> TrackMeta:
        self._track.active = False
        return getattr(self._track, "meta", None) or TrackMeta()

    def _track_instant(self, ts: float) -> None:
        """One included instant sample: the result holds until it ages
        past the lookback (same-value re-appends only extend that, so the
        bound serves both tiers)."""
        if not getattr(self._track, "active", False):
            return
        meta = self._track.meta
        expiry = ts + self.lookback
        if expiry < meta.expiry_strict:
            meta.expiry_strict = expiry
        if expiry < meta.expiry_b:
            meta.expiry_b = expiry

    def _track_excluded(self) -> None:
        """A matched series was EXCLUDED (empty/thin window, lookback-
        stale): value-unchanging appends could revive it — changing the
        result set without a value-version bump — so the uniform tier is
        off for this evaluation."""
        if getattr(self._track, "active", False):
            self._track.meta.uniform = False

    def _track_range(self, func: str, window: "SeriesWindow",
                     window_len: float) -> None:
        """One included range window. Range-func results depend only on
        the in-window SAMPLE SET (the extrapolation math uses sample
        timestamps, never eval time), so with no appends the result holds
        until the first sample departs (strict). A uniform window's VALUE
        additionally survives same-value appends + departures until it
        thins below the func's minimum sample count (tier b)."""
        if not getattr(self._track, "active", False):
            return
        meta = self._track.meta
        ts, vals, lo, hi = window.ts, window.vals, window.lo, window.hi
        strict = ts[lo] + window_len
        if strict < meta.expiry_strict:
            meta.expiry_strict = strict
        if not meta.uniform:
            return
        final = vals[hi - 1]
        for i in range(lo, hi - 1):
            if vals[i] != final:
                meta.uniform = False
                return
        min_idx = hi - 2 if func in ("rate", "increase") else hi - 1
        b = ts[max(lo, min_idx)] + window_len
        if b < meta.expiry_b:
            meta.expiry_b = b

    def _eval(self, node, now: float) -> list[SeriesPoint]:
        if isinstance(node, NumberLiteral):
            return [SeriesPoint({}, node.value, now)]
        if isinstance(node, Selector):
            return self._eval_instant(node, now)
        if isinstance(node, FuncCall):
            return self._eval_range_func(node, now)
        if isinstance(node, Aggregation):
            return self._eval_agg(node, now)
        if isinstance(node, BinaryOp):
            return self._eval_binop(node, now)
        raise PromQLError(f"unknown node {node!r}")

    def _select(self, sel: Selector):
        matchers = [("__name__", "=", sel.name)] + sel.matchers
        return self.db.matching_series(matchers)

    def _eval_instant(self, sel: Selector, now: float) -> list[SeriesPoint]:
        if sel.range_seconds > 0:
            raise PromQLError(f"range selector {sel.name} needs a function")
        legacy = self.db.legacy_reads
        out = []
        for labels, window in self._select(sel):
            if legacy:
                # Pre-ring shape: linear scan with per-sample objects.
                latest = None
                for s in window:
                    if s.timestamp <= now:
                        latest = s
                    else:
                        break
            else:
                latest = window.latest_at_or_before(now)
            if latest is None or now - latest.timestamp > self.lookback:
                self._track_excluded()
                continue
            self._track_instant(latest.timestamp)
            out.append(SeriesPoint(labels, latest.value, latest.timestamp))
        return out

    def _eval_range_func(self, call: FuncCall, now: float) -> list[SeriesPoint]:
        window_len = call.arg.range_seconds
        legacy = self.db.legacy_reads
        out = []
        for labels, window in self._select(call.arg):
            if legacy:
                # Pre-ring shape: full linear scan over every retained
                # sample, materializing Sample objects for the window —
                # the read-path cost `make bench-collect` measures as the
                # honest before.
                samples = [s for s in window
                           if now - window_len <= s.timestamp <= now]
                if not samples:
                    continue
                val = _apply_range_func_samples(call.func, samples,
                                                window_len)
                last_ts = samples[-1].timestamp
            else:
                in_window = window.range_window(now - window_len, now)
                if not len(in_window):
                    self._track_excluded()
                    continue
                self._track_range(call.func, in_window, window_len)
                if self.db.delta_range_eval:
                    val = _apply_range_func_delta(call.func, in_window,
                                                  window_len, self.db)
                else:
                    val = _apply_range_func(call.func, in_window,
                                            window_len)
                last_ts = in_window.ts[in_window.hi - 1]
            if val is None:
                self._track_excluded()
                continue
            result_labels = {k: v for k, v in labels.items() if k != "__name__"}
            out.append(SeriesPoint(result_labels, val, last_ts))
        return out

    def _eval_agg(self, agg: Aggregation, now: float) -> list[SeriesPoint]:
        inputs = self._eval(agg.arg, now)
        if not inputs:
            return []  # Prometheus: aggregation over empty vector is empty
        # Group keys are the sorted (label, value) item tuples — built
        # directly from the PRE-sORTED by-label names, so the per-point
        # dict + sort the old shape paid at fleet scale is gone while the
        # key (and thus output ordering) stays byte-identical.
        by_sorted = sorted(agg.by)
        groups: dict[tuple, list[SeriesPoint]] = {}
        for point in inputs:
            labels = point.labels
            key = tuple((l, labels.get(l, "")) for l in by_sorted)
            groups.setdefault(key, []).append(point)
        out = []
        for key, points in sorted(groups.items()):
            values = [p.value for p in points]
            if agg.op == "sum":
                val = sum(values)
            elif agg.op == "max":
                val = max(values)
            elif agg.op == "min":
                val = min(values)
            elif agg.op == "avg":
                val = sum(values) / len(values)
            elif agg.op == "count":
                val = float(len(values))
            else:
                raise PromQLError(f"unknown aggregation {agg.op!r}")
            out.append(SeriesPoint(dict(key), val, max(p.timestamp for p in points)))
        return out

    def _eval_binop(self, node: BinaryOp, now: float) -> list[SeriesPoint]:
        left = self._eval(node.left, now)
        if node.op == "or":
            right = self._eval(node.right, now)
            if not right:
                # Common registered-template shape: "vllm_metric or
                # jetstream_metric" where one engine's family is entirely
                # absent — skip the fleet-sized identity-set build.
                return left
            left_ids = {_series_identity(p.labels) for p in left}
            return left + [p for p in right if _series_identity(p.labels) not in left_ids]
        if node.op == "/":
            right = self._eval(node.right, now)
            # scalar division
            if len(right) == 1 and not right[0].labels:
                divisor = right[0].value
                if divisor == 0:
                    return []
                return [SeriesPoint(p.labels, p.value / divisor, p.timestamp) for p in left]
            right_by_id = {_series_identity(p.labels): p for p in right}
            out = []
            for p in left:
                match = right_by_id.get(_series_identity(p.labels))
                if match is None or match.value == 0:
                    continue  # unmatched or div-by-zero series are dropped
                out.append(SeriesPoint(p.labels, p.value / match.value, p.timestamp))
            return out
        raise PromQLError(f"unknown binary op {node.op!r}")


def _fold_range_acc(func: str, vals, lo: int, hi: int) -> float:
    """Left fold of the range function's accumulator over ``[lo, hi)`` —
    operation-for-operation the same fold the scanning evaluator runs
    (sum / running max / positive-delta total), so a fold extended over
    an appended suffix is bitwise the fold recomputed from scratch."""
    if func == "max_over_time":
        m = vals[lo]
        for i in range(lo + 1, hi):
            v = vals[i]
            if v > m:
                m = v
        return m
    if func == "avg_over_time":
        total = 0.0
        for i in range(lo, hi):
            total += vals[i]
        return total
    # rate / increase: positive-delta accumulation with counter-reset
    # handling, exactly _apply_range_func's loop.
    total = 0.0
    prev = vals[lo]
    for i in range(lo + 1, hi):
        v = vals[i]
        delta = v - prev
        total += delta if delta >= 0 else v
        prev = v
    return total


def _extend_range_acc(func: str, vals, m_hi: int, hi: int,
                      acc: float) -> float:
    """Continue the fold from a memoized prefix ``[lo, m_hi)`` over the
    appended suffix ``[m_hi, hi)``. A left fold's partial result plus the
    remaining terms in order IS the full fold — no re-association, so
    the extension is exact (the byte-equality the lever test asserts)."""
    if func == "max_over_time":
        m = acc
        for i in range(m_hi, hi):
            v = vals[i]
            if v > m:
                m = v
        return m
    if func == "avg_over_time":
        total = acc
        for i in range(m_hi, hi):
            total += vals[i]
        return total
    total = acc
    prev = vals[m_hi - 1]
    for i in range(m_hi, hi):
        v = vals[i]
        delta = v - prev
        total += delta if delta >= 0 else v
        prev = v
    return total


def _range_result(func: str, acc: float, ts, lo: int, hi: int,
                  window_len: float) -> float | None:
    """Finish a range function from its accumulator: O(1) — everything
    else the scanning evaluator derives comes from the window's first/
    last timestamps and the sample count."""
    if func == "max_over_time":
        return acc
    if func == "avg_over_time":
        return acc / (hi - lo)
    if hi - lo < 2:
        return None
    span = ts[hi - 1] - ts[lo]
    if span <= 0:
        return None
    window_start = ts[hi - 1] - window_len
    interval = span / (hi - lo - 1)
    limit = interval * 1.1
    extend_start = min(max(ts[lo] - window_start, 0.0), limit)
    scaled = acc * ((span + extend_start) / span)
    return scaled / window_len if func == "rate" else scaled


def _apply_range_func_delta(func: str, window: SeriesWindow,
                            window_len: float, db: TimeSeriesDB
                            ) -> float | None:
    """Delta-maintained twin of :func:`_apply_range_func` (ROADMAP item
    1a): per-(series, func, window) rolling accumulators keyed to the in-
    window sample set. An unchanged window (quiet series) returns the
    memoized result with zero fold work; an appended window extends the
    fold over only the new samples; a window whose LEFT edge moved
    (samples expired out) rescans — the left fold cannot be un-folded
    exactly, and byte-equality with the scanning evaluator is the
    contract. The memo anchors on the backing array OBJECT (compaction
    replaces arrays, so a replaced ring can never alias a stale memo),
    holding the old array alive at most until the next evaluation
    refreshes the entry. Counters (range_hits/extends/scans) are test
    introspection, not synchronized."""
    s = window.series
    if s is None:
        db.range_scans += 1
        return _apply_range_func(func, window, window_len)
    ts, vals, lo, hi = window.ts, window.vals, window.lo, window.hi
    key = (func, window_len)
    memo = s.range_memo.get(key)
    acc = None
    if memo is not None and memo[0] is ts and memo[1] == lo:
        _ref, _lo, m_hi, m_acc, m_val = memo
        if m_hi == hi:
            db.range_hits += 1
            return m_val
        if hi > m_hi:
            db.range_extends += 1
            acc = _extend_range_acc(func, vals, m_hi, hi, m_acc)
    if acc is None:
        db.range_scans += 1
        acc = _fold_range_acc(func, vals, lo, hi)
    val = _range_result(func, acc, ts, lo, hi, window_len)
    if len(s.range_memo) >= 16:  # bound pathological window_len churn
        s.range_memo.clear()
    s.range_memo[key] = (ts, lo, hi, acc, val)
    return val


def _apply_range_func(func: str, window: SeriesWindow,
                      window_len: float) -> float | None:
    ts, vals, lo, hi = window.ts, window.vals, window.lo, window.hi
    if func == "max_over_time":
        return max(vals[i] for i in range(lo, hi))
    if func == "avg_over_time":
        return sum(vals[i] for i in range(lo, hi)) / (hi - lo)
    if func in ("rate", "increase"):
        if hi - lo < 2:
            return None
        # Counter-reset handling: accumulate positive deltas.
        total = 0.0
        prev = vals[lo]
        for i in range(lo + 1, hi):
            v = vals[i]
            delta = v - prev
            total += delta if delta >= 0 else v
            prev = v
        span = ts[hi - 1] - ts[lo]
        if span <= 0:
            return None
        # Prometheus-style bounded extrapolation: extend toward the window
        # edges by at most ~one sample interval per side, so a series younger
        # than the window isn't inflated to the full window.
        window_start = ts[hi - 1] - window_len  # eval time ~ last sample
        interval = span / (hi - lo - 1)
        limit = interval * 1.1
        extend_start = min(max(ts[lo] - window_start, 0.0), limit)
        scaled = total * ((span + extend_start) / span)
        return scaled / window_len if func == "rate" else scaled
    raise PromQLError(f"unknown range function {func!r}")


def _apply_range_func_samples(func: str, samples: list[Sample],
                              window: float) -> float | None:
    """Sample-list twin of :func:`_apply_range_func` — the pre-ring code
    path, kept only for the ``legacy_reads`` bench lever. Same math."""
    values = [s.value for s in samples]
    if func == "max_over_time":
        return max(values)
    if func == "avg_over_time":
        return sum(values) / len(values)
    if func in ("rate", "increase"):
        if len(samples) < 2:
            return None
        total = 0.0
        prev = samples[0].value
        for s in samples[1:]:
            delta = s.value - prev
            total += delta if delta >= 0 else s.value
            prev = s.value
        span = samples[-1].timestamp - samples[0].timestamp
        if span <= 0:
            return None
        window_start = samples[-1].timestamp - window
        interval = span / (len(samples) - 1)
        limit = interval * 1.1
        extend_start = min(max(samples[0].timestamp - window_start, 0.0), limit)
        scaled = total * ((span + extend_start) / span)
        return scaled / window if func == "rate" else scaled
    raise PromQLError(f"unknown range function {func!r}")
