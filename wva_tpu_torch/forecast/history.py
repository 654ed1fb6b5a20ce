"""Per-model demand history store.

Same storage discipline as the TSDB's series columns
(``collector/source/promql.py`` ``_Series``): parallel ``array('d')``
timestamp/value columns with a live-region start offset — appends are O(1)
amortized, retention trims advance the offset instead of ``pop(0)``-ing
objects, and reads hand out zero-copy :class:`SeriesWindow` views.

Two tiers per key, because the forecaster registry reads two grids:

- **fine** — every sample (engine ticks + fast-path feed, seconds apart),
  bounded by ``fine_window_seconds``; feeds the recent-trend forecasters
  (linear, Holt).
- **long** — decimated to ``long_gap_seconds`` between samples, bounded by
  ``window_seconds`` (>= 2 seasonal periods); feeds the seasonal
  forecasters (seasonal-naive, Holt-Winters), which need days of context a
  dense ring could not hold at bounded memory.
"""

from __future__ import annotations

import threading
from array import array
from dataclasses import dataclass

from wva_tpu_torch.collector.source.promql import SeriesWindow


class RingColumns:
    """One series' column store: parallel timestamp/value arrays with a
    live-region start offset — the same layout and trim/compaction
    discipline as the TSDB's ``promql._Series``, deliberately a SEPARATE
    implementation rather than an extraction: the TSDB trims against a
    store-wide retention under striped locks on its ingest hot path, while
    this ring owns a per-ring window and trims inline on append. If you
    change the compaction heuristic here, check
    ``collector/source/promql.py`` ``_trim_locked`` for the twin."""

    __slots__ = ("ts", "vals", "start", "last_ts", "window_seconds")

    COMPACT_MIN_DEAD = 256

    def __init__(self, window_seconds: float) -> None:
        self.ts = array("d")
        self.vals = array("d")
        self.start = 0
        self.last_ts = float("-inf")
        self.window_seconds = window_seconds

    def append(self, ts: float, value: float) -> None:
        # Monotonic guard: the store is fed by several cadences (engine tick,
        # fast path); an out-of-order stamp would break the bisect reads.
        if ts < self.last_ts:
            return
        self.ts.append(ts)
        self.vals.append(value)
        self.last_ts = ts
        cutoff = ts - self.window_seconds
        start, n = self.start, len(self.ts)
        while start < n and self.ts[start] < cutoff:
            start += 1
        self.start = start
        if start >= self.COMPACT_MIN_DEAD and start * 2 >= n:
            self.ts = self.ts[start:]
            self.vals = self.vals[start:]
            self.start = 0

    def __len__(self) -> int:
        return len(self.ts) - self.start

    def window(self) -> SeriesWindow:
        """Zero-copy view of the live region (immutable snapshot: appends
        only extend past ``hi``; compaction replaces the arrays)."""
        return SeriesWindow(self.ts, self.vals, self.start, len(self.ts))


@dataclass
class _KeyHistory:
    fine: RingColumns
    long: RingColumns


@dataclass
class HistoryKeyStats:
    samples_fine: int
    samples_long: int
    span_seconds: float
    staleness_seconds: float


class DemandHistoryStore:
    """Thread-safe per-key (``"ns|model"``) demand history, two-tier rings."""

    def __init__(self, window_seconds: float = 2 * 86400.0,
                 fine_window_seconds: float = 1800.0,
                 long_gap_seconds: float = 0.0) -> None:
        self.window_seconds = window_seconds
        self.fine_window_seconds = min(fine_window_seconds, window_seconds)
        # Decimation gap for the long ring: default sized so the long ring
        # holds the whole window in ~1k samples regardless of feed cadence.
        self.long_gap_seconds = long_gap_seconds or max(
            window_seconds / 1024.0, 1.0)
        self._mu = threading.Lock()
        self._keys: dict[str, _KeyHistory] = {}

    def observe(self, key: str, now: float, demand: float) -> None:
        with self._mu:
            h = self._keys.get(key)
            if h is None:
                h = _KeyHistory(fine=RingColumns(self.fine_window_seconds),
                                long=RingColumns(self.window_seconds))
                self._keys[key] = h
            h.fine.append(now, demand)
            if now - h.long.last_ts >= self.long_gap_seconds:
                h.long.append(now, demand)

    def windows(self, key: str) -> tuple[SeriesWindow, SeriesWindow] | None:
        """(fine, long) zero-copy views, or None for an unknown key."""
        with self._mu:
            h = self._keys.get(key)
            if h is None:
                return None
            return h.fine.window(), h.long.window()

    def keys(self) -> list[str]:
        with self._mu:
            return sorted(self._keys)

    def evict_idle(self, now: float) -> int:
        """Drop keys whose newest sample fell out of the window (deleted /
        renamed models must not pin rings forever); returns count dropped.
        Deliberately time-based, NOT active-set-based: a model scaled to
        zero keeps its history so the pre-wake forecast can still see its
        seasonal pattern."""
        with self._mu:
            stale = [k for k, h in self._keys.items()
                     if now - h.long.last_ts > self.window_seconds]
            for k in stale:
                del self._keys[k]
            return len(stale)

    def stats(self, now: float) -> dict[str, HistoryKeyStats]:
        with self._mu:
            out = {}
            for k, h in self._keys.items():
                w = h.long.window()
                span = (w.ts[w.hi - 1] - w.ts[w.lo]) if len(w) >= 2 else 0.0
                out[k] = HistoryKeyStats(
                    samples_fine=len(h.fine),
                    samples_long=len(h.long),
                    span_seconds=span,
                    staleness_seconds=(now - h.long.last_ts
                                       if len(h.long) else float("inf")),
                )
            return out
