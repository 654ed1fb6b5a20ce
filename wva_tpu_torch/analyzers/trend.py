"""Per-model demand-trend estimation for provisioning-horizon anticipation.

TPU slices take minutes to provision and load a model (2-7 min design point,
BASELINE.md); a replica sized for TODAY's demand is already undersized by the
time it becomes ready when load is ramping. The estimator tracks each model's
demand series and returns the growth rate (units/second) from a least-squares
fit over a sliding window, so analyzers can size scale-up for
``demand + max(slope, 0) * provisioning_horizon``.

This machinery has no reference equivalent — the reference reacts to current
saturation only (its cascade-prevention blocks over-reaction but nothing
anticipates ramps; SURVEY.md section 7 "hard parts" #4 calls out slow slice
provisioning as correctness-critical).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass

DEFAULT_WINDOW_SECONDS = 180.0
# Slope needs at least this much time span to be meaningful; below it the
# estimator returns 0 (no anticipation) rather than extrapolating noise.
MIN_SPAN_SECONDS = 20.0
MIN_SAMPLES = 2
MAX_SAMPLES_PER_KEY = 256
# A series whose average inter-sample gap is at least this is a SPARSE
# feeder (engine ticks only, 10-30s apart) and may use the conservative
# 2-point/20s rule; densely fed series (fast-path samples every few
# seconds) must satisfy min_samples — a dense feeder can never
# legitimately hold just 2 samples spanning 20s.
SPARSE_GAP_SECONDS = 10.0
# Idle-key eviction floor: a key whose newest sample is older than
# max(IDLE_EVICT_MIN_SECONDS, 2*window, min_age + window) is dropped on the
# next observe() sweep. Callers that rename/delete VAs without ever calling
# evict_missing (long-lived controllers with churning models) would
# otherwise accumulate dead deques forever. The floor is deliberately far
# above any live feed cadence: evicting a LIVE series would reset its
# first_seen and re-impose the min_age anticipation blindness.
IDLE_EVICT_MIN_SECONDS = 300.0
IDLE_SWEEP_INTERVAL_SECONDS = 60.0


@dataclass
class TrendSeriesStats:
    """Health snapshot of one key's series (stats() hook; surfaced as
    ``wva_trend_*`` gauges)."""

    samples: int
    staleness_seconds: float  # now - newest sample
    age_seconds: float  # now - first_seen (min_age gate progress)


class DemandTrend:
    """Thread-safe sliding-window linear-trend estimator keyed by model.

    ``min_span_seconds``/``min_samples`` trade anticipation latency against
    noise: a sparse series (one sample per engine tick) needs a long span to
    be meaningful, while a densely fed series (the fast-path monitor samples
    every few seconds) supports a short span because the least-squares fit
    averages many points."""

    def __init__(self, window_seconds: float = DEFAULT_WINDOW_SECONDS,
                 min_span_seconds: float = MIN_SPAN_SECONDS,
                 min_samples: int = MIN_SAMPLES,
                 min_age_seconds: float = 0.0,
                 fast_window_seconds: float = 0.0) -> None:
        self.window_seconds = window_seconds
        self.min_span_seconds = min_span_seconds
        self.min_samples = max(min_samples, 2)
        # Optional second fit over only the most recent samples. A fit over
        # a window that mixes pre-ramp flat samples with a fresh ramp
        # UNDERESTIMATES the current slope by r^2(3w-2r)/w^3 (r = ramp age,
        # w = window) — for slow-provisioning capacity every second of
        # underestimate is backlog at landing. The reported slope is
        # max(full fit, recent fit); the recent fit needs its own minimum
        # span/samples before it participates. 0 = off.
        self.fast_window_seconds = fast_window_seconds
        # Telemetry spin-up gate: a freshly created series climbs from 0 to
        # the true rate as the backing rate() window fills — a pure
        # measurement artifact that least-squares reads as a steep ramp
        # (observed fabricating a 6-replica scale-up on flat load). Slope
        # stays 0 until the series has existed at least this long, set by
        # callers to their telemetry window + margin. Accepted tradeoff:
        # series age is process-local, so a controller restart re-imposes
        # one gate-length of anticipation blindness even though the backing
        # counter is old and accurate — during which the demand/backlog
        # terms still drive reactive scale-up, only the slope extrapolation
        # is lost. The alternative (no gate) fabricates scale-ups and
        # migration churn on EVERY new model, which is the common case.
        self.min_age_seconds = min_age_seconds
        self._mu = threading.Lock()
        self._series: dict[str, deque[tuple[float, float]]] = {}
        self._first_seen: dict[str, float] = {}
        self._last_idle_sweep = float("-inf")

    def observe(self, key: str, now: float, demand: float) -> float:
        """Record a sample and return the current demand slope (units/s)."""
        with self._mu:
            self._sweep_idle_locked(now)
            series = self._series.setdefault(
                key, deque(maxlen=MAX_SAMPLES_PER_KEY))
            first_seen = self._first_seen.setdefault(key, now)
            if now - first_seen < self.min_age_seconds:
                # Spin-up samples are DROPPED, not merely ignored: leaving
                # them in the window would poison the fit for a full
                # window length after the gate lifts.
                return 0.0
            series.append((now, demand))
            while series and now - series[0][0] > self.window_seconds:
                series.popleft()
            slope = self._slope(series)
            if self.fast_window_seconds > 0:
                recent = [(t, d) for t, d in series
                          if now - t <= self.fast_window_seconds]
                slope = max(slope, self._slope(recent))
            return slope

    def evict(self, key: str) -> None:
        with self._mu:
            self._series.pop(key, None)
            self._first_seen.pop(key, None)

    def evict_missing(self, active_keys: set[str]) -> int:
        """Drop series for models no longer tracked (prevents unbounded key
        growth as models come and go); returns how many were dropped."""
        with self._mu:
            stale = [k for k in self._series if k not in active_keys]
            for k in stale:
                del self._series[k]
                self._first_seen.pop(k, None)
            return len(stale)

    def evict_idle(self, now: float) -> int:
        """Force an idle-key sweep now (the time gate normally amortizes it
        into observe()); returns how many keys were dropped."""
        with self._mu:
            self._last_idle_sweep = float("-inf")
            return self._sweep_idle_locked(now)

    def _idle_threshold(self) -> float:
        return max(IDLE_EVICT_MIN_SECONDS, 2 * self.window_seconds,
                   self.min_age_seconds + self.window_seconds)

    def _sweep_idle_locked(self, now: float) -> int:
        """Time-gated idle-key eviction: callers that never invoke
        evict_missing (deleted/renamed VAs on a long-lived controller) must
        not leak per-key deques forever. Caller holds the lock."""
        if now - self._last_idle_sweep < IDLE_SWEEP_INTERVAL_SECONDS:
            return 0
        self._last_idle_sweep = now
        cutoff = self._idle_threshold()
        stale = [k for k, s in self._series.items()
                 if not s or now - s[-1][0] > cutoff]
        # A gated series (all samples dropped by min_age) holds an empty
        # deque; judge it by first_seen so a model idle since creation is
        # still evicted.
        dropped = 0
        for k in stale:
            if not self._series[k] and \
                    now - self._first_seen.get(k, now) <= cutoff:
                continue
            del self._series[k]
            self._first_seen.pop(k, None)
            dropped += 1
        return dropped

    def stats(self, now: float) -> dict[str, TrendSeriesStats]:
        """Per-key health snapshot (sample count, staleness, age) —
        surfaced by the engine as ``wva_trend_*`` gauges."""
        with self._mu:
            out = {}
            for k, s in self._series.items():
                out[k] = TrendSeriesStats(
                    samples=len(s),
                    staleness_seconds=(now - s[-1][0] if s
                                       else float("inf")),
                    age_seconds=now - self._first_seen.get(k, now),
                )
            return out

    def _slope(self, series: deque[tuple[float, float]]) -> float:
        n = len(series)
        if n < 2:
            return 0.0
        t0 = series[0][0]
        span = series[-1][0] - t0
        # Two regimes: a densely fed series qualifies at (min_samples,
        # min_span); a genuinely sparse one (one sample per engine tick when
        # the fast-path feed is off — detected by its inter-sample gap)
        # falls back to the conservative 2-point / MIN_SPAN_SECONDS rule
        # rather than waiting min_samples ticks. The gap test keeps the
        # min_samples noise guard binding for dense feeders.
        dense_ok = n >= self.min_samples and span >= self.min_span_seconds
        sparse_ok = (span >= max(self.min_span_seconds, MIN_SPAN_SECONDS)
                     and span / (n - 1) >= SPARSE_GAP_SECONDS)
        if not (dense_ok or sparse_ok):
            return 0.0
        # Least-squares slope of demand over time.
        sum_t = sum_d = sum_tt = sum_td = 0.0
        for t, d in series:
            x = t - t0
            sum_t += x
            sum_d += d
            sum_tt += x * x
            sum_td += x * d
        denom = n * sum_tt - sum_t * sum_t
        if denom <= 0:
            return 0.0
        return (n * sum_td - sum_t * sum_d) / denom
