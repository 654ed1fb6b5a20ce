"""Measured provisioning lead times.

Replaces the static provisioning-horizon constant
(``anticipationHorizonSeconds``) with the per-(accelerator, model) quantile
of OBSERVED actuation->ready latencies. The engine feeds each model's
variant states every tick; the estimator opens an episode when a variant's
desired replicas exceed its ready replicas (a scale-up is in flight), and
closes it when ready catches up — the elapsed time is one lead-time sample
covering the whole real chain: HPA/actuator reaction, slice provisioning,
multi-host group assembly, model load, readiness. In the emulation harness
those transitions are driven by ``emulator/kubelet.py``'s ``ready_at``
physics; in live mode by pod readiness as reflected in scale-target status.

Samples are kept in small per-(accelerator, model) rings; the estimate is a
configurable quantile (default p90 — sizing for the common-case lead time
under-provisions whenever provisioning lands slow, and slow is exactly when
backlog hurts most). Fallback order: (accelerator, model) -> accelerator ->
configured default.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from dataclasses import dataclass

MAX_SAMPLES = 64
# An episode that outlives this is abandoned (deleted variant, wedged
# provisioning the operator resolved by other means): recording it would
# poison the quantile with an unbounded outlier.
EPISODE_TIMEOUT_SECONDS = 3600.0


@dataclass
class _Episode:
    started: float
    goal: int
    accelerator: str
    # Phase split: the instant the goal count of replicas became SCHEDULED
    # (pods bound — the slice exists; what remains is model load +
    # readiness). 0 = not reached yet. An episode that never reaches
    # scheduled (provisioning stockout) times out and records NOTHING:
    # a wedged order must not pollute either phase's p90.
    scheduled_at: float = 0.0
    tier: str = ""


class LeadTimeEstimator:
    """Thread-safe actuation->ready latency tracker, split into an
    actuation->scheduled phase (slice provisioning, measured per
    (variant, tier)) and a scheduled->ready phase (model load/readiness,
    per variant). The full-chain quantile remains the planner's horizon;
    the provisioning phase feeds the capacity ledger's ETA math."""

    def __init__(self, quantile: float = 0.9,
                 default_seconds: float = 150.0) -> None:
        self.quantile = min(max(quantile, 0.0), 1.0)
        self.default_seconds = default_seconds
        self._mu = threading.Lock()
        # (model_key, accelerator) -> ring of observed latencies (seconds).
        self._samples: dict[tuple[str, str], deque[float]] = {}
        self._by_accel: dict[str, deque[float]] = {}
        # Provisioning phase (actuation->scheduled), keyed per
        # (slice variant, capacity tier) — the scarce, tier-dependent part
        # of the chain — with a per-tier fleet-wide fallback ring that
        # mirrors ``_by_accel``.
        self._prov: dict[tuple[str, str], deque[float]] = {}
        self._prov_by_tier: dict[str, deque[float]] = {}
        # Serving phase (scheduled->ready) per variant.
        self._serve: dict[str, deque[float]] = {}
        # "model_key|variant" -> open scale-up episode.
        self._episodes: dict[str, _Episode] = {}

    def observe(self, model_key: str, variant_name: str, accelerator: str,
                desired: int, ready: int, now: float,
                scheduled: int | None = None, tier: str = "") -> None:
        """One variant's (desired, ready) observation for this tick.
        ``scheduled`` (pods bound to provisioned hosts), when known, stamps
        the episode's phase boundary so provisioning and serving latencies
        are recorded separately; callers without that signal keep the
        single-phase behavior unchanged."""
        ekey = f"{model_key}|{variant_name}"
        with self._mu:
            ep = self._episodes.get(ekey)
            if ep is not None and (now - ep.started > EPISODE_TIMEOUT_SECONDS
                                   or desired < ep.goal):
                # Abandoned or retargeted down: elapsed time no longer
                # measures one provisioning round trip. Nothing recorded —
                # a stockout that never scheduled must expire silently.
                del self._episodes[ekey]
                ep = None
            if ep is None:
                if desired > ready:
                    self._episodes[ekey] = _Episode(
                        started=now, goal=desired, accelerator=accelerator,
                        tier=tier)
                return
            if desired > ep.goal:
                # Retarget up mid-flight: measure to the new goal (the
                # planner cares when the full order lands).
                ep.goal = desired
                if scheduled is not None and scheduled < ep.goal:
                    ep.scheduled_at = 0.0  # new goal: not yet provisioned
            if tier:
                ep.tier = tier
            if (scheduled is not None and ep.scheduled_at == 0.0
                    and scheduled >= ep.goal):
                ep.scheduled_at = now
                self._record_provisioning_locked(
                    ep.accelerator, ep.tier, now - ep.started)
            if ready >= ep.goal:
                self._record(model_key, ep.accelerator, now - ep.started)
                if ep.scheduled_at > 0.0:
                    self._ring(self._serve, ep.accelerator).append(
                        max(now - ep.scheduled_at, 0.0))
                del self._episodes[ekey]

    def _record(self, model_key: str, accelerator: str,
                latency: float) -> None:
        if latency <= 0:
            return
        ring = self._samples.setdefault(
            (model_key, accelerator), deque(maxlen=MAX_SAMPLES))
        ring.append(latency)
        self._by_accel.setdefault(
            accelerator, deque(maxlen=MAX_SAMPLES)).append(latency)

    @staticmethod
    def _ring(store: dict, key) -> deque:
        ring = store.get(key)
        if ring is None:
            ring = store[key] = deque(maxlen=MAX_SAMPLES)
        return ring

    def _record_provisioning_locked(self, variant: str, tier: str,
                                    latency: float) -> None:
        if latency <= 0:
            return
        self._ring(self._prov, (variant, tier)).append(latency)
        if tier:
            self._ring(self._prov_by_tier, tier).append(latency)

    def record_provisioning(self, variant: str, tier: str,
                            latency: float) -> None:
        """Direct provisioning-lead sample from the capacity ledger: a
        slice order's submission->discovered-ready latency, measured per
        (variant, tier)."""
        with self._mu:
            self._record_provisioning_locked(variant, tier, latency)

    def provisioning_estimate(self, variant: str,
                              tier: str = "") -> tuple[float, bool]:
        """(provisioning lead seconds, measured?). Fallback chain mirrors
        :meth:`estimate`'s per-accelerator ladder: the (variant, tier)
        samples -> the variant's best-covered tier -> the fleet's samples
        for ``tier`` (a variant never provisioned through this tier
        inherits the tier's measured behavior) -> the configured default
        (measured=False)."""
        with self._mu:
            ring = self._prov.get((variant, tier))
            if not ring:
                rings = [r for (v, _), r in self._prov.items()
                         if v == variant and r]
                if rings:
                    ring = max(rings, key=len)
            if ring:
                return self._quantile(list(ring), self.quantile), True
            tier_ring = self._prov_by_tier.get(tier)
            if tier_ring:
                return self._quantile(list(tier_ring), self.quantile), True
            return self.default_seconds, False

    @staticmethod
    def _quantile(samples: list[float], q: float) -> float:
        xs = sorted(samples)
        pos = q * (len(xs) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

    def estimate(self, model_key: str,
                 accelerator: str = "") -> tuple[float, bool]:
        """(lead-time seconds, measured?). Fallback chain: the model's own
        samples on ``accelerator`` -> the model's best-covered accelerator
        -> the fleet's samples for ``accelerator`` (a NEW model inherits
        its accelerator's measured latencies) -> the configured default
        (measured=False)."""
        with self._mu:
            ring = self._samples.get((model_key, accelerator))
            if not ring:
                # Best-covered accelerator for the model (covers both the
                # model-level ask and a variant that moved accelerators).
                rings = [r for (mk, _), r in self._samples.items()
                         if mk == model_key and r]
                if rings:
                    ring = max(rings, key=len)
            if ring:
                return self._quantile(list(ring), self.quantile), True
            accel_ring = self._by_accel.get(accelerator)
            if accel_ring:
                return self._quantile(list(accel_ring), self.quantile), True
            # Phase composition: no full-chain sample yet, but the capacity
            # plane measured slice provisioning (per variant/tier) and a
            # serving phase exists for the accelerator — their sum is a
            # measured horizon where the single-phase ladder has nothing.
            prov_rings = [r for (v, _), r in self._prov.items()
                          if v == accelerator and r]
            serve_ring = self._serve.get(accelerator)
            if prov_rings and serve_ring:
                prov = max(prov_rings, key=len)
                return (self._quantile(list(prov), self.quantile)
                        + self._quantile(list(serve_ring), self.quantile),
                        True)
            return self.default_seconds, False

    def sample_count(self, model_key: str) -> int:
        with self._mu:
            return sum(len(r) for (mk, _), r in self._samples.items()
                       if mk == model_key)

    # --- crash-restart checkpoint (wva_tpu_torch.resilience) ---

    @staticmethod
    def _export_rings(store: dict, split_key: bool) -> list:
        if split_key:
            return [[k[0], k[1], list(ring)]
                    for k, ring in sorted(store.items()) if ring]
        return [[k, list(ring)] for k, ring in sorted(store.items())
                if ring]

    def export_state(self) -> dict:
        """Serializable sample rings for the resilience checkpoint — the
        measured actuation->ready and provisioning latencies every horizon
        decision keys on (losing them re-opens the default-constant
        under-provisioning window after every restart). Open episodes are
        NOT exported: their (desired, ready) anchors do not survive the
        restart gap, and a re-opened episode mid-scale-up would record a
        bogus short sample."""
        with self._mu:
            return {
                "samples": self._export_rings(self._samples, True),
                "by_accel": self._export_rings(self._by_accel, False),
                "prov": self._export_rings(self._prov, True),
                "prov_by_tier": self._export_rings(self._prov_by_tier,
                                                   False),
                "serve": self._export_rings(self._serve, False),
            }

    def restore_state(self, state: dict) -> int:
        """Rehydrate from :meth:`export_state` output (boot warm-start).
        Returns how many rings were restored."""
        restored = 0
        with self._mu:
            for model_key, accel, values in state.get("samples", []):
                ring = self._ring(self._samples, (str(model_key),
                                                  str(accel)))
                ring.extend(float(v) for v in values)
                restored += 1
            for variant, tier, values in state.get("prov", []):
                ring = self._ring(self._prov, (str(variant), str(tier)))
                ring.extend(float(v) for v in values)
                restored += 1
            for store_name, store in (("by_accel", self._by_accel),
                                      ("prov_by_tier", self._prov_by_tier),
                                      ("serve", self._serve)):
                for key, values in state.get(store_name, []):
                    ring = self._ring(store, str(key))
                    ring.extend(float(v) for v in values)
                    restored += 1
        return restored

    def evict_missing(self, live_keys: set[str]) -> None:
        """Drop episodes + samples for models that no longer exist."""
        with self._mu:
            for k in [k for k in self._episodes
                      if k.rsplit("|", 1)[0] not in live_keys]:
                del self._episodes[k]
            for k in [k for k in self._samples if k[0] not in live_keys]:
                del self._samples[k]
