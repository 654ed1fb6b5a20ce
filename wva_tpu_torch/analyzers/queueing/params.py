"""Parameter types for the SLO (queueing-model) analyzer family.

Successor of the reference's dormant "inferno" optimizer inputs
(``pkg/analyzer/queueanalyzer.go:28-81``): request processing is modeled as

    iterationTime(n) = alpha + n * (beta * computeTokens + gamma * memoryTokens)

with per-(model, accelerator) fitted ``alpha/beta/gamma`` (the reference fits
these offline per GPU type, ``docs/tutorials/parameter-estimation.md:242-258``;
our Kalman tuner re-estimates them online, see
``wva_tpu_torch.analyzers.queueing.tuner``).

Unlike the reference there is no process-global singleton system
(``pkg/core/system.go:10``): profiles live in an explicit
:class:`PerfProfileStore` value owned by the analyzer/config.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

# Fraction below the maximum service rate kept as stability headroom when
# sizing for a throughput target (reference queueanalyzer.go:11).
STABILITY_SAFETY_FRACTION = 0.1

# Small relative disturbance bounding the feasible arrival-rate range
# (reference queueanalyzer.go:8).
EPSILON = 1e-3

# Default per-iteration token budget (reference queueanalyzer.go:14).
DEFAULT_MAX_NUM_TOKENS = 8192

# Static shape bounds for the JAX chain solver (see queue_model.py). All
# occupancy chains are padded to K_MAX states and masked; batch-dependent
# service rates saturate at the (dynamic, <= MAX_BATCH_BOUND) max batch size.
K_MAX = 2048
MAX_BATCH_BOUND = 512

DEFAULT_MAX_BATCH_SIZE = 256
DEFAULT_MAX_QUEUE_SIZE = K_MAX - MAX_BATCH_BOUND


@dataclass
class ServiceParms:
    """Fitted iteration-time parameters (reference queueanalyzer.go:36-41).

    All times in milliseconds.
    """

    alpha: float = 0.0  # base iteration time
    beta: float = 0.0  # slope for compute tokens
    gamma: float = 0.0  # slope for memory-access tokens

    def valid(self) -> bool:
        return (
            self.alpha > 0
            and self.beta >= 0
            and self.gamma >= 0
            and (self.beta + self.gamma) > 0
        )


@dataclass
class RequestSize:
    """Average request token counts (reference queueanalyzer.go:43-47)."""

    avg_input_tokens: float = 0.0
    avg_output_tokens: float = 0.0

    def valid(self) -> bool:
        return self.avg_input_tokens >= 0 and self.avg_output_tokens >= 1


@dataclass
class QueueConfig:
    """Server queue/batch limits (reference queueanalyzer.go:27-33)."""

    max_batch_size: int = DEFAULT_MAX_BATCH_SIZE
    max_num_tokens: int = DEFAULT_MAX_NUM_TOKENS
    max_queue_size: int = DEFAULT_MAX_QUEUE_SIZE
    service_parms: ServiceParms = field(default_factory=ServiceParms)

    def valid(self) -> bool:
        return (
            1 <= self.max_batch_size <= MAX_BATCH_BOUND
            and self.max_num_tokens > 0
            and self.max_queue_size >= 0
            and self.max_batch_size + self.max_queue_size <= K_MAX
            and self.service_parms.valid()
        )


@dataclass
class TargetPerf:
    """SLO targets (reference queueanalyzer.go:68-73). <=0 disables a target."""

    target_ttft_ms: float = 0.0  # queueing + prefill + first decode (msec)
    target_itl_ms: float = 0.0  # inter-token latency (msec)
    target_tps: float = 0.0  # token generation throughput (tokens/sec)


@dataclass
class TargetRate:
    """Max request rates (req/s) meeting each target (reference :75-80)."""

    rate_target_ttft: float = 0.0
    rate_target_itl: float = 0.0
    rate_target_tps: float = 0.0

    def min_rate(self) -> float:
        return min(self.rate_target_ttft, self.rate_target_itl, self.rate_target_tps)


@dataclass
class AnalysisMetrics:
    """Steady-state queue metrics at a given arrival rate (reference :55-66)."""

    throughput: float = 0.0  # req/s
    avg_resp_time_ms: float = 0.0
    avg_wait_time_ms: float = 0.0
    avg_num_in_serv: float = 0.0
    avg_prefill_time_ms: float = 0.0
    avg_token_time_ms: float = 0.0  # ITL
    avg_ttft_ms: float = 0.0
    max_rate: float = 0.0  # req/s
    rho: float = 0.0


PROFILE_SOURCE_CONFIG = "config"
PROFILE_SOURCE_TUNER = "tuner"


@dataclass
class PerfProfile:
    """Per-(namespace, model, accelerator) serving profile: fitted service
    parameters and batching limits — the analogue of the reference's
    ``core.Model`` perf profiles (``pkg/core/model.go``), stored flat instead
    of inside a global system object. ``namespace == ""`` means global scope
    (system-namespace ConfigMap); namespace-local profiles shadow it."""

    model_id: str = ""
    accelerator: str = ""  # TPU slice variant, e.g. "v5e-8"
    namespace: str = ""  # "" = global
    service_parms: ServiceParms = field(default_factory=ServiceParms)
    max_batch_size: int = DEFAULT_MAX_BATCH_SIZE
    max_queue_size: int = DEFAULT_MAX_QUEUE_SIZE
    max_num_tokens: int = DEFAULT_MAX_NUM_TOKENS
    # Where the current service_parms came from: config (static fit) or the
    # online Kalman tuner. Tuner refinements survive config re-syncs.
    source: str = PROFILE_SOURCE_CONFIG

    def queue_config(self) -> QueueConfig:
        return QueueConfig(
            max_batch_size=self.max_batch_size,
            max_num_tokens=self.max_num_tokens,
            max_queue_size=self.max_queue_size,
            service_parms=self.service_parms,
        )


class PerfProfileStore:
    """Thread-safe registry of :class:`PerfProfile` keyed by
    ``namespace|model_id|accelerator`` with namespace-local > global ("")
    resolution. Profiles come from config (static fit) and are refined online
    by the Kalman tuner (:mod:`wva_tpu_torch.analyzers.queueing.tuner`); tuner
    refinements are kept across config re-syncs."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._profiles: dict[tuple[str, str, str], PerfProfile] = {}

    @staticmethod
    def _key(namespace: str, model_id: str, accelerator: str) -> tuple[str, str, str]:
        return (namespace, model_id, accelerator)

    def put(self, profile: PerfProfile) -> None:
        with self._lock:
            self._profiles[self._key(
                profile.namespace, profile.model_id, profile.accelerator)] = profile

    def get(self, model_id: str, accelerator: str,
            namespace: str = "") -> PerfProfile | None:
        """Namespace-local profile if present, else the global one.

        Lock-free: dict reads are atomic under the GIL, writers either
        mutate entries in place (atomic set) or swap the whole dict
        (``sync_namespace``), and a read racing a writer legitimately
        sees either side of it — the same outcomes the locked read had,
        minus the RLock convoy the analyze pool paid per model."""
        profiles = self._profiles
        if namespace:
            prof = profiles.get(self._key(namespace, model_id, accelerator))
            if prof is not None:
                return prof
        return profiles.get(self._key("", model_id, accelerator))

    def sync_namespace(self, namespace: str, profiles: list[PerfProfile]) -> None:
        """Adopt the config's profile set for one namespace scope: config-
        sourced profiles in that scope are replaced wholesale (updates apply,
        deletions take effect); tuner-refined profiles keep their refined
        service_parms but adopt updated batching limits from config. Tuner
        profiles whose (model, accelerator) no longer appears in the synced
        set are evicted too — otherwise stale tuned parms would accumulate
        forever and shadow any future config refit for that key."""
        with self._lock:
            incoming = {(p.model_id, p.accelerator) for p in profiles}
            keep = {
                k: v for k, v in self._profiles.items()
                if k[0] != namespace or (
                    v.source == PROFILE_SOURCE_TUNER
                    and (v.model_id, v.accelerator) in incoming)
            }
            self._profiles = keep
            for prof in profiles:
                prof.namespace = namespace
                key = self._key(namespace, prof.model_id, prof.accelerator)
                existing = self._profiles.get(key)
                if existing is not None and existing.source == PROFILE_SOURCE_TUNER:
                    existing.max_batch_size = prof.max_batch_size
                    existing.max_queue_size = prof.max_queue_size
                    existing.max_num_tokens = prof.max_num_tokens
                else:
                    self._profiles[key] = prof

    def update_service_parms(
        self, model_id: str, accelerator: str, parms: ServiceParms,
        namespace: str = "",
    ) -> bool:
        """Tuner write-back path; marks the profile tuner-sourced so config
        re-syncs don't clobber it. Returns False when no profile exists."""
        with self._lock:
            prof = None
            if namespace:
                prof = self._profiles.get(self._key(namespace, model_id, accelerator))
            if prof is None:
                prof = self._profiles.get(self._key("", model_id, accelerator))
            if prof is None:
                return False
            prof.service_parms = parms
            prof.source = PROFILE_SOURCE_TUNER
            return True

    def all(self) -> list[PerfProfile]:
        with self._lock:
            return list(self._profiles.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._profiles)


def iteration_time_ms(p: ServiceParms, r: RequestSize, batch_size: float) -> float:
    """Scalar mirror of the JAX kernel, for host-side spot checks
    (reference queueanalyzer.go:261-266)."""
    tokens_compute = (r.avg_input_tokens + r.avg_output_tokens) / (
        r.avg_output_tokens + 1.0
    )
    tokens_memory = r.avg_input_tokens + r.avg_output_tokens / 2.0
    return p.alpha + batch_size * (p.beta * tokens_compute + p.gamma * tokens_memory)


def prefill_time_ms(p: ServiceParms, r: RequestSize, batch_size: float) -> float:
    """Reference queueanalyzer.go:269-274."""
    if r.avg_input_tokens == 0:
        return 0.0
    return iteration_time_ms(p, r, batch_size) + (p.beta + p.gamma) * r.avg_input_tokens


def decode_time_ms(p: ServiceParms, r: RequestSize, batch_size: float) -> float:
    """Per-token decode time (reference queueanalyzer.go:277-280)."""
    return (
        iteration_time_ms(p, r, batch_size)
        + p.beta
        + p.gamma * (r.avg_input_tokens + r.avg_output_tokens / 2.0)
    )


def service_rate_per_ms(
    p: ServiceParms, r: RequestSize, batch_size: int
) -> float:
    """Requests/ms completed at occupancy ``batch_size`` (reference
    queueanalyzer.go:99-105): n requests complete every
    prefill(n) + avgOutputTokens * decode(n) ms."""
    pf = prefill_time_ms(p, r, float(batch_size))
    dc = r.avg_output_tokens * decode_time_ms(p, r, float(batch_size))
    total = pf + dc
    if total <= 0 or not math.isfinite(total):
        return 0.0
    return batch_size / total
