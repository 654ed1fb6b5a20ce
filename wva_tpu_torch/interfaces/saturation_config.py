"""Saturation scaling configuration with defaults + validation
(reference ``internal/interfaces/saturation_scaling.go:8-108``).
"""

from __future__ import annotations

from dataclasses import dataclass

DEFAULT_SCALE_UP_THRESHOLD = 0.85
DEFAULT_SCALE_DOWN_BOUNDARY = 0.70

# V1 defaults (reference docs/saturation-scaling-config.md:24-44).
DEFAULT_KV_CACHE_THRESHOLD = 0.80
DEFAULT_QUEUE_LENGTH_THRESHOLD = 5.0
DEFAULT_KV_SPARE_TRIGGER = 0.10
DEFAULT_QUEUE_SPARE_TRIGGER = 3.0

V2_ANALYZER_NAME = "saturation"
SLO_ANALYZER_NAME = "slo"


@dataclass
class SaturationScalingConfig:
    """Per-model saturation thresholds; override entries carry model_id+namespace."""

    model_id: str = ""
    namespace: str = ""

    # Replica saturated iff kv >= kv_cache_threshold OR queue >= queue_length_threshold.
    kv_cache_threshold: float = DEFAULT_KV_CACHE_THRESHOLD
    queue_length_threshold: float = DEFAULT_QUEUE_LENGTH_THRESHOLD
    # Scale-up iff avg spare kv < kv_spare_trigger OR avg spare queue < queue_spare_trigger.
    kv_spare_trigger: float = DEFAULT_KV_SPARE_TRIGGER
    queue_spare_trigger: float = DEFAULT_QUEUE_SPARE_TRIGGER

    # Include the TPU-slice limiter stage in the pipeline (default off).
    enable_limiter: bool = False

    # "" -> V1 percentage analyzer; "saturation" -> V2 token analyzer;
    # "slo" -> queueing-model (SLO) analyzer.
    analyzer_name: str = ""

    # V2 thresholds (0 means "apply default" when analyzer is V2).
    scale_up_threshold: float = 0.0
    scale_down_boundary: float = 0.0

    # Optimizer selection for the V2/SLO flow: "" = per-model cost-aware
    # (reference CostAwareOptimizer); "global" = fleet-wide assignment solver
    # (service-class priorities + per-generation chip capacity + transition
    # penalties — the inferno successor, SLO analyzer only).
    optimizer_name: str = ""

    # Demand-trend anticipation for slow slice provisioning: size scale-up
    # for demand + max(slope, 0) x this horizon, where slope is the model's
    # observed demand growth rate. Set to the slice provisioning + model-load
    # time so new replicas are sized for the demand that will exist when they
    # become ready (TPU pools take minutes; 0 = off). Scale-DOWN never
    # anticipates — only growth is extrapolated.
    anticipation_horizon_seconds: float = 0.0

    # Standing spare-capacity floor (whole replicas of the most
    # cost-efficient variant) for latency-SLO models: the first minutes of
    # any demand ramp are served by capacity that ALREADY exists (slices
    # take minutes to provision), so a TTFT SLO needs provisioned insurance
    # — N+1 keeps one replica's worth of burst headroom at all times.
    # Counted as required capacity on scale-up and shielded from
    # scale-down. 0 = off (the reference has no equivalent; its analyzers
    # react to observed saturation only). SLO analyzer only.
    headroom_replicas: int = 0

    # Derived burst insurance: the worst CREDIBLE demand ramp the operator
    # commits to absorbing without SLO loss, in req/s per second. The
    # analyzer stands spare capacity of burstSlopeRps x
    # anticipationHorizonSeconds — exactly the demand that can arrive
    # during the provisioning blackout (no decision made after a ramp
    # starts can land a slice sooner than the provisioning horizon), so
    # the standing headroom is a derived quantity, not a guessed replica
    # count. Combined with headroomReplicas via max. 0 = off. SLO analyzer
    # only.
    burst_slope_rps: float = 0.0

    # Scale-from-N fast path: the 100ms backlog monitor (the scale-from-zero
    # detection loop generalized to ACTIVE models) requests an immediate
    # engine tick when a model's scheduler flow-control backlog reaches
    # fastPathQueueThreshold, instead of waiting out the poll interval.
    # Cooldown bounds how often backlog can force ticks per model.
    fast_path_enabled: bool = True
    fast_path_queue_threshold: float = 1.0
    fast_path_cooldown_seconds: float = 15.0

    # Apply scale-UP decisions to the scale subresource immediately instead
    # of waiting for the external HPA to act on wva_desired_replicas (HPA
    # still converges to the same gauge; scale-DOWN always stays HPA-paced).
    # With TPU slices taking minutes to provision, the HPA sync interval +
    # stabilization window is pure added backlog. Default off: the
    # reference's contract is metric-only steady-state actuation.
    fast_actuation: bool = False

    def get_analyzer_name(self) -> str:
        return self.analyzer_name

    def apply_defaults(self) -> None:
        """Fill zero-valued V2 fields (reference :61-70); extended to the SLO
        analyzer, which reuses the same utilization thresholds."""
        if self.analyzer_name in (V2_ANALYZER_NAME, SLO_ANALYZER_NAME):
            if self.scale_up_threshold == 0:
                self.scale_up_threshold = DEFAULT_SCALE_UP_THRESHOLD
            if self.scale_down_boundary == 0:
                self.scale_down_boundary = DEFAULT_SCALE_DOWN_BOUNDARY

    def validate(self) -> None:
        """Raise ValueError on invalid thresholds (reference :75-108)."""
        if not 0 <= self.kv_cache_threshold <= 1:
            raise ValueError(
                f"kvCacheThreshold must be between 0 and 1, got {self.kv_cache_threshold:.2f}"
            )
        if self.queue_length_threshold < 0:
            raise ValueError(
                f"queueLengthThreshold must be >= 0, got {self.queue_length_threshold:.1f}"
            )
        if not 0 <= self.kv_spare_trigger <= 1:
            raise ValueError(
                f"kvSpareTrigger must be between 0 and 1, got {self.kv_spare_trigger:.2f}"
            )
        if self.queue_spare_trigger < 0:
            raise ValueError(
                f"queueSpareTrigger must be >= 0, got {self.queue_spare_trigger:.1f}"
            )
        if self.fast_path_queue_threshold < 0:
            raise ValueError(
                "fastPathQueueThreshold must be >= 0, got "
                f"{self.fast_path_queue_threshold}")
        if self.fast_path_cooldown_seconds < 0:
            raise ValueError(
                "fastPathCooldownSeconds must be >= 0, got "
                f"{self.fast_path_cooldown_seconds}")
        if self.kv_cache_threshold < self.kv_spare_trigger:
            raise ValueError(
                f"kvCacheThreshold ({self.kv_cache_threshold:.2f}) should be >= "
                f"kvSpareTrigger ({self.kv_spare_trigger:.2f})"
            )
        if self.analyzer_name in (V2_ANALYZER_NAME, SLO_ANALYZER_NAME):
            if not 0 < self.scale_up_threshold <= 1:
                raise ValueError(
                    f"scaleUpThreshold must be in (0, 1], got {self.scale_up_threshold:.2f}"
                )
            if self.optimizer_name not in ("", "global"):
                raise ValueError(
                    f'optimizerName must be "" or "global", got '
                    f"{self.optimizer_name!r}")
            if self.anticipation_horizon_seconds < 0:
                raise ValueError(
                    "anticipationHorizonSeconds must be >= 0, got "
                    f"{self.anticipation_horizon_seconds}")
            if self.headroom_replicas < 0:
                raise ValueError(
                    "headroomReplicas must be >= 0, got "
                    f"{self.headroom_replicas}")
            if self.burst_slope_rps < 0:
                raise ValueError(
                    "burstSlopeRps must be >= 0, got "
                    f"{self.burst_slope_rps}")
            if self.burst_slope_rps > 0 and \
                    self.anticipation_horizon_seconds <= 0:
                # A knob that parses but stands zero insurance is worse
                # than absent: the operator believes the ramp commitment
                # holds. The insurance is slope x horizon, so the horizon
                # must be declared too.
                raise ValueError(
                    "burstSlopeRps requires anticipationHorizonSeconds > 0 "
                    "(insurance = slope x horizon; set the horizon to the "
                    "slice provisioning + model-load time)")
            if not 0 < self.scale_down_boundary <= 1:
                raise ValueError(
                    f"scaleDownBoundary must be in (0, 1], got {self.scale_down_boundary:.2f}"
                )
            if self.scale_up_threshold <= self.scale_down_boundary:
                raise ValueError(
                    f"scaleUpThreshold ({self.scale_up_threshold:.2f}) must be > "
                    f"scaleDownBoundary ({self.scale_down_boundary:.2f})"
                )

    # --- YAML dict mapping (camelCase keys, as the ConfigMap format) ---

    _KEYS = {
        "model_id": "model_id",
        "namespace": "namespace",
        "kvCacheThreshold": "kv_cache_threshold",
        "queueLengthThreshold": "queue_length_threshold",
        "kvSpareTrigger": "kv_spare_trigger",
        "queueSpareTrigger": "queue_spare_trigger",
        "enableLimiter": "enable_limiter",
        "analyzerName": "analyzer_name",
        "scaleUpThreshold": "scale_up_threshold",
        "scaleDownBoundary": "scale_down_boundary",
        "anticipationHorizonSeconds": "anticipation_horizon_seconds",
        "headroomReplicas": "headroom_replicas",
        "burstSlopeRps": "burst_slope_rps",
        "optimizerName": "optimizer_name",
        "fastPathEnabled": "fast_path_enabled",
        "fastPathQueueThreshold": "fast_path_queue_threshold",
        "fastPathCooldownSeconds": "fast_path_cooldown_seconds",
        "fastActuation": "fast_actuation",
    }

    @classmethod
    def from_dict(cls, d: dict) -> "SaturationScalingConfig":
        cfg = cls()
        for yaml_key, attr in cls._KEYS.items():
            if yaml_key in d and d[yaml_key] is not None:
                cur = getattr(cfg, attr)
                val = d[yaml_key]
                if isinstance(cur, bool):
                    # Same truthy strings as config.helpers.parse_bool_from_config
                    # so both config surfaces agree on "1"/"yes".
                    if isinstance(val, str):
                        val = val.strip().lower() in ("true", "1", "yes")
                    else:
                        val = bool(val)
                elif isinstance(cur, float):
                    val = float(val)
                elif isinstance(cur, int):
                    val = int(val)
                setattr(cfg, attr, val)
        return cfg

    def to_dict(self) -> dict:
        d = {}
        for yaml_key, attr in self._KEYS.items():
            val = getattr(self, attr)
            if val != "" or yaml_key not in ("model_id", "namespace", "analyzerName"):
                d[yaml_key] = val
        return d
