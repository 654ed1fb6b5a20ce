"""SLO analyzer configuration: service classes and per-(model, accelerator)
performance profiles.

Successor of the reference's inferno config specs
(``pkg/config/types.go`` — AcceleratorSpec/ServiceClassSpec/OptimizerSpec) and
the service-class model (``pkg/core/serviceclass.go``): a service class has a
priority and per-model SLO targets (TTFT/ITL/TPS); profiles carry the fitted
alpha/beta/gamma iteration-time parameters per TPU variant
(``docs/tutorials/parameter-estimation.md:242-258`` describes the offline fit).

Hot-reloaded from the ``wva-slo-config`` ConfigMap like the saturation config
(same data-key YAML convention, reference configmap_reconciler.go:154-194).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from wva_tpu_torch.analyzers.queueing.params import (
    DEFAULT_MAX_BATCH_SIZE,
    DEFAULT_MAX_NUM_TOKENS,
    DEFAULT_MAX_QUEUE_SIZE,
    K_MAX,
    MAX_BATCH_BOUND,
    PerfProfile,
    ServiceParms,
    TargetPerf,
)

# Well-known ConfigMap name (peer of wva-saturation-scaling-config,
# reference internal/config/helpers.go:11-18).
SLO_CONFIGMAP_NAME = "wva-slo-config"
SLO_CONFIGMAP_DATA_KEY = "slo-config"

DEFAULT_SERVICE_CLASS_PRIORITY = 10


@dataclass
class ServiceClass:
    """Priority tier with per-model SLO targets (reference
    pkg/core/serviceclass.go; lower priority value = more important)."""

    name: str = "default"
    priority: int = DEFAULT_SERVICE_CLASS_PRIORITY
    # model_id -> SLO targets
    model_targets: dict[str, TargetPerf] = field(default_factory=dict)


@dataclass
class SLOConfigData:
    """Parsed SLO ConfigMap contents."""

    service_classes: list[ServiceClass] = field(default_factory=list)
    profiles: list[PerfProfile] = field(default_factory=list)
    # Fallback targets for models not listed in any service class; None means
    # "no SLO -> model is skipped by the SLO analyzer".
    default_targets: TargetPerf | None = None
    # Online alpha/beta/gamma re-estimation from observed TTFT/ITL (Kalman
    # tuner). Off by default: the reference ships its tuner unwired
    # (SURVEY.md section 2 L(-1)); here it is wired but opt-in.
    tuner_enabled: bool = False

    # Lazy model -> (targets, priority, class name, owner class) index.
    # The linear class walk is O(classes) per lookup, which turns the
    # engine's per-model resolution into O(models * classes) per tick —
    # quadratic on fleets provisioned one-class-per-model. The guard must
    # itself be O(1) (an O(classes) signature walk per lookup would just
    # re-pay the scan): class-list length + entry-count total + default
    # identity catch appends/removals, and every hit is verified against
    # the owning class's live dict, so in-place replacement of a model's
    # entry can never serve a stale target.
    _index: dict | None = field(default=None, repr=False, compare=False)
    _index_sig: tuple | None = field(default=None, repr=False, compare=False)
    _index_entries: int = field(default=-1, repr=False, compare=False)

    def _model_index(self) -> dict:
        sig = (len(self.service_classes), id(self.default_targets))
        if self._index is None or self._index_sig != sig:
            index: dict[str, tuple] = {}
            total = 0
            for sc in self.service_classes:
                total += len(sc.model_targets)
                for model_id, t in sc.model_targets.items():
                    prior = index.get(model_id)
                    if prior is None or sc.priority < prior[1]:
                        index[model_id] = (t, sc.priority, sc.name, sc)
            self._index = index
            self._index_sig = sig
            self._index_entries = total
        return self._index

    def _resolve(self, model_id: str) -> tuple | None:
        hit = self._model_index().get(model_id)
        if hit is None:
            return None
        targets, _priority, _name, owner = hit
        if owner.model_targets.get(model_id) is not targets:
            # In-place replacement under an unchanged signature: rebuild.
            self._index = None
            hit = self._model_index().get(model_id)
        return hit

    def targets_for_model(self, model_id: str) -> tuple[TargetPerf | None, int]:
        """Resolve (targets, priority) for a model: best (lowest-priority-value)
        service class listing it, else the default targets."""
        hit = self._resolve(model_id)
        if hit is not None:
            return hit[0], hit[1]
        if self.default_targets is not None:
            return self.default_targets, DEFAULT_SERVICE_CLASS_PRIORITY
        return None, DEFAULT_SERVICE_CLASS_PRIORITY

    def class_for_model(self, model_id: str) -> str | None:
        """Name of the best (lowest-priority-value) service class listing the
        model; None when unlisted (and no classes would match)."""
        hit = self._resolve(model_id)
        return hit[2] if hit is not None else None


def _parse_targets(raw: dict) -> TargetPerf:
    return TargetPerf(
        target_ttft_ms=float(raw.get("ttft", raw.get("targetTTFT", 0.0)) or 0.0),
        target_itl_ms=float(raw.get("itl", raw.get("targetITL", 0.0)) or 0.0),
        target_tps=float(raw.get("tps", raw.get("targetTPS", 0.0)) or 0.0),
    )


def parse_slo_config(text: str) -> SLOConfigData:
    """Parse the YAML payload of the SLO ConfigMap. Schema::

        serviceClasses:
          - name: premium
            priority: 1
            models:
              meta-llama/Llama-3.1-8B: {ttft: 1000, itl: 50}
        defaultTargets: {ttft: 2000}          # optional
        profiles:
          - model: meta-llama/Llama-3.1-8B
            accelerator: v5e-8
            alpha: 6.973
            beta: 0.027
            gamma: 0.001
            maxBatchSize: 256
            maxQueueSize: 1024

    Raises ValueError on malformed entries (mirrors the fail-fast parse of
    reference scale_to_zero.go:165-225).
    """
    # PyYAML is imported here, not at module import: the sizing pass never
    # parses YAML, and the port must import where PyYAML is not installed.
    import yaml

    raw = yaml.safe_load(text) or {}
    if not isinstance(raw, dict):
        raise ValueError("SLO config must be a YAML mapping")

    data = SLOConfigData()
    for sc_raw in raw.get("serviceClasses") or []:
        if not isinstance(sc_raw, dict) or not sc_raw.get("name"):
            raise ValueError(f"invalid service class entry: {sc_raw!r}")
        sc = ServiceClass(
            name=str(sc_raw["name"]),
            priority=int(sc_raw.get("priority", DEFAULT_SERVICE_CLASS_PRIORITY)),
        )
        for model_id, t_raw in (sc_raw.get("models") or {}).items():
            if not isinstance(t_raw, dict):
                raise ValueError(
                    f"invalid targets for model {model_id!r} in class {sc.name}")
            sc.model_targets[str(model_id)] = _parse_targets(t_raw)
        data.service_classes.append(sc)

    if isinstance(raw.get("defaultTargets"), dict):
        data.default_targets = _parse_targets(raw["defaultTargets"])

    tuner_raw = raw.get("tuner")
    if isinstance(tuner_raw, dict):
        data.tuner_enabled = bool(tuner_raw.get("enabled", False))

    for p_raw in raw.get("profiles") or []:
        if not isinstance(p_raw, dict) or not p_raw.get("model") or not p_raw.get("accelerator"):
            raise ValueError(f"invalid profile entry: {p_raw!r}")
        parms = ServiceParms(
            alpha=float(p_raw.get("alpha", 0.0)),
            beta=float(p_raw.get("beta", 0.0)),
            gamma=float(p_raw.get("gamma", 0.0)),
        )
        if not parms.valid():
            raise ValueError(
                f"invalid service parms for profile {p_raw.get('model')}/"
                f"{p_raw.get('accelerator')}: {parms}")
        max_batch = int(p_raw.get("maxBatchSize", DEFAULT_MAX_BATCH_SIZE))
        max_queue = int(p_raw.get("maxQueueSize", DEFAULT_MAX_QUEUE_SIZE))
        # Enforce the solver's static shape bounds at parse time so the
        # sizing model and the tuner's observation model always agree
        # (silent clipping downstream would make them diverge).
        if not 1 <= max_batch <= MAX_BATCH_BOUND:
            raise ValueError(
                f"profile {p_raw['model']}/{p_raw['accelerator']}: "
                f"maxBatchSize {max_batch} outside [1, {MAX_BATCH_BOUND}]")
        if max_queue < 0 or max_batch + max_queue > K_MAX:
            raise ValueError(
                f"profile {p_raw['model']}/{p_raw['accelerator']}: "
                f"maxBatchSize+maxQueueSize {max_batch + max_queue} exceeds "
                f"{K_MAX}")
        data.profiles.append(PerfProfile(
            model_id=str(p_raw["model"]),
            accelerator=str(p_raw["accelerator"]),
            service_parms=parms,
            max_batch_size=max_batch,
            max_queue_size=max_queue,
            max_num_tokens=int(p_raw.get("maxNumTokens", DEFAULT_MAX_NUM_TOKENS)),
        ))
    return data
