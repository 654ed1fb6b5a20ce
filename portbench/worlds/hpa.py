# A frozen copy of wva_tpu_torch/emulator/hpa.py (imports of its siblings
# pointed here), so that the benchmark's world cannot move with the program.
"""HPA emulator acting on the ``wva_desired_replicas`` gauge.

Closes the external actuation loop the reference delegates to
Prometheus Adapter + HorizontalPodAutoscaler
(``docs/integrations/hpa-integration.md``): desired = ceil(sum(metric) /
target AverageValue 1), with up/down stabilization windows and a scale-up
rate policy (defaults from the reference chart: 240s stabilization both
directions, max 10 pods per 150s, maxReplicas 10).
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field

from wva_tpu_torch.constants import WVA_DESIRED_REPLICAS
from wva_tpu_torch.k8s.client import KubeClient, NotFoundError
from wva_tpu_torch.k8s.objects import Deployment
from wva_tpu_torch.metrics import MetricsRegistry
from wva_tpu_torch.utils.clock import Clock

log = logging.getLogger(__name__)


@dataclass
class HPAParams:
    # Reference chart defaults (charts/.../README.md:11-20).
    stabilization_up_seconds: float = 240.0
    stabilization_down_seconds: float = 240.0
    max_pods_per_policy_window: int = 10
    policy_window_seconds: float = 150.0
    min_replicas: int = 1
    max_replicas: int = 10
    sync_period_seconds: float = 15.0


@dataclass
class _Target:
    namespace: str
    deployment: str  # scale-target name (Deployment or LeaderWorkerSet)
    variant_name: str
    accelerator: str
    params: HPAParams
    kind: str = Deployment.KIND
    # (time, desired) observations for stabilization windows
    history: list[tuple[float, int]] = field(default_factory=list)
    last_scale_up_at: float = -1e18
    scaled_up_in_window: int = 0
    last_sync: float = -1e18


class HPAEmulator:
    def __init__(self, client: KubeClient, registry: "MetricsRegistry | None",
                 clock: Clock, metric_source=None) -> None:
        if registry is None and metric_source is None:
            raise ValueError("HPAEmulator needs a registry or a metric_source")
        self.client = client
        self.registry = registry
        self.clock = clock
        # Where desired-replica signals come from: the in-process registry
        # (default, what the harness uses) or any callable(target) ->
        # float|None — e.g. external_metrics.adapter_metric_source, which
        # reads through a scraped /metrics endpoint + the
        # external.metrics.k8s.io API shape like production HPA does.
        self._metric_source = metric_source or self._registry_metric
        self._targets: list[_Target] = []

    def _registry_metric(self, t: "_Target") -> float | None:
        return self.registry.get(WVA_DESIRED_REPLICAS, {
            "variant_name": t.variant_name,
            "namespace": t.namespace,
            "accelerator_type": t.accelerator,
        })

    def add_target(self, namespace: str, deployment: str, variant_name: str,
                   accelerator: str, params: HPAParams | None = None,
                   kind: str = Deployment.KIND) -> None:
        self._targets.append(_Target(
            namespace=namespace, deployment=deployment, kind=kind,
            variant_name=variant_name, accelerator=accelerator,
            params=params or HPAParams()))

    def step(self) -> None:
        now = self.clock.now()
        for target in self._targets:
            if now - target.last_sync < target.params.sync_period_seconds:
                continue
            target.last_sync = now
            self._sync_target(target, now)

    def _sync_target(self, t: _Target, now: float) -> None:
        metric = self._metric_source(t)
        if metric is None:
            return
        # Record the RAW desired (only max-clamped): the scale-to-zero path
        # needs to observe genuine zeros; min_replicas applies at scale time.
        desired_raw = min(math.ceil(metric), t.params.max_replicas)
        desired = max(desired_raw, t.params.min_replicas)

        try:
            deploy = self.client.get(t.kind, t.namespace, t.deployment)
        except NotFoundError:
            return
        current = deploy.desired_replicas()
        if current == 0:
            # HPA is disabled at zero (HPAScaleToZero semantics): only the
            # direct scale-from-zero actuator wakes the target; but WVA may
            # also set desired=0 which we honor below.
            if metric <= 0:
                return

        # Record observation, trim windows.
        t.history.append((now, desired_raw))
        horizon = max(t.params.stabilization_up_seconds,
                      t.params.stabilization_down_seconds)
        t.history = [(ts, d) for ts, d in t.history if now - ts <= horizon]

        if metric <= 0 and current > 0:
            # Scale to zero: WVA says 0; HPA defers after down-stabilization
            # (HPAScaleToZero feature-gate semantics: minReplicas=0 allowed).
            window = [(ts, d) for ts, d in t.history
                      if now - ts <= t.params.stabilization_down_seconds]
            if window and all(d <= 0 for _, d in window) and \
                    now - window[0][0] >= t.params.stabilization_down_seconds - \
                    t.params.sync_period_seconds - 1e-9:
                self._scale(t, 0)
            return

        if desired > current:
            # Up-stabilization: use the LOWEST desired over the window
            # (prevents flapping on short spikes).
            window = [d for ts, d in t.history
                      if now - ts <= t.params.stabilization_up_seconds]
            stabilized = min(window) if window else desired
            new = min(stabilized, t.params.max_replicas)
            if new > current:
                # Rate policy: max N pods per policy window.
                if now - t.last_scale_up_at > t.params.policy_window_seconds:
                    t.scaled_up_in_window = 0
                allowed = t.params.max_pods_per_policy_window - t.scaled_up_in_window
                if allowed <= 0:
                    return
                new = min(new, current + allowed)
                t.scaled_up_in_window += new - current
                t.last_scale_up_at = now
                self._scale(t, new)
        elif desired < current:
            window = [d for ts, d in t.history
                      if now - ts <= t.params.stabilization_down_seconds]
            stabilized = max(window) if window else desired
            if stabilized < current:
                self._scale(t, max(stabilized, t.params.min_replicas))

    def _scale(self, t: _Target, replicas: int) -> None:
        try:
            self.client.patch_scale(t.kind, t.namespace,
                                    t.deployment, replicas)
            log.info("HPA: scaled %s/%s -> %d", t.namespace, t.deployment, replicas)
        except NotFoundError:
            pass
