"""The emulated world the benchmark drives the Manager in: cluster, serving
simulators, kubelet and HPA, advanced by a FakeClock.

A frozen copy of ``wva_tpu_torch/emulator/harness.py``'s ``EmulationHarness``
cut to what one world of the benchmark needs (no chaos faults, no slice
provisioner, no standby managers, no shards). The serving simulator,
kubelet, HPA and node pools are the copies beside this file; the Manager,
and everything under test, comes from ``wva_tpu_torch``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from wva_tpu_torch.api.v1alpha1 import (
    CrossVersionObjectReference,
    ObjectMeta,
    VariantAutoscaling,
    VariantAutoscalingSpec,
)
from wva_tpu_torch.collector.source import TimeSeriesDB
from wva_tpu_torch.config import Config, new_test_config
from wva_tpu_torch.constants import ACCELERATOR_NAME_LABEL_KEY, TPU_RESOURCE_NAME
from wva_tpu_torch.interfaces import SaturationScalingConfig
from wva_tpu_torch.k8s import (
    Container,
    Deployment,
    ExtensionRef,
    FakeCluster,
    InferencePool,
    Pod,
    PodStatus,
    PodTemplateSpec,
    ResourceRequirements,
    Service,
)
from wva_tpu_torch.main import build_manager
from wva_tpu_torch.utils.clock import FakeClock

from portbench.worlds.hpa import HPAEmulator, HPAParams
from portbench.worlds.kubelet import FakeKubelet
from portbench.worlds.loadgen import LoadProfile
from portbench.worlds.profiles import add_tpu_nodepool
from portbench.worlds.server_sim import ModelServerSim, ServingParams


@dataclass
class VariantSpec:
    """One model variant to emulate."""

    name: str  # VA/Deployment name
    model_id: str
    accelerator: str = "v5e-8"
    chips_per_replica: int = 8
    cost: float = 10.0
    initial_replicas: int = 1
    serving: ServingParams = field(default_factory=ServingParams)
    load: LoadProfile | None = None
    hpa: HPAParams = field(default_factory=HPAParams)


class EmulationHarness:
    def __init__(
        self,
        variants: list[VariantSpec],
        namespace: str = "inference",
        saturation_config: SaturationScalingConfig | None = None,
        config: Config | None = None,
        nodepools: list[tuple[str, str, str, int]] | None = None,
        startup_seconds: float = 120.0,
        engine_interval: float = 30.0,
        sfz_interval: float = 1.0,
        emit_interval: float = 5.0,
        start_time: float = 1_000_000.0,
        stochastic_seed: int | None = None,
        device=None,
    ) -> None:
        self.namespace = namespace
        self.variants = variants
        self.clock = FakeClock(start=start_time)
        self.start_time = start_time
        self.cluster = FakeCluster(clock=self.clock)
        self.tsdb = TimeSeriesDB(clock=self.clock, retention=1800.0)
        self.config = config or new_test_config()
        self.config.update_saturation_config(
            {"default": saturation_config or SaturationScalingConfig()})
        for pool in (nodepools or [("v5e-pool", "v5e", "2x4", 8)]):
            add_tpu_nodepool(self.cluster, *pool)

        # EPP service + pod (the scrape target for scale-from-zero).
        self.cluster.create(Service(
            metadata=ObjectMeta(name="epp-svc", namespace=namespace),
            selector={"app": "epp"}))
        self.cluster.create(Pod(
            metadata=ObjectMeta(name="epp-0", namespace=namespace,
                                labels={"app": "epp"}),
            status=PodStatus(phase="Running", ready=True, pod_ip="10.0.1.1")))

        self._stochastic_seed = stochastic_seed
        self.sims: dict[str, ModelServerSim] = {}
        self._sims_by_model: dict[str, ModelServerSim] = {}
        for spec in variants:
            self._create_variant(spec)

        def epp_fetcher(pod):
            return "".join(sim.epp_exposition()
                           for sim in self._sims_by_model.values())

        self.manager = build_manager(
            self.cluster, self.config, clock=self.clock, tsdb=self.tsdb,
            pod_fetcher=epp_fetcher, device=device)
        self.manager.engine.executor.max_retries_per_tick = 1
        self.manager.scale_from_zero.executor.max_retries_per_tick = 1
        self.manager.setup()
        self.flight_recorder = self.manager.flight_recorder

        self.kubelet = FakeKubelet(client=self.cluster, clock=self.clock,
                                   startup_seconds=startup_seconds)
        self.hpa = HPAEmulator(self.cluster, self.manager.registry, self.clock)
        for spec in variants:
            self.hpa.add_target(namespace, spec.name, spec.name,
                                spec.accelerator, spec.hpa,
                                kind=Deployment.KIND)

        self.engine_interval = engine_interval
        self.sfz_interval = sfz_interval
        self.emit_interval = emit_interval
        self._last_engine = -1e18
        self._last_sfz = -1e18
        self._last_emit = -1e18
        # Bring pods up for the initial replicas.
        self.kubelet.startup_seconds, orig = 0.0, self.kubelet.startup_seconds
        self.kubelet.step()
        self.kubelet.step()
        self.kubelet.startup_seconds = orig
        self._sync_sims()
        for sim in self._sims_by_model.values():
            sim.emit_metrics(self.clock.now())

    def _create_variant(self, spec: VariantSpec) -> None:
        labels = {"app": spec.model_id.split("/")[-1].lower(),
                  "variant": spec.name}
        p = spec.serving
        template = PodTemplateSpec(
            labels=dict(labels),
            containers=[Container(
                name="server",
                args=[f"--max_concurrent_decodes={p.max_concurrent_decodes}",
                      f"--tokens_per_slot={p.tokens_per_slot}",
                      "--max_target_length="
                      f"{int(p.avg_input_tokens + p.avg_output_tokens)}"],
                resources=ResourceRequirements(
                    requests={TPU_RESOURCE_NAME: str(spec.chips_per_replica)}),
            )])
        self.cluster.create(Deployment(
            metadata=ObjectMeta(name=spec.name, namespace=self.namespace),
            replicas=spec.initial_replicas,
            selector=dict(labels),
            template=template,
        ))
        self.cluster.create(VariantAutoscaling(
            metadata=ObjectMeta(
                name=spec.name, namespace=self.namespace,
                labels={ACCELERATOR_NAME_LABEL_KEY: spec.accelerator}),
            spec=VariantAutoscalingSpec(
                scale_target_ref=CrossVersionObjectReference(name=spec.name),
                model_id=spec.model_id,
                variant_cost=str(spec.cost))))
        self.cluster.create(InferencePool(
            metadata=ObjectMeta(name=f"{spec.name}-pool",
                                namespace=self.namespace),
            selector=dict(labels),
            extension_ref=ExtensionRef(service_name="epp-svc")))
        # One simulator a MODEL: the EPP routes a model's traffic across all
        # of its variants' pods.
        sim = self._sims_by_model.get(spec.model_id)
        if sim is None:
            seed = None if self._stochastic_seed is None \
                else self._stochastic_seed + len(self._sims_by_model)
            sim = ModelServerSim(spec.model_id, self.namespace, spec.serving,
                                 self.tsdb, seed=seed)
            self._sims_by_model[spec.model_id] = sim
        self.sims[spec.name] = sim

    def _sync_sims(self) -> None:
        pods_by_model: dict[str, dict] = {}
        for spec in self.variants:
            pods = pods_by_model.setdefault(spec.model_id, {})
            for pod in self.kubelet.ready_pods_of(self.namespace, spec.name):
                pods[pod] = spec.serving
        for model_id, pods in pods_by_model.items():
            self._sims_by_model[model_id].set_ready_replicas(pods)

    def step(self, dt: float = 1.0, on_step=None) -> None:
        """One world step: simulators, kubelet, the manager's executors on
        their cadences, the HPA, then the clock."""
        now = self.clock.now()
        t = now - self.start_time
        mgr = self.manager

        self._sync_sims()
        rates: dict[str, float] = {}
        for spec in self.variants:
            if spec.load is not None:
                rates[spec.model_id] = rates.get(spec.model_id, 0.0) \
                    + spec.load(t)
        for model_id, sim in self._sims_by_model.items():
            sim.step(now, dt, rates.get(model_id, 0.0))

        if now - self._last_emit >= self.emit_interval:
            for sim in self._sims_by_model.values():
                sim.emit_metrics(now)
            self._last_emit = now

        self.kubelet.step()
        if mgr.elector is not None:
            mgr.election_tick()
        if now - self._last_sfz >= self.sfz_interval:
            mgr.scale_from_zero.executor.tick()
            # A detected backlog forces an immediate engine tick.
            if mgr.fast_path_tick():
                mgr.engine.executor.tick()
                self._last_engine = now
            self._last_sfz = now
        if now - self._last_engine >= self.engine_interval:
            mgr.engine.executor.tick()
            self._last_engine = now
        mgr.va_reconciler.drain_triggers()
        self.hpa.step()

        if on_step is not None:
            on_step(self, t)
        self.clock.advance(dt)

    def replicas_of(self, name: str) -> int:
        return self.cluster.get(Deployment.KIND, self.namespace,
                                name).desired_replicas()

    def sim_of_model(self, model_id: str) -> ModelServerSim:
        return self._sims_by_model[model_id]
