# A frozen copy of wva_tpu_torch/emulator/kubelet.py (imports of its siblings
# pointed here), so that the benchmark's world cannot move with the program.
"""Fake kubelet: Deployment -> Pod reconciliation with slice-provisioning
delays and chip-aware node binding.

The TPU-critical behavior being modeled (SURVEY.md section 7, hard part 4):
slice provisioning + model loading take MINUTES — pods exist (pending) long
before they serve, which is exactly what the engine's pending-replica
cascade-prevention machinery has to handle.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from wva_tpu_torch.api.v1alpha1 import ObjectMeta
from wva_tpu_torch.constants.labels import TPU_RESOURCE_NAME
from wva_tpu_torch.k8s.client import KubeClient, NotFoundError
from wva_tpu_torch.k8s.objects import (
    clone,
    Deployment,
    LeaderWorkerSet,
    Node,
    Pod,
    PodStatus,
    parse_quantity,
)
from wva_tpu_torch.utils.clock import Clock

log = logging.getLogger(__name__)


@dataclass
class _PendingPod:
    name: str
    ready_at: float


@dataclass
class FakeKubelet:
    """Reconciles spec.replicas with pods for every Deployment, binding pods
    to nodes with free chips and marking them Ready after ``startup_seconds``.
    """

    client: KubeClient
    clock: Clock
    startup_seconds: float = 120.0  # model load + slice spin-up
    _pending: dict[str, _PendingPod] = field(default_factory=dict)
    _counters: dict[str, int] = field(default_factory=dict)

    def step(self) -> None:
        now = self.clock.now()
        # Node losses first: pods whose host vanished (spot preemption,
        # node-pool deletion) must die BEFORE reconciliation so the same
        # step recreates them (the controller-manager's pod GC + ReplicaSet
        # replacement, compressed into one pass).
        self._handle_lost_nodes()
        # Readiness next so the status refresh below sees pods that became
        # ready by now (otherwise statuses lag one step).
        self._mark_ready(now)
        for deploy in self.client.list(Deployment.KIND):
            self._reconcile_deployment(deploy, now)
        for lws in self.client.list(LeaderWorkerSet.KIND):
            self._reconcile_lws(lws, now)
        self._retry_unscheduled(now)

    def _handle_lost_nodes(self) -> None:
        """Pods bound to deleted nodes are deleted (their owner recreates
        them); pods on NotReady nodes lose readiness but survive (the node
        may come back). Cordoned nodes keep their pods — cordon only blocks
        NEW scheduling, exactly like kubectl cordon."""
        nodes = {n.metadata.name: n for n in self.client.list(Node.KIND)}
        for pod in self.client.list(Pod.KIND):
            if not pod.node_name:
                continue
            node = nodes.get(pod.node_name)
            if node is None:
                try:
                    self.client.delete(Pod.KIND, pod.metadata.namespace,
                                       pod.metadata.name)
                except NotFoundError:
                    pass
                self._pending.pop(pod.metadata.name, None)
            elif not node.ready and pod.status.ready:
                pod = clone(pod)  # listed pods are frozen store views
                pod.status.ready = False
                try:
                    self.client.update_status(pod)
                except NotFoundError:
                    pass

    def _retry_unscheduled(self, now: float) -> None:
        """Re-attempt binding for pods stuck without a node — chips may have
        freed since creation (real kube-scheduler retries continuously)."""
        for pod in self.client.list(Pod.KIND):
            if pod.node_name or pod.status.phase != "Pending" \
                    or pod.metadata.name in self._pending:
                continue
            chips_needed = sum(
                parse_quantity(c.resources.requests.get(TPU_RESOURCE_NAME, "0"))
                for c in pod.spec.containers)
            if chips_needed <= 0:
                continue
            node_name = self._find_node_with_chips(chips_needed)
            if node_name is None:
                continue
            pod = clone(pod)
            pod.node_name = node_name
            try:
                self.client.update(pod)
            except NotFoundError:
                continue
            self._pending[pod.metadata.name] = _PendingPod(
                name=pod.metadata.name, ready_at=now + self.startup_seconds)

    def _pods_of(self, deploy: Deployment) -> list[Pod]:
        return [
            p for p in self.client.list(Pod.KIND, namespace=deploy.metadata.namespace)
            if any(ref.get("kind") == "Deployment"
                   and ref.get("name") == deploy.metadata.name
                   for ref in p.metadata.owner_references)
        ]

    def _reconcile_deployment(self, deploy: Deployment, now: float) -> None:
        pods = self._pods_of(deploy)
        want = deploy.desired_replicas()
        have = len(pods)

        if have < want:
            for _ in range(want - have):
                self._create_pod(deploy, now)
        elif have > want:
            # Delete newest-first (approximates ReplicaSet downscale).
            doomed = sorted(pods, key=lambda p: p.metadata.creation_timestamp,
                            reverse=True)[: have - want]
            for pod in doomed:
                self._release_chips(pod)
                self.client.delete(Pod.KIND, pod.metadata.namespace,
                                   pod.metadata.name)
                self._pending.pop(pod.metadata.name, None)

        # refresh deployment status
        pods = self._pods_of(deploy)
        ready = sum(1 for p in pods if p.is_ready())
        status_changed = (deploy.status.replicas != len(pods)
                          or deploy.status.ready_replicas != ready)
        if status_changed:
            deploy = clone(deploy)
            deploy.status.replicas = len(pods)
            deploy.status.ready_replicas = ready
            deploy.status.updated_replicas = len(pods)
            try:
                self.client.update_status(deploy)
            except NotFoundError:
                pass

    # --- multi-host slice groups (LeaderWorkerSet) ---

    GROUP_INDEX_LABEL = "leaderworkerset.sigs.k8s.io/group-index"

    def _lws_groups(self, lws: LeaderWorkerSet) -> dict[int, list[Pod]]:
        groups: dict[int, list[Pod]] = {}
        for p in self.client.list(Pod.KIND, namespace=lws.metadata.namespace):
            if not any(ref.get("kind") == LeaderWorkerSet.KIND
                       and ref.get("name") == lws.metadata.name
                       for ref in p.metadata.owner_references):
                continue
            idx = int(p.metadata.labels.get(self.GROUP_INDEX_LABEL, "0"))
            groups.setdefault(idx, []).append(p)
        return groups

    def _reconcile_lws(self, lws: LeaderWorkerSet, now: float) -> None:
        """One replica = one group of ``size`` pods that provision together;
        downscale removes whole groups, highest index first."""
        size = max(lws.size, 1)
        groups = self._lws_groups(lws)
        want = lws.desired_replicas()

        if len(groups) < want:
            next_idx = max(groups, default=-1) + 1
            for g in range(next_idx, next_idx + (want - len(groups))):
                for h in range(size):
                    self._create_lws_pod(lws, g, h, now)
        elif len(groups) > want:
            for g in sorted(groups, reverse=True)[: len(groups) - want]:
                for pod in groups[g]:
                    self._release_chips(pod)
                    self.client.delete(Pod.KIND, pod.metadata.namespace,
                                       pod.metadata.name)
                    self._pending.pop(pod.metadata.name, None)

        groups = self._lws_groups(lws)
        # A group is ready only when EVERY host pod is ready — one unready
        # host keeps the whole slice replica pending.
        ready = sum(1 for pods in groups.values()
                    if len(pods) >= size and all(p.is_ready() for p in pods))
        if (lws.status.replicas != len(groups)
                or lws.status.ready_replicas != ready):
            lws = clone(lws)
            lws.status.replicas = len(groups)
            lws.status.ready_replicas = ready
            try:
                self.client.update_status(lws)
            except NotFoundError:
                pass

    def _create_lws_pod(self, lws: LeaderWorkerSet, group: int, host: int,
                        now: float) -> None:
        name = f"{lws.metadata.name}-{group}-{host}"
        chips_needed = sum(
            parse_quantity(c.resources.requests.get(TPU_RESOURCE_NAME, "0"))
            for c in lws.template.containers)
        node_name = self._find_node_with_chips(chips_needed)
        labels = dict(lws.template.labels)
        labels[self.GROUP_INDEX_LABEL] = str(group)
        pod = Pod(
            metadata=ObjectMeta(
                name=name, namespace=lws.metadata.namespace, labels=labels,
                owner_references=[{"kind": LeaderWorkerSet.KIND,
                                   "name": lws.metadata.name}]),
            spec=lws.template,
            node_name=node_name or "",
            status=PodStatus(phase="Pending", ready=False,
                             pod_ip=f"10.244.{group % 250}.{host % 250 + 1}"),
        )
        self.client.create(pod)
        if node_name or chips_needed == 0:
            self._pending[name] = _PendingPod(
                name=name, ready_at=now + self.startup_seconds)

    def _create_pod(self, deploy: Deployment, now: float) -> None:
        idx = self._counters.get(deploy.metadata.name, 0)
        self._counters[deploy.metadata.name] = idx + 1
        name = f"{deploy.metadata.name}-{idx}"
        chips_needed = sum(
            parse_quantity(c.resources.requests.get(TPU_RESOURCE_NAME, "0"))
            for c in deploy.template.containers)
        node_name = self._find_node_with_chips(chips_needed)
        pod = Pod(
            metadata=ObjectMeta(
                name=name, namespace=deploy.metadata.namespace,
                labels=dict(deploy.template.labels),
                owner_references=[{"kind": "Deployment",
                                   "name": deploy.metadata.name}]),
            spec=deploy.template,
            node_name=node_name or "",
            status=PodStatus(phase="Pending", ready=False,
                             pod_ip=f"10.244.0.{idx % 250 + 1}"),
        )
        self.client.create(pod)
        if node_name or chips_needed == 0:
            self._pending[name] = _PendingPod(name=name,
                                              ready_at=now + self.startup_seconds)
        else:
            # Unschedulable now; _retry_unscheduled rebinds when chips free up
            # (kube-scheduler retry semantics).
            log.debug("pod %s unschedulable: no node with %d free chips",
                      name, chips_needed)

    def _find_node_with_chips(self, chips_needed: int) -> str | None:
        """First node whose allocatable minus scheduled pod requests fits."""
        if chips_needed <= 0:
            return None
        used: dict[str, int] = {}
        for pod in self.client.list(Pod.KIND):
            if not pod.node_name or pod.status.phase in ("Succeeded", "Failed"):
                continue
            req = sum(parse_quantity(c.resources.requests.get(TPU_RESOURCE_NAME, "0"))
                      for c in pod.spec.containers)
            used[pod.node_name] = used.get(pod.node_name, 0) + req
        for node in self.client.list(Node.KIND):
            if not node.ready or getattr(node, "unschedulable", False):
                continue  # NotReady / cordoned hosts take no new pods
            alloc = parse_quantity(node.status.allocatable.get(TPU_RESOURCE_NAME, "0"))
            if alloc - used.get(node.metadata.name, 0) >= chips_needed:
                return node.metadata.name
        return None

    def _mark_ready(self, now: float) -> None:
        for name, pending in list(self._pending.items()):
            if pending.ready_at > now:
                continue
            # find the pod across namespaces
            for pod in self.client.list(Pod.KIND):
                if pod.metadata.name == name and not pod.status.ready:
                    pod = clone(pod)
                    pod.status.phase = "Running"
                    pod.status.ready = True
                    try:
                        self.client.update_status(pod)
                    except NotFoundError:
                        pass
                    break
            del self._pending[name]

    def _release_chips(self, pod: Pod) -> None:
        # Chips are derived from live pod listing; nothing to do explicitly.
        return

    def ready_pods_of(self, namespace: str, deployment_name: str) -> list[str]:
        """Pod names that count as serving replicas. For a Deployment: every
        ready pod. For a LeaderWorkerSet: one entry per FULLY-ready group
        (its leader pod, host 0) — a multi-host slice serves as one unit and
        exposes metrics through its leader."""
        try:
            deploy = self.client.get(Deployment.KIND, namespace, deployment_name)
            return sorted(p.metadata.name for p in self._pods_of(deploy)
                          if p.is_ready())
        except NotFoundError:
            pass
        try:
            lws = self.client.get(LeaderWorkerSet.KIND, namespace, deployment_name)
        except NotFoundError:
            return []
        size = max(lws.size, 1)
        out = []
        for g, pods in sorted(self._lws_groups(lws).items()):
            if len(pods) >= size and all(p.is_ready() for p in pods):
                leader = min(pods, key=lambda p: p.metadata.name)
                out.append(leader.metadata.name)
        return out
