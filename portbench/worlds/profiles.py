# A frozen copy of wva_tpu_torch/emulator/profiles.py (imports of its siblings
# pointed here), so that the benchmark's world cannot move with the program.
"""Fake TPU node-pool profiles
(equivalent of ``deploy/kind-emulator/setup.sh:144-262``, which patches GPU
labels + allocatable onto kind nodes; here we create Nodes carrying the GKE
TPU label schema directly).
"""

from __future__ import annotations

from wva_tpu_torch.api.v1alpha1 import ObjectMeta
from wva_tpu_torch.constants.labels import (
    GKE_NODEPOOL_NODE_LABEL,
    GKE_TPU_ACCELERATOR_NODE_LABEL,
    GKE_TPU_TOPOLOGY_NODE_LABEL,
    TPU_RESOURCE_NAME,
)
from wva_tpu_torch.discovery.tpu import parse_tpu_topology
from wva_tpu_torch.k8s.client import KubeClient
from wva_tpu_torch.k8s.objects import Node, NodeStatus

# accelerator label values per short generation name
_ACCELERATOR_LABELS = {
    "v3": "tpu-v3-slice",
    "v4": "tpu-v4-podslice",
    "v5e": "tpu-v5-lite-podslice",
    "v5p": "tpu-v5p-slice",
    "v6e": "tpu-v6e-slice",
}


def add_tpu_nodepool(
    client: KubeClient,
    pool_name: str,
    generation: str,
    topology: str,
    num_slices: int,
    chips_per_host: int | None = None,
    extra_labels: dict[str, str] | None = None,
) -> list[Node]:
    """Create the hosts of ``num_slices`` whole slices of the given shape.

    e.g. ``add_tpu_nodepool(c, "v5e-pool", "v5e", "2x4", 8)`` creates 8
    single-host v5e-8 nodes; ``("mh-pool", "v5e", "4x4", 2,
    chips_per_host=4)`` creates 2 slices x 4 hosts of 4 chips each.
    ``extra_labels`` rides on every host (capacity-tier labels like
    ``cloud.google.com/gke-spot``).
    """
    accel = _ACCELERATOR_LABELS[generation]
    info = parse_tpu_topology(accel, topology,
                              chips_per_host=chips_per_host or 0)
    if info is None:
        raise ValueError(f"unknown TPU shape {generation}/{topology}")
    nodes = []
    for s in range(num_slices):
        for h in range(info.hosts):
            node = Node(
                metadata=ObjectMeta(
                    name=f"{pool_name}-s{s}-h{h}",
                    labels={
                        GKE_TPU_ACCELERATOR_NODE_LABEL: accel,
                        GKE_TPU_TOPOLOGY_NODE_LABEL: topology,
                        GKE_NODEPOOL_NODE_LABEL: pool_name,
                        **(extra_labels or {}),
                    },
                ),
                status=NodeStatus(
                    capacity={TPU_RESOURCE_NAME: str(info.chips_per_host)},
                    allocatable={TPU_RESOURCE_NAME: str(info.chips_per_host)},
                ),
            )
            client.create(node)
            nodes.append(node)
    return nodes
