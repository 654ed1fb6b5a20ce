"""Per-replica serving metrics.

TPU re-design of the reference's ``ReplicaMetrics``
(``/root/reference/internal/interfaces/saturation_analyzer.go:12-71``):

- ``kv_cache_usage`` is the **HBM KV-cache utilization** of the slice (0..1).
  JetStream exposes it as ``jetstream_kv_cache_utilization``; vLLM-TPU as
  ``vllm:kv_cache_usage_perc`` — the collector normalizes both here.
- ``queue_length`` is the waiting-request depth. JetStream splits it into
  prefill and generate backlogs; the analyzer's saturation notion is the
  *prefill* backlog (requests not yet admitted), so ``queue_length`` carries
  prefill backlog + waiting, and ``generate_backlog`` is kept separately.
- The V2 token-capacity fields keep the reference names (`num_kv_blocks` is
  the engine-agnostic spelling of vLLM's ``num_gpu_blocks``); on JetStream the
  capacity comes from decode slots x tokens-per-slot instead of block counts,
  and the collector fills ``total_kv_capacity_tokens`` directly.
"""

from __future__ import annotations

from dataclasses import dataclass

from wva_tpu_torch.api.v1alpha1 import DEFAULT_VARIANT_COST

# Freshness states (reference saturation_analyzer.go:69-71).
FRESH = "fresh"
STALE = "stale"
UNAVAILABLE = "unavailable"


@dataclass
class ReplicaMetricsMetadata:
    collected_at: float = 0.0
    age_seconds: float = 0.0
    freshness: str = FRESH


@dataclass
class ReplicaMetrics:
    """Capacity-related metrics for a single replica (= one slice workload pod,
    or the leader pod of a multi-host slice)."""

    pod_name: str = ""
    kv_cache_usage: float = 0.0  # HBM KV utilization, 0.0-1.0
    queue_length: int = 0  # waiting requests (prefill backlog on JetStream)
    variant_name: str = ""
    namespace: str = ""
    model_id: str = ""
    accelerator_name: str = ""  # TPU slice variant, e.g. "v5e-8"
    cost: float = DEFAULT_VARIANT_COST
    metadata: ReplicaMetricsMetadata | None = None

    # --- V2 token-capacity fields (reference :24-60) ---
    num_kv_blocks: int = 0  # vLLM-TPU cache_config_info num_gpu_blocks
    block_size: int = 0  # tokens per KV block
    total_kv_capacity_tokens: int = 0  # num_kv_blocks*block_size, or JetStream slots budget
    tokens_in_use: int = 0  # kv_cache_usage * total_kv_capacity_tokens
    avg_output_tokens: float = 0.0
    avg_input_tokens: float = 0.0
    prefix_cache_hit_rate: float = 0.0

    # --- TPU/JetStream-specific extensions ---
    # Decode ("generate") backlog: admitted requests waiting for a free decode
    # slot (jetstream_generate_backlog_size). Counted into demand by V2.
    generate_backlog: int = 0
    # Concurrent decode slots used / total (jetstream_slots_used/_available).
    slots_used: int = 0
    slots_total: int = 0


@dataclass
class SchedulerQueueMetrics:
    """Model-level queue metrics from the inference-scheduler flow-control
    layer (``inference_extension_flow_control_*``; reference analyzer.go:54-65).
    Model-scoped, not per-pod."""

    queue_size: int = 0
    queue_bytes: int = 0
