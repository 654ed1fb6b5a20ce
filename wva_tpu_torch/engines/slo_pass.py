"""The staged SLO sizing pass of the engine tick.

Counterpart of the SLO branch of the JAX engine's analyze phase with the
fused program and the vectorized decision stage off
(``wva_tpu/engines/saturation/engine.py``): per-model ``prepare``, ONE
batched ``size_candidates`` over the fleet (``engine.py:2029-2075``),
per-model ``finalize`` in sorted model-key order (``engine.py:2125-2208``)
and the cost-aware optimizer (``engine.py:2279``).
"""

from __future__ import annotations

from wva_tpu_torch.analyzers.queueing.analyzer import QueueingModelAnalyzer
from wva_tpu_torch.interfaces import AnalyzerInput, VariantDecision
from wva_tpu_torch.pipeline.optimizer import (
    CostAwareOptimizer,
    ModelScalingRequest,
)


def run_slo_pass(analyzer: QueueingModelAnalyzer,
                 optimizer: CostAwareOptimizer,
                 inputs: list[AnalyzerInput]) -> list[VariantDecision]:
    """One tick's SLO decisions for ``inputs``, in the engine's sorted
    model-key (``model_id|namespace``) order:

    1. ``analyzer.prepare`` per model;
    2. one ``analyzer.size_candidates`` over the concatenated candidates of
       every model that needs sizing, sliced back per model
       (``engine.py:2029-2075``);
    3. ``analyzer.finalize`` per sized model; a model whose result has no
       variant capacities is left out, as the engine leaves it at its
       current replicas (``engine.py:2150-2185``);
    4. ``optimizer.optimize(requests, None)`` (``engine.py:2279``).
    """
    by_key = {f"{inp.model_id}|{inp.namespace}": inp for inp in inputs}
    keys = sorted(by_key)
    plans = {k: analyzer.prepare(by_key[k]) for k in keys}
    batch_keys = [k for k in keys if plans[k].needs_sizing]
    sized: dict[str, list[float]] = {}
    if batch_keys:
        per_replica = analyzer.size_candidates(
            [c for k in batch_keys for c in plans[k].candidates])
        offset = 0
        for k in batch_keys:
            n = len(plans[k].candidates)
            sized[k] = per_replica[offset:offset + n]
            offset += n
    requests = []
    for k in keys:
        plan = plans[k]
        result = (analyzer.finalize(plan, sized[k]) if plan.needs_sizing
                  else plan.result)
        if not result.variant_capacities:
            continue
        requests.append(ModelScalingRequest(
            model_id=plan.input.model_id, namespace=plan.input.namespace,
            result=result, variant_states=plan.input.variant_states))
    return optimizer.optimize(requests, None)
