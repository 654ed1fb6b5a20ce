"""PyTorch / CUDA port of the workload variant autoscaler.

Each module keeps the module path and names of its counterpart in the JAX
package so a reader can find it there. The port imports ``torch`` and
``numpy`` and never ``jax`` or the JAX package; host-only modules it needs
are kept as checked-in copies.

Covered so far: the SLO sizing pass (``engines.slo_pass.run_slo_pass``):
``QueueingModelAnalyzer.prepare`` per model, one batched sizing call over
the fleet's candidates (the hand-written CUDA sizing-bisection kernel on
the card), ``finalize`` per model and the ``CostAwareOptimizer``.
"""

from wva_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
