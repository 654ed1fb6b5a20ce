"""PyTorch / CUDA port of the workload variant autoscaler.

Each module keeps the module path and names of its counterpart in the JAX
package so a reader can find it there. The port imports ``torch`` and
``numpy`` and never ``jax`` or the JAX package; host-only modules it needs
are kept as checked-in copies.

Covered so far: the SLO engine tick (``engines.slo_pass``), staged
(``run_slo_pass``) and fused (``run_fused_pass``): ``prepare`` per model,
the forecast planner's learning pass, one fused program on the card (the
hand-written CUDA sizing-bisection and forecaster-fit kernels, one host
transfer), ``finalize`` per model, the fleet solve for global-routed models,
the ``CostAwareOptimizer`` for the rest, and the forecast floors.
"""

from wva_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
