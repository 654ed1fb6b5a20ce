"""PyTorch / CUDA port of the workload variant autoscaler.

Each module keeps the module path and names of its counterpart in the JAX
package so a reader can find it there. The port imports ``torch`` and
``numpy`` and never ``jax`` or the JAX package; host-only modules it needs
are kept as checked-in copies.

Every module of the JAX package has its counterpart here but the Pallas
kernel, which the hand-written CUDA sizing-bisection kernel replaces. The
main paths: the emulated control loop — ``emulator.EmulationHarness`` ->
``main.build_manager`` -> ``engines.saturation.SaturationEngine`` — with
the SLO analyzer, the EKF tuner (``analyzers.queueing.tuner``, its h and
jacobian one launch of the hand-written CUDA kernel
``analyzers/queueing/csrc/ekf_jacobian.cu`` on the card, and
``torch.func.jacfwd``, its plain version, on the CPU) and the fused
program on the card (the hand-written CUDA sizing-bisection and
forecaster-fit kernels, one host transfer), the same tick at fleet width;
the sizing solve's graft entry points (``entry``); the policy sweep
(``sweep``, its horizon scan one launch of the hand-written CUDA kernel a
chunk); and the CLI (``python -m wva_tpu_torch``). Each entry point takes
``device`` (None: the card).
"""

from wva_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
