"""The EKF tuner's observation-and-jacobian CUDA kernel: its build, its
launch and its bound.

``csrc/ekf_jacobian.cu`` computes what the JAX package's jitted
``_observe_and_jacobian`` (``wva_tpu/analyzers/queueing/tuner.py:158``)
computes: h = (TTFT, ITL) at the observed rate and H = dh/d(alpha, beta,
gamma), by forward mode through the chain of 2048 states, in one block.
:func:`wva_tpu_torch.analyzers.queueing.tuner._observation` is the wrapper
the tuner calls: on CUDA tensors it runs :func:`launch` once, on CPU
tensors the plain version ``observe_and_jacobian_plain`` (``jacfwd``).

The library is built with ``-fmad=false``: no multiply and add are
contracted, so each operation rounds once, as the plain version's do.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from wva_tpu_torch import cuda_build
from wva_tpu_torch.analyzers.queueing.sizing_kernel import FP32_OPS_PER_S

_SOURCE = Path(__file__).resolve().parent / "csrc" / "ekf_jacobian.cu"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ekf_jacobian_launch
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int


LIBRARY = cuda_build.Library(_SOURCE, _bind,
                             cuda_build.NVCC_FLAGS + ("-fmad=false",))

# Kernel launches made by :func:`launch` since the last reset. Callers that
# want to show a run went through the kernel set it to 0 before the run and
# read it after.
launches = 0

# The output: TTFT and ITL in rows, each the value and its derivatives by
# alpha, beta and gamma.
OUT_SHAPE = (2, 4)

# The bytes one step must move: x and env read, h and H written.
STEP_BYTES = 4 * (3 + 5 + 2 + 6)
# The dependent chain of one step's evaluation, parallel over the states,
# counted from the plain version's operations (_observe_and_jacobian
# through _chain_stats at K_MAX = 2048 states): the rate bounds (14), the
# clip (2), log and the chain ratio (2), the prefix sum over 2048 states as
# a tree (11), the clamp (1), logsumexp (a max tree 11, subtract, exp, a sum
# tree 11, log, add: 26), exp (2), the two weighted sums (12), throughput
# and the response times (5), prefill at the mean occupancy and the
# latencies (10): 85 operations, doubled because each tangent follows its
# value and a product's tangent adds one more.
CHAIN_OPS = 2 * 85


class Work(NamedTuple):
    """What one step's h and H must do."""

    bytes: int  # x and env read once, h and H written once
    operations: int  # elements the plain version's pointwise ops write
    chain_ops: int  # dependent operations on the step's critical path

    def bound_terms_ms(self) -> dict[str, float]:
        """The bytes and chain terms (:func:`cuda_build.chain_bound_terms_ms`)
        and the operations at the float32 rate, in ms."""
        return {**cuda_build.chain_bound_terms_ms(self.bytes, self.chain_ops),
                "operations": 1e3 * self.operations / FP32_OPS_PER_S}

    def bound(self) -> tuple[float, str]:
        """(ms, term): the larger of :meth:`bound_terms_ms`, and its name."""
        return cuda_build.binding(self.bound_terms_ms())


def work(operations: int) -> Work:
    """One step's work, ``operations`` being the elements the plain
    version's pointwise ops write (one operation an element)."""
    return Work(bytes=STEP_BYTES, operations=operations, chain_ops=CHAIN_OPS)


def launch(x: torch.Tensor, env: torch.Tensor) -> torch.Tensor:
    """Run the kernel once on CUDA tensors ``x`` [3] and ``env`` [5]
    (float32, one card) and return the ``[2, 4]`` output: h in column 0, H
    in columns 1-3."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors; x is on {dev}")
    cuda_build.check_tensor("x", x, torch.float32, (3,), dev)
    cuda_build.check_tensor("env", env, torch.float32, (5,), dev)
    out = torch.empty(OUT_SHAPE, dtype=torch.float32, device=dev)
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    global launches
    launches += 1
    args = (x.data_ptr(), env.data_ptr(), out.data_ptr(), stream)
    if dev.index == torch.cuda.current_device():
        err = lib.ekf_jacobian_launch(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.ekf_jacobian_launch(*args)
    if err != 0:
        raise RuntimeError(f"ekf_jacobian kernel launch failed: "
                           f"{LIBRARY.error_string(err)} (cudaError {err})")
    return out
