"""The sweep's horizon-scan CUDA kernel: its build, its launch and its bound.

``csrc/world_scan.cu`` computes what the JAX package's jitted scan
(``wva_tpu/sweep/world.py:177`` ``_build_scan``) computes: a chunk of fluid
worlds advanced through the whole horizon. A block holds 32 (world, model)
lanes and splits each step into its three stages (forecast and sizing,
control, serving), each walked by its own warp in tiles of steps handed
on through shared memory, with the divisions in a pool of warps, one step
a thread, and the provisioning pipeline's pending sums as running partial
folds in registers.
:func:`wva_tpu_torch.sweep.world.run_chunk` is the wrapper the sweep calls:
on CUDA tensors it runs :func:`launch` once a chunk, on CPU tensors the
plain version ``run_chunk_plain``.

The library is built with ``-fmad=false``: no multiply and add are
contracted, so each operation rounds once, in the plain version's order.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Mapping, NamedTuple

import torch

from wva_tpu_torch import cuda_build
from wva_tpu_torch.sweep import knobs as kb

_SOURCE = Path(__file__).resolve().parent / "csrc" / "world_scan.cu"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.world_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.world_scan_block
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = None


LIBRARY = cuda_build.Library(_SOURCE, _bind,
                             cuda_build.NVCC_FLAGS + ("-fmad=false",))

# Kernel launches made by :func:`launch` since the last reset. Callers that
# want to show a run went through the kernel set it to 0 before the run and
# read it after.
launches = 0

# The deepest provisioning pipeline the kernel takes (kMaxLead in the
# source): lead_steps above it are refused, never truncated.
MAX_LEAD = 128

# The step's float32 constants, in the kernel's ``Consts`` order
# (:func:`wva_tpu_torch.sweep.world.scan_constants` gives their values).
CONSTANT_NAMES = (
    "eps", "dt", "ms", "max_batch", "max_replicas", "steps", "lead",
    "iter_slope", "alpha", "prefill_extra", "out_tokens", "rate_full",
    "slo_ttft", "queue_bound", "startup", "stab_steps", "chips_per_replica",
    "init_replicas", "err_gain", "two",
)

# The longest chain of dependent operations one step of the plain loop
# hands to the next: the Holt trend through level + trend, * (1-ga),
# + ga*obs, the update's select, - level, * gb, + (1-gb)*trend, select.
# The other carries are shorter (the queue 6; the pipeline's new tail
# through the next step's last two lanes of the fold, ready + pending,
# desired less it, the max and the new tail, 6; ready and desired 4). The
# six IEEE divisions (~9 dependent instructions, ~40 cycles each) feed the
# observation, the smoothed error, the raw desired count and the TTFT,
# which no carry reads back through itself, so none is on the chain.
CHAIN_OPS_PER_STEP = 8


class Work(NamedTuple):
    """What one chunk of ``worlds`` x ``models`` lanes over ``steps`` steps
    must do."""

    worlds: int
    models: int
    steps: int
    bytes: int  # each input read once, each output written once
    chain_ops: int  # dependent operations on one lane's critical path

    def bound_terms_ms(self) -> dict[str, float]:
        """The bytes and chain terms (:func:`cuda_build.chain_bound_terms_ms`),
        in ms."""
        return cuda_build.chain_bound_terms_ms(self.bytes, self.chain_ops)

    def bound(self) -> tuple[float, str]:
        """(ms, term): the larger of :meth:`bound_terms_ms`, and its name."""
        return cuda_build.binding(self.bound_terms_ms())


def work(worlds: int, models: int, steps: int) -> Work:
    """The knob rows ``[W, K]``, the rates ``[T, M]`` and the arrival and
    fault tables ``[T, W, M]`` read, the four ``[W, M]`` outputs written,
    and T steps of the chain on each lane."""
    lanes = worlds * models
    floats = (worlds * len(kb.KNOB_FIELDS) + steps * models
              + 2 * steps * lanes + 4 * lanes)
    return Work(worlds=worlds, models=models, steps=steps, bytes=4 * floats,
                chain_ops=steps * CHAIN_OPS_PER_STEP if lanes else 0)


def block(lead: int) -> dict[str, int]:
    """A block's threads and dynamic shared memory, in bytes, at a pipeline
    of ``lead`` lanes, as the built library launches it."""
    if not 1 <= lead <= MAX_LEAD:
        raise ValueError(f"lead={lead} steps is outside the kernel's 1.."
                         f"{MAX_LEAD}")
    threads, shared = ctypes.c_int(), ctypes.c_int()
    LIBRARY.load().world_scan_block(lead, ctypes.byref(threads),
                                    ctypes.byref(shared))
    return {"threads": threads.value, "shared_bytes": shared.value}


def launch(knob_rows: torch.Tensor, lam_t: torch.Tensor,
           arrivals: torch.Tensor, faults: torch.Tensor,
           consts: Mapping[str, float], *, lead: int) -> torch.Tensor:
    """Run the kernel once on CUDA tensors: ``knob_rows [W, K]``, ``lam_t
    [T, M]``, ``arrivals`` and ``faults [T, W, M]``, float32 and contiguous;
    ``consts`` maps each of ``CONSTANT_NAMES`` to its value (rounded to
    float32 here); ``lead`` is the pipeline's depth, 1..``MAX_LEAD``. The
    ``[4, W, M]`` results (attainment, chip-seconds, wrong-direction
    events, arrivals in total) are returned as one new tensor."""
    if not 1 <= lead <= MAX_LEAD:
        raise ValueError(f"lead={lead} steps is outside the kernel's 1.."
                         f"{MAX_LEAD}")
    if not knob_rows.is_cuda:
        raise ValueError(f"the kernel needs CUDA tensors; knob_rows is on "
                         f"{knob_rows.device}")
    if knob_rows.dim() != 2 or lam_t.dim() != 2:
        raise ValueError(f"knob_rows and lam_t must be 2-D, got shapes "
                         f"{tuple(knob_rows.shape)}, {tuple(lam_t.shape)}")
    (w, k), (t, m) = knob_rows.shape, lam_t.shape
    if k != len(kb.KNOB_FIELDS):
        raise ValueError(f"knob_rows has {k} columns, expected "
                         f"{len(kb.KNOB_FIELDS)}")
    dev = knob_rows.device
    for name, tensor, shape in (("knob_rows", knob_rows, (w, k)),
                                ("lam_t", lam_t, (t, m)),
                                ("arrivals", arrivals, (t, w, m)),
                                ("faults", faults, (t, w, m))):
        cuda_build.check_tensor(name, tensor, torch.float32, shape, dev)
    out = torch.empty((4, w, m), dtype=torch.float32, device=dev)
    values = (ctypes.c_float * len(CONSTANT_NAMES))(
        *(float(consts[name]) for name in CONSTANT_NAMES))
    if w * m == 0:
        return out
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    global launches
    launches += 1
    args = (knob_rows.data_ptr(), lam_t.data_ptr(), arrivals.data_ptr(),
            faults.data_ptr(), out.data_ptr(), w, m, t, lead, k, values,
            len(CONSTANT_NAMES), stream)
    with torch.cuda.device(dev):
        err = lib.world_scan_launch(*args)
    if err != 0:
        raise RuntimeError(f"world_scan kernel launch failed: "
                           f"{LIBRARY.error_string(err)} (cudaError {err})")
    return out
