"""The sizing kernel's host side, on the CPU: its launch geometry, the work
count behind its bound, the compiler-report parser, and the wrapper's
refusal to run the kernel on CPU tensors."""

import numpy as np
import pytest
import torch

from wva_tpu_torch.analyzers.queueing import _build, sizing_kernel
from wva_tpu_torch.analyzers.queueing import queue_model as qm


@pytest.mark.parametrize("k_cols,nv", [(32, 8), (96, 8), (256, 8), (288, 16),
                                       (512, 16), (1024, 32), (1056, 64),
                                       (2048, 64)])
def test_launch_shape_values_per_lane(k_cols, nv):
    assert sizing_kernel.launch_shape(77, k_cols).values_per_lane == nv


@pytest.mark.parametrize("c,rows,blocks", [(0, 4, 0), (1, 4, 1), (77, 4, 20),
                                           (77, 1, 77), (2048, 4, 512),
                                           (8192, 8, 1024), (8191, 2, 4096)])
def test_launch_shape_grid(c, rows, blocks):
    shape = sizing_kernel.launch_shape(c, 512, rows)
    assert shape.blocks == blocks and shape.threads == 32 * rows
    assert shape.blocks * rows >= c > (shape.blocks - 1) * rows or c == 0


@pytest.mark.parametrize("k_cols,rows", [(200, 4), (0, 4), (-32, 4),
                                         (2080, 4), (512, 9), (512, 16),
                                         (512, 0)])
def test_launch_shape_rejects(k_cols, rows):
    with pytest.raises(ValueError, match="k_cols|rows_per_block"):
        sizing_kernel.launch_shape(8, k_cols, rows)


def test_every_trimmed_state_axis_has_a_launch_shape():
    # k_cols_for is the sizing path's trim rule; the kernel takes each width.
    for k in (1, 255, 256, 257, 480, 1000, 2048):
        k_cols = qm.k_cols_for([k])
        shape = sizing_kernel.launch_shape(2048, k_cols)
        assert 32 * shape.values_per_lane >= k_cols >= k


def _cand(k):
    n = len(k)
    return qm.candidate_batch(np.full(n, 8.0), np.full(n, 0.01),
                              np.full(n, 1e-4), np.full(n, 512.0),
                              np.full(n, 256.0), np.full(n, 64),
                              np.asarray(k), device="cpu")


def test_work_and_bound_at_the_slice_call():
    # The slice's sizing call: 2048 rows, every k = 480, k_cols = 512.
    w = sizing_kernel.work(_cand([480] * 2048), 512)
    assert w.states == 2048 * 480 == 983_040
    assert w.exps == 96 * w.states == 94_371_840
    assert w.fp32_ops == 96 * 11 * w.states
    assert w.bytes == 4 * (w.states + 2048 * 16)
    ms, term = w.bound()
    assert term == "sfu"
    assert round(ms, 4) == 0.0226
    terms = w.bound_terms_ms()
    assert terms["sfu"] == ms > terms["fp32"] > terms["bytes"]
    assert round(terms["fp32"], 4) == 0.0155


def test_work_clamps_k_at_k_cols():
    w = sizing_kernel.work(_cand([100, 600, 2048]), 512)
    assert w.states == 100 + 512 + 512
    assert sizing_kernel.work(_cand([100, 600, 2048]), 2048).states == 2748


_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123sizing_bisection_kernelILi8EEEvPKfS2_S2_S2_S2_Pfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123sizing_bisection_kernelILi8EEEvPKfS2_S2_S2_S2_Pfiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123sizing_bisection_kernelILi64EEEvPKfS2_S2_S2_S2_Pfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123sizing_bisection_kernelILi64EEEvPKfS2_S2_S2_S2_Pfiiii
    24 bytes stack frame, 24 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 512 bytes smem, 392 bytes cmem[0]
"""


def test_resources_parses_the_compiler_report():
    assert _build.resources(_PTXAS) == [
        dict(values_per_lane=8, registers=40, stack=0, spill_stores=0,
             spill_loads=0, smem=0),
        dict(values_per_lane=64, registers=128, stack=24, spill_stores=24,
             spill_loads=28, smem=512)]
    assert _build.resources("nvcc: nothing compiled\n") == []


def test_launch_order_only_past_one_wave():
    # Past one wave of the widest rows: C * k_cols > rows_per_wave * 2048.
    wave = 2112  # e.g. 132 SMs x 16 rows
    k = torch.from_numpy(np.random.default_rng(9).integers(
        1, 2049, 4 * wave + 1).astype(np.int32))
    for n, k_cols, sorts in ((64, 2048, False), (wave, 2048, False),
                             (wave + 1, 2048, True), (2 * wave, 1024, False),
                             (2 * wave + 1, 1024, True),
                             (4 * wave, 512, False),
                             (4 * wave + 1, 512, True)):
        order = sizing_kernel.launch_order(k[:n], k_cols, wave)
        assert (order is not None) == sorts, (n, k_cols)
    order = sizing_kernel.launch_order(k, 512, wave)
    assert torch.equal(order, sizing_kernel.rows_by_k(k))
    assert order.dtype == torch.int64 and order.shape == k.shape
    assert torch.equal(torch.sort(order).values, torch.arange(len(k)))
    assert bool((k[order][:-1] // 16 >= k[order][1:] // 16).all())


def test_launch_refuses_cpu_tensors():
    cand = _cand([100, 200])
    clm = qm._cum_log_mu(cand, 256)
    clm_at_k = torch.gather(clm, 1, (cand.k[:, None] - 1).long())[:, 0]
    lo, hi = qm.rate_bounds_per_ms(cand)
    before = sizing_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        sizing_kernel.launch(clm, clm_at_k, cand, torch.ones(2, 2),
                             torch.stack([lo, lo]), torch.stack([hi, hi]),
                             torch.empty(2, 2))
    assert sizing_kernel.launches == before
