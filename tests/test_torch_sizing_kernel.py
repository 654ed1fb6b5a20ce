"""The CUDA sizing-bisection kernel against its plain version, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit and skip without one.
On a machine with the card (where jax may be absent, hence no conftest):

    python -m pytest --noconftest tests/test_torch_sizing_kernel.py -q
"""

import numpy as np
import pytest
import torch

from wva_tpu_torch.analyzers.queueing import queue_model as qm
from wva_tpu_torch.analyzers.queueing import sizing_kernel

pytestmark = pytest.mark.cuda

RTOL = 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def _population(n, seed, k_hi, device, k_lo=None):
    rng = np.random.default_rng(seed)
    cand = qm.candidate_batch(
        rng.uniform(3.0, 30.0, n), rng.uniform(0.001, 0.05, n),
        rng.uniform(0.00001, 0.002, n), rng.uniform(64, 2048, n),
        rng.uniform(32, 1024, n), rng.integers(8, 128, n),
        rng.integers(min(128, k_hi - 1) if k_lo is None else k_lo, k_hi, n),
        device=device)
    targets = torch.tensor(
        np.stack([rng.uniform(100, 3000, n), rng.uniform(5, 100, n)]),
        dtype=torch.float32, device=device)
    return cand, targets


def _args(cand, targets, k_cols, clm=None):
    lo, hi = qm.rate_bounds_per_ms(cand)
    if clm is None:
        clm = qm._cum_log_mu(cand, k_cols)
    clm_at_k = torch.gather(clm, 1, (cand.k[:, None] - 1).long())[:, 0]
    return (clm, clm_at_k, cand, targets.contiguous(),
            torch.stack([lo, lo]), torch.stack([hi, hi]))


# One k_cols per NV instantiation; 77 and 3001 rows leave the last block
# ragged at every rows-per-block choice above 1.
@pytest.mark.parametrize("k_cols", [256, 512, 1024, 2048])
@pytest.mark.parametrize("n", [1, 77, 3001])
def test_kernel_matches_plain(cuda, n, k_cols):
    args = _args(*_population(n, n + k_cols, k_cols, cuda), k_cols)
    before = sizing_kernel.launches
    got = sizing_kernel.sizing_bisection(*args)
    assert sizing_kernel.launches == before + 1
    want = sizing_kernel.sizing_bisection_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL)


def test_rows_are_bitwise_independent(cuda):
    cand, targets = _population(128, 1, 512, cuda)
    full = sizing_kernel.sizing_bisection(*_args(cand, targets, 512))
    sub = qm.CandidateBatch(*(f[:77] for f in cand))
    part = sizing_kernel.sizing_bisection(
        *_args(sub, targets[:, :77], 512))
    assert torch.equal(part, full[:, :77])
    perm = torch.randperm(128, generator=torch.Generator().manual_seed(3))
    perm = perm.to(cuda)
    shuffled = qm.CandidateBatch(*(f[perm] for f in cand))
    out = sizing_kernel.sizing_bisection(
        *_args(shuffled, targets[:, perm], 512))
    assert torch.equal(out, full[:, perm])


def test_wider_state_axis_is_bitwise_neutral(cuda):
    cand, targets = _population(200, 2, 512, cuda)
    wide = qm._cum_log_mu(cand, 2048)
    a = sizing_kernel.sizing_bisection(*_args(cand, targets, 2048, wide))
    for k_cols in (512, 1024):
        b = sizing_kernel.sizing_bisection(
            *_args(cand, targets, k_cols, wide[:, :k_cols].contiguous()))
        assert torch.equal(a, b), k_cols


def test_skip_past_k_is_bitwise_neutral(cuda):
    # Rows of small k skip most chunks of a 2048-wide chain: the same bits
    # as computing every chunk, and as the 256-wide chain.
    cand, targets = _population(200, 5, 64, cuda, k_lo=8)
    wide = qm._cum_log_mu(cand, 2048)
    args = _args(cand, targets, 2048, wide)
    skipped = sizing_kernel.sizing_bisection(*args)
    full = sizing_kernel.launch(*args, torch.empty_like(skipped),
                                skip_past_k=False)
    assert torch.equal(full, skipped)
    narrow = sizing_kernel.sizing_bisection(
        *_args(cand, targets, 256, wide[:, :256].contiguous()))
    assert torch.equal(narrow, skipped)


@pytest.mark.parametrize("rows_per_block", [1, 4])
def test_rows_per_block_is_bitwise_neutral(cuda, rows_per_block):
    cand, targets = _population(77, 6, 512, cuda)
    args = _args(cand, targets, 512)
    want = sizing_kernel.sizing_bisection(*args)
    got = sizing_kernel.launch(*args, torch.empty_like(want),
                               rows_per_block=rows_per_block)
    assert torch.equal(got, want)


def test_rows_per_wave_is_whole_blocks_on_every_sm(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    waves = [sizing_kernel.rows_per_wave(cuda, nv) for nv in (8, 16, 32, 64)]
    for n in waves:
        assert n > 0 and n % (sms * sizing_kernel.ROWS_PER_BLOCK) == 0
    assert waves == sorted(waves, reverse=True)  # more registers, fewer rows


def test_launch_order_is_bitwise_neutral(cuda):
    n = sizing_kernel.rows_per_wave(cuda, 64) + 1
    cand, targets = _population(n, 7, 2048, cuda, k_lo=32)
    args = _args(cand, targets, 2048)
    got = sizing_kernel.sizing_bisection(*args)  # ordered: past one wave
    assert sizing_kernel.launch_order(cand.k, 2048, n - 1) is not None
    in_place = sizing_kernel.launch(*args, torch.empty_like(got))
    assert torch.equal(got, in_place)
    reverse = torch.arange(n - 1, -1, -1, device=cuda)
    reversed_ = sizing_kernel.launch(*args, torch.empty_like(got),
                                     order=reverse)
    assert torch.equal(got, reversed_)


def test_size_batch_one_launch_and_disabled_targets(cuda):
    cand, targets = _population(5000, 3, 512, cuda)
    zeros = torch.zeros(5000, device=cuda)
    before = sizing_kernel.launches
    got = qm.size_batch(cand, zeros, zeros, zeros, k_cols=512)
    assert sizing_kernel.launches == before + 1  # no chunking on the card
    want = qm.size_batch(cand, zeros, zeros, zeros, k_cols=512, impl="plain")
    assert sizing_kernel.launches == before + 1
    for key in ("max_rate_per_s", "rate_target_ttft_per_s",
                "rate_target_itl_per_s"):
        np.testing.assert_allclose(got[key].cpu().numpy(),
                                   want[key].cpu().numpy(), rtol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    cand, targets = _population(16, 4, 256, cuda)
    args = list(_args(cand, targets, 256))
    with pytest.raises(ValueError, match="dtype"):
        sizing_kernel.sizing_bisection(
            *args[:3], args[3].double(), *args[4:])
    with pytest.raises(ValueError, match="contiguous"):
        sizing_kernel.sizing_bisection(
            *args[:3], torch.stack([args[3][1], args[3][0]], 1).t(),
            *args[4:])
    with pytest.raises(ValueError, match="on cpu"):
        sizing_kernel.sizing_bisection(*args[:3], args[3].cpu(), *args[4:])
    with pytest.raises(ValueError, match="k_cols"):
        sizing_kernel.sizing_bisection(args[0][:, :200].contiguous(),
                                       *args[1:])
