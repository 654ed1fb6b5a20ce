"""The chain-setup and chain-statistics CUDA kernels
(``wva_tpu_torch/analyzers/queueing/csrc/chain_setup.cu`` and
``chain_stats.cu``) against their plain versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit and skip without one.
On a machine with the card (where jax may be absent, hence no conftest):

    python -m pytest --noconftest tests/test_torch_chain_kernel.py -q

Seeded populations at C in {1, 7, 64, 2048} and every k_cols of the sizing
path, with the edge rows of ``chip_smoke.chain_inputs`` (k = 1, k = k_cols,
no prompt, disabled targets, rates outside the bounds), go through each
kernel and its plain version on the same CUDA tensors, held by
``chip_smoke``'s own checks (rtol 2e-3; the prefix sums at 2e-3 of the sum
of their terms' magnitudes; ``valid`` equal). ``size_batch`` makes three
launches (setup, sizing, statistics) and ``analyze_batch`` one; a row's
bits are the same alone and inside a batch; ``analyze_batch`` at k_cols
2048 with k = 480 gives the bits of k_cols 512; a max batch of 300 (its
own log mu over two segments) holds; the tuner's kernel agrees with
``jacfwd``; the wrappers refuse what the kernels do not take, counting no
launch.
"""

import pytest
import torch

import chip_smoke
from wva_tpu_torch.analyzers.queueing import (
    chain_setup,
    chain_stats,
    jacobian_kernel,
    sizing_kernel,
)
from wva_tpu_torch.analyzers.queueing import queue_model as qm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


CASES = [(n, k_cols) for k_cols in chip_smoke.CHAIN_K_COLS
         for n in chip_smoke.CHAIN_ROWS]


@pytest.mark.parametrize("n,k_cols", CASES)
def test_kernels_match_their_plain_versions(cuda, n, k_cols):
    err = chip_smoke.Errors()
    cand, t, rate = chip_smoke.chain_inputs(n, 900 + n + k_cols, k_cols)
    plain = chain_setup.chain_setup_plain(cand, k_cols)
    chip_smoke.check_setup(chain_setup.launch(cand, k_cols), plain, cand,
                           k_cols, "setup", err)
    lam_star = sizing_kernel.sizing_bisection_plain(
        plain.clm, plain.clm_at_k, cand, t[:2], plain.lo0, plain.hi0)
    args = (cand, lam_star, t, plain.bounds[2], k_cols)
    chip_smoke.check_chain(chain_stats.size_tail(*args),
                           chain_stats.size_tail_plain(*args),
                           chain_stats.TAIL_KEYS, "tail", err)
    chip_smoke.check_chain(chain_stats.analyze(rate, cand, k_cols),
                           chain_stats.analyze_plain(rate, cand, k_cols),
                           ["valid", *chain_stats.ANALYZE_KEYS], "analyze",
                           err)


def test_size_batch_three_launches_analyze_batch_one(cuda):
    cand, t, rate = chip_smoke.chain_inputs(300, 31, 1024)
    before = chip_smoke.chain_launch_counts()
    got = qm.size_batch(cand, *t, k_cols=1024)
    after = chip_smoke.chain_launch_counts()
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    qm.analyze_batch(rate, cand, k_cols=1024)
    last = chip_smoke.chain_launch_counts()
    assert tuple(a - b for a, b in zip(last, after)) == (0, 0, 1)
    want = qm.size_batch(cand, *t, k_cols=1024, impl="plain")
    qm.analyze_batch(rate, cand, k_cols=1024, impl="plain")
    assert chip_smoke.chain_launch_counts() == last
    chip_smoke.check_chain(got, want, chain_stats.TAIL_KEYS, "size_batch",
                           chip_smoke.Errors())


@pytest.mark.parametrize("k_cols,wider", [(256, 2048), (512, 1024)])
def test_a_rows_bits_depend_on_the_row_alone(cuda, k_cols, wider):
    cand, t, rate = chip_smoke.chain_inputs(257, 32, k_cols)
    sized = qm.size_batch(cand, *t, k_cols=k_cols)
    analyzed = qm.analyze_batch(rate, cand, k_cols=k_cols)
    for got in (qm.size_batch(cand, *t, k_cols=wider),
                qm.analyze_batch(rate, cand, k_cols=wider)):
        want = sized if len(got) == len(sized) else analyzed
        for key in got:
            assert torch.equal(got[key], want[key]), key
    for i in (0, 100, 256):
        one = qm.CandidateBatch(*(f[i:i + 1] for f in cand))
        alone = qm.size_batch(one, *t[:, i:i + 1].contiguous(),
                              k_cols=k_cols)
        for key in alone:
            assert torch.equal(alone[key], sized[key][i:i + 1]), (i, key)
        alone = qm.analyze_batch(rate[i:i + 1], one, k_cols=k_cols)
        for key in alone:
            assert torch.equal(alone[key], analyzed[key][i:i + 1]), (i, key)


def test_analyze_walks_only_the_rows_segments(cuda):
    """k = 480 far below k_cols 2048: the kernel walks the row's 2 segments
    of 8, and gives the bits of the same rows at k_cols 512."""
    cand, _, rate = chip_smoke.chain_inputs(512, 34, 512)
    cand = cand._replace(k=torch.full_like(cand.k, 480))
    wide = qm.analyze_batch(rate, cand, k_cols=2048)
    narrow = qm.analyze_batch(rate, cand, k_cols=512)
    for key in wide:
        assert torch.equal(wide[key], narrow[key]), key
    chip_smoke.check_chain(wide, chain_stats.analyze_plain(rate, cand, 2048),
                           ["valid", *chain_stats.ANALYZE_KEYS], "analyze",
                           chip_smoke.Errors())


@pytest.mark.parametrize("k_cols", [512, 1024])
def test_a_batch_above_a_segment(cuda, k_cols):
    """B = 300: the states below B that need their own log mu span two
    segments. Each kernel against its plain version, and a row's bits the
    same alone."""
    err = chip_smoke.Errors()
    cand, t, rate = chip_smoke.chain_inputs(64, 35, k_cols)
    cand = cand._replace(max_batch=torch.full_like(cand.max_batch, 300))
    plain = chain_setup.chain_setup_plain(cand, k_cols)
    chip_smoke.check_setup(chain_setup.launch(cand, k_cols), plain, cand,
                           k_cols, "setup", err)
    lam_star = sizing_kernel.sizing_bisection_plain(
        plain.clm, plain.clm_at_k, cand, t[:2], plain.lo0, plain.hi0)
    args = (cand, lam_star, t, plain.bounds[2], k_cols)
    chip_smoke.check_chain(chain_stats.size_tail(*args),
                           chain_stats.size_tail_plain(*args),
                           chain_stats.TAIL_KEYS, "tail", err)
    analyzed = chain_stats.analyze(rate, cand, k_cols)
    chip_smoke.check_chain(analyzed,
                           chain_stats.analyze_plain(rate, cand, k_cols),
                           ["valid", *chain_stats.ANALYZE_KEYS], "analyze",
                           err)
    one = qm.CandidateBatch(*(f[5:6] for f in cand))
    alone = chain_stats.analyze(rate[5:6], one, k_cols)
    for key in alone:
        assert torch.equal(alone[key], analyzed[key][5:6]), key


def test_the_jacobian_kernel_matches_jacfwd(cuda):
    before = jacobian_kernel.launches
    errs = chip_smoke.jacobian_vs_plain()
    assert errs["max_rel_err"] <= chip_smoke.RTOL
    assert jacobian_kernel.launches - before == len(chip_smoke.JACOBIAN_EDGES)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    cand, t, rate = chip_smoke.chain_inputs(16, 33, 256)
    before = chip_smoke.chain_launch_counts()
    with pytest.raises(ValueError, match="k_cols"):
        chain_setup.launch(cand, 4096)
    with pytest.raises(ValueError, match="dtype"):
        chain_setup.launch(cand._replace(k=cand.k.float()), 256)
    with pytest.raises(ValueError, match="shape"):
        chain_stats.analyze(rate[:8], cand, 256)
    with pytest.raises(ValueError, match="contiguous"):
        chain_stats.size_tail(cand, torch.ones(16, 2, device=cuda).t(), t,
                              rate, 256)
    with pytest.raises(ValueError, match="on cpu"):
        chain_stats.analyze(rate.cpu(), cand, 256)
    x = torch.ones(3, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        jacobian_kernel.launch(x, torch.ones(4, device=cuda))
    assert chip_smoke.chain_launch_counts() == before
