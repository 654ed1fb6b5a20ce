"""The CUDA forecaster-fit kernel against its plain version, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit and skip without one.
On a machine with the card (where jax may be absent, hence no conftest):

    python -m pytest --noconftest tests/test_torch_fit_kernel.py -q

Tolerance: rtol 2e-3 with an absolute floor of 1e-4 x (1 + the row's
largest forecast), since forecasts are clamped at 0 and the linear fit's
slope is a difference of large sums. ``seasonal_naive`` (a pick) and every
persistence fallback (a copy) must match bitwise.
"""

import numpy as np
import pytest
import torch

from wva_tpu_torch.forecast import fit_kernel
from wva_tpu_torch.forecast import forecasters as fc

pytestmark = pytest.mark.cuda

RTOL = 2e-3
ATOL_SCALE = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def fit_inputs(m, seed, device):
    """Seeded inputs over the full ranges: values 0-10, valid counts 0-160,
    horizons 0-20 (fine) and 0-5 (long) steps, seasons 1-160."""
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(0, 10, (m, fc.N_GRID)).astype(np.float32),
              rng.integers(0, fc.N_GRID + 1, m).astype(np.float32),
              rng.uniform(0, 10, (m, fc.N_GRID)).astype(np.float32),
              rng.integers(0, fc.N_GRID + 1, m).astype(np.float32),
              rng.uniform(0, 20, m).astype(np.float32),
              rng.uniform(0, 5, m).astype(np.float32),
              rng.integers(1, fc.N_GRID + 1, m).astype(np.int32))
    return [torch.from_numpy(a).to(device) for a in arrays]


def assert_close(got, want, inputs):
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    scale = 1.0 + want.abs().amax(dim=0)
    bad = (got - want).abs() > RTOL * want.abs() + ATOL_SCALE * scale
    assert not bool(bad.any()), int(bad.sum())
    sn = fc.FORECASTERS.index("seasonal_naive")
    assert torch.equal(got[sn], want[sn])
    short_fine = inputs[1] < fc.MIN_VALID
    short_long = inputs[3] < fc.MIN_VALID
    assert torch.equal(got[:2, short_fine], want[:2, short_fine])
    assert torch.equal(got[2:, short_long], want[2:, short_long])


@pytest.mark.parametrize("m", [1, 7, 1024, 4096])
def test_kernel_matches_plain(cuda, m):
    inputs = fit_inputs(m, m, cuda)
    before = fit_kernel.launches
    got = fc.fit_grid(*inputs, m=m)
    assert fit_kernel.launches == before + 1
    want = fc.fit_grid_plain(*inputs, m=m)
    assert_close(got, want, inputs)


def test_padding_is_bitwise_neutral(cuda):
    inputs = fit_inputs(1024, 5, cuda)
    full = fc.fit_grid(*inputs, m=1024)
    for r in (0, 511, 1023):
        one = fc.fit_grid(*(t[r:r + 1].contiguous() for t in inputs), m=1)
        assert torch.equal(one[:, 0], full[:, r])


def test_row_order_is_bitwise_neutral(cuda):
    inputs = fit_inputs(1024, 6, cuda)
    full = fc.fit_grid(*inputs, m=1024)
    perm = torch.randperm(1024, generator=torch.Generator().manual_seed(3))
    perm = perm.to(cuda)
    permuted = fc.fit_grid(*(t[perm].contiguous() for t in inputs), m=1024)
    assert torch.equal(permuted, full[:, perm])


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    inputs = fit_inputs(8, 7, cuda)
    out = torch.empty((4, 8), device=cuda)
    narrow = [inputs[0][:, :128].contiguous(), *inputs[1:]]
    with pytest.raises(ValueError, match="160"):
        fit_kernel.launch(*narrow, out)
    with pytest.raises(ValueError, match="dtype"):
        fit_kernel.launch(*inputs[:6], inputs[6].float(), out)
    with pytest.raises(ValueError, match="shape"):
        fit_kernel.launch(*inputs, torch.empty((4, 9), device=cuda))
