"""tpuhuff_torch histogram (plain version, CPU) against the JAX Pallas
histogram in interpret mode and numpy, at sizes that are not multiples of
the Pallas kernel's 128 KiB cell."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuhuff.kernels.pallas_histogram import CELL_BYTES, histogram_pallas

from tpuhuff_torch.kernels import histogram


@pytest.mark.parametrize("n", [1, 1000, CELL_BYTES + 7, 2 * CELL_BYTES + 40001])
def test_histogram_matches_pallas_and_numpy(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, n, dtype=np.uint8)
    data[: n // 2] = 101  # skewed, like text
    got = histogram(torch.from_numpy(data))
    assert got.dtype == torch.int64 and got.shape == (256,)
    want = np.bincount(data, minlength=256)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(),
                          np.asarray(histogram_pallas(jnp.asarray(data),
                                                      interpret=True)))


def test_histogram_empty_and_shapes():
    assert not histogram(torch.zeros(0, dtype=torch.uint8)).any()
    two_d = torch.arange(512, dtype=torch.int64).remainder(256).to(torch.uint8)
    assert torch.equal(histogram(two_d.reshape(8, 64)),
                       torch.full((256,), 2, dtype=torch.int64))
    with pytest.raises(TypeError):
        histogram(torch.zeros(4, dtype=torch.int32))
