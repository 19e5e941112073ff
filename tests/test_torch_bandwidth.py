"""Port parity: the bandwidth kernel K(x) = max(0, 1 - ||x/h||^2) of
``ops/kernels.py`` against the JAX package's, with NaN samples (which give
0) at C = 1 (the squared norm scaled by 3) and C = 3, over the last and
over an inner channel axis.  Equal within 1e-7 (float32, one sum)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remotesensingproject_tpu.ops import kernels as jk
from remotesensingproject_tpu_torch.ops import kernels as tk


def _diff(C, axis, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(0.0, 0.15, (6, 7, C)).astype(np.float32)
    d[0, :3, 0] = np.nan
    d[2, 4, -1] = np.nan
    d[3, :2] = 0.0
    return np.moveaxis(d, -1, axis)


@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("C", [1, 3])
def test_bandwidth_kernel_matches_jax(C, axis):
    d = _diff(C, axis, C)
    got = tk.bandwidth_kernel(torch.from_numpy(d), 0.2, axis=axis).numpy()
    want = np.asarray(jk.bandwidth_kernel(jnp.asarray(d), 0.2, axis=axis))
    assert got.shape == want.shape
    assert not np.isnan(got).any()
    assert (got >= 0).all() and (got <= 1).all()
    nan_slots = np.isnan(d).any(axis=axis)
    assert nan_slots.any() and (got[nan_slots] == 0).all()
    assert (got[~nan_slots] > 0).any() and (got[3, :2] == 1).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("C", [1, 3])
def test_bandwidth_kernel_masked_matches_jax(C):
    d = _diff(C, -1, 10 + C)
    valid = ~np.isnan(d).any(axis=-1)
    finite = np.nan_to_num(d, nan=0.7)
    got = tk.bandwidth_kernel_masked(torch.from_numpy(finite),
                                     torch.from_numpy(valid), 0.2).numpy()
    want = np.asarray(jk.bandwidth_kernel_masked(
        jnp.asarray(finite), jnp.asarray(valid), 0.2))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    # equal to the NaN-masking kernel on the same samples
    np.testing.assert_array_equal(
        got, tk.bandwidth_kernel(torch.from_numpy(d), 0.2).numpy())
