"""Port parity: selective median and median blur, bitwise vs the JAX
package's XLA path and its Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remotesensingproject_tpu.ops.median import (
    median_blur as j_blur, selective_median as j_med)
from remotesensingproject_tpu.ops.median_pallas import selective_median_pallas
from remotesensingproject_tpu_torch.ops.median import (
    median_blur, selective_median)
from remotesensingproject_tpu_torch.ops.median_pallas import (
    selective_median_cuda)


def _inputs(seed, V, U, C):
    rng = np.random.default_rng(seed)
    # values on a coarse grid so that ties occur, as with swept depths
    src = (rng.integers(-8, 17, (V, U)) / 8.0).astype(np.float32)
    frame = rng.uniform(0.3, 0.6, (V, U, C)).astype(np.float32)
    mask = rng.random((V, U)) < 0.6
    return src, frame, mask


@pytest.mark.parametrize("C,size,eps", [(1, 5, 0.1), (3, 5, 0.1),
                                        (4, 5, 0.1), (1, 3, 0.05),
                                        (1, 7, 0.2)])
def test_selective_median_bitwise(C, size, eps):
    src, frame, mask = _inputs(C + size, 13, 37, C)
    want = np.asarray(j_med(jnp.asarray(src), jnp.asarray(frame),
                            jnp.asarray(mask), size, eps))
    got = selective_median(torch.from_numpy(src), torch.from_numpy(frame),
                           torch.from_numpy(mask), size, eps).numpy()
    np.testing.assert_array_equal(got, want)
    via_wrapper = selective_median_cuda(
        torch.from_numpy(src), torch.from_numpy(frame),
        torch.from_numpy(mask), size, eps).numpy()
    np.testing.assert_array_equal(via_wrapper, want)


@pytest.mark.parametrize("C", [1, 3, 4])
def test_selective_median_matches_pallas_interpret(C):
    src, frame, mask = _inputs(20 + C, 21, 40, C)
    want = np.asarray(selective_median_pallas(
        jnp.asarray(src), jnp.asarray(frame), jnp.asarray(mask), 5, 0.1,
        interpret=True))
    got = selective_median_cuda(torch.from_numpy(src), torch.from_numpy(frame),
                                torch.from_numpy(mask), 5, 0.1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [3, 5])
def test_median_blur_bitwise(size):
    img = np.random.default_rng(size).normal(size=(11, 17)).astype(np.float32)
    np.testing.assert_array_equal(
        median_blur(torch.from_numpy(img), size).numpy(),
        np.asarray(j_blur(jnp.asarray(img), size)))
