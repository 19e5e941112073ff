"""Port parity: ``ops/fft.py`` ``fft_htranslate`` against the JAX
package's (within 1e-5: both normalized, signed frequencies; the JAX
phases are float32, the port's float64), and the shift theorem's
properties that tests/test_utils.py holds there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remotesensingproject_tpu.ops.fft import fft_htranslate as j_translate
from remotesensingproject_tpu_torch.ops.fft import fft_htranslate


@pytest.mark.parametrize("shift", [2.0, 0.4, -1.7, 0.0])
@pytest.mark.parametrize("n", [32, 33])
def test_matches_jax(shift, n):
    x = np.random.default_rng(n).random((3, n)).astype(np.float32)
    got = fft_htranslate(torch.from_numpy(x), shift)
    assert got.dtype == torch.float32 and got.shape == (3, n)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_translate(jnp.asarray(x), shift)),
                               rtol=0, atol=1e-5)


def test_integer_shift_rolls_and_fraction_round_trips():
    """On band-limited rows, as tests/test_utils.py holds the JAX one."""
    n = 64
    u = 2 * np.pi * np.arange(n) / n
    x = (np.sin(3 * u) + 0.5 * np.cos(7 * u)).astype(np.float32)[None]
    t = torch.from_numpy(x)
    np.testing.assert_allclose(fft_htranslate(t, 2.0).numpy(),
                               np.roll(x, 2, axis=-1), atol=1e-4)
    back = fft_htranslate(fft_htranslate(t, 0.4), -0.4)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-4)
    const = torch.full((1, 16), 0.25)
    np.testing.assert_allclose(fft_htranslate(const, 0.3).numpy(), 0.25,
                               atol=1e-6)
