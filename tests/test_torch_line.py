"""Port parity: line mode (``score_version="line"``) against the JAX package.

* ``_line_confidence`` alone against the JAX one, within 1e-5 (the bound
  tests/test_variants.py puts between the JAX package's own routes; the
  port sums over s in one reduction, the JAX package in a scan): lines that
  leave the image on both sides, at integer positions (t = 0) and between
  columns.
* A whole ``Depth2DComputer`` run against the JAX package's Pallas route in
  interpret mode, whose pixel kernel exports k_best (its
  ``with_k_best``), at the size of tests/test_variants.py:289: claims
  equal, line_conf within 1e-5, depths within 1e-6; and the validity
  getter's line branch.

One pass from a carried state in line mode is a case of
tests/test_torch_depth2d.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu.config import DepthParams as JParams
from remotesensingproject_tpu.models import depth2d as jd
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.models import depth2d as td


def _line_inputs(seed, depths, S=9, V=6, U=40):
    rng = np.random.default_rng(seed)
    ce = rng.uniform(0.0, 1.0, (S, V, U)).astype(np.float32)
    if depths == "integer":
        # (s_hat - s) * d + u on a column: t = 0, up to 16 columns away
        depth = rng.integers(-4, 5, (V, U)).astype(np.float32)
    else:
        depth = rng.uniform(-4.0, 4.0, (V, U)).astype(np.float32)
    k = rng.uniform(0.0, 1.0, (V, S, U)).astype(np.float32)
    k[rng.uniform(size=k.shape) < 0.3] = 0.0
    k[:, 0] = np.maximum(k[:, 0], 0.1)       # every sum over s is > 0
    mask = rng.uniform(size=(V, U)) < 0.7
    return ce, depth, k, mask


@pytest.mark.parametrize("s_hat", [4, 0, 8])
@pytest.mark.parametrize("depths", ["integer", "between"])
def test_line_confidence_matches_jax(depths, s_hat):
    ce, depth, k, mask = _line_inputs(s_hat + 10 * (depths == "integer"),
                                      depths)
    S, V, U = ce.shape
    want = np.asarray(jd._line_confidence(
        jnp.asarray(ce), jnp.asarray(depth), jnp.asarray(k),
        jnp.asarray(mask), jnp.int32(s_hat), (-4.0, 4.0)))
    got = td._line_confidence(torch.from_numpy(ce), torch.from_numpy(depth),
                              torch.from_numpy(k), torch.from_numpy(mask),
                              s_hat).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[~mask].any()
    # lines left the image on both sides, so some samples did not count
    ds = s_hat - np.arange(S)[:, None, None]
    idx = ds * depth + np.arange(U)
    assert (idx < 0).any() and (idx > U - 1).any()


def test_depth2d_line_mode_matches_jax_pixel_kernel():
    vol, _ = oracle.make_synthetic_lf(S=6, V=8, U=48, C=1, n_objects=3,
                                      seed=2, dmin=-1.0, dmax=1.5)
    jparams = JParams(score_version="line")
    j = jd.Depth2DComputer(jnp.asarray(vol), -1.0, 1.5, 7, params=jparams,
                           use_pallas=True)
    j.run()
    t = td.Depth2DComputer(vol, -1.0, 1.5, 7,
                           params=DepthParams(score_version="line"),
                           device="cpu")
    t.run()
    assert tuple(t.state.line_conf.shape) == (6, 8, 48)
    np.testing.assert_array_equal(t.state.claim.numpy(),
                                  np.asarray(j.state.claim))
    np.testing.assert_allclose(t.state.line_conf.numpy(),
                               np.asarray(j.state.line_conf), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(t.state.best_depth.numpy(),
                               np.asarray(j.state.best_depth), rtol=0,
                               atol=1e-6)
    assert float(t.state.line_conf.max()) > 0.02   # some pixels are sources
    valid = t.get_valid_depths_mask_s_v_u()
    np.testing.assert_array_equal(valid.numpy(),
                                  np.asarray(j.get_valid_depths_mask_s_v_u()))
    np.testing.assert_array_equal(valid.numpy(),
                                  t.state.line_conf.numpy() > 0.02)


def test_line_conf_is_a_dummy_outside_line_mode():
    vol, _ = oracle.make_synthetic_lf(S=4, V=4, U=24, C=1, seed=1)
    t = td.Depth2DComputer(vol, -1.0, 1.5, 5, device="cpu")
    assert tuple(t.initial_state().line_conf.shape) == (1, 1, 1)
