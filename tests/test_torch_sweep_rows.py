"""Port parity: the dense row sweep (kernel of ``csrc/sweep_rows.cu``) in
its plain version against the JAX package's Pallas kernel in interpret
mode, at the inputs of tests/test_sweep_pallas.py.  Tolerances are the JAX
tests' own: scores, means, r_bar and k_best within 2e-5 (float32 sums in
another order), depths exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu.config import DepthParams as JParams
from remotesensingproject_tpu.ops.sweep_pallas import sweep_pile_pallas
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.ops.sweep import sweep_pile
from remotesensingproject_tpu_torch.ops.sweep_pallas import (
    activity_mask, candidate_grid, sweep_pile_rows, sweep_rows_plain)

ATOL = 2e-5


def _compare(got, want, with_k=False, mask=None):
    names = ["best_score", "score_mean", "rbar"] + (["k_best"] if with_k
                                                    else [])
    for name in names + ["best_depth"]:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        if name == "k_best":
            g, w = np.moveaxis(g, 1, 2), np.moveaxis(w, 1, 2)
        if mask is not None:
            g, w = g[mask], w[mask]
        if name == "best_depth":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)


def _scene(C, V=3, S=6, U=40, seed=7):
    vol, _ = oracle.make_synthetic_lf(S=S, V=V, U=U, C=1, n_objects=3,
                                      seed=seed, dmin=-1.0, dmax=1.5)
    base = vol[..., 0]
    if C == 3:
        vol = np.stack([base, 0.5 * base + 0.1, 1.0 - 0.5 * base], -1)
    elif C == 4:
        vol = np.stack([base, 0.5 * base + 0.1, 1.0 - 0.5 * base,
                        0.8 * base * base + 0.05], -1)
    return vol.astype(np.float32)


@pytest.mark.parametrize("C", [1, 3, 4])
@pytest.mark.parametrize("s_hat", [3, 0])
def test_rows_plain_matches_pallas_interpret(C, s_hat):
    vol = _scene(C)
    want = sweep_pile_pallas(jnp.asarray(vol), -1.0, 1.5, 7,
                             jnp.int32(s_hat), JParams(), with_k_best=True,
                             interpret=True)
    got = sweep_pile_rows(torch.from_numpy(vol), -1.0, 1.5, 7, s_hat,
                          DepthParams(), with_k_best=True)
    _compare(got, want, with_k=True)


def test_rows_large_offsets():
    """Lines leave the image: the validity interval and card_R."""
    vol = np.random.default_rng(0).uniform(0.2, 1.0, (2, 9, 30, 1)) \
        .astype(np.float32)
    want = sweep_pile_pallas(jnp.asarray(vol), -3.0, 4.0, 9, jnp.int32(4),
                             JParams(), interpret=True)
    got = sweep_pile_rows(torch.from_numpy(vol), -3.0, 4.0, 9, 4,
                          DepthParams())
    _compare(got, want)


def test_rows_chunk_flags():
    """Per-128-lane-chunk activity: active chunks equal the dense sweep."""
    V, S, U = 2, 5, 160
    vol = np.random.default_rng(1).uniform(0.2, 1.0, (V, S, U, 1)) \
        .astype(np.float32)
    flags = np.array([[1, 0], [0, 1]], np.int32)
    want = sweep_pile_pallas(jnp.asarray(vol), -1.0, 1.0, 5, jnp.int32(2),
                             JParams(), interpret=True,
                             row_active=jnp.asarray(flags))
    got = sweep_pile_rows(torch.from_numpy(vol), -1.0, 1.0, 5, 2,
                          DepthParams(), row_active=torch.from_numpy(flags))
    mask = activity_mask(V, U, torch.from_numpy(flags)).numpy()
    assert mask[0, :128].all() and not mask[0, 128:].any()
    assert mask[1, 128:].all() and not mask[1, :128].any()
    _compare(got, want, mask=mask)


def test_rows_rule_agrees_with_per_pixel_rounding_within_last_ulps():
    """The shared-shift rule against the per-pixel plain sweep of
    ops/sweep.py: the two roundings differ in the last ulp of the
    interpolation weight only."""
    vol = _scene(1, seed=3)
    V, S, U, _ = vol.shape
    t = torch.from_numpy(vol)
    rows = sweep_rows_plain(t, candidate_grid(-1.0, 1.5, 7, "cpu"), 3,
                            DepthParams(), with_k_best=True)
    pix = sweep_pile(t, torch.full((V, U), -1.0), torch.full((V, U), 1.5), 7,
                     3, DepthParams(), with_k_best=True)
    _compare(rows, pix, with_k=True)


@pytest.mark.parametrize("dmin,dmax,D", [(-1.0, 4.0, 120), (-0.5, 1.0, 1030)])
def test_candidate_grid_is_the_jax_device_expression(dmin, dmax, D):
    rng_ = np.float32(np.float32(dmax) - np.float32(dmin))
    num = np.arange(D, dtype=np.float32) * rng_
    want = np.float32(dmin) + num / np.float32(D - 1)
    np.testing.assert_array_equal(candidate_grid(dmin, dmax, D, "cpu")
                                  .numpy(), want)
