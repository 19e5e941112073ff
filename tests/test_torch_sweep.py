"""Port parity: the plain sweep and the CUDA sweep's wrapper vs the JAX
package.  Tolerances are those of tests/test_sweep_pixel.py: best_depth
1e-6, best_score and rbar 2e-5, score_mean 5e-5 (float32 sums in another
order than XLA's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu.config import DepthParams as JParams
from remotesensingproject_tpu.ops.sweep import sweep_pile as j_sweep
from remotesensingproject_tpu.ops.sweep_pallas import (
    candidate_disparities as j_grid)
from remotesensingproject_tpu.ops.sweep_pallas_pixel import (
    sweep_pile_pallas_pixel)
from remotesensingproject_tpu_torch.config import DepthParams as TParams
from remotesensingproject_tpu_torch.ops.sweep import (
    candidate_disparities, sweep_pile)
from remotesensingproject_tpu_torch.ops.sweep_pallas_pixel import (
    sweep_pile_pixel)

TOL = {"best_score": 2e-5, "best_depth": 1e-6, "score_mean": 5e-5,
       "rbar": 2e-5}
DMIN, DMAX, DIM_D = -1.0, 1.5, 7


def _scene(seed, C, S=6, V=5, U=40):
    vol, _ = oracle.make_synthetic_lf(S=S, V=V, U=U, C=C, n_objects=3,
                                      seed=seed, dmin=DMIN, dmax=DMAX)
    return (vol / vol.max()).astype(np.float32)


def _bounds(seed, V, U, per_pixel):
    if not per_pixel:
        return (np.full((V, U), DMIN, np.float32),
                np.full((V, U), DMAX, np.float32))
    c = np.random.default_rng(seed + 10).uniform(DMIN + 0.4, DMAX - 0.4,
                                                 (V, U)).astype(np.float32)
    return np.clip(c - 0.35, DMIN, DMAX), np.clip(c + 0.35, DMIN, DMAX)


def _compare(got, want, mask=None):
    for name, atol in TOL.items():
        g = getattr(got, name)
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(getattr(want, name))
        if mask is not None:
            g, w = g[mask], w[mask]
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("seed,s_hat,C", [(0, 3, 1), (1, 0, 1), (2, 5, 3)])
def test_sweep_matches_jax(seed, s_hat, C, per_pixel):
    vol = _scene(seed, C)
    V, S, U, _ = vol.shape
    lo, hi = _bounds(seed, V, U, per_pixel)
    want = j_sweep(jnp.asarray(vol), jnp.asarray(lo), jnp.asarray(hi),
                   DIM_D, jnp.int32(s_hat), JParams())
    got = sweep_pile(torch.from_numpy(vol), torch.from_numpy(lo),
                     torch.from_numpy(hi), DIM_D, s_hat, TParams())
    _compare(got, want)


@pytest.mark.parametrize("C", [1, 3])
def test_sweep_nearest_matches_jax(C):
    vol = _scene(5, C)
    V, S, U, _ = vol.shape
    lo, hi = _bounds(5, V, U, True)
    want = j_sweep(jnp.asarray(vol), jnp.asarray(lo), jnp.asarray(hi),
                   DIM_D, jnp.int32(2), JParams(interpolation="nearest"))
    got = sweep_pile(torch.from_numpy(vol), torch.from_numpy(lo),
                     torch.from_numpy(hi), DIM_D, 2,
                     TParams(interpolation="nearest"))
    _compare(got, want)


@pytest.mark.parametrize("S,s_hat,interp,per_pixel", [
    (100, 50, "linear", False), (100, 50, "nearest", True),
    (101, 37, "linear", True)])
def test_sweep_full_depth_c3_matches_jax(S, s_hat, interp, per_pixel):
    """C = 3 at the RGB scene's depth (S = 100, s_hat = 50) and at an odd
    one, at a small V x U and D: runs the borders cut and whole ones."""
    vol = _scene(11, 3, S=S, V=2, U=32)
    V, _, U, _ = vol.shape
    lo, hi = _bounds(11, V, U, per_pixel)
    p = dict(interpolation=interp, slope_factor=0.25)
    want = j_sweep(jnp.asarray(vol), jnp.asarray(lo), jnp.asarray(hi),
                   DIM_D, jnp.int32(s_hat), JParams(**p))
    got = sweep_pile(torch.from_numpy(vol), torch.from_numpy(lo),
                     torch.from_numpy(hi), DIM_D, s_hat, TParams(**p))
    _compare(got, want)


def test_sweep_k_best_matches_jax():
    vol = _scene(4, 1)
    V, S, U, _ = vol.shape
    lo, hi = _bounds(4, V, U, False)
    want = j_sweep(jnp.asarray(vol), jnp.asarray(lo), jnp.asarray(hi),
                   DIM_D, jnp.int32(2), JParams(), with_k_best=True)
    got = sweep_pile(torch.from_numpy(vol), torch.from_numpy(lo),
                     torch.from_numpy(hi), DIM_D, 2, TParams(),
                     with_k_best=True)
    np.testing.assert_allclose(got.k_best.numpy(), np.asarray(want.k_best),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("per_pixel,C", [(False, 1), (True, 1), (True, 3)])
def test_wrapper_matches_pallas_pixel_interpret(per_pixel, C):
    """The CUDA kernel's wrapper (plain version on the CPU) against the
    TPU kernel in interpret mode, at the active pixels."""
    vol = _scene(7, C)
    V, S, U, _ = vol.shape
    lo, hi = _bounds(7, V, U, per_pixel)
    active = np.random.default_rng(8).random((V, U)) < 0.5
    kw = {}
    if per_pixel:
        kw = dict(dmin_v_u=jnp.asarray(lo), dmax_v_u=jnp.asarray(hi))
    want = sweep_pile_pallas_pixel(jnp.asarray(vol), DMIN, DMAX, DIM_D,
                                   jnp.int32(3), JParams(),
                                   active_v_u=jnp.asarray(active),
                                   interpret=True, **kw)
    tkw = {}
    if per_pixel:
        tkw = dict(dmin_v_u=torch.from_numpy(lo), dmax_v_u=torch.from_numpy(hi))
    got = sweep_pile_pixel(torch.from_numpy(vol), DMIN, DMAX, DIM_D, 3,
                           TParams(), torch.from_numpy(active), **tkw)
    _compare(got, want, mask=active)


def test_wrapper_on_cpu_is_the_plain_version():
    vol = _scene(3, 1)
    V, S, U, _ = vol.shape
    lo, hi = _bounds(3, V, U, False)
    act = torch.ones((V, U), dtype=torch.bool)
    got = sweep_pile_pixel(torch.from_numpy(vol), DMIN, DMAX, DIM_D, 2,
                           TParams(), act)
    want = sweep_pile(torch.from_numpy(vol), torch.from_numpy(lo),
                      torch.from_numpy(hi), DIM_D, 2, TParams())
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dmin,dmax,D", [(-1.0, 4.0, 120), (-1.0, 1.5, 7),
                                         (0.0, 4.0, 33)])
def test_candidate_grid_matches_jax(dmin, dmax, D):
    np.testing.assert_array_equal(candidate_disparities(dmin, dmax, D),
                                  j_grid(dmin, dmax, D))
    # the plain sweep's uniform grid is that grid, bit for bit
    lo = torch.full((1, 1), np.float32(dmin))
    hi = torch.full((1, 1), np.float32(dmax))
    den = torch.full_like(lo, float(D - 1))
    grid = torch.cat([lo + ((hi - lo) * float(d)) / den for d in range(D)])
    np.testing.assert_array_equal(grid[:, 0].numpy(),
                                  candidate_disparities(dmin, dmax, D))
