"""The port's umbrella API against the JAX package's: every name of its
``__all__``, and ``sweep_epi`` (one EPI's dense sweep) against the JAX
``sweep_epi``, jitted as tests/test_sweep.py jits it, within the sweep
tolerances of tests/test_torch_sweep.py (scores and r_bar 2e-5, depths
1e-6)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
import remotesensingproject_tpu as jrs
import remotesensingproject_tpu_torch as trs
from remotesensingproject_tpu.config import DepthParams as JParams
from remotesensingproject_tpu.ops.sweep import sweep_epi as _j_sweep_epi
from remotesensingproject_tpu_torch.config import DepthParams

j_sweep_epi = jax.jit(_j_sweep_epi,
                      static_argnames=("dim_d", "params", "with_k_best"))
TOL = (2e-5, 2e-5, 1e-6, 2e-5, 2e-5)  # best_score, mean, depth, rbar, k
NAMES = ("best_score", "score_mean", "best_depth", "rbar", "k_best")


def test_all_covers_the_jax_package():
    assert set(jrs.__all__) <= set(trs.__all__)
    for name in trs.__all__:
        assert hasattr(trs, name), name
    assert trs.DTYPE == torch.float32 and trs.SQRT3 == jrs.SQRT3


def test_norms_match_the_jax_package():
    x = np.random.default_rng(1).normal(size=(4, 5, 3)).astype(np.float32)
    for c in (1, 3):
        for name in ("norm", "normsq"):
            got = getattr(trs, name)(torch.from_numpy(x[..., :c])).numpy()
            want = np.asarray(getattr(jrs, name)(jnp.asarray(x[..., :c])))
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


@functools.lru_cache(maxsize=None)
def _epi(C, S=7, U=40):
    vol, _ = oracle.make_synthetic_lf(S=S, V=1, U=U, C=C, n_objects=3,
                                      seed=C, dmin=-1.0, dmax=1.5)
    return (vol[0] / vol.max()).astype(np.float32)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("with_k", [False, True])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_sweep_epi_matches_jax(C, with_k, per_pixel):
    epi = _epi(C)
    S, U, _ = epi.shape
    if per_pixel:
        c = np.random.default_rng(5).uniform(-0.6, 1.1, U).astype(np.float32)
        lo, hi = np.clip(c - 0.4, -1.0, 1.5), np.clip(c + 0.4, -1.0, 1.5)
    else:
        lo, hi = np.full(U, -1.0, np.float32), np.full(U, 1.5, np.float32)
    got = trs.sweep_epi(torch.from_numpy(epi), torch.from_numpy(lo),
                        torch.from_numpy(hi), 9, 3, DepthParams(),
                        with_k_best=with_k)
    want = j_sweep_epi(jnp.asarray(epi), jnp.asarray(lo), jnp.asarray(hi),
                       9, 3, JParams(), with_k_best=with_k)
    shapes = ((U,), (U,), (U,), (U, C), (S, U))
    for name, g, w, tol, shape in zip(NAMES, got, want, TOL, shapes):
        assert tuple(g.shape) == shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol, err_msg=name)
    if not with_k:
        assert not got[4].any()


@pytest.mark.parametrize("window", [(0, 39), (6, 30), (-5, 47)])
def test_sweep_epi_u_valid_matches_jax(window):
    """The window of valid sample columns (the (v, u) mesh's): the port
    takes positions in the window's columns, the JAX package in the
    block's (ROADMAP Queue 3), the same within the sweep tolerances."""
    epi = _epi(1)
    got = trs.sweep_epi(torch.from_numpy(epi), -1.0, 1.5, 9, 3,
                        DepthParams(), with_k_best=True, u_valid=window)
    U = epi.shape[1]
    want = j_sweep_epi(jnp.asarray(epi), jnp.full((U,), -1.0, jnp.float32),
                       jnp.full((U,), 1.5, jnp.float32), 9, 3, JParams(),
                       with_k_best=True, u_valid=window)
    for name, g, w, tol in zip(NAMES, got, want, TOL):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol, err_msg=name)


def test_sweep_epi_is_sweep_pile_at_v_1():
    epi = torch.from_numpy(_epi(3))
    U = epi.shape[1]
    lo, hi = torch.full((1, U), -1.0), torch.full((1, U), 1.5)
    pile = trs.sweep_pile(epi[None], lo, hi, 9, 3, DepthParams(), True)
    got = trs.sweep_epi(epi, -1.0, 1.5, 9, 3, DepthParams(), True)
    for name, g in zip(NAMES, got):
        assert torch.equal(g, getattr(pile, name)[0]), name
