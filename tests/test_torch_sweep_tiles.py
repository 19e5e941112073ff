"""Port parity: the per-pixel-bounds tile sweep (kernel of
``csrc/sweep_tiles.cu``) in its plain version against the JAX package's
Pallas kernel in interpret mode, at the inputs of
tests/test_sweep_pallas_pp.py, in the pixel and the masked tile mode.
Tolerances are the JAX tests' own: scores, means, r_bar and k_best within
2e-5, depths exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu.config import DepthParams as JParams
from remotesensingproject_tpu.ops.sweep_pallas_perpixel import (
    sweep_pile_pallas_perpixel)
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.ops.sweep_pallas import activity_mask
from remotesensingproject_tpu_torch.ops.sweep_pallas_perpixel import (
    sweep_pile_tiles, tile_quantized_bounds)
from test_torch_sweep_rows import _compare, _scene

GMIN, GMAX = -1.0, 1.5


def _bounds(V, U, seed=0):
    rng = np.random.default_rng(seed)
    dmin = rng.uniform(GMIN, 0.0, (V, U)).astype(np.float32)
    dmax = rng.uniform(0.1, GMAX, (V, U)).astype(np.float32)
    wide = rng.uniform(size=(V, U)) < 0.2
    dmin[wide] = GMIN
    dmax[wide] = GMAX
    return dmin, dmax


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("C", [1, 3, 4])
@pytest.mark.parametrize("s_hat", [3, 0])
def test_tiles_pixel_mode_matches_pallas_interpret(C, s_hat):
    vol = _scene(C, seed=11)
    V, S, U, _ = vol.shape
    dmin, dmax = _bounds(V, U)
    params = dict(slope_factor=0.5)
    want = sweep_pile_pallas_perpixel(
        jnp.asarray(vol), jnp.asarray(dmin), jnp.asarray(dmax), (GMIN, GMAX),
        7, jnp.int32(s_hat), JParams(**params), with_k_best=True,
        interpret=True)
    got = sweep_pile_tiles(*_t(vol, dmin, dmax), 7, s_hat,
                           DepthParams(**params), with_k_best=True)
    _compare(got, want, with_k=True)


def test_tiles_large_offsets():
    vol = np.random.default_rng(2).uniform(0.2, 1.0, (2, 9, 30, 1)) \
        .astype(np.float32)
    rng = np.random.default_rng(3)
    dmin = rng.uniform(-3.0, 0.0, (2, 30)).astype(np.float32)
    dmax = rng.uniform(0.5, 4.0, (2, 30)).astype(np.float32)
    want = sweep_pile_pallas_perpixel(
        jnp.asarray(vol), jnp.asarray(dmin), jnp.asarray(dmax), (-3.0, 4.0),
        9, jnp.int32(4), JParams(), interpret=True)
    got = sweep_pile_tiles(*_t(vol, dmin, dmax), 9, 4, DepthParams())
    _compare(got, want)


def test_tiles_tile_flags():
    V, S, U = 2, 5, 160
    vol = np.random.default_rng(4).uniform(0.2, 1.0, (V, S, U, 1)) \
        .astype(np.float32)
    dmin, dmax = _bounds(V, U, seed=5)
    flags = np.array([[1, 0], [0, 1]], np.int32)
    want = sweep_pile_pallas_perpixel(
        jnp.asarray(vol), jnp.asarray(dmin), jnp.asarray(dmax), (GMIN, GMAX),
        5, jnp.int32(2), JParams(), interpret=True,
        tile_active=jnp.asarray(flags))
    got = sweep_pile_tiles(*_t(vol, dmin, dmax), 5, 2, DepthParams(),
                           tile_active=torch.from_numpy(flags))
    _compare(got, want, mask=activity_mask(V, U, torch.from_numpy(flags))
             .numpy())


@pytest.mark.parametrize("C", [1, 4])
def test_tiles_masked_tile_mode_matches_pallas_interpret(C):
    """test_perpixel_kernel_masked_tile_quantized's setup: per-tile grid
    bounds from the active pixels' ranges, each pixel's own range kept
    by masking."""
    V, S, U = 2, 6, 150
    vol = _scene(C, V=V, S=S, U=U, seed=5)
    rng = np.random.default_rng(0)
    c = rng.uniform(GMIN + 0.4, GMAX - 0.4, (V, U)).astype(np.float32)
    pdmin = np.clip(c - 0.3, GMIN, GMAX).astype(np.float32)
    pdmax = np.clip(c + 0.3, GMIN, GMAX).astype(np.float32)
    active = rng.random((V, U)) < 0.8
    active[1, 128:] = False  # a tile without active pixels
    qmin, qmax = tile_quantized_bounds(torch.from_numpy(active),
                                       *_t(pdmin, pdmax), (GMIN, GMAX))
    for j in range(2):
        sl = slice(j * 128, min(U, (j + 1) * 128))
        for v in range(V):
            a = active[v, sl]
            want_lo = pdmin[v, sl][a].min() if a.any() else np.float32(GMIN)
            want_hi = pdmax[v, sl][a].max() if a.any() else np.float32(GMAX)
            assert (qmin[v, sl].numpy() == want_lo).all()
            assert (qmax[v, sl].numpy() == want_hi).all()

    params = dict(slope_factor=0.5)
    want = sweep_pile_pallas_perpixel(
        jnp.asarray(vol), jnp.asarray(qmin.numpy()),
        jnp.asarray(qmax.numpy()), (GMIN, GMAX), 9, jnp.int32(3),
        JParams(**params), with_k_best=True, interpret=True,
        pdmin_v_u=jnp.asarray(pdmin), pdmax_v_u=jnp.asarray(pdmax))
    got = sweep_pile_tiles(torch.from_numpy(vol), qmin, qmax, 9, 3,
                           DepthParams(**params), with_k_best=True,
                           pdmin_v_u=torch.from_numpy(pdmin),
                           pdmax_v_u=torch.from_numpy(pdmax))
    _compare(got, want, with_k=True)
    # and against the oracle over the tile grid, at the test's pixels
    f32 = np.float32
    qmin_n, qmax_n = qmin.numpy(), qmax.numpy()
    if C == 1:
        for v in range(V):
            for u in range(0, U, 13):
                scores = oracle.sweep_pixel(vol[v], u, qmin_n[v, u],
                                            qmax_n[v, u], 9, 3,
                                            slope_factor=0.5)[0]
                grid = np.array([f32(f32(qmin_n[v, u]) + f32(
                    f32(f32(d) * f32(f32(qmax_n[v, u]) - f32(qmin_n[v, u])))
                    / f32(8))) for d in range(9)], np.float32)
                tol = f32(f32(qmax_n[v, u] - qmin_n[v, u]) / f32(8))
                allowed = (grid >= pdmin[v, u] - tol) & \
                    (grid <= pdmax[v, u] + tol)
                best = int(np.argmax(np.where(allowed, scores, -np.inf)))
                assert abs(got.best_depth[v, u] - grid[best]) < 1e-6
                assert abs(got.score_mean[v, u]
                           - scores[allowed].mean()) < 3e-5
