"""Port parity: pyramid ops vs the JAX package (float32 sums in the same
order, so the results agree to a few ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu.ops import pyramid as jp
from remotesensingproject_tpu_torch.ops import pyramid as tp


@pytest.mark.parametrize("shape", [(24, 6, 44, 1), (17, 4, 23, 3)])
def test_downsample_epis(shape):
    V, S, U, C = shape
    vol, _ = oracle.make_synthetic_lf(S=S, V=V, U=U, C=C, seed=V)
    want = np.asarray(jp.downsample_epis(jnp.asarray(vol)))
    got = tp.downsample_epis(torch.from_numpy(vol)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("out_shape,scales", [((7, 12), None),
                                              ((30, 50), None),
                                              ((8, 11), (2.0, 2.0))])
def test_resizes(out_shape, scales):
    img = np.random.default_rng(1).normal(size=(2, 15, 23)).astype(np.float32)
    np.testing.assert_allclose(
        tp.resize_bilinear_cv(torch.from_numpy(img), out_shape, scales).numpy(),
        np.asarray(jp.resize_bilinear_cv(jnp.asarray(img), out_shape, scales)),
        rtol=0, atol=1e-6)
    m = img > 0
    np.testing.assert_array_equal(
        tp.resize_nearest_cv(torch.from_numpy(m), out_shape).numpy(),
        np.asarray(jp.resize_nearest_cv(jnp.asarray(m), out_shape)))


@pytest.mark.parametrize("seed,up,down", [(0, (10, 22), (5, 11)),
                                          (1, (9, 21), (5, 11))])
def test_bounds_from_parent(seed, up, down):
    rng = np.random.default_rng(seed)
    S = 3
    depth = rng.uniform(-1, 1.5, (S,) + up).astype(np.float32)
    mask = rng.random((S,) + up) < 0.3
    lo = np.full((S,) + down, -1.0, np.float32)
    hi = np.full((S,) + down, 1.5, np.float32)
    want = jp.bounds_from_parent(jnp.asarray(depth), jnp.asarray(mask),
                                 jnp.asarray(lo), jnp.asarray(hi))
    got = tp.bounds_from_parent(torch.from_numpy(depth),
                                torch.from_numpy(mask), torch.from_numpy(lo),
                                torch.from_numpy(hi))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy() != lo).any()


def test_fuse_disp_maps():
    rng = np.random.default_rng(4)
    shapes = [(3, 20, 36), (3, 10, 18), (3, 5, 9)]
    disp = [rng.uniform(-1, 1.5, s).astype(np.float32) for s in shapes]
    valid = [rng.random(s) < 0.6 for s in shapes]
    valid[-1][:] = True
    fj, vj = jp.fuse_disp_maps([jnp.asarray(d) for d in disp],
                               [jnp.asarray(v) for v in valid], 3)
    ft, vt = tp.fuse_disp_maps([torch.from_numpy(d) for d in disp],
                               [torch.from_numpy(v) for v in valid], 3)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-6)
