"""Port parity: fast mode (``DepthParams.fast``), which caps the mean shift
at 5 steps in the pixel sweep under linear interpolation, as the JAX
package's pixel kernel does, and nowhere else.

* The pixel route on the CPU against the JAX pixel kernel in interpret
  mode, both with ``fast=True`` (the JAX XLA path ignores the flag, so it
  is no reference here), within the tolerances of tests/test_sweep_pixel.py.
* The C = 4 routes (row sweep at uniform levels, tile sweep at
  bounds-edited ones) and nearest interpolation are not capped: the same
  result with and without ``fast``.
* A small ``Depth2DComputer`` in fast mode against the JAX package's Pallas
  route in interpret mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu.config import DepthParams as JParams
from remotesensingproject_tpu.models.depth2d import (
    Depth2DComputer as JDepth2D)
from remotesensingproject_tpu.ops.sweep_pallas_pixel import (
    sweep_pile_pallas_pixel)
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.models import depth2d as td
from remotesensingproject_tpu_torch.ops.sweep_pallas_pixel import (
    FAST_MAX_ITER, mean_shift_iters, sweep_pile_pixel)
from test_torch_depth2d import _edited_bounds
from test_torch_sweep_rows import _scene

FAST = DepthParams(fast=True)


def test_fast_caps_only_the_linear_pixel_sweep():
    assert mean_shift_iters(FAST) == FAST_MAX_ITER == 5
    assert mean_shift_iters(DepthParams()) == 10
    assert mean_shift_iters(DepthParams(fast=True, mean_shift_max_iter=3)) == 3
    assert mean_shift_iters(DepthParams(fast=True,
                                        interpolation="nearest")) == 10


@pytest.mark.parametrize("C,per_pixel", [(1, True), (3, False)])
def test_pixel_route_fast_matches_jax_pixel_kernel(C, per_pixel):
    vol, _ = oracle.make_synthetic_lf(S=6, V=5, U=40, C=C, n_objects=3,
                                      seed=C, dmin=-1.0, dmax=1.5)
    vol = vol / vol.max()
    V, S, U, _ = vol.shape
    rng = np.random.default_rng(C + per_pixel)
    active = rng.random((V, U)) < 0.5
    kw, tkw = {}, {}
    if per_pixel:
        lo, hi = (b[0].copy() for b in _edited_bounds(1, V, U, seed=C))
        kw = dict(dmin_v_u=jnp.asarray(lo), dmax_v_u=jnp.asarray(hi))
        tkw = dict(dmin_v_u=torch.from_numpy(lo),
                   dmax_v_u=torch.from_numpy(hi))
    want = sweep_pile_pallas_pixel(jnp.asarray(vol), -1.0, 1.5, 7,
                                   jnp.int32(3), JParams(fast=True),
                                   active_v_u=jnp.asarray(active),
                                   interpret=True, **kw)
    got = sweep_pile_pixel(torch.from_numpy(vol), -1.0, 1.5, 7, 3, FAST,
                           torch.from_numpy(active), **tkw)
    for name, atol in (("best_score", 2e-5), ("best_depth", 1e-6),
                       ("score_mean", 5e-5), ("rbar", 2e-5)):
        np.testing.assert_allclose(getattr(got, name).numpy()[active],
                                   np.asarray(getattr(want, name))[active],
                                   rtol=0, atol=atol, err_msg=name)
    full = sweep_pile_pixel(torch.from_numpy(vol), -1.0, 1.5, 7, 3,
                            DepthParams(), torch.from_numpy(active), **tkw)
    # the cap took effect: the 10-step mean shift ends elsewhere
    assert not torch.equal(full.rbar, got.rbar)


@pytest.mark.parametrize("edited,interp", [(False, "linear"),
                                           (True, "linear"),
                                           (True, "nearest")])
def test_four_band_routes_ignore_fast(edited, interp):
    S, V, U = 6, 4, 40
    vol = _scene(4, V=V, S=S, U=U, seed=3)
    lo, hi = _edited_bounds(S, V, U, seed=3)
    states = []
    for fast in (False, True):
        t = td.Depth2DComputer(vol, -1.0, 1.5, 9, device="cpu",
                               params=DepthParams(fast=fast,
                                                  interpolation=interp))
        if edited:
            t.set_bounds(torch.from_numpy(lo), torch.from_numpy(hi))
        states.append(t.run())
    for f in dataclasses.fields(states[0]):
        assert torch.equal(getattr(states[0], f.name),
                           getattr(states[1], f.name)), f.name


def test_depth2d_fast_matches_jax_pixel_kernel():
    vol, _ = oracle.make_synthetic_lf(S=6, V=8, U=48, C=1, n_objects=3,
                                      seed=2, dmin=-1.0, dmax=1.5)
    j = JDepth2D(jnp.asarray(vol), -1.0, 1.5, 7, params=JParams(fast=True),
                 use_pallas=True)
    j.run()
    t = td.Depth2DComputer(vol, -1.0, 1.5, 7, params=FAST, device="cpu")
    t.run()
    np.testing.assert_array_equal(t.state.claim.numpy(),
                                  np.asarray(j.state.claim))
    for name, atol in (("best_depth", 1e-6), ("disp_conf", 2e-3)):
        np.testing.assert_allclose(getattr(t.state, name).numpy(),
                                   np.asarray(getattr(j.state, name)),
                                   rtol=0, atol=atol, err_msg=name)
    np.testing.assert_array_equal(
        t.get_valid_depths_mask_s_v_u().numpy(),
        np.asarray(j.get_valid_depths_mask_s_v_u()))
