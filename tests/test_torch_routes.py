"""Port parity: the routes of the pass sweep (pixel, row and tile kernels)
on the CPU, where each route runs its own plain version.

* A four-band scene through FineToCoarse: the row kernel at level 0 and
  the tile kernel in its masked tile mode at levels 1-2, against the JAX
  package's Pallas route in interpret mode (claims exact, per-level depths
  within 1e-6, fused map within 1e-6).  dim_d - 1 is a power of two
  there: the tile mode's allowed range is widened by
  tol = (dmax - dmin) / (dim_d - 1), which the TPU compiles as a division
  (and the port computes so), while interpret mode multiplies by the
  reciprocal, one ulp apart for other dim_d, which moves candidates on the
  border of a pixel's range in or out.
* dim_d > 1024 at a uniform level: the row kernel, at the scene of
  tests/test_variants.py:262 and its limits but one.  Claims are equal and
  every depth is within one grid step of the XLA path.  At D = 1030 the
  step (0.0015) sits inside the last-ulp score jitter between the port's
  sequential sums over s (the CUDA kernel's order) and XLA's, so some
  exact-tie argmax picks flip to the neighbouring candidate: 15 of 384
  here (3.9%; the JAX row kernel flips 1.6% against XLA on this scene, its
  test's bound is 2%), bounded at 5%.
* Which wrapper each (C, dim_d, bounds, coarse_mode) reaches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu.config import PyramidParams as JPyr
from remotesensingproject_tpu.models.depth2d import (
    Depth2DComputer as JDepth2D)
from remotesensingproject_tpu.models.fine_to_coarse import (
    FineToCoarse as JFTC)
from remotesensingproject_tpu_torch.config import DepthParams, PyramidParams
from remotesensingproject_tpu_torch.models import depth2d as td
from remotesensingproject_tpu_torch.models.fine_to_coarse import FineToCoarse
from test_torch_sweep_rows import _scene


def test_four_band_fine_to_coarse_matches_jax_pallas_route():
    vol = _scene(4, V=48, S=6, U=96, seed=9)
    j = JFTC(jnp.asarray(vol), -1.0, 1.5, 9, pyramid=JPyr(), use_pallas=True)
    j.run()
    fj, vj = j.get_results()
    t = FineToCoarse(vol, -1.0, 1.5, 9, pyramid=PyramidParams(),
                     device="cpu")
    t.run()
    ft, vt = t.get_results()
    assert len(t.computers) == len(j.computers) == 3
    for cj, ct in zip(j.computers, t.computers):
        np.testing.assert_array_equal(ct.state.claim.numpy(),
                                      np.asarray(cj.state.claim))
        np.testing.assert_allclose(ct.get_depths_s_v_u().numpy(),
                                   np.asarray(cj.get_depths_s_v_u()),
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-6)
    assert np.isfinite(ft.numpy()).all()


def test_dim_d_over_1024_routes_to_the_row_kernel():
    vol, _ = oracle.make_synthetic_lf(S=3, V=4, U=32, C=1, n_objects=2,
                                      seed=4, dmin=-0.5, dmax=1.0)
    a = td.Depth2DComputer(vol, -0.5, 1.0, 1030, device="cpu").run()
    b = JDepth2D(jnp.asarray(vol), -0.5, 1.0, 1030, use_pallas=False,
                 early_stop=False).run()
    assert (a.claim.numpy() == np.asarray(b.claim)).all()
    ad, bd = a.best_depth.numpy(), np.asarray(b.best_depth)
    step = 1.5 / 1029
    assert (ad != bd).mean() <= 0.05, (ad != bd).mean()
    assert (np.abs(ad - bd) <= step * 1.001).all()


@pytest.mark.parametrize("C,D,edited,mode,route", [
    (1, 9, False, "tile", "pixel"), (3, 9, True, "tile", "pixel"),
    (1, 1030, False, "tile", "rows"), (1, 1030, True, "tile", "tiles-masked"),
    (4, 9, False, "tile", "rows"), (4, 9, True, "tile", "tiles-masked"),
    (4, 9, True, "pixel", "tiles")])
def test_route(monkeypatch, C, D, edited, mode, route):
    seen = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            masked = kw.get("pdmin_v_u") is not None
            seen.append(name + ("-masked" if masked else ""))
            return fn(*args, **kw)
        monkeypatch.setattr(td, fn.__name__, wrapped)

    spy("pixel", td.sweep_pile_pixel)
    spy("rows", td.sweep_pile_rows)
    spy("tiles", td.sweep_pile_tiles)
    vol = _scene(C, V=3, S=4, U=20) if C != 3 else _scene(3, V=3, S=4, U=20)
    comp = td.Depth2DComputer(vol, -1.0, 1.5, D, device="cpu",
                              coarse_mode=mode)
    if edited:
        lo = torch.full((4, 3, 20), -0.5)
        comp.set_bounds(lo, lo + 1.0)
    comp.params = DepthParams(mean_shift_max_iter=2)
    comp.run()
    assert seen and set(seen) == {route}


def test_coarse_mode_is_checked():
    with pytest.raises(ValueError):
        td.Depth2DComputer(np.zeros((2, 2, 4, 1), np.float32), -1.0, 1.0, 3,
                           device="cpu", coarse_mode="tiles")
