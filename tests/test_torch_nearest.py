"""Port parity: nearest interpolation (``interpolation="nearest"``) against
the JAX package's XLA path, which is the only route the JAX package has for
it (its Pallas routes require linear interpolation): each pixel rounds its
own position, ``sign(I) * floor(|I| + 0.5)``, on its own grid at
bounds-edited levels, with no tile quantisation.

The port sends nearest to the pixel sweep (C in {1, 3}) or to the tile
sweep on each pixel's own grid (any other C), never to the row sweep, and
ignores ``coarse_mode`` for it.  Claims and validity are exact, depths
within 1e-6 (the bound of tests/test_torch_pile.py), confidences within
the tolerances of tests/test_torch_depth2d.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remotesensingproject_tpu.config import DepthParams as JParams
from remotesensingproject_tpu.config import PyramidParams as JPyr
from remotesensingproject_tpu.models.depth2d import (
    Depth2DComputer as JDepth2D)
from remotesensingproject_tpu.models.fine_to_coarse import (
    FineToCoarse as JFTC)
from remotesensingproject_tpu.models.pile import (
    Depth1DComputerPile as JPile)
from remotesensingproject_tpu_torch.config import DepthParams, PyramidParams
from remotesensingproject_tpu_torch.models import depth2d as td
from remotesensingproject_tpu_torch.models import pile as tpile
from remotesensingproject_tpu_torch.models.fine_to_coarse import FineToCoarse
from test_torch_depth2d import _edited_bounds
from test_torch_sweep_rows import _scene

NEAREST = DepthParams(interpolation="nearest")
J_NEAREST = JParams(interpolation="nearest")


@pytest.mark.parametrize("C", [1, 4])
def test_pile_nearest_matches_jax(C):
    vol = _scene(C, V=10, S=8, U=48, seed=6)
    jr = JPile(jnp.asarray(vol), -1.0, 1.5, 11, params=J_NEAREST,
               use_pallas=False).run()
    tr = tpile.Depth1DComputerPile(vol, -1.0, 1.5, 11, params=NEAREST,
                                   device="cpu").run()
    np.testing.assert_array_equal(tr.edge_mask.numpy(),
                                  np.asarray(jr.edge_mask))
    assert tr.edge_mask.float().mean() > 0.2
    for name, atol in (("best_depth", 1e-6), ("best_depth_raw", 1e-6),
                       ("edge_confidence", 1e-6), ("disp_confidence", 2e-5),
                       ("rbar", 2e-5)):
        np.testing.assert_allclose(getattr(tr, name).numpy(),
                                   np.asarray(getattr(jr, name)), rtol=0,
                                   atol=atol, err_msg=name)
    linear = tpile.Depth1DComputerPile(vol, -1.0, 1.5, 11,
                                       device="cpu").run()
    assert not torch.equal(linear.best_depth_raw, tr.best_depth_raw)


@pytest.mark.parametrize("C,edited", [(1, False), (1, True), (4, False),
                                      (4, True)])
def test_depth2d_nearest_matches_jax(C, edited):
    S, V, U = 6, 5, 40
    vol = _scene(C, V=V, S=S, U=U, seed=5)
    j = JDepth2D(jnp.asarray(vol), -1.0, 1.5, 9, params=J_NEAREST,
                 use_pallas=False)
    # the tile mode asked for is ignored: nearest sweeps each pixel's grid
    t = td.Depth2DComputer(vol, -1.0, 1.5, 9, params=NEAREST, device="cpu",
                           coarse_mode="tile")
    if edited:
        lo, hi = _edited_bounds(S, V, U)
        j.set_bounds(jnp.asarray(lo), jnp.asarray(hi))
        t.set_bounds(torch.from_numpy(lo), torch.from_numpy(hi))
    j.run()
    t.run()
    for name in ("claim", "ce_mask"):
        np.testing.assert_array_equal(getattr(t.state, name).numpy(),
                                      np.asarray(getattr(j.state, name)))
    for name, atol in (("best_depth", 1e-6), ("disp_conf", 2e-3),
                       ("ce", 1e-6)):
        np.testing.assert_allclose(getattr(t.state, name).numpy(),
                                   np.asarray(getattr(j.state, name)),
                                   rtol=0, atol=atol, err_msg=name)
    np.testing.assert_array_equal(
        t.get_valid_depths_mask_s_v_u().numpy(),
        np.asarray(j.get_valid_depths_mask_s_v_u()))
    assert t.passes_run > 1


def test_fine_to_coarse_nearest_matches_jax():
    vol = _scene(1, V=24, S=5, U=24, seed=4)
    j = JFTC(jnp.asarray(vol), -1.0, 1.5, 7, params=J_NEAREST,
             pyramid=JPyr(min_spatial_dim=10), use_pallas=False)
    j.run()
    fj, vj = j.get_results()
    t = FineToCoarse(vol, -1.0, 1.5, 7, params=NEAREST,
                     pyramid=PyramidParams(min_spatial_dim=10), device="cpu")
    t.run()
    ft, vt = t.get_results()
    assert len(t.computers) == len(j.computers) == 2
    for cj, ct in zip(j.computers, t.computers):
        np.testing.assert_array_equal(ct.state.claim.numpy(),
                                      np.asarray(cj.state.claim))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-6)
    assert np.isfinite(ft.numpy()).all()


@pytest.mark.parametrize("C,D,edited,route", [
    (1, 9, False, "pixel"), (3, 9, True, "pixel"), (1, 1030, False, "tiles"),
    (4, 9, False, "tiles"), (4, 9, True, "tiles")])
def test_nearest_route(monkeypatch, C, D, edited, route):
    """Which wrapper nearest reaches: never the row sweep, never the tile
    sweep's masked mode, whatever ``coarse_mode`` says."""
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
    vol = _scene(C, V=3, S=4, U=20)
    comp = td.Depth2DComputer(vol, -1.0, 1.5, D, device="cpu",
                              coarse_mode="tile")
    if edited:
        lo = torch.full((4, 3, 20), -0.5)
        comp.set_bounds(lo, lo + 1.0)
    comp.params = DepthParams(interpolation="nearest", mean_shift_max_iter=2)
    comp.run()
    assert seen and set(seen) == {route}
    seen.clear()
    tpile.Depth1DComputerPile(vol, -1.0, 1.5, D, params=comp.params,
                              device="cpu").run()
    assert seen == [route]
