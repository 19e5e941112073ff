"""Port parity: the renderers of ``utils/plot.py`` and every coloured getter
against the JAX package's, byte for byte.  The functions take the same
arrays (torch tensors in the port, numpy in the JAX package); the getters
take the same results: the port's run is handed to the JAX object, so that
what is compared is the rendering, not the last ulps of two sweeps."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu.config import DepthParams as JParams
from remotesensingproject_tpu.config import PyramidParams as JPyramid
from remotesensingproject_tpu.models import depth2d as jd2
from remotesensingproject_tpu.models import pile as jpile
from remotesensingproject_tpu.models.fine_to_coarse import FineToCoarse as JFTC
from remotesensingproject_tpu.utils import _jet_lut as jlut
from remotesensingproject_tpu.utils import plot as jplot
from remotesensingproject_tpu_torch import (Depth1DComputerPile,
                                            Depth2DComputer, DepthParams,
                                            FineToCoarse, PyramidParams)
from remotesensingproject_tpu_torch.utils import _jet_lut as tlut
from remotesensingproject_tpu_torch.utils import plot as tplot


def test_jet_table_equals_jax():
    assert tlut.JET_LUT == jlut.JET_LUT
    assert len(tlut.JET_LUT) == 256
    np.testing.assert_array_equal(tplot._LUTS["jet"], jplot._LUTS["jet"])


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    S, V, U = 6, 9, 14
    depth = rng.uniform(-1.0, 2.0, (S, V, U)).astype(np.float32)
    depth[:, :, 3] = 0.5                     # ties on the 0.5-grid
    mask = rng.random((S, V, U)) > 0.3
    epis = rng.random((V, S, U, 3)).astype(np.float32)
    epis[:, :, :2] = 0.01                    # below the shadow level
    return depth, mask, epis


def _case(name, m, t):
    """Render case ``name`` with plot module ``m``; ``t`` turns a numpy
    array into the module's input type."""
    depth, mask, epis = _arrays()
    params = SimpleNamespace(cut_shadows=True,
                             shadow_level=0.05 * 1.73205080757)
    if name == "apply_colormap":
        return m.apply_colormap(t(np.arange(256, dtype=np.uint8)
                                  .reshape(16, 16)))
    if name == "saturate_cast_u8":
        return m.saturate_cast_u8(np.array(
            [-3.0, 0.5, 1.5, 2.5, 254.5, 255.5, 300.0, 7.49], np.float32))
    if name == "copy_and_scale_float":
        return m.copy_and_scale_uchar(t(depth[0]))
    if name == "copy_and_scale_u8":
        return m.copy_and_scale_uchar(t((depth[0] * 50 + 60)
                                        .astype(np.uint8)))
    if name == "copy_and_scale_constant":
        return m.copy_and_scale_uchar(t(np.full((3, 4), 0.25, np.float32)))
    if name in ("converter_saturate", "converter_full_range"):
        conv = m.ImageConverterUint8().fit(
            t(epis[:, 0]), saturate=name == "converter_saturate")
        return np.stack([conv.copy_and_scale(t(epis[:, 1])),
                         conv.copy_and_scale(t(epis[:, 2]))]), \
            (conv.min, conv.max)
    if name == "disparity_map_image":
        return m.disparity_map_image(t(depth[1]), t(mask[1]))
    if name == "coloured_epi_lines":
        res = SimpleNamespace(best_depth=t(depth[0, 2]),
                              edge_mask=t(mask[0, 2]))
        return m.coloured_epi_lines(t(epis[2, :, :, :1]), res, 2, params)
    if name == "coloured_epi_from_pile":
        pile = SimpleNamespace(epis=t(epis[..., :1]), s_hat=3,
                               result=SimpleNamespace(best_depth=t(depth[3]),
                                                      edge_mask=t(mask[3])))
        return m.coloured_epi_from_pile(pile, 4)
    if name.startswith("coloured_depth_maps"):
        ep = epis[..., :1] if name.endswith("c1") else epis
        if name.endswith("no_shadow_cut"):
            params.cut_shadows = False
        return m.coloured_depth_maps(t(depth), t(mask), t(ep), params,
                                     saturate=not name.endswith("c3"))
    if name == "coloured_epi_2d":
        return m.coloured_epi_2d(t(depth), t(mask), 5)
    if name.startswith("depth_pyramid_images"):
        slices = [depth[2], depth[2, ::2, ::2] * 1.5, depth[2, ::4, ::4]]
        masks = [mask[2], mask[2, ::2, ::2], mask[2, ::4, ::4]]
        return m.depth_pyramid_images([t(x) for x in slices],
                                      [t(x) for x in masks],
                                      saturate=name.endswith("saturate"))
    if name == "side_by_side_wide":
        return m.side_by_side(np.zeros((4, 9), np.uint8),
                              np.ones((4, 9, 3), np.uint8))
    if name == "side_by_side_tall":
        return m.side_by_side(np.zeros((9, 4, 3), np.uint8),
                              np.ones((9, 4, 3), np.uint8))
    if name.startswith("draw_red_lines"):
        kw = {"draw_red_lines": {},
              "draw_red_lines_row": dict(fill_row_red=4, max_height=4),
              "draw_red_lines_col": dict(fill_col_red=2, max_width=6),
              "draw_red_lines_both": dict(fill_row_red=1, max_height=5,
                                          fill_col_red=12, max_width=3),
              }[name]
        return m.draw_red_lines(t(depth[0]), **kw)
    raise KeyError(name)


CASES = ["apply_colormap", "saturate_cast_u8", "copy_and_scale_float",
         "copy_and_scale_u8", "copy_and_scale_constant",
         "converter_saturate", "converter_full_range", "disparity_map_image",
         "coloured_epi_lines", "coloured_epi_from_pile",
         "coloured_depth_maps_c1", "coloured_depth_maps_c3",
         "coloured_depth_maps_no_shadow_cut", "coloured_epi_2d",
         "depth_pyramid_images_saturate", "depth_pyramid_images_full_range",
         "side_by_side_wide", "side_by_side_tall", "draw_red_lines",
         "draw_red_lines_row", "draw_red_lines_col", "draw_red_lines_both"]


def _same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, float):
        assert got == want
    else:
        want = np.asarray(want)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CASES)
def test_renderer_matches_jax(name):
    got = _case(name, tplot, torch.from_numpy)
    want = _case(name, jplot, np.asarray)
    _same(got, want)
    flat = got[0] if isinstance(got, tuple) else got
    flat = np.asarray(flat[0] if isinstance(flat, list) else flat)
    # a constant image scales to zeros (scale 0); every other case paints
    assert flat.any() != (name == "copy_and_scale_constant")


def _scene(S=5, V=24, U=32, C=1, seed=4):
    vol, _ = oracle.make_synthetic_lf(S=S, V=V, U=U, C=C, n_objects=3,
                                      seed=seed, dmin=-1.0, dmax=1.5)
    return np.clip(np.round(vol * 255.0), 0, 255).astype(np.uint8)


def _to_jax_state(st):
    return jd2.Depth2DState(**{f: jnp.asarray(getattr(st, f).numpy())
                               for f in jd2.Depth2DState._fields})


def test_pile_getters_match_jax():
    vol = _scene(S=8, V=10, U=48)
    t = Depth1DComputerPile(vol, -1.0, 1.5, 11, device="cpu")
    tr = t.run()
    j = jpile.Depth1DComputerPile(jnp.asarray(vol), -1.0, 1.5, 11,
                                  use_pallas=False)
    j.result = jpile.PileResult(**{f: jnp.asarray(getattr(tr, f).numpy())
                                   for f in jpile.PileResult._fields})
    assert t.s_hat == j.s_hat
    for got, want in ((t.get_coloured_epi(), j.get_coloured_epi()),
                      (t.get_coloured_epi(v=3), j.get_coloured_epi(v=3)),
                      (t.get_disparity_map(), j.get_disparity_map())):
        assert got.any()
        _same(got, np.asarray(want))


@pytest.mark.parametrize("score", ["edge", "disp", "line"])
def test_depth2d_getters_match_jax(score):
    vol = _scene(S=5, V=12, U=24)
    t = Depth2DComputer(vol, -1.0, 1.5, 5,
                        params=DepthParams(score_version=score),
                        device="cpu")
    st = t.run()
    j = jd2.Depth2DComputer(jnp.asarray(vol), -1.0, 1.5, 5,
                            params=JParams(score_version=score),
                            use_pallas=False)
    j.state = _to_jax_state(st)
    np.testing.assert_array_equal(t._criterion_mask().numpy(),
                                  np.asarray(j._criterion_mask()))
    for got, want in ((t.get_coloured_epi(), j.get_coloured_epi()),
                      (t.get_coloured_epi(v=2), j.get_coloured_epi(v=2)),
                      (t.get_disparity_map(), j.get_disparity_map()),
                      (t.get_disparity_map(s=1), j.get_disparity_map(s=1))):
        assert got.any()
        _same(got, np.asarray(want))


def test_fine_to_coarse_getters_match_jax(monkeypatch):
    """On a 5x24x32 scene: the fused maps, the maps beside the frames, the
    per-level EPI and depth slices at the default (half-to-even
    ``round(V0 / 2)``, ``round(S / 2)``) and explicit rows and frames."""
    vol = _scene()
    t = FineToCoarse(vol, -1.0, 1.5, 9, pyramid=PyramidParams(
        min_spatial_dim=10), device="cpu")
    t.run()
    j = JFTC(jnp.asarray(vol), -1.0, 1.5, 9,
             pyramid=JPyramid(min_spatial_dim=10), use_pallas=False)
    assert len(j.computers) == len(t.computers) == 2
    for jc, tc in zip(j.computers, t.computers):
        np.testing.assert_array_equal(tc.epis.numpy(), np.asarray(jc.epis))
        jc.state = _to_jax_state(tc.state)
        jc.accept_all = tc.accept_all
    fused, validity = t.get_results()
    monkeypatch.setattr(j, "get_results", lambda: (
        jnp.asarray(fused.numpy()), jnp.asarray(validity.numpy())))
    pairs = [
        (t.get_coloured_depth_maps(), j.get_coloured_depth_maps()),
        (t.get_coloured_depth_maps(saturate=False),
         j.get_coloured_depth_maps(saturate=False)),
        (t.get_coloured_depth_maps_and_imgs(),
         j.get_coloured_depth_maps_and_imgs()),
        (t.get_coloured_epi_pyr(), j.get_coloured_epi_pyr()),
        (t.get_coloured_epi_pyr(v=5, saturate=False),
         j.get_coloured_epi_pyr(v=5, saturate=False)),
        (t.get_coloured_depth_pyr(), j.get_coloured_depth_pyr()),
        (t.get_coloured_depth_pyr(s=1), j.get_coloured_depth_pyr(s=1))]
    for got, want in pairs:
        _same(got, [np.asarray(w) for w in want] if isinstance(want, list)
              else np.asarray(want))
    assert pairs[0][0].shape == (5, 24, 32, 3) and pairs[0][0].any()
    assert pairs[2][0][0].shape == (48, 32, 3)
