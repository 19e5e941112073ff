"""Port parity: Depth1DComputer (one EPI, one s_hat, no median) against the
JAX package's, which sweeps with its XLA ``sweep_epi`` (per-pixel sample
positions, never capped).  Masks exact, edge confidence and depths within
1e-6, disp_confidence and r_bar within 2e-5 (the sweep bound of
tests/test_torch_sweep.py).  ``fast=True`` is compared on r_bar too: the
pixel sweep's fast cap (5 mean-shift steps) moves r_bar by ~1e-2 and not
the depths, so a depth-only test would miss it.  The route test holds
which wrapper and mode each (C, D) takes: never the row kernel."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu.config import DepthParams as JParams
from remotesensingproject_tpu.models.depth1d import (
    Depth1DComputer as JDepth1D, Depth1DResult as JResult)
from remotesensingproject_tpu_torch import Depth1DComputer
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.models import depth1d, depth2d

DMIN, DMAX = -1.0, 1.5
TOL = (("edge_confidence", 1e-6), ("best_depth", 1e-6),
       ("disp_confidence", 2e-5), ("rbar", 2e-5))


def _epi(C, S=9, U=64, seed=0):
    """One [S, U, C] EPI of a synthetic scene, with a dark band (C_e = 0
    there, by the shadow cut) so that the edge mask has holes."""
    vol, _ = oracle.make_synthetic_lf(S=S, V=4, U=U, C=min(C, 3), seed=seed,
                                      dmin=DMIN, dmax=DMAX)
    epi = vol[1]
    if C > 3:
        epi = epi[..., :1] * np.linspace(1.0, 0.5, C).astype(np.float32)
    epi = np.ascontiguousarray(epi)
    epi[:, U // 3:U // 3 + 8] = 0.01
    return epi


def _run_both(epi, dim_d, s_hat=-1, **kw):
    j = JDepth1D(jnp.asarray(epi), DMIN, DMAX, dim_d, s_hat=s_hat,
                 params=JParams(**kw))
    t = Depth1DComputer(epi, DMIN, DMAX, dim_d, s_hat=s_hat,
                        params=DepthParams(**kw), device="cpu")
    return j, j.run(), t, t.run()


def _assert_close(tr, jr):
    assert tr._fields == jr._fields
    mask = tr.edge_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(jr.edge_mask))
    assert 0.3 < mask.mean() < 1.0
    for name, atol in TOL:
        np.testing.assert_allclose(getattr(tr, name).numpy(),
                                   np.asarray(getattr(jr, name)), rtol=0,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("D", [7, 24])
@pytest.mark.parametrize("C", [1, 3, 4])
def test_depth1d_matches_jax(C, D, fast):
    j, jr, t, tr = _run_both(_epi(C, seed=C), D, fast=fast)
    assert t.s_hat == j.s_hat == 4
    assert tuple(tr.rbar.shape) == (64, C)
    _assert_close(tr, jr)


@pytest.mark.parametrize("C", [1, 4])
def test_depth1d_nearest_matches_jax(C):
    _, jr, _, tr = _run_both(_epi(C, seed=5), 24, interpolation="nearest")
    _assert_close(tr, jr)


@pytest.mark.parametrize("case", ["u8", "2d", "s_hat", "s_hat_out_of_range",
                                  "scale_factor"])
def test_depth1d_inputs_match_jax(case):
    """uint8 input (/255), a 2-D EPI (given a channel axis), an explicit
    s_hat, an out-of-range one (the default S // 2) and an explicit scale
    factor."""
    epi = _epi(1, seed=7)
    s_hat = {"s_hat": 2, "s_hat_out_of_range": 9}.get(case, -1)
    if case == "u8":
        epi = np.clip(np.round(epi * 255.0), 0, 255).astype(np.uint8)
    elif case == "2d":
        epi = epi[..., 0]
    sf = 2.0 if case == "scale_factor" else -1.0
    j = JDepth1D(jnp.asarray(epi), DMIN, DMAX, 24, s_hat=s_hat,
                 epi_scale_factor=sf)
    t = Depth1DComputer(epi, DMIN, DMAX, 24, s_hat=s_hat,
                        epi_scale_factor=sf, device="cpu")
    assert t.s_hat == j.s_hat == (2 if case == "s_hat" else 4)
    np.testing.assert_array_equal(t.epi.numpy(), np.asarray(j.epi))
    tr, jr = t.run(), j.run()
    if case == "scale_factor":   # half the radiance: fewer edges
        np.testing.assert_array_equal(tr.edge_mask.numpy(),
                                      np.asarray(jr.edge_mask))
        for name, atol in TOL:
            np.testing.assert_allclose(getattr(tr, name).numpy(),
                                       np.asarray(getattr(jr, name)), rtol=0,
                                       atol=atol, err_msg=name)
    else:
        _assert_close(tr, jr)


@pytest.mark.parametrize("opening", [1, 3])
def test_depth1d_edge_opening_at_one_row(opening):
    """Edge confidence on the [1, U, C] frame at s_hat: V = 1, a border
    case of the (v, u) opening that the pile never reaches."""
    _, jr, _, tr = _run_both(_epi(3, seed=3), 7,
                             edge_confidence_opening_size=opening)
    _assert_close(tr, jr)


def test_coloured_epi_matches_jax():
    """The coloured EPI is byte-equal to the JAX getter's on the same
    result, and keeps the reference's ``requested_index > 0`` test: column
    0 is never painted."""
    j, jr, t, tr = _run_both(_epi(1, seed=2), 24)
    _assert_close(tr, jr)
    j.result = JResult(*(jnp.asarray(x.numpy()) for x in tr))
    got = t.get_coloured_epi()
    want = np.asarray(j.get_coloured_epi())
    assert got.dtype == np.uint8 and got.shape == (9, 64, 3)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got[:, 0].any()


@pytest.mark.parametrize("C,D,interp,wrapper", [
    (1, 24, "linear", "pixel"), (3, 24, "linear", "pixel"),
    (4, 24, "linear", "tiles"), (1, 1030, "linear", "tiles"),
    (1, 24, "nearest", "pixel"), (4, 9, "nearest", "tiles")])
def test_depth1d_routes(monkeypatch, C, D, interp, wrapper):
    """The pixel kernel for C in {1, 3} and D <= 1024, else the tile kernel
    in pixel mode (each pixel's own grid, no allowed-range mask) on
    uniform [1, U] bounds; the row kernel never; always with fast=False."""
    calls = []

    def record(name, fn):
        def wrapped(*a, **k):
            calls.append((name, a, k))
            return fn(*a, **k)
        return wrapped

    def no_rows(*a, **k):
        raise AssertionError("depth1d reached the row sweep")

    monkeypatch.setattr(depth2d, "sweep_pile_rows", no_rows)
    for name in ("sweep_pile_pixel", "sweep_pile_tiles"):
        monkeypatch.setattr(depth2d, name, record(name,
                                                  getattr(depth2d, name)))
    modes = []
    sweep_pass = depth1d.sweep_pass
    monkeypatch.setattr(depth1d, "sweep_pass", lambda *a, **k: modes.append(
        (a, k)) or sweep_pass(*a, **k))

    epi = _epi(C, S=5, U=32, seed=1)
    t = Depth1DComputer(epi, DMIN, DMAX, D, device="cpu",
                        params=DepthParams(interpolation=interp, fast=True))
    t.run()
    (a, k), = modes
    assert k["coarse_mode"] == "pixel"
    assert a[4].fast is False and a[4].interpolation == interp
    for bound, value in zip(a[6:8], (DMIN, DMAX)):
        assert tuple(bound.shape) == (1, 32)
        assert bool((bound == value).all())
    (name, ca, ck), = calls
    assert name == f"sweep_pile_{wrapper}"
    if wrapper == "tiles":
        assert ck.get("pdmin_v_u") is None
    assert ca[0].shape == (1, 5, 32, C)
