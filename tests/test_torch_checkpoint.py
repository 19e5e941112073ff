"""Checkpoint / resume and pass progress.

A port checkpoint round trip is bitwise; a directory written by the JAX
package (its XLA path) resumes in the port, wholly or from a level on,
with results within tests/test_torch_fine_to_coarse.py's bounds (validity
exact, fused depth within 1e-4); a level saved with scalar bounds resets
a reused computer's bound planes.  ``early_stop=False`` and ``verbose``
give the JAX package's pass counts and progress lines."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu.config import DepthParams as JParams
from remotesensingproject_tpu.config import PyramidParams as JPyramid
from remotesensingproject_tpu.models import depth2d as jd2
from remotesensingproject_tpu.models.fine_to_coarse import FineToCoarse as JFTC
from remotesensingproject_tpu_torch import (Depth2DComputer, DepthParams,
                                            FineToCoarse, PyramidParams)
from remotesensingproject_tpu_torch.utils import checkpoint

FIELDS = ("ce", "ce_mask", "disp_conf", "line_conf", "best_depth", "claim")


def _vol(S=8, V=24, U=40, seed=4):
    vol, _ = oracle.make_synthetic_lf(S=S, V=V, U=U, C=1, n_objects=3,
                                      seed=seed, dmin=-1.0, dmax=1.5)
    return vol


def _ftc(vol, score="edge", dim_d=21):
    return FineToCoarse(vol, -1.0, 1.5, dim_d,
                        params=DepthParams(score_version=score),
                        pyramid=PyramidParams(min_spatial_dim=10),
                        device="cpu")


@pytest.mark.parametrize("score", ["edge", "line"])
def test_port_round_trip_is_bitwise(tmp_path, score):
    vol = _vol(S=6, V=24, U=32)
    first = _ftc(vol, score, dim_d=9)
    first.run(ckpt_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["level_00.npz", "level_01.npz"]
    with np.load(tmp_path / "level_00.npz") as z0, \
            np.load(tmp_path / "level_01.npz") as z1:
        assert "dmin_scalar" in z0.files and "dmin" not in z0.files
        assert z1["dmin"].shape == (6, 12, 16) and bool(z1["accept_all"])
        assert z0["rbar"].shape == (6, 24, 32, 1)
    again = _ftc(vol, score, dim_d=9)
    again.run(ckpt_dir=str(tmp_path))
    assert [c.passes_run for c in again.computers] == [0, 0]
    assert [c.passes_run for c in first.computers] != [0, 0]
    for a, b in zip(first.computers, again.computers):
        for f in FIELDS:
            assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
        assert a._bounds_edited == b._bounds_edited
        if a._bounds_edited:
            assert torch.equal(a.dmin_s_v_u, b.dmin_s_v_u)
            assert torch.equal(a.dmax_s_v_u, b.dmax_s_v_u)
    assert tuple(again.computers[0].state.line_conf.shape) == (
        (6, 24, 32) if score == "line" else (1, 1, 1))
    for x, y in zip(first.get_results(), again.get_results()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("from_level", [0, 1])
def test_jax_checkpoint_resumes_in_port(tmp_path, from_level):
    """Every level restored (from_level 0), or level 0 restored and level 1
    run by the port from the bounds the restored level gives."""
    vol = _vol()
    j = JFTC(jnp.asarray(vol), -1.0, 1.5, 21,
             pyramid=JPyramid(min_spatial_dim=10), use_pallas=False)
    j.run(ckpt_dir=str(tmp_path))
    fj, vj = j.get_results()
    if from_level:
        os.remove(tmp_path / "level_01.npz")
    t = _ftc(vol)
    t.run(ckpt_dir=str(tmp_path))
    assert t.computers[0].passes_run == 0
    assert (t.computers[1].passes_run > 0) == bool(from_level)
    ft, vt = t.get_results()
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-4)
    for jc, tc in zip(j.computers, t.computers):
        np.testing.assert_array_equal(tc.state.claim.numpy(),
                                      np.asarray(jc.state.claim))
    # the level the port ran is saved in the JAX package's format
    assert os.path.exists(tmp_path / "level_01.npz")


def test_scalar_level_resets_reused_computer(tmp_path):
    vol = _vol(S=5, V=12, U=24)
    c = Depth2DComputer(vol, -1.0, 1.5, 5, device="cpu")
    c.run()
    checkpoint.save_level(str(tmp_path), 0, c)
    reused = Depth2DComputer(vol, -3.0, 3.0, 5, device="cpu")
    planes = torch.full((5, 12, 24), 0.25)
    reused.set_bounds(planes, planes + 1.0)
    assert checkpoint.load_level(str(tmp_path), 0, reused)
    assert not reused._bounds_edited
    assert reused._dmin_arr is None and reused._dmax_arr is None
    assert (reused.dmin, reused.dmax) == (-1.0, 1.5)
    assert bool((reused.dmin_s_v_u == -1.0).all())
    for f in FIELDS:
        assert torch.equal(getattr(reused.state, f), getattr(c.state, f)), f
    assert not checkpoint.load_level(str(tmp_path), 1, reused)


@pytest.mark.parametrize("score", ["edge", "line"])
def test_line_conf_of_any_saved_shape(tmp_path, score):
    """A level whose file holds ``line_conf`` as [S, V, U] loads into an
    edge-mode computer as (1, 1, 1) and into a line-mode one as saved."""
    vol = _vol(S=5, V=12, U=24)
    line = Depth2DComputer(vol, -1.0, 1.5, 5, device="cpu",
                           params=DepthParams(score_version="line"))
    line.run()
    checkpoint.save_level(str(tmp_path), 0, line)
    c = Depth2DComputer(vol, -1.0, 1.5, 5, device="cpu",
                        params=DepthParams(score_version=score))
    assert checkpoint.load_level(str(tmp_path), 0, c)
    if score == "line":
        assert torch.equal(c.state.line_conf, line.state.line_conf)
        want = line.get_valid_depths_mask_s_v_u()
    else:
        assert tuple(c.state.line_conf.shape) == (1, 1, 1)
        want = line.state.ce > c.params.edge_score_threshold
    assert torch.equal(c.get_valid_depths_mask_s_v_u(), want)


def _progress(text):
    return ([tuple(map(int, m)) for m in re.findall(
        r"passes (\d+)/(\d+) \(\+[\d.]+s, remaining px (\d+)\)", text)],
        re.findall(r"early stop after (\d+) passes", text))


@pytest.mark.parametrize("early_stop", [True, False])
def test_pass_counts_and_progress_match_jax(capsys, early_stop):
    """``verbose`` prints the JAX package's progress lines (passes done,
    pixels left, every 8 passes, at the end and at the stop) with the same
    numbers.  A static scene (disparity 0, a candidate) is claimed by its
    first pass and stops there; ``early_stop=False`` runs every pass of
    the schedule of a moving scene."""
    vol = _vol(S=11, V=12, U=24, seed=2)
    if early_stop:
        vol = np.repeat(vol[:, 5:6], 11, axis=1)
    j = jd2.Depth2DComputer(jnp.asarray(vol), -1.0, 1.0, 5, verbose=True,
                            early_stop=early_stop, use_pallas=False,
                            params=JParams())
    j.run()
    jout = capsys.readouterr().out
    t = Depth2DComputer(vol, -1.0, 1.0, 5, verbose=True,
                        early_stop=early_stop, device="cpu")
    t.run()
    tout = capsys.readouterr().out
    jp, tp = _progress(jout), _progress(tout)
    assert jp == tp
    if early_stop:
        assert t.passes_run == 1 and tp == ([(1, 11, 0)], ["1"])
    else:
        assert t.passes_run == 11 and not tp[1]
        assert [p for p, _, _ in tp[0]] == [8, 11] and tp[0][-1][2] > 0
    np.testing.assert_array_equal(t.state.claim.numpy(),
                                  np.asarray(j.state.claim))
    quiet = Depth2DComputer(vol, -1.0, 1.0, 5, early_stop=early_stop,
                            device="cpu")
    quiet.run()
    assert capsys.readouterr().out == ""
    assert quiet.passes_run == t.passes_run


def test_fine_to_coarse_pass_progress(capsys):
    """``pass_progress`` (default: ``verbose``) prints the levels' pass
    lines; ``verbose`` the level lines."""
    vol = _vol(S=5, V=24, U=32)
    ftc = FineToCoarse(vol, -1.0, 1.5, 5, pass_progress=True, device="cpu",
                       pyramid=PyramidParams(min_spatial_dim=10),
                       early_stop=False)
    ftc.run()
    out = capsys.readouterr().out
    assert "level 0" not in out and len(_progress(out)[0]) == 2
    assert [c.passes_run for c in ftc.computers] == [5, 5]
    FineToCoarse(vol, -1.0, 1.5, 5, verbose=True, device="cpu",
                 pyramid=PyramidParams(min_spatial_dim=10)).run()
    out = capsys.readouterr().out
    assert "level 1 done" in out and _progress(out)[0]
