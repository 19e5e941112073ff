"""Port parity: the pile entry point (one s_hat, all rows; row sweep then
selective median) against the JAX package's XLA path, the bundled
data/strips16 gate of tests/test_sample_data.py, and the ``pile``,
``depth2d`` and ``fine-to-coarse`` commands on the CPU, with ``--score
line`` and ``--fast``.  The JAX pile reaches its row kernel only
on a TPU (no interpret mode), so the row kernel's numerics are held in
tests/test_torch_sweep_rows.py; against the XLA path's per-pixel rounding
depths agree within 1e-6 and scores within 2e-5."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu.models.pile import (
    Depth1DComputerPile as JPile)
from remotesensingproject_tpu_torch import Depth1DComputerPile
from remotesensingproject_tpu_torch.cli import main as cli
from remotesensingproject_tpu_torch.models.depth2d import Depth2DComputer
from remotesensingproject_tpu_torch.utils.io import (
    build_epis_from_imgs, read_imgs_from_folder)
from test_torch_no_fallback import _write_frames

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "strips16")


@pytest.mark.parametrize("C,s_hat", [(1, -1), (3, 2)])
def test_pile_matches_jax(C, s_hat):
    vol, _ = oracle.make_synthetic_lf(S=8, V=10, U=48, C=C, n_objects=3,
                                      seed=6, dmin=-1.0, dmax=1.5)
    j = JPile(jnp.asarray(vol), -1.0, 1.5, 11, s_hat=s_hat,
              use_pallas=False)
    jr = j.run()
    t = Depth1DComputerPile(vol, -1.0, 1.5, 11, s_hat=s_hat, device="cpu")
    tr = t.run()
    assert t.s_hat == j.s_hat
    np.testing.assert_array_equal(tr.edge_mask.numpy(),
                                  np.asarray(jr.edge_mask))
    assert tr.edge_mask.float().mean() > 0.2
    for name, atol in (("best_depth", 1e-6), ("best_depth_raw", 1e-6),
                       ("edge_confidence", 1e-6), ("disp_confidence", 2e-5),
                       ("rbar", 2e-5)):
        np.testing.assert_allclose(getattr(tr, name).numpy(),
                                   np.asarray(getattr(jr, name)), rtol=0,
                                   atol=atol, err_msg=name)
    assert torch.equal(t.get_depths(), tr.best_depth)


def test_sample_dataset_pile_recovers_layer_disparities():
    frames = read_imgs_from_folder(DATA, "png")
    assert frames.shape[:3] == (16, 48, 96)
    epis = build_epis_from_imgs(frames)
    layers = np.load(os.path.join(DATA, "ground_truth.npz"))[
        "layer_disparities"]
    comp = Depth1DComputerPile(epis, dmin=-1.0, dmax=1.5, dim_d=24,
                               device="cpu")
    comp.run()
    depth = comp.get_depths().numpy()
    mask = comp.result.edge_mask.numpy()
    assert mask.mean() > 0.3
    err = np.min(np.abs(depth[mask][:, None] - layers[None]), axis=1)
    assert np.median(err) < 0.1
    assert np.sqrt((err ** 2).mean()) < 0.3


def test_pile_and_depth2d_commands_on_cpu(tmp_path):
    vol, _ = oracle.make_synthetic_lf(S=4, V=12, U=24, C=1, seed=2)
    u8 = _write_frames(vol, tmp_path / "frames")
    common = ["--ext", "png", "--dmin", "-1", "--dmax", "1.5", "--dim-d",
              "5", "--out", str(tmp_path / "out"), "--device", "cpu"]
    cli.main(["pile", str(tmp_path / "frames"), *common])
    res = np.load(tmp_path / "out" / "pile_results.npz")
    want = Depth1DComputerPile(u8, -1.0, 1.5, 5, device="cpu").run()
    for name, x in want._asdict().items():
        np.testing.assert_array_equal(res[name], x.numpy(), err_msg=name)

    cli.main(["depth2d", str(tmp_path / "frames"), *common])
    res = np.load(tmp_path / "out" / "depth2d_results.npz")
    comp = Depth2DComputer(u8, -1.0, 1.5, 5, device="cpu")
    st = comp.run()
    for name, x in (("best_depth", st.best_depth),
                    ("disp_confidence", st.disp_conf),
                    ("edge_confidence", st.ce),
                    ("validity", comp.get_valid_depths_mask_s_v_u())):
        np.testing.assert_array_equal(res[name], x.numpy(), err_msg=name)


@pytest.mark.parametrize("flag", [["--sharded"], ["--no-pallas"],
                                  ["--ckpt-dir", "ckpt", "--sharded"]])
def test_commands_refuse_what_is_not_ported(tmp_path, flag, monkeypatch):
    """``--sharded`` and ``--no-pallas`` are ported: ``pile`` takes them as
    the JAX command does (``--sharded`` and ``--ckpt-dir`` are
    fine-to-coarse's; ``--no-pallas`` runs the plain versions).  Nothing
    is left unported: the ``bench`` command runs the port's bench, which
    without a card refuses to start, as every entry point does."""
    vol, _ = oracle.make_synthetic_lf(S=4, V=12, U=24, C=1, seed=2)
    u8 = _write_frames(vol, tmp_path / "frames")
    cli.main(["pile", str(tmp_path / "frames"), "--ext", "png", "--dmin",
              "-1", "--dmax", "1.5", "--dim-d", "5", "--out",
              str(tmp_path / "out"), "--device", "cpu", *flag])
    res = np.load(tmp_path / "out" / "pile_results.npz")
    want = Depth1DComputerPile(u8, -1.0, 1.5, 5, device="cpu",
                               use_pallas=False if "--no-pallas" in flag
                               else None).run()
    np.testing.assert_array_equal(res["best_depth"], want.best_depth.numpy())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench"])


@pytest.mark.parametrize("command,flag", [
    ("depth2d", ["--fast"]), ("depth2d", ["--score", "line"]),
    ("pile", ["--fast"]), ("fine-to-coarse", ["--score", "line", "--fast"])])
def test_commands_run_line_and_fast_on_cpu(tmp_path, command, flag):
    """``--score line`` and ``--fast`` set the params as the JAX commands
    do, and the commands write their npz."""
    from remotesensingproject_tpu_torch.config import DepthParams
    from remotesensingproject_tpu_torch.models.fine_to_coarse import (
        FineToCoarse)

    vol, _ = oracle.make_synthetic_lf(S=4, V=12, U=24, C=1, seed=2)
    u8 = _write_frames(vol, tmp_path / "frames")
    cli.main([command, str(tmp_path / "frames"), "--ext", "png", "--dmin",
              "-1", "--dmax", "1.5", "--dim-d", "5", "--out",
              str(tmp_path / "out"), "--device", "cpu", *flag])
    params = DepthParams(score_version="line" if "line" in flag else "edge",
                         fast="--fast" in flag)
    name = command.replace("-", "_") + "_results.npz"
    res = np.load(tmp_path / "out" / name)
    if command == "pile":
        want = Depth1DComputerPile(u8, -1.0, 1.5, 5, params=params,
                                   device="cpu").run().best_depth
        got = res["best_depth"]
    elif command == "depth2d":
        comp = Depth2DComputer(u8, -1.0, 1.5, 5, params=params, device="cpu")
        comp.run()
        want = comp.get_valid_depths_mask_s_v_u()
        got = res["validity"]
    else:
        ftc = FineToCoarse(u8, -1.0, 1.5, 5, params=params, device="cpu")
        ftc.run()
        want = ftc.get_results()[0]
        got = res["fused"]
    np.testing.assert_array_equal(got, want.numpy())
