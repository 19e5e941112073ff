"""The port's CLI on the CPU (``--device cpu``) on a tiny PNG folder: every
command of the JAX package's CLI (``bench`` runs the port's bench, which
tests/test_torch_bench.py holds).  ``read-img``, ``build-epi``
and ``gallery`` write the JAX commands' images; the depth commands write
the PNGs of the JAX commands (their pixels equal the getters' renders) and
their npz; ``--score`` and ``--fast`` reach ``depth1d`` (the JAX command
drops them); ``--ckpt-dir`` resumes; ``info`` imports no JAX."""

import argparse
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
from PIL import Image

import oracle
from remotesensingproject_tpu.cli import main as jcli
from remotesensingproject_tpu_torch import (Depth1DComputer,
                                            Depth1DComputerPile,
                                            Depth2DComputer, DepthParams,
                                            FineToCoarse)
from remotesensingproject_tpu_torch.cli import main as cli
from remotesensingproject_tpu_torch.models import depth1d
from remotesensingproject_tpu_torch.utils.plot import (apply_colormap,
                                                       copy_and_scale_uchar)
from test_torch_no_fallback import _write_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def frames(tmp_path):
    vol, _ = oracle.make_synthetic_lf(S=5, V=24, U=32, C=1, seed=2)
    u8 = _write_frames(vol, tmp_path / "frames")
    return str(tmp_path / "frames"), u8


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im)


def _depth_cmd(name, folder, out, *flags):
    cli.main([name, folder, "--ext", "png", "--dmin", "-1", "--dmax", "1.5",
              "--dim-d", "5", "--out", out, "--device", "cpu", *flags])


def test_read_img_prints_the_jax_commands_stats(frames, capsys):
    folder, _ = frames
    cli.main(["read-img", folder, "frame_002", "--ext", "png"])
    got = capsys.readouterr().out
    jcli.cmd_read_img(argparse.Namespace(folder=folder, name="frame_002",
                                         ext="png"))
    assert got == capsys.readouterr().out
    assert got.startswith("shape=(24, 32) dtype=uint8")


@pytest.mark.parametrize("command,flags,names", [
    ("build-epi", [], ["epi_1st", "epi"]),
    ("build-epi", ["--row", "3", "--transpose"], ["epi_1st", "epi"]),
    ("gallery", [], [f"frame_{s:03d}" for s in range(5)])])
def test_image_commands_match_jax(tmp_path, frames, command, flags, names):
    folder, _ = frames
    cli.main([command, folder, "--ext", "png", "--out",
              str(tmp_path / "port"), *flags])
    args = argparse.Namespace(folder=folder, ext="png",
                              out=str(tmp_path / "jax"), row=-1,
                              transpose=False, rotate180=False)
    if "--row" in flags:
        args.row, args.transpose = 3, True
    with warnings.catch_warnings():
        # the JAX package's reader may warn about its native loader
        warnings.simplefilter("ignore", RuntimeWarning)
        getattr(jcli, "cmd_" + command.replace("-", "_"))(args)
    for n in names:
        got = _png(tmp_path / "port" / f"{n}.png")
        np.testing.assert_array_equal(got, _png(tmp_path / "jax" /
                                                f"{n}.png"), err_msg=n)
        assert got.any()


def test_depth1d_command_writes_png_and_npz(tmp_path, frames):
    folder, u8 = frames
    out = str(tmp_path / "out")
    _depth_cmd("depth1d", folder, out, "--row", "7", "--s-hat", "1")
    want = Depth1DComputer(u8[7], -1.0, 1.5, 5, s_hat=1, device="cpu")
    res = want.run()
    np.testing.assert_array_equal(_png(os.path.join(out, "coloured_epi.png")),
                                  want.get_coloured_epi())
    z = np.load(os.path.join(out, "depth1d_results.npz"))
    for name, x in res._asdict().items():
        np.testing.assert_array_equal(z[name], x.numpy(), err_msg=name)
    assert z["edge_mask"].any()


@pytest.mark.parametrize("flags,score,fast", [
    ([], "edge", False), (["--fast"], "edge", True),
    (["--score", "line"], "line", False),
    (["--score", "disp", "--fast"], "disp", True)])
def test_depth1d_command_passes_score_and_fast(tmp_path, frames, monkeypatch,
                                               flags, score, fast):
    seen = []

    class Recording(depth1d.Depth1DComputer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self.params)

    monkeypatch.setattr(depth1d, "Depth1DComputer", Recording)
    _depth_cmd("depth1d", frames[0], str(tmp_path / "out"), *flags)
    (params,) = seen
    assert params == DepthParams(score_version=score, fast=fast)


def test_pile_and_depth2d_commands_write_pngs(tmp_path, frames):
    folder, u8 = frames
    out = str(tmp_path / "out")
    _depth_cmd("pile", folder, out)
    pile = Depth1DComputerPile(u8, -1.0, 1.5, 5, device="cpu")
    pile.run()
    np.testing.assert_array_equal(
        _png(os.path.join(out, "disparity_map.png")), pile.get_disparity_map())
    np.testing.assert_array_equal(
        _png(os.path.join(out, "coloured_epi.png")), pile.get_coloured_epi())

    _depth_cmd("depth2d", folder, out, "--score", "disp")
    comp = Depth2DComputer(u8, -1.0, 1.5, 5, device="cpu",
                           params=DepthParams(score_version="disp"))
    st = comp.run()
    valid = comp.get_valid_depths_mask_s_v_u().numpy()
    for s in range(5):
        want = apply_colormap(copy_and_scale_uchar(st.best_depth[s]))
        want[~valid[s]] = 0
        np.testing.assert_array_equal(
            _png(os.path.join(out, f"disparity_{s:03d}.png")), want)
    assert want.any()


def test_fine_to_coarse_command_resumes_from_ckpt_dir(tmp_path, frames,
                                                      capsys):
    folder, u8 = frames
    ckpt = str(tmp_path / "ckpt")
    first, second = str(tmp_path / "a"), str(tmp_path / "b")
    _depth_cmd("fine-to-coarse", folder, first, "--ckpt-dir", ckpt)
    out1 = capsys.readouterr().out
    assert sorted(os.listdir(ckpt)) == ["level_00.npz", "level_01.npz"]
    _depth_cmd("fine-to-coarse", folder, second, "--ckpt-dir", ckpt)
    out2 = capsys.readouterr().out
    assert "level 0 done" in out1 and "passes 5/5" in out1
    assert "level 0 restored" in out2 and "level 1 restored" in out2
    assert "passes" not in out2.replace("(0 passes)", "")
    z1 = np.load(os.path.join(first, "fine_to_coarse_results.npz"))
    z2 = np.load(os.path.join(second, "fine_to_coarse_results.npz"))
    for name in ("fused", "validity"):
        np.testing.assert_array_equal(z1[name], z2[name])
    ftc = FineToCoarse(u8, -1.0, 1.5, 5, device="cpu")
    ftc.run()
    maps = ftc.get_coloured_depth_maps()
    for s in range(5):
        for d in (first, second):
            np.testing.assert_array_equal(
                _png(os.path.join(d, f"depth_map_{s:03d}.png")), maps[s])
    np.testing.assert_array_equal(z1["fused"], ftc.get_results()[0].numpy())


def test_info_imports_no_jax():
    code = ("import sys\n"
            "from remotesensingproject_tpu_torch.cli import main\n"
            "main.main(['info'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'remotesensingproject_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    lines = out.splitlines()
    assert lines[0] == "remotesensingproject_tpu_torch 0.1.0"
    assert lines[1].startswith("torch ")
    assert lines[2].startswith("cuda available: ")


def test_bench_and_help_say_what_is_not_ported(capsys, monkeypatch):
    """Everything is ported: ``bench`` runs the port's ``bench.main`` (as
    the JAX command runs bench.py's), and the help names nothing as not
    ported."""
    from remotesensingproject_tpu_torch import bench

    calls = []
    monkeypatch.setattr(bench, "main", lambda: calls.append(1))
    assert cli.main(["bench"]) is None
    assert calls == [1]
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "bench" in text
    assert "not ported" not in text.lower()
    assert "--sharded" not in text and "--no-pallas" not in text
