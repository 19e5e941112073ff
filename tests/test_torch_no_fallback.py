"""The port stands alone and never falls back to the CPU on its own."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu_torch import bench
from remotesensingproject_tpu_torch.cli import main as cli
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.models.depth2d import Depth2DComputer
from remotesensingproject_tpu_torch.models.fine_to_coarse import FineToCoarse
from remotesensingproject_tpu_torch.models.pile import Depth1DComputerPile
from remotesensingproject_tpu_torch.ops import (cuda_build, median_pallas,
                                                merge, propagation_pallas,
                                                sweep_pallas,
                                                sweep_pallas_perpixel,
                                                sweep_pallas_pixel)
from remotesensingproject_tpu_torch.types import resolve_device

PKG = pathlib.Path(__file__).resolve().parent.parent / \
    "remotesensingproject_tpu_torch"
# the JAX package, JAX, and the repository's bench.py (whose scenes import
# jax.numpy): the port keeps its own copies
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|remotesensingproject_tpu|bench)"
    r"(\.|\s|$)", re.M)


def test_sources_import_no_jax_and_no_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 18
    assert PKG / "bench.py" in files
    assert PKG / "native" / "loader.py" in files
    for f in files:
        assert not FORBIDDEN.search(f.read_text()), f


def test_importing_every_module_loads_no_jax():
    mods = [".".join(p.relative_to(PKG.parent).with_suffix("").parts)
            for p in sorted(PKG.rglob("*.py"))]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'remotesensingproject_tpu', 'bench')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=PKG.parent, timeout=120)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    vol, _ = oracle.make_synthetic_lf(S=4, V=12, U=24, C=1, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Depth2DComputer(vol, -1.0, 1.5, 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FineToCoarse(vol, -1.0, 1.5, 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main({"BENCH_SMALL": "1"})
    _write_frames(vol, tmp_path / "frames")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["fine-to-coarse", str(tmp_path / "frames"), "--ext",
                  "png", "--out", str(tmp_path / "out")])


@pytest.mark.parametrize("command", ["pile", "depth2d"])
def test_pile_and_depth2d_raise_without_cuda(no_cuda, tmp_path, command):
    vol, _ = oracle.make_synthetic_lf(S=4, V=12, U=24, C=1, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Depth1DComputerPile(vol, -1.0, 1.5, 5)
    _write_frames(vol, tmp_path / "frames")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([command, str(tmp_path / "frames"), "--ext", "png",
                  "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_depth1d_raises_without_cuda(no_cuda, tmp_path):
    from remotesensingproject_tpu_torch import Depth1DComputer

    vol, _ = oracle.make_synthetic_lf(S=4, V=12, U=24, C=3, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Depth1DComputer(vol[3], -1.0, 1.5, 5)
    assert Depth1DComputer(vol[3], -1.0, 1.5, 5, device="cpu").epi.is_cpu
    _write_frames(vol[..., :1], tmp_path / "frames")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["depth1d", str(tmp_path / "frames"), "--ext", "png",
                  "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


class _OnCard:
    """Stands in for a CUDA tensor where there is no card: the shape, type
    and layout of a CPU tensor, reported on ``cuda:0``."""

    device = torch.device("cuda:0")

    def __init__(self, t):
        self.shape, self.dtype = t.shape, t.dtype

    def is_contiguous(self):
        return True

    def contiguous(self):
        return self


@pytest.mark.parametrize("wrapper", ["pixel", "tiles"])
def test_sweep_launchers_raise_for_cuda_tensor_never_plain(monkeypatch,
                                                           wrapper):
    """Given a CUDA tensor the pixel and the tile sweep launch their kernel
    or raise: here, with no card and no nvcc, they must raise, and must not
    reach the plain version."""
    plain_calls = []

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    for mod in (sweep_pallas_pixel, sweep_pallas_perpixel):
        monkeypatch.setattr(mod, "sweep_pile",
                            lambda *a, **k: plain_calls.append(a))
    monkeypatch.setattr(cuda_build, "load", no_nvcc)
    epis = _OnCard(torch.zeros((2, 5, 16, 1)))
    plane = _OnCard(torch.zeros((2, 16)))
    mask = _OnCard(torch.ones((2, 16), dtype=torch.bool))
    with pytest.raises((RuntimeError, AssertionError)):
        if wrapper == "pixel":
            sweep_pallas_pixel.sweep_pile_pixel(epis, -1.0, 1.5, 5, 2,
                                                DepthParams(), mask)
        else:
            sweep_pallas_perpixel.sweep_pile_tiles(
                epis, plane, plane, 5, 2, DepthParams(), active_v_u=mask,
                pdmin_v_u=plane, pdmax_v_u=plane)
    assert not plain_calls


@pytest.mark.parametrize("wrapper", ["rows", "paint"])
def test_rows_and_paint_raise_for_cuda_tensor_never_plain(monkeypatch,
                                                          wrapper):
    """Given a CUDA tensor the row sweep and the paint launch their kernel
    or raise: here, with no card and no nvcc, they must raise, and must not
    reach the plain version."""
    plain_calls = []

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(sweep_pallas, "sweep_rows_plain",
                        lambda *a, **k: plain_calls.append(a))
    monkeypatch.setattr(propagation_pallas, "propagate",
                        lambda *a, **k: plain_calls.append(a))
    monkeypatch.setattr(cuda_build, "load", no_nvcc)
    n0 = (cuda_build.launches["sweep_rows"],
          cuda_build.launches["paint"])
    plane = _OnCard(torch.zeros((2, 16)))
    mask = _OnCard(torch.ones((2, 16), dtype=torch.bool))
    with pytest.raises((RuntimeError, AssertionError)):
        if wrapper == "rows":
            sweep_pallas.sweep_pile_rows(
                _OnCard(torch.zeros((2, 5, 16, 1))), -1.0, 1.5, 5, 2,
                DepthParams(), with_k_best=True, active_v_u=mask)
        else:
            volume = _OnCard(torch.zeros((5, 2, 16)))
            propagation_pallas.propagate_cuda(
                _OnCard(torch.ones((5, 2, 16), dtype=torch.bool)),
                _OnCard(torch.zeros((5, 2, 16, 1))), plane,
                _OnCard(torch.zeros((2, 16, 1))), mask, 2, 1.0, 0.1,
                [(volume, plane), (volume, plane)])
    assert not plain_calls
    assert n0 == (cuda_build.launches["sweep_rows"],
                  cuda_build.launches["paint"])


@pytest.mark.parametrize("case", ["pixel-nearest", "pixel-fast",
                                  "pixel-k_best", "tiles-nearest",
                                  "tiles-fast", "rows-fast", "paint-three"])
def test_line_fast_nearest_raise_for_cuda_tensor_never_plain(monkeypatch,
                                                             case):
    """Line mode (k_best, a third payload), fast mode and nearest
    interpolation on a CUDA tensor launch a kernel or raise: here, with no
    card and no nvcc, they must raise, reach no plain sweep or paint, and
    count no launch."""
    plain_calls = []

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    for mod in (sweep_pallas_pixel, sweep_pallas_perpixel):
        monkeypatch.setattr(mod, "sweep_pile",
                            lambda *a, **k: plain_calls.append(a))
    monkeypatch.setattr(sweep_pallas, "sweep_rows_plain",
                        lambda *a, **k: plain_calls.append(a))
    monkeypatch.setattr(propagation_pallas, "propagate",
                        lambda *a, **k: plain_calls.append(a))
    monkeypatch.setattr(cuda_build, "load", no_nvcc)
    libs = ("sweep_pixel", "sweep_tiles", "sweep_rows", "paint")
    n0 = [cuda_build.launches[lib] for lib in libs]
    kind, mode = case.split("-")
    params = DepthParams(interpolation="nearest" if mode == "nearest"
                         else "linear", fast=mode == "fast")
    epis = _OnCard(torch.zeros((2, 5, 16, 1)))
    plane = _OnCard(torch.zeros((2, 16)))
    mask = _OnCard(torch.ones((2, 16), dtype=torch.bool))
    with pytest.raises((RuntimeError, AssertionError)):
        if kind == "pixel":
            sweep_pallas_pixel.sweep_pile_pixel(
                epis, -1.0, 1.5, 5, 2, params, mask,
                with_k_best=mode == "k_best")
        elif kind == "tiles":
            sweep_pallas_perpixel.sweep_pile_tiles(
                epis, plane, plane, 5, 2, params, with_k_best=True,
                active_v_u=mask)
        elif kind == "rows":
            sweep_pallas.sweep_pile_rows(epis, -1.0, 1.5, 5, 2, params,
                                         active_v_u=mask)
        else:
            volume = _OnCard(torch.zeros((5, 2, 16)))
            propagation_pallas.propagate_cuda(
                _OnCard(torch.ones((5, 2, 16), dtype=torch.bool)),
                _OnCard(torch.zeros((5, 2, 16, 1))), plane,
                _OnCard(torch.zeros((2, 16, 1))), mask, 2, 1.0, 0.1,
                [(volume, plane)] * 3)
    assert not plain_calls
    assert n0 == [cuda_build.launches[lib] for lib in libs]


def test_row_sweep_refuses_nearest():
    """The row sweep's shared-shift rule is not nearest's per-pixel
    rounding: it refuses nearest on every device."""
    params = DepthParams(interpolation="nearest")
    with pytest.raises(NotImplementedError, match="linear"):
        sweep_pallas.sweep_pile_rows(torch.zeros((2, 5, 16, 1)), -1.0, 1.5,
                                     5, 2, params)
    with pytest.raises(NotImplementedError, match="linear"):
        sweep_pallas.sweep_pile_rows(_OnCard(torch.zeros((2, 5, 16, 1))),
                                     -1.0, 1.5, 5, 2, params)


def test_median_raises_for_cuda_tensor_never_plain(monkeypatch):
    """Given a CUDA tensor the median launches its kernel or raises: here,
    with no card and no nvcc, it must raise, and must not reach the plain
    version; operands of the wrong shape or size raise first."""
    plain_calls = []

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(median_pallas, "selective_median",
                        lambda *a, **k: plain_calls.append(a))
    monkeypatch.setattr(cuda_build, "load", no_nvcc)
    n0 = cuda_build.launches["median"]
    plane = _OnCard(torch.zeros((2, 16)))
    mask = _OnCard(torch.ones((2, 16), dtype=torch.bool))
    frame = _OnCard(torch.zeros((2, 16, 1)))
    with pytest.raises((RuntimeError, AssertionError)):
        median_pallas.selective_median_cuda(plane, frame, mask, 5, 0.1)
    with pytest.raises(ValueError, match="must be"):
        median_pallas.selective_median_cuda(
            plane, _OnCard(torch.zeros((2, 15, 1))), mask, 5, 0.1)
    with pytest.raises(ValueError, match="must be"):
        median_pallas.selective_median_cuda(
            plane, _OnCard(torch.zeros((2, 16, 0))), mask, 5, 0.1)
    with pytest.raises(NotImplementedError, match="1..17"):
        median_pallas.selective_median_cuda(plane, frame, mask, 18, 0.1)
    assert not plain_calls
    assert n0 == cuda_build.launches["median"]


@pytest.mark.parametrize("with_good", [False, True])
def test_merge_raises_for_cuda_tensor_never_plain(monkeypatch, with_good):
    """Given a CUDA tensor the pass's merge launches its kernel or raises:
    here, with no card and no nvcc, it must raise, and must not reach the
    plain version; operands of the wrong shape raise first."""
    import types

    from remotesensingproject_tpu_torch.ops.sweep import SweepResult

    plain_calls = []

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(merge, "merge",
                        lambda *a, **k: plain_calls.append(a))
    monkeypatch.setattr(cuda_build, "load", no_nvcc)
    n0 = cuda_build.launches["merge"]
    volume = _OnCard(torch.zeros((5, 2, 16)))
    state = types.SimpleNamespace(
        ce=volume, ce_mask=_OnCard(torch.zeros((5, 2, 16), dtype=torch.bool)),
        disp_conf=volume, best_depth=volume,
        rbar=_OnCard(torch.zeros((5, 2, 16, 3))))
    plane = _OnCard(torch.zeros((2, 16)))
    res = SweepResult(plane, plane, plane, _OnCard(torch.zeros((2, 16, 3))),
                      None)
    mask = _OnCard(torch.ones((2, 16), dtype=torch.bool))
    with pytest.raises((RuntimeError, AssertionError)):
        merge.merge_cuda(state, 2, mask, res, 0.0, with_good)
    with pytest.raises(ValueError, match="merge"):
        merge.merge_cuda(state, 2, _OnCard(torch.ones((2, 15), dtype=bool)),
                         res, 0.0, with_good)
    assert not plain_calls
    assert n0 == cuda_build.launches["merge"]


def _write_frames(vol, folder):
    from PIL import Image

    folder.mkdir(parents=True)
    u8 = np.clip(vol * 255.0, 0, 255).astype(np.uint8)
    for s in range(u8.shape[1]):
        Image.fromarray(u8[:, s, :, 0]).save(folder / f"frame_{s:03d}.png")
    return u8


def test_cli_on_cpu_writes_results(tmp_path):
    vol, _ = oracle.make_synthetic_lf(S=4, V=12, U=24, C=1, seed=2)
    u8 = _write_frames(vol, tmp_path / "frames")
    cli.main(["fine-to-coarse", str(tmp_path / "frames"), "--ext", "png",
              "--dmin", "-1", "--dmax", "1.5", "--dim-d", "5", "--out",
              str(tmp_path / "out"), "--device", "cpu"])
    res = np.load(tmp_path / "out" / "fine_to_coarse_results.npz")
    ftc = FineToCoarse(u8, -1.0, 1.5, 5, device="cpu")
    ftc.run()
    fused, validity = ftc.get_results()
    np.testing.assert_array_equal(res["fused"], fused.numpy())
    np.testing.assert_array_equal(res["validity"], validity.numpy())


def test_io_matches_jax_package(tmp_path):
    from remotesensingproject_tpu.utils import io as jio
    from remotesensingproject_tpu_torch.utils import io as tio

    vol, _ = oracle.make_synthetic_lf(S=3, V=6, U=10, C=1, seed=3)
    _write_frames(vol, tmp_path / "f")
    (tmp_path / "f" / "notes.txt").write_text("skip me")
    assert tio.list_images(str(tmp_path / "f"), "png") == \
        jio.list_images(str(tmp_path / "f"), ".png")
    imgs = tio.read_imgs_from_folder(str(tmp_path / "f"), "png")
    want = jio.read_imgs_from_folder(str(tmp_path / "f"), "png",
                                     use_native=False)
    np.testing.assert_array_equal(imgs, want)
    np.testing.assert_array_equal(tio.build_epis_from_imgs(imgs),
                                  jio.build_epis_from_imgs(want))
    with pytest.raises(FileNotFoundError):
        tio.read_imgs_from_folder(str(tmp_path / "f"), "tif")


def test_default_reaches_the_kernel_wrappers_and_no_pallas_does_not(
        monkeypatch):
    """The default (``use_pallas=None``) routes every stage of a pass to the
    kernel wrappers, which a CUDA tensor launches (above); ``use_pallas=
    False`` is the caller's choice of the plain versions and reaches no
    wrapper.  Spies stand in for the wrappers here, on the CPU."""
    from remotesensingproject_tpu_torch.models import depth2d, pile

    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    for mod, name in ((depth2d, "sweep_pile_pixel"),
                      (depth2d, "selective_median_cuda"),
                      (depth2d, "propagate_cuda"),
                      (pile, "sweep_pile_rows"),
                      (pile, "selective_median_cuda")):
        monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
    vol, _ = oracle.make_synthetic_lf(S=4, V=12, U=24, C=1, seed=0)
    Depth2DComputer(vol, -1.0, 1.5, 5, device="cpu").run()
    Depth1DComputerPile(vol, -1.0, 1.5, 5, device="cpu").run()
    assert set(calls) == {"sweep_pile_pixel", "selective_median_cuda",
                          "propagate_cuda", "sweep_pile_rows"}
    calls.clear()
    Depth2DComputer(vol, -1.0, 1.5, 5, device="cpu", use_pallas=False).run()
    Depth1DComputerPile(vol, -1.0, 1.5, 5, device="cpu",
                        use_pallas=False).run()
    FineToCoarse(vol, -1.0, 1.5, 5, device="cpu", use_pallas=False).run()
    assert calls == []
