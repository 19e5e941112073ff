"""The port's native frame loader (``remotesensingproject_tpu_torch/native``),
built here with g++, against PIL and the JAX package's loader.

Every format the reference's data comes in, byte-equal in values and
dtype to PIL's read: float32, uint8 (grey and RGB) and uint16 TIFF,
uncompressed and LZW; 8- and 16-bit grey PNG, 8-bit RGB PNG and palette
PNG (which the loader expands to RGB: PIL's RGB conversion); grey and RGB
JPEG.  Also: the JAX package's ``read_imgs_from_folder(use_native=True)``
where its library loads, the loud fallback to PIL, ``grayscale``,
``transpose`` and ``rotate_180``, and a failed build."""

import warnings

import numpy as np
import pytest
from PIL import Image

from remotesensingproject_tpu.native import loader as j_loader
from remotesensingproject_tpu.utils import io as j_io
from remotesensingproject_tpu_torch.native import loader
from remotesensingproject_tpu_torch.utils import io

S, H, W = 3, 13, 21


def _frames(kind, seed=0):
    """S frames and the PIL mode to write them in."""
    rng = np.random.default_rng(seed)
    if kind == "f32":
        return rng.uniform(-2, 300, (S, H, W)).astype(np.float32), "F"
    if kind == "u16":
        return rng.integers(0, 65536, (S, H, W), dtype=np.uint16), None
    if kind == "rgb":
        return rng.integers(0, 256, (S, H, W, 3), dtype=np.uint8), "RGB"
    if kind == "palette":
        return rng.integers(0, 16, (S, H, W), dtype=np.uint8), "P"
    return rng.integers(0, 256, (S, H, W), dtype=np.uint8), "L"


def _write(folder, kind, ext, **save):
    folder.mkdir(exist_ok=True)
    frames, mode = _frames(kind)
    for s, a in enumerate(frames):
        im = Image.fromarray(a, mode) if mode else Image.fromarray(a)
        if mode == "P":
            im.putpalette(list(np.random.default_rng(7).integers(
                0, 256, 768)))
        im.save(folder / f"frame_{s:02d}.{ext}", **save)
    return str(folder)


CASES = [
    ("f32", "tif", {}), ("f32", "tif", {"compression": "tiff_lzw"}),
    ("grey", "tif", {}), ("grey", "tif", {"compression": "tiff_lzw"}),
    ("rgb", "tif", {}), ("rgb", "tif", {"compression": "tiff_lzw"}),
    ("u16", "tif", {}), ("u16", "tif", {"compression": "tiff_lzw"}),
    ("grey", "png", {}), ("u16", "png", {}), ("rgb", "png", {}),
    ("palette", "png", {}),
    ("grey", "jpg", {"quality": 90}), ("rgb", "jpg", {"quality": 90}),
]


def _case_id(case):
    kind, ext, save = case
    return f"{kind}-{ext}" + ("-lzw" if save.get("compression") else "")


@pytest.mark.parametrize("kind,ext,save", CASES, ids=map(_case_id, CASES))
def test_native_equals_pil(tmp_path, kind, ext, save):
    folder = _write(tmp_path / "f", kind, ext, **save)
    names = io.list_images(folder, ext)
    got = loader.read_stack(folder, names, ext)
    assert got is not None
    # a palette comes out as RGB: PIL's own RGB conversion of the frame
    grey = False if kind == "palette" else None
    want = np.stack([io.read_img_from_file(folder, n, ext, grayscale=grey)
                     for n in names])
    if want.ndim == 3:
        want = want[..., None]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        stack = io.read_imgs_from_folder(folder, ext)
    assert stack.dtype == got.dtype
    np.testing.assert_array_equal(stack, got)
    if j_loader._load() is not None:
        jax_stack = j_io.read_imgs_from_folder(folder, ext, use_native=True)
        assert jax_stack.dtype == got.dtype
        np.testing.assert_array_equal(jax_stack, got)


def test_strips16_native_equals_pil():
    got = io.read_imgs_from_folder("data/strips16", "png")
    want = io.read_imgs_from_folder("data/strips16", "png", use_native=False)
    assert got.shape == (16, 48, 96, 1) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("transpose,rotate", [(True, False), (False, True),
                                              (True, True)])
def test_transpose_and_rotate_once(tmp_path, transpose, rotate):
    folder = _write(tmp_path / "f", "rgb", "png")
    got = io.read_imgs_from_folder(folder, "png", transpose=transpose,
                                   rotate_180=rotate)
    want = io.read_imgs_from_folder(folder, "png", transpose=transpose,
                                    rotate_180=rotate, use_native=False)
    assert got.shape == want.shape == ((S, W, H, 3) if transpose
                                       else (S, H, W, 3))
    np.testing.assert_array_equal(got, want)


def test_grayscale_goes_through_pil_without_a_warning(tmp_path):
    folder = _write(tmp_path / "f", "rgb", "png")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = io.read_imgs_from_folder(folder, "png", grayscale=True)
    want = np.stack([np.asarray(Image.open(f"{folder}/frame_{s:02d}.png")
                                .convert("L")) for s in range(S)])[..., None]
    np.testing.assert_array_equal(got, want)


def _fallback(folder, ext):
    with pytest.warns(RuntimeWarning,
                      match="falling back to single-threaded PIL"):
        return io.read_imgs_from_folder(folder, ext)


def test_fallback_warns_when_the_loader_breaks(tmp_path, monkeypatch):
    folder = _write(tmp_path / "f", "grey", "png")

    def broken(*a, **k):
        raise OSError("simulated broken library")

    monkeypatch.setattr(loader, "read_stack", broken)
    got = _fallback(folder, "png")
    np.testing.assert_array_equal(got, io.read_imgs_from_folder(
        folder, "png", use_native=False))


def test_fallback_warns_when_the_build_fails(tmp_path, monkeypatch):
    folder = _write(tmp_path / "f", "grey", "png")
    monkeypatch.setattr(loader, "_lib", None)

    def no_build():
        raise RuntimeError("simulated failed build")

    monkeypatch.setattr(loader, "build", no_build)
    assert _fallback(folder, "png").shape == (S, H, W, 1)


def test_fallback_warns_on_an_undecodable_format(tmp_path):
    folder = _write(tmp_path / "f", "grey", "bmp")
    assert loader.read_stack(folder, io.list_images(folder, "bmp"),
                             "bmp") is None
    got = _fallback(folder, "bmp")
    np.testing.assert_array_equal(got[..., 0], _frames("grey")[0])


def test_frames_of_different_shapes_are_not_decoded(tmp_path):
    folder = tmp_path / "f"
    folder.mkdir()
    Image.fromarray(np.zeros((4, 5), np.uint8)).save(folder / "a.png")
    Image.fromarray(np.zeros((4, 6), np.uint8)).save(folder / "b.png")
    assert loader.read_stack(str(folder), ["a", "b"], "png") is None


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "loader.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(loader, "SOURCE", bad)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        loader.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_path_names_source_and_flags(tmp_path, monkeypatch):
    path = loader.library_path()
    assert path.parent == loader.BUILD_DIR
    assert path.name.startswith("librslf_native-")
    monkeypatch.setattr(loader, "CXXFLAGS", loader.CXXFLAGS + ["-g"])
    assert loader.library_path() != path
