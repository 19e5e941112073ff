"""Port parity: the rest of ``utils/io.py`` against the JAX package's.  YML
matrices written by one package are read by the other, both ways, and the
files are byte-equal; the one-row EPI functions, ``write_img`` read back and
``grayscale=`` give the JAX package's arrays (its PIL path: the port has no
native loader)."""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from remotesensingproject_tpu.utils import io as jio
from remotesensingproject_tpu_torch.utils import io as tio


def _mat(kind):
    rng = np.random.default_rng(3)
    return {
        "u8": rng.integers(0, 256, (4, 5), dtype=np.uint8),
        "u8x3": rng.integers(0, 256, (3, 4, 3), dtype=np.uint8),
        "f32": rng.normal(size=(5, 3)).astype(np.float32),
        "f32x3": rng.normal(size=(2, 4, 3)).astype(np.float32),
        "f64": rng.normal(size=(3, 3)),
        "i32": rng.integers(-9, 9, (2, 6), dtype=np.int32),
        "i16_as_f32": rng.integers(-9, 9, (3, 2), dtype=np.int16),
    }[kind]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kind", ["u8", "u8x3", "f32", "f32x3", "f64", "i32",
                                  "i16_as_f32"])
def test_yml_interchange(tmp_path, kind, writer):
    a = _mat(kind)
    write, read = ((tio.write_mat_to_yml, jio.read_mat_from_yml)
                   if writer == "port" else
                   (jio.write_mat_to_yml, tio.read_mat_from_yml))
    path = write(a, str(tmp_path / "w"), "m")
    got = read(str(tmp_path / "w"), "m")
    want = a.astype(np.float32) if kind == "i16_as_f32" else a
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    other = (jio if writer == "port" else tio).write_mat_to_yml(
        a, str(tmp_path / "o"), "m")
    assert Path(path).read_text() == Path(other).read_text()


def _frames(folder, rgb):
    folder.mkdir()
    rng = np.random.default_rng(5)
    shape = (4, 6, 10, 3) if rgb else (4, 6, 10)
    stack = rng.integers(0, 256, shape, dtype=np.uint8)
    for s in range(stack.shape[0]):
        Image.fromarray(stack[s]).save(folder / f"f_{s:02d}.png")
    return stack


@pytest.mark.parametrize("rgb", [False, True])
def test_row_epi_functions_match_jax(tmp_path, rgb):
    stack = _frames(tmp_path / "f", rgb)
    for imgs in ([stack] if rgb else [stack, stack[..., None]]):
        got = tio.build_row_epi_from_imgs(imgs, 2)
        np.testing.assert_array_equal(got, jio.build_row_epi_from_imgs(
            imgs, 2))
        assert got.shape == (4, 10, 3 if rgb else 1)
    for kw in ({}, dict(transpose=True), dict(grayscale=True),
               dict(rotate_180=True, grayscale=False)):
        got = tio.build_row_epi_from_path(str(tmp_path / "f"), "png", 3,
                                          **kw)
        want = jio.build_row_epi_from_path(str(tmp_path / "f"), "png", 3,
                                           **kw)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (5, 7, 3)])
def test_write_img_reads_back(tmp_path, shape):
    a = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    path = tio.write_img(a, str(tmp_path / "new"), "img")
    assert path == str(tmp_path / "new" / "img.png")
    back = tio.read_img_from_file(str(tmp_path / "new"), "img", "png")
    np.testing.assert_array_equal(back, a[..., 0] if shape[-1] == 1 else a)
    jpath = jio.write_img(a, str(tmp_path / "jax"), "img", ".png")
    assert Path(path).read_bytes() == Path(jpath).read_bytes()


@pytest.mark.parametrize("grayscale", [None, True, False])
@pytest.mark.parametrize("rgb", [False, True])
def test_grayscale_matches_jax(tmp_path, rgb, grayscale):
    _frames(tmp_path / "f", rgb)
    got = tio.read_imgs_from_folder(str(tmp_path / "f"), "png",
                                    grayscale=grayscale)
    want = jio.read_imgs_from_folder(str(tmp_path / "f"), "png",
                                     grayscale=grayscale, use_native=False)
    np.testing.assert_array_equal(got, want)
    channels = 3 if (grayscale is False or (rgb and grayscale is None)) else 1
    assert got.shape == (4, 6, 10, channels)
    one = tio.read_img_from_file(str(tmp_path / "f"), "f_01", "png",
                                 grayscale, transpose=True)
    np.testing.assert_array_equal(one, jio.read_img_from_file(
        str(tmp_path / "f"), "f_01", "png", grayscale, transpose=True))
