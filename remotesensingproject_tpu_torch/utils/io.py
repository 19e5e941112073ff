"""Frame reading, EPI construction, image, npz and YML writing.

Counterpart of ``remotesensingproject_tpu/utils/io.py`` (reference:
include/rslf_io.hpp, src/rslf_io.cpp): the folder scan with lexicographic
sort, image reading (the threaded native decoder of ``native/`` for a
folder, PIL for one file and as the fallback), the EPI reslice as one
transpose, one-row EPIs, PNG and npz writing, and OpenCV-FileStorage-
compatible YML matrices (the files are interchangeable with the JAX
package's).
"""

from __future__ import annotations

import os
import re
import warnings
from typing import List, Optional

import numpy as np

from ..native import loader as native_loader


def list_images(path_to_folder: str, extension: str) -> List[str]:
    """File stems with the given extension, lexicographically sorted."""
    extension = extension.lstrip(".")
    names = []
    for fn in os.listdir(path_to_folder):
        stem, dot, ext = fn.rpartition(".")
        if dot and ext == extension:
            names.append(stem)
    names.sort()
    return names


def read_img_from_file(path_to_folder: str, name_we: str, extension: str,
                       grayscale: Optional[bool] = None,
                       transpose: bool = False,
                       rotate_180: bool = False) -> np.ndarray:
    """Read one image (rslf::read_img_from_file, src/rslf_io.cpp:11-44).

    Args:
      grayscale: None keeps the file's own format; True forces one
        channel, False forces RGB.
    """
    from PIL import Image

    path = os.path.join(path_to_folder, name_we + "." + extension.lstrip("."))
    with Image.open(path) as im:
        if grayscale is True and im.mode not in ("F", "I", "L", "I;16"):
            im = im.convert("L")
        elif grayscale is False and im.mode != "RGB":
            im = im.convert("RGB")
        a = np.asarray(im)
    if transpose:
        a = np.swapaxes(a, 0, 1)
    if rotate_180:
        a = a[::-1, ::-1].copy()
    return a


def read_imgs_from_folder(path_to_folder: str, extension: str,
                          grayscale: Optional[bool] = None,
                          transpose: bool = False,
                          rotate_180: bool = False,
                          use_native: bool = True) -> np.ndarray:
    """Read a frame stack ``[S, H, W, C]`` (src/rslf_io.cpp:46-96), with
    the native loader (``native/``, built at first use) unless
    ``use_native`` is False or ``grayscale`` asks for a conversion, which
    PIL makes.  Where the loader cannot be built or cannot decode the
    files, a RuntimeWarning says so and PIL reads them: on a 100-frame
    stack the threaded decoder against per-file PIL is the difference
    between ingest hidden and ingest a visible serial stage, so the
    fallback is never quiet.  Transpose and rotation are applied once, as
    in the JAX package (the reference applies them twice for folder
    reads, which its callers do not intend)."""
    names = list_images(path_to_folder, extension)
    if not names:
        raise FileNotFoundError(f"no *.{extension} files in {path_to_folder}")
    if use_native and grayscale is None:
        try:
            stack = native_loader.read_stack(path_to_folder, names,
                                             extension)
        except (OSError, RuntimeError) as e:
            warnings.warn(f"native loader unavailable ({type(e).__name__}: "
                          f"{e}); falling back to single-threaded PIL "
                          f"ingest", RuntimeWarning, stacklevel=2)
        else:
            if stack is not None:
                if transpose:
                    stack = np.swapaxes(stack, 1, 2)
                if rotate_180:
                    stack = stack[:, ::-1, ::-1].copy()
                return stack
            warnings.warn(f"native loader could not decode *.{extension} in "
                          f"{path_to_folder} (unsupported format, corrupt "
                          f"file or frames of different shapes); falling "
                          f"back to single-threaded PIL ingest",
                          RuntimeWarning, stacklevel=2)
    stack = np.stack([read_img_from_file(path_to_folder, n, extension,
                                         grayscale, transpose, rotate_180)
                      for n in names])
    if stack.ndim == 3:
        stack = stack[..., None]
    return stack


def build_epis_from_imgs(imgs_s_h_w_c: np.ndarray) -> np.ndarray:
    """Frame stack -> EPI volume ``[V, S, U, C]`` (the v-th EPI is the
    stack of row v over all frames)."""
    a = np.asarray(imgs_s_h_w_c)
    if a.ndim == 3:
        a = a[..., None]
    return np.ascontiguousarray(np.swapaxes(a, 0, 1))


def build_row_epi_from_imgs(imgs_s_h_w_c: np.ndarray, row: int) -> np.ndarray:
    """One EPI ``[S, U, C]``: row ``row`` of every frame
    (src/rslf_io.cpp:158-192)."""
    a = np.asarray(imgs_s_h_w_c)
    if a.ndim == 3:
        a = a[..., None]
    return a[:, row]


def build_row_epi_from_path(path_to_folder: str, extension: str, row: int,
                            **kwargs) -> np.ndarray:
    """One EPI ``[S, U, C]`` read frame by frame, keeping only row ``row``
    of each (src/rslf_io.cpp:229-296); ``kwargs`` go to
    :func:`read_img_from_file`."""
    rows = [read_img_from_file(path_to_folder, n, extension, **kwargs)[row]
            for n in list_images(path_to_folder, extension)]
    epi = np.stack(rows)
    if epi.ndim == 2:
        epi = epi[..., None]
    return epi


def write_img(img: np.ndarray, path_to_folder: str, name_we: str,
              extension: str = "png") -> str:
    """Write an image with PIL (rslf::write_mat_to_imgfile,
    src/rslf_io.cpp:120-133)."""
    from PIL import Image

    os.makedirs(path_to_folder, exist_ok=True)
    path = os.path.join(path_to_folder, name_we + "." + extension.lstrip("."))
    a = np.asarray(img)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    Image.fromarray(a).save(path)
    return path


def write_npz(path_to_folder: str, name_we: str, **arrays) -> str:
    os.makedirs(path_to_folder, exist_ok=True)
    path = os.path.join(path_to_folder, name_we + ".npz")
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in arrays.items()})
    return path


# OpenCV FileStorage YML interop (rslf::write_mat_to_yml /
# read_mat_from_yml, src/rslf_io.cpp:98-156)

_CV_DT = {"u": np.uint8, "f": np.float32, "d": np.float64, "i": np.int32}


def write_mat_to_yml(img: np.ndarray, path_to_folder: str, name_we: str,
                     extension: str = "yml") -> str:
    """Write a matrix in OpenCV FileStorage YAML format (readable by the
    reference's read_mat_from_yml); types other than uint8, int32 and
    float64 are written as float32."""
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[..., None]
    rows, cols, ch = a.shape
    dt = {np.dtype(np.uint8): "u", np.dtype(np.float64): "d",
          np.dtype(np.int32): "i"}.get(a.dtype, "f")
    if dt == "f":
        a = a.astype(np.float32)
    dts = dt if ch == 1 else f"{ch}{dt}"
    os.makedirs(path_to_folder, exist_ok=True)
    path = os.path.join(path_to_folder, name_we + "." + extension.lstrip("."))
    values = ", ".join(repr(float(x)) if dt in "fd" else str(int(x))
                       for x in a.reshape(-1))
    with open(path, "w") as f:
        f.write("%YAML:1.0\n---\n")
        f.write("img: !!opencv-matrix\n")
        f.write(f"   rows: {rows}\n   cols: {cols}\n   dt: {dts}\n")
        f.write(f"   data: [ {values} ]\n")
    return path


def read_mat_from_yml(path_to_folder: str, name_we: str,
                      extension: str = "yml") -> np.ndarray:
    """Read an OpenCV FileStorage YAML matrix (one top-level node)."""
    path = os.path.join(path_to_folder, name_we + "." + extension.lstrip("."))
    with open(path) as f:
        text = f.read()
    rows = int(re.search(r"rows:\s*(\d+)", text).group(1))
    cols = int(re.search(r"cols:\s*(\d+)", text).group(1))
    dts = re.search(r"dt:\s*\"?(\w+)\"?", text).group(1)
    m = re.match(r"(\d*)([ufdi])", dts)
    ch = int(m.group(1)) if m.group(1) else 1
    data = re.search(r"data:\s*\[(.*?)\]", text, re.S).group(1)
    vals = np.array([float(x) for x in data.replace("\n", " ").split(",")],
                    dtype=_CV_DT[m.group(2)])
    a = vals.reshape(rows, cols, ch)
    return a[..., 0] if ch == 1 else a
