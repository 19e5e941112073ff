"""Frame reading, EPI volume construction and npz dumps.

Counterpart of part of ``remotesensingproject_tpu/utils/io.py``
(reference: include/rslf_io.hpp, src/rslf_io.cpp): the folder scan with
lexicographic sort, PIL image reading, the EPI reslice as one transpose,
and npz writing.  The JAX package's native threaded loader is not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np


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
                       transpose: bool = False,
                       rotate_180: bool = False) -> np.ndarray:
    """Read one image in the file's own format."""
    from PIL import Image

    path = os.path.join(path_to_folder, name_we + "." + extension.lstrip("."))
    with Image.open(path) as im:
        a = np.asarray(im)
    if transpose:
        a = np.swapaxes(a, 0, 1)
    if rotate_180:
        a = a[::-1, ::-1].copy()
    return a


def read_imgs_from_folder(path_to_folder: str, extension: str,
                          transpose: bool = False,
                          rotate_180: bool = False) -> np.ndarray:
    """Read a frame stack ``[S, H, W, C]`` with PIL."""
    names = list_images(path_to_folder, extension)
    if not names:
        raise FileNotFoundError(f"no *.{extension} files in {path_to_folder}")
    stack = np.stack([read_img_from_file(path_to_folder, n, extension,
                                         transpose, rotate_180)
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


def write_npz(path_to_folder: str, name_we: str, **arrays) -> str:
    os.makedirs(path_to_folder, exist_ok=True)
    path = os.path.join(path_to_folder, name_we + ".npz")
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in arrays.items()})
    return path
