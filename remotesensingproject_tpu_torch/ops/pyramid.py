"""Fine-to-coarse pyramid ops: downsample, disparity bounds, fusion.

Counterpart of ``remotesensingproject_tpu/ops/pyramid.py`` (reference:
src/rslf_fine_to_coarse_core.cpp:14-135, rslf_fine_to_coarse.hpp:179-294).

OpenCV semantics mirrored: GaussianBlur(ksize=7, sigma=0) with OpenCV's
fixed 7-tap table and BORDER_REFLECT, written as shifted sums (no
convolution, so no TF32); cv::resize INTER_LINEAR at half-pixel centres
with no antialiasing; INTER_NEAREST for the fusion's masks.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..types import DTYPE
from ..utils import profiling
from .median import median_blur

#: OpenCV getGaussianKernel(7, sigma<=0) fixed table.
GAUSSIAN7 = np.array(
    [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    dtype=np.float32)


def gaussian_blur_vu(frames: torch.Tensor, ksize: int = 7) -> torch.Tensor:
    """Separable Gaussian blur over the last two axes (v, u)."""
    if ksize != 7:
        raise NotImplementedError("reference uses _GAUSSIAN_KSIZE 7")
    w = (ksize - 1) // 2

    def conv_axis(x, axis):
        n = x.shape[axis]
        idx = torch.as_tensor(np.pad(np.arange(n), (w, w), mode="symmetric"),
                              device=x.device)
        xp = torch.index_select(x, axis, idx)  # BORDER_REFLECT
        out = torch.zeros_like(x)
        for i in range(ksize):
            out = out + float(GAUSSIAN7[i]) * xp.narrow(axis, i, n)
        return out

    return conv_axis(conv_axis(frames, frames.dim() - 2), frames.dim() - 1)


def cv_resize_shape(dim: int, scale: float = 0.5) -> int:
    """cv::resize target size for a scale factor (cvRound)."""
    return int(np.rint(dim * scale))


def _axis_weights(n_in: int, n_out: int, scale: Optional[float]):
    if scale is None:
        scale = n_in / n_out
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = (src - i0).astype(np.float32)
    # OpenCV clamps: sx < 0 -> t = 0; sx >= n - 1 -> t = 1
    t = np.where(i0 < 0, 0.0, t)
    t = np.where(i0 >= n_in - 1, 1.0, t).astype(np.float32)
    return (np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), t)


def resize_bilinear_cv(img: torch.Tensor, out_shape: Tuple[int, int],
                       scales: Optional[Tuple[float, float]] = None):
    """cv::resize INTER_LINEAR replica over the last two axes.

    ``scales`` = (src/dst per axis) replicates explicit fx/fy factors;
    by default the scales come from the sizes."""
    V, U = img.shape[-2:]
    V2, U2 = out_shape
    sv, su = scales if scales is not None else (None, None)
    dev = img.device

    def t_(a, dtype=None):
        return torch.as_tensor(a, device=dev, dtype=dtype)

    v0, v1, tv = _axis_weights(V, V2, sv)
    u0, u1, tu = _axis_weights(U, U2, su)
    tv, tu = t_(tv), t_(tu)
    a = torch.index_select(img, -2, t_(v0))
    b = torch.index_select(img, -2, t_(v1))
    x = a * (1.0 - tv)[:, None] + b * tv[:, None]
    a = torch.index_select(x, -1, t_(u0))
    b = torch.index_select(x, -1, t_(u1))
    return a * (1.0 - tu) + b * tu


def resize_nearest_cv(img: torch.Tensor, out_shape: Tuple[int, int]):
    """cv::resize INTER_NEAREST replica (sx = floor(dx * scale))."""
    V, U = img.shape[-2:]
    V2, U2 = out_shape
    vi = np.clip(np.floor(np.arange(V2) * (V / V2)).astype(np.int64), 0, V - 1)
    ui = np.clip(np.floor(np.arange(U2) * (U / U2)).astype(np.int64), 0, U - 1)
    out = torch.index_select(img, -2, torch.as_tensor(vi, device=img.device))
    return torch.index_select(out, -1, torch.as_tensor(ui, device=img.device))


def downsample_epis(epis_v_s_u_c: torch.Tensor) -> torch.Tensor:
    """One pyramid step: per-frame 7x7 Gaussian + 0.5x bilinear
    decimation; ``[V, S, U, C]`` -> ``[round(V/2), S, round(U/2), C]``."""
    V, S, U, C = epis_v_s_u_c.shape
    frames = epis_v_s_u_c.permute(1, 3, 0, 2)            # [S, C, V, U]
    blurred = gaussian_blur_vu(frames)
    small = resize_bilinear_cv(blurred, (cv_resize_shape(V),
                                         cv_resize_shape(U)),
                               scales=(2.0, 2.0))
    return small.permute(2, 0, 3, 1).contiguous()        # [V2, S, U2, C]


def bounds_from_parent(depth_up_s_v_u: torch.Tensor,
                       mask_up_s_v_u: torch.Tensor,
                       dmin_down_s_v_u: torch.Tensor,
                       dmax_down_s_v_u: torch.Tensor):
    """Per-pixel disparity bounds for the next (coarser) level.

    For each coarse pixel, parent rows v_up = min(2v, V_up-1) and v_up+1
    are scanned from u_up = min(2u, U_up-1) for the nearest masked parent
    strictly left (index >= 1) and strictly right; a row contributes its
    (d_left, d_right) pair only if both exist, and the bounds become the
    min / max over the contributed pairs (rslf_fine_to_coarse.hpp:202-294).
    """
    with profiling.span("ftc.bounds"):
        S, Vu, Uu = depth_up_s_v_u.shape
        _, Vd, Ud = dmin_down_s_v_u.shape
        dev = depth_up_s_v_u.device
        u_idx = torch.arange(Uu, device=dev)

        li = torch.where(mask_up_s_v_u & (u_idx >= 1), u_idx, -1)
        lcum = torch.cummax(li, dim=2).values
        left = torch.cat([torch.full((S, Vu, 1), -1, device=dev,
                                     dtype=lcum.dtype), lcum[:, :, :-1]],
                         dim=2)
        ri = torch.where(mask_up_s_v_u, u_idx, Uu)
        rcum = torch.flip(torch.cummin(torch.flip(ri, [2]), dim=2).values, [2])
        right = torch.cat([rcum[:, :, 1:],
                           torch.full((S, Vu, 1), Uu, device=dev,
                                      dtype=rcum.dtype)], dim=2)

        dl = torch.gather(depth_up_s_v_u, 2, torch.clamp(left, 0, Uu - 1))
        dr = torch.gather(depth_up_s_v_u, 2, torch.clamp(right, 0, Uu - 1))
        pair_ok = (left >= 1) & (right < Uu)
        pmin = torch.minimum(dl, dr)
        pmax = torch.maximum(dl, dr)

        v_up = np.minimum(2 * np.arange(Vd), Vu - 1)
        u_up = torch.as_tensor(np.minimum(2 * np.arange(Ud), Uu - 1),
                               device=dev)
        v_up2 = v_up + 1
        row2 = torch.as_tensor(v_up2 < Vu, device=dev)
        v_up = torch.as_tensor(v_up, device=dev)
        v_up2c = torch.as_tensor(np.minimum(v_up2, Vu - 1), device=dev)

        def at(arr, rows):
            return torch.index_select(torch.index_select(arr, 1, rows), 2,
                                      u_up)

        ok1 = at(pair_ok, v_up)
        ok2 = at(pair_ok, v_up2c) & row2[None, :, None]
        inf = torch.tensor(float("inf"), dtype=DTYPE, device=dev)
        new_dmin = torch.minimum(torch.where(ok1, at(pmin, v_up), inf),
                                 torch.where(ok2, at(pmin, v_up2c), inf))
        new_dmax = torch.maximum(torch.where(ok1, at(pmax, v_up), -inf),
                                 torch.where(ok2, at(pmax, v_up2c), -inf))
        any_pair = ok1 | ok2
        return (torch.where(any_pair, new_dmin, dmin_down_s_v_u),
                torch.where(any_pair, new_dmax, dmax_down_s_v_u))


def fuse_disp_maps(disp_pyr: List[torch.Tensor],
                   validity_pyr: List[torch.Tensor],
                   final_median_size: int = 3):
    """Coarse-to-fine fusion of the pyramid's disparity maps
    (rslf_fine_to_coarse_core.cpp:69-135): upsample (bilinear map,
    nearest mask), fill the finer level's invalid pixels, OR the masks,
    then a final median blur.

    Returns:
      (fused [S, V_0, U_0], validity [S, V_0, U_0] bool).
    """
    P = len(disp_pyr)
    map_down = disp_pyr[P - 1]
    mask_down = validity_pyr[P - 1]
    for p in range(P - 1, 0, -1):
        target_shape = tuple(disp_pyr[p - 1].shape[-2:])
        map_up = resize_bilinear_cv(map_down, target_shape)
        mask_up = resize_nearest_cv(mask_down, target_shape)
        fine_mask = validity_pyr[p - 1]
        map_down = torch.where(fine_mask, disp_pyr[p - 1], map_up)
        mask_down = fine_mask | mask_up
    return median_blur(map_down, final_median_size), mask_down
