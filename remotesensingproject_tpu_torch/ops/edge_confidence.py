"""Edge confidence C_e and its threshold mask.

Counterpart of ``remotesensingproject_tpu/ops/edge_confidence.py``
(reference: rslf_depth_computation_core.hpp:426-478, 901-931):

    C_e(s, v, u) = sum_{o in [-w, w], o != 0} sum_c (E(s,v,u) - E(s,v,u+o))^2

with reflect-101 borders along u, written as shifted sums (no
convolution, so no TF32).  Shadow cut: C_e = 0 where the sqrt(3)-scaled
pixel norm is below ``shadow_level``.  Mask: C_e > threshold, optionally
followed by a cv2-exact elliptical opening of the (v, u) planes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DepthParams
from ..types import channel_sumsq, norm


def _reflect101_index(n: int, w: int) -> np.ndarray:
    """Source index of each column of a reflect-101 padded axis."""
    return np.pad(np.arange(n), (w, w), mode="reflect")


def edge_confidence_volume(epis_v_s_u_c: torch.Tensor, params: DepthParams):
    """C_e and mask for every (v, s, u).

    Args:
      epis_v_s_u_c: ``[V, S, U, C]`` normalized volume.

    Returns:
      (ce, mask): ``[V, S, U]`` float32 and bool.
    """
    e = epis_v_s_u_c
    w = (params.edge_confidence_filter_size - 1) // 2
    U = e.shape[2]
    idx = torch.as_tensor(_reflect101_index(U, w), device=e.device)
    ep = torch.index_select(e, 2, idx)

    ce = torch.zeros(e.shape[:3], dtype=e.dtype, device=e.device)
    for o in range(-w, w + 1):
        if o == 0:
            continue
        diff = e - ep[:, :, w + o: w + o + U]
        ce = ce + channel_sumsq(diff)

    if params.cut_shadows:
        ce = torch.where(norm(e) < params.shadow_level,
                         torch.zeros_like(ce), ce)

    mask = ce > params.edge_score_threshold
    if params.edge_confidence_opening_size > 1:
        mask = _morph_open_vu(mask, params.edge_confidence_opening_size)
    return ce, mask


def edge_confidence_frame(frame_v_u_c: torch.Tensor, params: DepthParams):
    """C_e and mask of one frame (a fixed s over all (v, u)); each row v is
    independent and the window runs along u (core.hpp:728-770).

    Returns:
      (ce, mask): ``[V, U]``.
    """
    ce, mask = edge_confidence_volume(frame_v_u_c[:, None], params)
    return ce[:, 0], mask[:, 0]


def _morph_open_vu(mask_v_s_u: torch.Tensor, size: int) -> torch.Tensor:
    """Morphological opening of the (v, u) mask planes, per s, with
    cv::getStructuringElement(MORPH_ELLIPSE) (core.hpp:759-769)."""
    se = _ellipse_element(size)
    m = mask_v_s_u.to(torch.float32)
    opened = _morph(_morph(m, se, erode=True), se, erode=False)
    return opened > 0.5


def _ellipse_element(n: int) -> np.ndarray:
    """cv::getStructuringElement(MORPH_ELLIPSE, (n, n)) exact replica:
    per row, columns [c - dx, c + dx] with
    dx = cvRound(c * sqrt(r*r - dy*dy) / r), r = c = n // 2."""
    if n <= 1:
        return np.ones((max(n, 1), max(n, 1)), bool)
    r = c = n // 2
    inv_r2 = 1.0 / (r * r)
    el = np.zeros((n, n), bool)
    for i in range(n):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
            el[i, max(c - dx, 0):min(c + dx + 1, n)] = True
    return el


def _morph(m_v_s_u: torch.Tensor, se: np.ndarray, erode: bool):
    """Erosion / dilation with OpenCV's anchor (n//2, n//2) and the same
    offsets for both operations."""
    n = se.shape[0]
    a = n // 2
    V, S, U = m_v_s_u.shape
    init = 1.0 if erode else 0.0
    # pad (v, u) with the neutral element: F.pad pads the last dims first
    mp = torch.nn.functional.pad(
        m_v_s_u.permute(1, 0, 2), (a, n - 1 - a, a, n - 1 - a),
        value=init).permute(1, 0, 2)
    out = torch.full((V, S, U), init, dtype=m_v_s_u.dtype,
                     device=m_v_s_u.device)
    for dy in range(n):
        for dx in range(n):
            if not se[dy, dx]:
                continue
            win = mp[dy:dy + V, :, dx:dx + U]
            out = torch.minimum(out, win) if erode else torch.maximum(out, win)
    return out
