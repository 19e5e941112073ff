"""Selective median filter and plain median blur (plain PyTorch).

Counterpart of ``remotesensingproject_tpu/ops/median.py``, and the plain
version of the CUDA kernel in ``median_pallas.py``.  Reference:
selective_median_filter (rslf_depth_computation_core.hpp:663-718) and the
final 3x3 cv::medianBlur of the fusion (rslf_fine_to_coarse_core.cpp:130).

Per masked pixel, the window taps that are masked and whose s_hat frame
colour is within ``epsilon`` of the centre's (sqrt(3)-scaled norm) are
sorted, and the element n // 2 is taken.  Out-of-image taps are skipped;
unmasked output pixels are 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..types import DTYPE, norm


def _sort_taps(taps):
    """Sort a list of equal-shape tensors elementwise with an odd-even
    transposition network of min/max pairs (ascending)."""
    k = len(taps)
    taps = list(taps)
    for rnd in range(k):
        for i in range(rnd & 1, k - 1, 2):
            lo = torch.minimum(taps[i], taps[i + 1])
            hi = torch.maximum(taps[i], taps[i + 1])
            taps[i], taps[i + 1] = lo, hi
    return taps


def _pad_vu(x: torch.Tensor, w: int, w_end: int) -> torch.Tensor:
    """Zero-pad the leading two (v, u) axes by w before and w_end after."""
    if x.dim() == 2:
        return F.pad(x, (w, w_end, w, w_end))
    return F.pad(x, (0, 0, w, w_end, w, w_end))


def selective_median(src_v_u: torch.Tensor, frame_v_u_c: torch.Tensor,
                     mask_v_u: torch.Tensor, size: int,
                     epsilon: float) -> torch.Tensor:
    """Confidence- and colour-gated median over a (v, u) window.

    Args:
      src_v_u: ``[V, U]`` values to filter (disparities).
      frame_v_u_c: ``[V, U, C]`` radiances of the s_hat frame.
      mask_v_u: ``[V, U]`` bool inclusion mask.
      size: window side; epsilon: colour gate.

    Returns:
      ``[V, U]`` filtered values; 0 where the mask is unset.
    """
    V, U = src_v_u.shape
    # window rows (and columns) v - w .. v - w + size - 1: one more after
    # the centre than before it at an even size
    w = (size - 1) // 2
    pads = (w, size - 1 - w)
    srcp = _pad_vu(src_v_u, *pads)
    maskp = _pad_vu(mask_v_u.to(DTYPE), *pads)
    framep = _pad_vu(frame_v_u_c, *pads)

    sortable = []
    n = torch.zeros((V, U), dtype=torch.int64, device=src_v_u.device)
    big = torch.tensor(float("inf"), dtype=DTYPE, device=src_v_u.device)
    for dy in range(size):
        for dx in range(size):
            mv = maskp[dy:dy + V, dx:dx + U]
            fv = framep[dy:dy + V, dx:dx + U, :]
            inc = (mv > 0) & (norm(frame_v_u_c - fv) < epsilon)
            sortable.append(torch.where(inc, srcp[dy:dy + V, dx:dx + U], big))
            n = n + inc.to(torch.int64)
    ordered = _sort_taps(sortable)
    pick = torch.clamp(n // 2, 0, size * size - 1)
    med = torch.gather(torch.stack(ordered, dim=-1), -1, pick[..., None])[..., 0]
    return torch.where(mask_v_u, med, torch.zeros_like(med))


def median_blur(img: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Square-window median over the last two axes with replicated
    borders (cv::medianBlur, BORDER_REPLICATE)."""
    V, U = img.shape[-2:]
    w = (size - 1) // 2
    lead = img.shape[:-2]
    p = F.pad(img.reshape(-1, 1, V, U), (w, w, w, w), mode="replicate")
    p = p.reshape(*lead, V + 2 * w, U + 2 * w)
    taps = [p[..., dy:dy + V, dx:dx + U]
            for dy in range(size) for dx in range(size)]
    return _sort_taps(taps)[(size * size) // 2]
