"""Input normalization to float32 in ~[0, 1].

Counterpart of ``remotesensingproject_tpu/ops/normalize.py``: uint8 is
scaled by 1/255, anything else by 1/global-max unless an explicit
positive scale factor is given (rslf_depth_computation.hpp:669-704).
"""

from __future__ import annotations

import torch

from ..types import DTYPE, div


def normalize_volume(volume: torch.Tensor,
                     scale_factor: float = -1.0) -> torch.Tensor:
    """Normalize a light-field volume (any shape, uint8 or float)."""
    if volume.dtype == torch.uint8:
        return div(volume.to(DTYPE), 255.0)
    v = volume.to(DTYPE)
    if scale_factor is not None and scale_factor > 0:
        return div(v, scale_factor)
    return div(v, torch.max(v))
