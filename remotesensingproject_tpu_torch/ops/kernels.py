"""Radiance-consistency score kernel (plain PyTorch).

Counterpart of ``remotesensingproject_tpu/ops/kernels.py`` (reference:
rslf::BandwidthKernel, include/rslf_kernels.hpp + src/rslf_kernels.cpp):
the truncated parabolic kernel K(x) = max(0, 1 - ||x/h||^2), with the
1-channel squared norm scaled by 3 for threshold parity with RGB and NaN
inputs mapped to 0 (the reference gets this via cv::max with 0;
``torch.maximum`` propagates NaN, so NaN is masked explicitly).
"""

from __future__ import annotations

import torch

from ..types import chan_scale


def _scaled_sq(diff: torch.Tensor, h: float, axis: int) -> torch.Tensor:
    c = diff.shape[axis]
    return (chan_scale(c) / (h * h)) * torch.sum(torch.square(diff), dim=axis)


def bandwidth_kernel(diff: torch.Tensor, h: float,
                     axis: int = -1) -> torch.Tensor:
    """K(diff) reduced over the channel axis.

    Args:
      diff: ``[..., C]`` radiance differences (may contain NaN).
      h: bandwidth (default 0.2 in the reference, core.hpp:26).
      axis: channel axis.

    Returns:
      ``[...]`` kernel values in [0, 1]; NaN slots give 0.
    """
    k = 1.0 - _scaled_sq(diff, h, axis)
    return torch.where(torch.isnan(k), torch.zeros_like(k),
                       torch.clamp_min(k, 0.0))


def bandwidth_kernel_masked(diff: torch.Tensor, valid: torch.Tensor, h: float,
                            axis: int = -1) -> torch.Tensor:
    """NaN-free variant: ``valid`` marks real samples, invalid slots give 0.

    Equal to :func:`bandwidth_kernel` when ``diff`` has had its NaNs
    replaced by finite values and ``valid`` is the non-NaN mask."""
    k = torch.clamp_min(1.0 - _scaled_sq(diff, h, axis), 0.0)
    return torch.where(valid, k, torch.zeros_like(k))
