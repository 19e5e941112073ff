"""Dtype and norm conventions, small numeric helpers, device selection.

PyTorch counterpart of ``remotesensingproject_tpu/types.py``.

* All compute is float32.
* Canonical layouts: EPI volume ``[V, S, U, C]``, frame volume
  ``[S, V, U, C]`` (s = temporal index, v = image row, u = column).
* 1-channel norms are scaled by sqrt(3) so that 1-channel and 3-channel
  data share the same thresholds.

Division by a plain Python number is avoided throughout the port: on a
CUDA tensor PyTorch turns ``x / c`` into ``x * (1 / c)``, which rounds
differently from the reference's IEEE division.  :func:`div` divides by
a tensor instead.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPE = torch.float32

#: sqrt(3) constant used by the reference for 1-channel norm scaling.
SQRT3 = 1.73205080757

SHADOW_NORMALIZED_LEVEL = 0.05 * SQRT3
"""Shadow cut-off on the per-pixel norm."""


def chan_scale(num_channels: int) -> float:
    """Scale applied to sums of squared per-channel values (3 for 1-ch)."""
    return 3.0 if num_channels == 1 else 1.0


def channel_sumsq(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last (channel) axis, channel 0 first.

    The fixed left-to-right order is the one the CUDA kernels use."""
    acc = torch.square(x[..., 0])
    for c in range(1, x.shape[-1]):
        acc = acc + torch.square(x[..., c])
    return acc


def normsq(x: torch.Tensor) -> torch.Tensor:
    """Squared channel norm with the reference's sqrt(3) 1-ch scaling."""
    return chan_scale(x.shape[-1]) * channel_sumsq(x)


def norm(x: torch.Tensor) -> torch.Tensor:
    """Channel norm matching rslf::norm."""
    return torch.sqrt(normsq(x))


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (C++ std::round).

    ``torch.round`` rounds half to even, so it is not used here."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (exact in float32)."""
    return float(np.float32(x))


def div(a: torch.Tensor, b) -> torch.Tensor:
    """IEEE float32 division ``a / b`` with ``b`` made a tensor on
    ``a``'s device (see the module docstring)."""
    if not torch.is_tensor(b):
        b = torch.tensor(f32(b), dtype=DTYPE, device=a.device)
    elif b.device != a.device:
        b = b.to(a.device)
    return a / b


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another.  Without a card and without an explicit request this
    raises: the port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
