"""Sub-pixel horizontal translation by a DFT phase shift.

Counterpart of ``remotesensingproject_tpu/ops/fft.py`` (reference:
rslf::fft_htranslate, src/rslf_types.cpp:149-209), which the reference
implements but its main path never calls; nothing in the port calls it
either.

Divergences from the reference, as in the JAX package: the reference's
inverse DFT omits DFT_SCALE, so its output is scaled by N
(src/rslf_types.cpp:208), and it takes raw bin indices j = 0..N-1 as
frequencies (:170-174), which corrupts fractional shifts of real signals.
This version is normalized (a translate of a constant row is that row) and
takes signed frequencies; the two agree for integer shifts.
"""

from __future__ import annotations

import math

import torch


def fft_htranslate(rows: torch.Tensor, shift: float) -> torch.Tensor:
    """Translate each row by ``shift`` pixels (rightward positive) with the
    DFT shift theorem: phase -2 pi shift f on the forward DFT, then the
    inverse, the real part in ``rows``' type.

    Args:
      rows: ``[..., N]`` real rows.
      shift: translation in pixels (may be fractional).
    """
    n = rows.shape[-1]
    spec = torch.fft.fft(rows, dim=-1)
    freq = torch.fft.fftfreq(n, device=rows.device, dtype=torch.float64)
    ph = (-2.0 * math.pi * float(shift)) * freq
    rot = torch.polar(torch.ones_like(ph), ph).to(spec.dtype)
    return torch.fft.ifft(spec * rot, dim=-1).real.to(rows.dtype)
