"""Operations and bytes of the port's kernels, counted from their inputs,
and the card's published peaks.

Frozen from the program's arithmetic at commit
030ba3ae819e6d9e24ff92eb0e364588e49180de, so that a roofline share reads
the same work whatever implements the kernel:

* ``PEAK_FP32`` and ``PEAK_BYTES``: ``chip_smoke.py:152-153`` (one H100
  SXM, NVIDIA's data sheet: 67 TFLOP/s fp32 outside the tensor cores,
  3.35 TB/s of HBM3);
* the sweep's operations: valid samples x mean-shift steps x
  ``4 C + 5`` (``ops/sweep_pallas_pixel.py:41-54``), a sample (s, d) of a
  pixel valid where its sheared position is inside the row
  (``ops/sweep.py`` ``_radiances``: I = u + ((s_hat - s) D[d]) slope,
  linear: floor(I) >= 0 and ceil(I) <= U - 1; nearest: the rounded I in
  [0, U - 1]);
* the median's bytes: ``chip_smoke.py:826``, each input read once and the
  output written once (source float32, mask uint8, frame C float32, out
  float32).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

#: the reference's truncated mean shift (core.hpp:16) and fast mode's cap
MEAN_SHIFT_STEPS = 10
FAST_MEAN_SHIFT_STEPS = 5


def f32(x: float) -> float:
    return float(np.float32(x))


def flops_per_sample_step(C: int) -> int:
    """fp32 operations per valid sample and mean-shift step: C diffs,
    squares and (C - 1) adds, the scale, 1 - x and max, the K sum, and per
    channel max / multiply / add of the r_bar numerator."""
    return 4 * C + 5


def mean_shift_steps(fast: bool, interpolation: str) -> int:
    """The steps the parameters fix: 10, or 5 in fast mode under linear
    interpolation."""
    if fast and interpolation == "linear":
        return FAST_MEAN_SHIFT_STEPS
    return MEAN_SHIFT_STEPS


def candidates(lo: torch.Tensor, hi: torch.Tensor, D: int) -> torch.Tensor:
    """``[P, D]`` candidate disparities of pixels with grid bounds ``lo``,
    ``hi`` ``[P]``: lo + ((hi - lo) d) / (D - 1) in float32, the order of
    the reference (core.hpp:545-548)."""
    drange = (hi - lo)[:, None]
    den = torch.full_like(drange, float(D - 1))
    d = torch.arange(D, dtype=torch.float32, device=lo.device)[None, :]
    return lo[:, None] + (drange * d) / den


def positions(u: torch.Tensor, delta: torch.Tensor, S: int, s_hat: int,
              slope: float) -> torch.Tensor:
    """``[P, D, S]`` sheared sample positions u + ((s_hat - s) D[d]) slope
    of pixels at columns ``u`` ``[P]`` with candidates ``delta``
    ``[P, D]``."""
    ds = float(s_hat) - torch.arange(S, dtype=torch.float32,
                                     device=u.device)
    shift = ds[None, None, :] * delta[:, :, None] * f32(slope)
    return u.to(torch.float32)[:, None, None] + shift


def valid_samples(positions_pds: torch.Tensor, U: int,
                  interpolation: str) -> torch.Tensor:
    """``[P, D, S]`` bool: the samples inside the row."""
    idx = positions_pds
    if interpolation == "nearest":
        ri = torch.sign(idx) * torch.floor(torch.abs(idx) + 0.5)
        return (ri >= 0) & (ri <= U - 1)
    return (torch.floor(idx) >= 0) & (torch.ceil(idx) <= U - 1)


def sweep_valid_samples(active_v_u: torch.Tensor, S: int, s_hat: int,
                        D: int, dmin: float, dmax: float, slope: float,
                        interpolation: str,
                        dmin_v_u: Optional[torch.Tensor] = None,
                        dmax_v_u: Optional[torch.Tensor] = None,
                        chunk: int = 4096) -> int:
    """Valid samples of one sweep call over the ``active_v_u`` pixels
    ``[V, U]``, each on the uniform grid [dmin, dmax] or, given
    ``dmin_v_u`` / ``dmax_v_u``, on its own."""
    V, U = active_v_u.shape
    flat = torch.nonzero(active_v_u.reshape(-1)).reshape(-1)
    total = 0
    for i in range(0, flat.numel(), chunk):
        px = flat[i:i + chunk]
        u = px % U
        if dmin_v_u is None:
            lo = torch.full(px.shape, f32(dmin), dtype=torch.float32,
                            device=px.device)
            hi = torch.full(px.shape, f32(dmax), dtype=torch.float32,
                            device=px.device)
        else:
            lo = dmin_v_u.reshape(-1)[px]
            hi = dmax_v_u.reshape(-1)[px]
        pos = positions(u, candidates(lo, hi, D), S, s_hat, slope)
        total += int(valid_samples(pos, U, interpolation).sum())
    return total


def sweep_flops(valid: int, steps: int, C: int) -> int:
    """fp32 operations of a sweep that ran ``valid`` samples."""
    return valid * steps * flops_per_sample_step(C)


def median_bytes(V: int, U: int, C: int) -> int:
    """Bytes a selective median over a ``[V, U]`` plane of C channels
    needs to move."""
    return V * U * (4 + 1 + 4 * C + 4)


def roofline_pct(seconds_at_peak: float, device_seconds: float):
    """The least time the card could take over the time it took, in %;
    None where there is no device time to compare with."""
    if not device_seconds or device_seconds <= 0:
        return None
    return 100.0 * seconds_at_peak / device_seconds
