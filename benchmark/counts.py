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
* the row sweep's (``ops/sweep_pallas.py`` ``_row_samples``): the same
  operations a valid sample and step, a sample valid under the row rule
  (one shift ((s_hat - s) D[d]) slope for every column, f0 its floor, t
  the rest: u >= -f0 and u <= U - 1 - (f0 + [t > 0])), on the level's
  uniform grid;
* the tile sweep's in tile mode (``ops/sweep.py`` ``sweep_pile`` with
  ``pdmin_v_u``, ``csrc/sweep_pc.cuh``'s masked mode, which runs the
  allowed candidates only): the valid samples of each pixel's candidates
  on its tile's grid that lie in its allowed range [plo - step, phi +
  step], step = (hi - lo) / (D - 1); the row and the tile sweep never cap
  the mean shift (:data:`MEAN_SHIFT_STEPS` steps);
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
                        chunk: int = 4096,
                        pdmin_v_u: Optional[torch.Tensor] = None,
                        pdmax_v_u: Optional[torch.Tensor] = None) -> int:
    """Valid samples of one sweep call over the ``active_v_u`` pixels
    ``[V, U]``, each on the uniform grid [dmin, dmax] or, given
    ``dmin_v_u`` / ``dmax_v_u``, on its own; given the allowed ranges
    ``pdmin_v_u`` / ``pdmax_v_u`` (the tile mode, ``dmin_v_u`` /
    ``dmax_v_u`` its tiles' grid), of the allowed candidates only."""
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
        delta = candidates(lo, hi, D)
        ok = valid_samples(positions(u, delta, S, s_hat, slope), U,
                           interpolation)
        if pdmin_v_u is not None:
            drange = (hi - lo)[:, None]
            step = drange / torch.full_like(drange, float(D - 1))
            allowed = ((delta >= pdmin_v_u.reshape(-1)[px][:, None] - step)
                       & (delta <= pdmax_v_u.reshape(-1)[px][:, None] + step))
            ok = ok & allowed[:, :, None]
        total += int(ok.sum())
    return total


def row_valid_samples(active_v_u: torch.Tensor, S: int, s_hat: int, D: int,
                      dmin: float, dmax: float, slope: float) -> int:
    """Valid samples of one row-sweep call over the ``active_v_u`` pixels
    ``[V, U]`` on the uniform grid [dmin, dmax], under the row rule."""
    V, U = active_v_u.shape
    dev = active_v_u.device
    per_column = active_v_u.sum(dim=0).to(torch.int64)               # [U]
    lo = torch.full((1,), f32(dmin), dtype=torch.float32, device=dev)
    hi = torch.full((1,), f32(dmax), dtype=torch.float32, device=dev)
    ds = float(s_hat) - torch.arange(S, dtype=torch.float32, device=dev)
    u = torch.arange(U, device=dev)[None, :]
    total = 0
    for delta in candidates(lo, hi, D)[0]:
        shift = ds * delta * f32(slope)                               # [S]
        f0 = torch.floor(shift)
        i0 = f0.to(torch.int64)[:, None]
        last = (U - 1) - (i0 + (shift - f0 > 0).to(torch.int64)[:, None])
        valid = (u >= -i0) & (u <= last)                              # [S, U]
        total += int((valid.to(torch.int64) * per_column).sum())
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
