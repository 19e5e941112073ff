"""Dense slope sweep with mean-shift radiance scoring (plain PyTorch).

Counterpart of ``remotesensingproject_tpu/ops/sweep.py`` (the XLA path)
and the plain version of the CUDA pixel sweep (``sweep_pallas_pixel.py``)
and of the CUDA tile sweep (``sweep_pallas_perpixel.py``, whose masked
tile mode ``sweep_pile`` takes with ``pdmin_v_u`` / ``pdmax_v_u``).
Reference: compute_1D_depth_epi, rslf_depth_computation_core.hpp:480-661.

Every (v, u) is swept densely; callers merge results at active pixels.
Numerics mirrored exactly:

* candidate disparities  D[d] = dmin + (d * (dmax - dmin)) / (dim_d - 1)
  in float32, per pixel (core.hpp:545-548);
* sheared sample index  I[s, d] = u + ((s_hat - s) * D[d]) * slope;
* linear interpolation, a sample valid iff floor(I) >= 0 and
  ceil(I) <= U - 1, with card_R the valid count;
* ``u_valid`` (lo, hi), the window of valid columns of a u-haloed block
  (JAX ``ops/sweep.py:62-100``): I is taken in the window's columns,
  I = (u - lo) + ..., valid against [0, hi - lo], and columns lo + floor(I)
  and lo + ceil(I) are read, clamped to [0, U - 1], so that a haloed
  block's positions are the whole image's bit for bit (the JAX package
  takes them in the block's columns: the same up to the last ulp);
* ``mean_shift_max_iter`` truncated mean-shift iterations, NaN -> 0 and
  r_bar floored at 0; the score uses the kernel of the LAST iteration
  while the reported r_bar has all updates applied;
* score = sum_s K / card_R, 0 where card_R == 0; first-max argmax over d;
* score_mean is the sequential sum of the scores over d, / dim_d.

Sums over s run in a fixed sequential order (s = 0, 1, ...), the order
the CUDA kernel uses, so that the two agree on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import DepthParams
from ..types import DTYPE, chan_scale, channel_sumsq, div, f32


class SweepResult(NamedTuple):
    """Dense per-(v, u) sweep outputs (before masking/merge)."""

    best_score: torch.Tensor  # [V, U] max_d score
    score_mean: torch.Tensor  # [V, U] mean over all d slots
    best_depth: torch.Tensor  # [V, U] disparity at the argmax d
    rbar: torch.Tensor        # [V, U, C] converged dominant radiance
    k_best: torch.Tensor      # [V, S, U] K(r - rbar) at the winning d
                              # (zeros when with_k_best=False)


def candidate_disparities(dmin: float, dmax: float, dim_d: int) -> np.ndarray:
    """The uniform candidate grid with the reference's float32 op order
    (core.hpp:548)."""
    f = np.float32
    rng = f(f(dmax) - f(dmin))
    return np.array(
        [f(f(dmin) + f(f(f(d) * rng) / f(dim_d - 1))) for d in range(dim_d)],
        np.float32)


def _sum_s(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 (s), sequentially from s = 0."""
    acc = x[:, 0]
    for s in range(1, x.shape[1]):
        acc = acc + x[:, s]
    return acc


def _radiances(epis, delta_v_u, ds_s, u_idx, slope, interpolation, lo=0,
               hi=None):
    """Sheared radiance samples for one candidate plane, ``u_idx`` the
    columns in the window [lo, hi] of valid columns (u - lo; the default
    window is [0, U - 1]).

    Returns (valpos, valraw [V, S, U, C], valid [V, S, U] bool)."""
    V, S, U, C = epis.shape
    hi = U - 1 if hi is None else hi
    shift = ds_s[None, :, None] * delta_v_u[:, None, :] * slope  # [V, S, U]
    idx = u_idx + shift

    def gather(i):
        ii = i.to(torch.int64)[..., None].expand(V, S, U, C)
        return torch.gather(epis, 2, ii)

    if interpolation == "nearest":
        ri = torch.sign(idx) * torch.floor(torch.abs(idx) + 0.5)
        valid = (ri >= 0) & (ri <= hi - lo)
        val = gather(torch.clamp(ri + lo, 0, U - 1))
    else:
        fi = torch.floor(idx)
        ci = torch.ceil(idx)
        t = idx - fi
        valid = (fi >= 0) & (ci <= hi - lo)
        a = gather(torch.clamp(fi + lo, 0, U - 1))
        b = gather(torch.clamp(ci + lo, 0, U - 1))
        tt = t[..., None]
        val = (1.0 - tt) * a + tt * b
    valid_c = valid[..., None]
    zero = torch.zeros((), dtype=DTYPE, device=epis.device)
    valraw = torch.where(valid_c, val, zero)
    valpos = torch.where(valid_c, torch.clamp_min(val, 0.0), zero)
    return valpos, valraw, valid


def _mean_shift(valpos, valraw, valid, rbar0, params: DepthParams):
    """Truncated mean shift; returns (sum_s K_last, rbar, K_last)."""
    C = valraw.shape[-1]
    a = f32(chan_scale(C) / (params.kernel_h * params.kernel_h))
    validf = valid.to(DTYPE)
    rbar = rbar0
    k = torch.zeros(valid.shape, dtype=DTYPE, device=valraw.device)
    for _ in range(params.mean_shift_max_iter):
        diff = valraw - rbar[:, None]
        ksq = a * channel_sumsq(diff)
        k = torch.clamp_min(1.0 - ksq, 0.0) * validf       # [V, S, U]
        sum_k = _sum_s(k)[..., None]                        # [V, U, 1]
        sum_rk = _sum_s(valpos * k[..., None])              # [V, U, C]
        rbar = torch.where(sum_k > 0, sum_rk / sum_k,
                           torch.zeros((), dtype=DTYPE, device=k.device))
    return _sum_s(k), rbar, k


def sweep_pile(epis_v_s_u_c: torch.Tensor, dmin_v_u: torch.Tensor,
               dmax_v_u: torch.Tensor, dim_d: int, s_hat: int,
               params: DepthParams, with_k_best: bool = False,
               pdmin_v_u: Optional[torch.Tensor] = None,
               pdmax_v_u: Optional[torch.Tensor] = None,
               u_valid: Optional[Tuple[int, int]] = None) -> SweepResult:
    """Dense sweep over all EPIs.

    Args:
      epis_v_s_u_c: ``[V, S, U, C]`` normalized volume.
      dmin_v_u / dmax_v_u: ``[V, U]`` per-pixel grid bounds.
      dim_d: number of candidate disparities.
      s_hat: reference temporal line.
      pdmin_v_u / pdmax_v_u: optional ``[V, U]`` allowed ranges (the
        masked mode of the tile sweep, ``sweep_pallas_perpixel.py``): a
        candidate outside [pdmin - step, pdmax + step], step = (dmax -
        dmin) / (dim_d - 1), can neither win nor count in the mean, which
        is then (sum * dim_d / max(n_allowed, 1)) / dim_d.
      u_valid: optional (lo, hi) window of valid sample columns in the
        volume's own u coordinates (default (0, U - 1)); it may reach
        beyond the volume, whose columns are read clamped.  Positions are
        taken in the window's columns (see the module docstring).
    """
    V, S, U, C = epis_v_s_u_c.shape
    dev = epis_v_s_u_c.device
    s_hat = int(s_hat)
    ds_s = float(s_hat) - torch.arange(S, dtype=DTYPE, device=dev)
    lo, hi = (0, U - 1) if u_valid is None else (int(u_valid[0]),
                                                  int(u_valid[1]))
    u_idx = torch.arange(-lo, U - lo, dtype=DTYPE, device=dev)
    slope = f32(params.slope_factor)
    rbar_init = epis_v_s_u_c[:, s_hat]                      # [V, U, C]

    drange = dmax_v_u - dmin_v_u
    den = torch.full_like(drange, float(dim_d - 1))
    best_score = torch.full((V, U), -1.0, dtype=DTYPE, device=dev)
    best_depth = torch.zeros((V, U), dtype=DTYPE, device=dev)
    score_sum = torch.zeros((V, U), dtype=DTYPE, device=dev)
    rbar_b = torch.zeros((V, U, C), dtype=DTYPE, device=dev)
    k_b = torch.zeros((V, S, U), dtype=DTYPE, device=dev)
    zero = torch.zeros((), dtype=DTYPE, device=dev)
    masked = pdmin_v_u is not None
    if masked:
        tol = drange / den
        pd_lo = pdmin_v_u - tol
        pd_hi = pdmax_v_u + tol
        n_allowed = torch.zeros((V, U), dtype=DTYPE, device=dev)
    for d in range(dim_d):
        delta = dmin_v_u + (drange * float(d)) / den
        valpos, valraw, valid = _radiances(
            epis_v_s_u_c, delta, ds_s, u_idx, slope, params.interpolation,
            lo, hi)
        card = _sum_s(valid.to(DTYPE))
        score_num, rbar, k_last = _mean_shift(valpos, valraw, valid,
                                              rbar_init, params)
        score = torch.where(card > 0, score_num / card, zero)

        better = score > best_score
        if masked:
            allowed = (delta >= pd_lo) & (delta <= pd_hi)
            better = better & allowed
            score_sum = score_sum + torch.where(allowed, score, zero)
            n_allowed = n_allowed + allowed.to(DTYPE)
        else:
            score_sum = score_sum + score
        best_score = torch.where(better, score, best_score)
        best_depth = torch.where(better, delta, best_depth)
        rbar_b = torch.where(better[..., None], rbar, rbar_b)
        if with_k_best:
            k_b = torch.where(better[:, None, :], k_last, k_b)
    if masked:
        score_sum = score_sum * float(dim_d) / torch.clamp_min(n_allowed, 1.0)
    return SweepResult(best_score=best_score,
                       score_mean=div(score_sum, float(dim_d)),
                       best_depth=best_depth, rbar=rbar_b, k_best=k_b)


def sweep_epi(epi_s_u_c: torch.Tensor, dmin_u, dmax_u, dim_d: int,
              s_hat: int, params: DepthParams, with_k_best: bool = False,
              u_valid: Optional[Tuple[int, int]] = None):
    """Dense sweep of one EPI ``[S, U, C]``: all u, all d, on the EPI's
    device (the V = 1 case of :func:`sweep_pile`).

    ``dmin_u`` / ``dmax_u`` are ``[U]`` per-pixel grid bounds or scalars.
    Returns (best_score [U], score_mean [U], best_depth [U], rbar [U, C],
    k_best [S, U]; zeros without ``with_k_best``), as the JAX package's
    ``sweep_epi``.
    """
    U = epi_s_u_c.shape[1]
    bounds = [torch.broadcast_to(torch.as_tensor(
        b, dtype=DTYPE, device=epi_s_u_c.device), (U,))[None]
        for b in (dmin_u, dmax_u)]
    r = sweep_pile(epi_s_u_c[None], *bounds, dim_d, s_hat, params,
                   with_k_best, u_valid=u_valid)
    return (r.best_score[0], r.score_mean[0], r.best_depth[0], r.rbar[0],
            r.k_best[0])
