"""Temporal depth propagation along EPI lines (plain PyTorch).

Counterpart of ``remotesensingproject_tpu/ops/propagation.py`` (its dense
descending-offset scan; the JAX package's candidate-bucket scan is an
optimisation with bit-identical results), and the plain version of the
CUDA kernel in ``propagation_pallas.py``.  Reference:
rslf_depth_computation_core.hpp:1083-1129.

After the sweep at pass line s_hat, every source pixel (v, u) passing the
propagation criterion paints its payloads along its own EPI line: target
u' = u + o, o = round_half_away(d * slope * (s_hat - s)), for every s,
where the target is unclaimed and its colour is within ``epsilon`` of the
source's r_bar.  The reference's u loop is sequential, first writer wins,
so the smallest source u wins a contested target: per s-plane the offsets
are visited from large to small.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..types import DTYPE, f32, normsq, round_half_away


def _shifted(x: torch.Tensor, o: int, fill, width: int,
             origin: int = 0) -> torch.Tensor:
    """y[:, u] = x[:, origin + u - o] for u in [0, width) where that
    column lies in x, else ``fill``."""
    Us = x.shape[1]
    out = torch.full((x.shape[0], width) + tuple(x.shape[2:]), fill,
                     dtype=x.dtype, device=x.device)
    lo, hi = max(0, o - origin), min(width, Us + o - origin)
    if lo < hi:
        out[:, lo:hi] = x[:, origin + lo - o:origin + hi - o]
    return out


def source_offset_range(offs_num_v_u: torch.Tensor,
                        source_mask_v_u: torch.Tensor) -> torch.Tensor:
    """Device tensor {min, max, any} of the sources' offsets per unit ds
    (0, 0, 0 without sources)."""
    inf = torch.tensor(float("inf"), dtype=DTYPE, device=offs_num_v_u.device)
    any_src = torch.any(source_mask_v_u)
    mn = torch.min(torch.where(source_mask_v_u, offs_num_v_u, inf))
    mx = torch.max(torch.where(source_mask_v_u, offs_num_v_u, -inf))
    zero = torch.zeros((), dtype=DTYPE, device=offs_num_v_u.device)
    return torch.stack([torch.where(any_src, mn, zero),
                        torch.where(any_src, mx, zero), any_src.to(DTYPE)])


def propagate(claim_s_v_u: torch.Tensor, frames_s_v_u_c: torch.Tensor,
              depth_f_v_u: torch.Tensor, rbar_v_u_c: torch.Tensor,
              source_mask_v_u: torch.Tensor, s_hat: int,
              slope_factor: float, epsilon: float,
              payloads: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              u_origin: int = 0):
    """One pass of line painting, in place.

    Args:
      claim_s_v_u: ``[S, V, U]`` bool, True = unclaimed.
      frames_s_v_u_c: ``[S, V, U, C]`` normalized volume.
      depth_f_v_u: ``[V, U]`` filtered sweep depths at s_hat.
      rbar_v_u_c: ``[V, U, C]`` dominant radiance at s_hat.
      source_mask_v_u: ``[V, U]`` bool propagation criterion.
      payloads: (target ``[S, V, U]``, source ``[V, U]``) pairs painted
        under the propagation condition.
      u_origin: the source planes (depth, r_bar, mask, payload sources)
        may be ``Us`` >= U columns wide, the targets' column 0 at their
        column ``u_origin``: a source at column j paints target
        j - u_origin + o (JAX ``propagation.py:90-98``; the (v, u) mesh
        passes sources haloed in u).  Default 0 with ``Us`` = U.

    Returns:
      (claim, tuple of targets): the same tensors, updated in place.
    """
    S, V, U = claim_s_v_u.shape
    targets = tuple(t for t, _ in payloads)
    sources = tuple(s for _, s in payloads)
    eps_sq = float(np.float32(epsilon) ** 2)
    offs_num = depth_f_v_u * f32(slope_factor)
    rng = source_offset_range(offs_num, source_mask_v_u)
    if not bool(rng[2]):
        return claim_s_v_u, targets

    for s in range(S):
        claim_s = claim_s_v_u[s]
        if not bool(torch.any(claim_s)):
            continue
        ds = float(s_hat - s)
        cand = round_half_away(rng[:2] * ds)
        o_lo, o_hi = int(torch.min(cand)), int(torch.max(cand))
        offs_r = round_half_away(offs_num * ds)
        frame = frames_s_v_u_c[s]
        for o in range(o_hi, o_lo - 1, -1):
            sm = _shifted(source_mask_v_u, o, False, U, u_origin)
            off_sh = _shifted(offs_r, o, 0.0, U, u_origin)
            rb_sh = _shifted(rbar_v_u_c, o, 0.0, U, u_origin)
            cond = (sm & (off_sh == float(o)) & claim_s
                    & (normsq(frame - rb_sh) < eps_sq))
            for tgt, src in zip(targets, sources):
                tgt[s] = torch.where(cond, _shifted(src, o, 0.0, U, u_origin),
                                     tgt[s])
            claim_s = claim_s & ~cond
        claim_s_v_u[s] = claim_s
    return claim_s_v_u, targets
