"""The pass over a (v, u) mesh, with u-halos.

Counterpart of ``remotesensingproject_tpu/parallel/sharding2d.py``.  For
very wide frames the columns are split over a second mesh axis as well as
the rows.  Three stages read across a u split; each gets the halo it
needs over the mesh's u ring (``sharding.exchange_halos``, one
``all_reduce`` each):

* the sweep's sheared gather reads up to
  hu = ceil((S - 1) * max|d| * slope) + 2 columns beyond a block: the EPI
  block is haloed by hu once per call, and the sweep runs on the haloed
  block with ``u_valid`` set to the image's columns in its coordinates,
  so that samples outside the image count as invalid exactly as they do
  unsharded; the kernels and the plain version take positions in the
  window's columns, so a haloed block's samples are the whole image's bit
  for bit.  The sweep is the pixel kernel where C is 1 or 3 and D <= 1024,
  else the tile kernel on each pixel's own grid (as the JAX package's 2-D
  path sweeps per pixel), with bound planes at every level; the halo's
  bound columns are the ctor bounds, since only the block's own pixels
  are swept and cropped back;
* the paint reaches pado = ceil(max|d| * slope * (S - 1)) + 1 columns: the
  pass's source planes (filtered depth, r_bar, source mask, payload
  sources) are haloed by pado and paint the block's targets from column
  ``u_origin = pado``; the smallest haloed source column is the image's
  smallest, so the first writer is the unsharded one;
* the selective median's (v, u) window gets size // 2 halos on both axes,
  u first and then v on the widened block, so that corner taps carry the
  diagonal rank's rows.

Every merge and state update is ``models.depth2d._pass_fn``'s: this module
only passes it three stage hooks.  Line mode is refused, as in the JAX
package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import DepthParams
from ..models.depth2d import sweep_pass, _pass_fn
from ..ops.median import selective_median
from ..ops.median_pallas import selective_median_cuda
from ..ops.propagation import propagate
from ..ops.propagation_pallas import propagate_cuda
from ..ops.sweep import SweepResult, sweep_pile
from ..types import DTYPE, f32
from .sharding import exchange_halos, run_schedule


def halo_widths(S: int, d_bounds, slope_factor: float) -> Tuple[int, int]:
    """(hu, pado): the sweep's gather reach (+1 for the linear blend's
    ceil sample, +1 slack) and the paint's line reach."""
    max_abs_d = max(abs(d_bounds[0]), abs(d_bounds[1]))
    hu = int(np.ceil((S - 1) * max_abs_d * slope_factor)) + 2
    pado = int(np.ceil(max_abs_d * slope_factor * (S - 1))) + 1
    return hu, pado


def _pad_u(x: torch.Tensor, width: int, value) -> torch.Tensor:
    """``x`` [V, U, ...] with ``width`` columns of ``value`` on each side."""
    side = torch.full((x.shape[0], width) + tuple(x.shape[2:]), value,
                      dtype=x.dtype, device=x.device)
    return torch.cat([side, x, side], 1)


def sharded_schedule_2d(mesh, dim_d: int, params: DepthParams,
                        d_bounds: Tuple[float, float], u_global: int,
                        use_pallas=None, early_stop: bool = True):
    """The passes of a schedule on a (v, u) mesh: ``fn(epis, frames,
    state, s_hats, dmin_s_v_u=None, dmax_s_v_u=None) -> (state, passes
    run, remaining)`` with the rank's ``[V_l, S, U_l, C]`` block and state
    planes.  ``u_global`` is the image's true width: columns beyond it
    (padding to a multiple of the u split) are outside the image."""
    if params.score_version == "line":
        raise NotImplementedError(
            "u-sharding does not support score_version='line'")
    kernels = use_pallas is not False
    median = selective_median_cuda if kernels else selective_median
    paint = propagate_cuda if kernels else propagate

    def fn(epis, frames, state, s_hats, dmin_s_v_u=None, dmax_s_v_u=None):
        Vl, S, Ul, _ = epis.shape
        hu, pado = halo_widths(S, d_bounds, params.slope_factor)
        u0 = mesh.u_index * Ul          # the block's first image column
        # the EPI block's halo, once for every pass of the call
        epis_h = exchange_halos([epis], hu, 2, mesh.u_ring, [0.0])[0]
        window = (hu - u0, u_global - 1 - u0 + hu)

        def sweep_fn(active, dmin_v_u, dmax_v_u, s_hat):
            # bound planes always (the ctor bounds at uniform levels, the
            # same grid): they keep every route on each pixel's own grid
            if dmin_v_u is None:
                dmin_v_u, dmax_v_u = (
                    torch.full((Vl, Ul), f32(b), dtype=DTYPE,
                               device=epis.device) for b in d_bounds)
            dmin_h, dmax_h = (_pad_u(b, hu, f32(v)) for b, v in
                              zip((dmin_v_u, dmax_v_u), d_bounds))
            act_h = _pad_u(active, hu, False)
            if kernels:
                res = sweep_pass(epis_h, act_h, s_hat, dim_d, params,
                                 d_bounds, dmin_h, dmax_h, "pixel",
                                 u_valid=window)
            else:
                res = sweep_pile(epis_h, dmin_h, dmax_h, dim_d, s_hat,
                                 params, u_valid=window)
            return SweepResult(*(None if x is None else
                                 x[:, hu:hu + Ul].contiguous()
                                 for x in res[:4]), None)

        def median_fn(src, frame, mask, size, epsilon):
            # a ring of one rank takes no halo (as selective_median_sharded)
            hu_, hv_ = (size // 2 if r.size > 1 else 0
                        for r in (mesh.u_ring, mesh.v_ring))
            fills = [0.0, 0.0, False]
            xs = exchange_halos([src, frame, mask], hu_, 1, mesh.u_ring,
                                fills)
            xs = exchange_halos(xs, hv_, 0, mesh.v_ring, fills)
            return median(*xs, size, epsilon)[hv_:hv_ + Vl,
                                              hu_:hu_ + Ul].contiguous()

        def prop_fn(claim, frames_, filtered, rbar, source_mask, s_hat,
                    payloads):
            # each source plane once (the depth payload is `filtered`)
            srcs = [filtered, rbar, source_mask]
            for _, x in payloads:
                if not any(x is y for y in srcs):
                    srcs.append(x)
            fills = [0.0, 0.0, False] + [0.0] * (len(srcs) - 3)
            hs = exchange_halos(srcs, pado, 1, mesh.u_ring, fills)
            haloed = {id(x): h for x, h in zip(srcs, hs)}
            return paint(claim, frames_, hs[0], hs[1], hs[2], s_hat,
                         params.slope_factor, params.propagation_epsilon,
                         [(t, haloed[id(x)]) for t, x in payloads],
                         u_origin=pado)

        def pass_one(st, s_hat):
            _pass_fn(epis, frames, st, int(s_hat), dim_d=dim_d,
                     params=params, d_bounds=d_bounds,
                     dmin_s_v_u=dmin_s_v_u, dmax_s_v_u=dmax_s_v_u,
                     sweep_fn=sweep_fn, median_fn=median_fn,
                     prop_fn=prop_fn)

        return run_schedule(pass_one, state, s_hats, early_stop)
    return fn
