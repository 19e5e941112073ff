"""Per-pixel-bounds (tile) sweep: wrapper of the CUDA kernel
``csrc/sweep_tiles.cu``.

Counterpart of ``remotesensingproject_tpu/ops/sweep_pallas_perpixel.py``,
whose Pallas kernel ``_sweep_pp_kernel`` the CUDA kernel replaces.  Each
pixel sweeps its own grid ``[dmin_v_u, dmax_v_u]`` with per-pixel sample
positions.  In the masked mode (``pdmin_v_u`` / ``pdmax_v_u`` given) a
candidate outside the pixel's allowed range, widened by one grid step, can
neither win nor count in the score mean: that is the tile-quantized coarse
sweep, whose grid bounds :func:`tile_quantized_bounds` shares per 128-lane
tile.  Any D and any C, under linear or nearest interpolation (callers
take the pixel mode for nearest, as the JAX package sweeps it on each
pixel's own grid).  Fast mode does not cap this sweep (the JAX package
caps only its pixel kernel).  ``u_valid`` sets the window of valid sample
columns, through the core's position rules shared with the pixel sweep
(the (v, u) mesh sweeps a u-haloed block in pixel mode).  The kernel is the (pixel, candidate) core
``csrc/sweep_pc.cuh``; its launcher chooses the block size and the pixels
of a group.

On a CPU tensor the wrapper runs the plain version, ``ops.sweep.sweep_pile``
(densely over every pixel); on a CUDA tensor it launches the kernel over
the pixels it is told are active, or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import DepthParams
from ..types import DTYPE, f32
from ..utils import profiling
from . import cuda_build
from .sweep import SweepResult, sweep_pile
from .sweep_pallas import (CHUNK, activity_mask, compact, count_pixels,
                           kernel_scalars, sample_step_counter)


def tile_quantized_bounds(active_v_u: torch.Tensor, dmin_v_u: torch.Tensor,
                          dmax_v_u: torch.Tensor,
                          d_bounds: Tuple[float, float]):
    """Grid bounds shared per 128-lane u-tile aligned at u = 0: the min of
    the active pixels' ``dmin_v_u`` and the max of their ``dmax_v_u``, the
    level's ctor bounds ``d_bounds`` where a tile has no active pixel
    (``models/depth2d.py:405-414`` of the JAX package)."""
    V, U = active_v_u.shape
    n_tiles = -(-U // CHUNK)
    pad = n_tiles * CHUNK - U
    inf = torch.tensor(float("inf"), dtype=DTYPE, device=dmin_v_u.device)

    def reduce(x, lowest):
        fill = inf if lowest else -inf
        xt = torch.where(active_v_u, x, fill)
        xt = torch.nn.functional.pad(xt, (0, pad), value=float(fill))
        xt = xt.reshape(V, n_tiles, CHUNK)
        red = xt.amin(dim=2) if lowest else xt.amax(dim=2)
        fallback = f32(d_bounds[0] if lowest else d_bounds[1])
        red = torch.where(torch.isfinite(red), red,
                          torch.full_like(red, fallback))
        return red.repeat_interleave(CHUNK, dim=1)[:, :U].contiguous()

    return reduce(dmin_v_u, True), reduce(dmax_v_u, False)


_SWEEP = cuda_build.Entry("sweep_tiles", "rslf_sweep_tiles",
                          "p iii p i pppp ii ff iiii pppppp s")
_PLAN = cuda_build.Entry("sweep_tiles", "rslf_sweep_tiles_plan", "iiiii p")


def launch_plan(S: int, C: int, with_k_best: bool = False,
                masked: bool = True, nearest: bool = False) -> dict:
    """What the launcher chose for ``S`` samples of ``C`` channels, with or
    without ``k_best`` and the masked mode, under the linear or the nearest
    rule, on the current card: threads of a block, items of a window, bytes
    of shared memory a block, resident blocks an SM, SMs.  Raises
    NotImplementedError when no block size fits."""
    return cuda_build.read_plan(_PLAN, S, C, int(with_k_best), int(masked),
                                int(nearest), size=f"S={S}, C={C}")


def sweep_pile_tiles(epis_v_s_u_c: torch.Tensor, dmin_v_u: torch.Tensor,
                     dmax_v_u: torch.Tensor, dim_d: int, s_hat: int,
                     params: DepthParams, with_k_best: bool = False,
                     tile_active=None,
                     active_v_u: Optional[torch.Tensor] = None,
                     pdmin_v_u: Optional[torch.Tensor] = None,
                     pdmax_v_u: Optional[torch.Tensor] = None,
                     work_count: Optional[torch.Tensor] = None,
                     u_valid: Optional[Tuple[int, int]] = None
                     ) -> SweepResult:
    """Per-pixel-bounds sweep of the active pixels.

    Args:
      epis_v_s_u_c: ``[V, S, U, C]`` normalized volume.
      dmin_v_u / dmax_v_u: ``[V, U]`` per-pixel grid bounds.
      tile_active: optional ``[V, ceil(U / 128)]`` flags, as the TPU
        wrapper takes them.
      active_v_u: optional ``[V, U]`` bool; only these pixels are swept.
      pdmin_v_u / pdmax_v_u: optional ``[V, U]`` allowed ranges (the
        masked mode).
      work_count: optional int64 CUDA tensor of one element; the kernel
        adds the valid samples times mean-shift steps it ran.  None while
        tracing: the counter ``sweep.sample_steps`` (``utils.profiling``).
      u_valid: optional (lo, hi) window of valid sample columns (default
        (0, U - 1)); the columns read stay clamped to the volume.

    While tracing, the pixels swept are added to the host counter
    ``sweep.tiles.pixels``.

    Returns:
      SweepResult; on CUDA zeros at the pixels not swept.
    """
    V, S, U, C = epis_v_s_u_c.shape
    dev = epis_v_s_u_c.device
    masked = pdmin_v_u is not None
    if dev.type != "cuda":
        count_pixels("sweep.tiles.pixels", V, U, tile_active, active_v_u)
        return sweep_pile(epis_v_s_u_c, dmin_v_u, dmax_v_u, dim_d, s_hat,
                          params, with_k_best, pdmin_v_u, pdmax_v_u, u_valid)

    cuda_build.require("epis", epis_v_s_u_c, dev)
    planes = [("dmin_v_u", dmin_v_u), ("dmax_v_u", dmax_v_u)]
    if masked:
        planes += [("pdmin_v_u", pdmin_v_u), ("pdmax_v_u", pdmax_v_u)]
    for name, t in planes:
        cuda_build.require(name, t, dev)
    work_count = sample_step_counter(work_count, dev)
    out, act, n_act = compact(
        activity_mask(V, U, tile_active, active_v_u, dev), S, C, with_k_best)
    profiling.count("sweep.tiles.pixels", n_act)
    if n_act == 0:
        return out

    with profiling.span("sweep.launch"):
        a_coef, lo, hi = kernel_scalars(U, C, params, u_valid)
        _SWEEP(epis_v_s_u_c, S, U, C, act, n_act, dmin_v_u, dmax_v_u,
               pdmin_v_u, pdmax_v_u, dim_d, int(s_hat),
               f32(params.slope_factor), a_coef, params.mean_shift_max_iter,
               int(params.interpolation == "nearest"), lo, hi,
               out.best_score, out.score_mean, out.best_depth, out.rbar,
               out.k_best, work_count, device=dev, no_fit=f"S={S}, C={C}")
    return out
