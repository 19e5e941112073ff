"""Pixel-compacted sweep: wrapper of the CUDA kernel ``csrc/sweep_pixel.cu``.

Counterpart of ``remotesensingproject_tpu/ops/sweep_pallas_pixel.py``,
whose Pallas kernel ``_pixel_kernel`` the CUDA kernel replaces.  The
kernel sweeps only the active pixels of a pass, with the uniform candidate
grid or with each pixel's own [dmin, dmax] grid (the bounds-edited pyramid
levels), D <= 1024 candidates and C in {1, 3}, under linear or nearest
interpolation, and exports ``k_best`` for line mode.  ``u_valid`` sets
the window of valid sample columns, as the JAX kernel's does (the (v, u)
mesh sweeps a u-haloed block).  The kernel is the
(pixel, candidate) core ``csrc/sweep_pc.cuh`` in its unmasked mode; its
launcher chooses the block size and the pixels of a group.

Fast mode caps the mean shift at 5 steps here, under linear interpolation,
as the JAX package's pixel kernel does; nearest, which the JAX package
sweeps on its uncapped XLA path, is not capped.

On a CPU tensor the wrapper runs the plain version, ``ops.sweep.sweep_pile``;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import DepthParams
from ..types import DTYPE, f32
from ..utils import profiling
from . import cuda_build
from .sweep import SweepResult, sweep_pile
from .sweep_pallas import compact, kernel_scalars, sample_step_counter

MAX_DIM_D = 1024
#: mean-shift steps of fast mode (``config.DepthParams.fast``)
FAST_MAX_ITER = 5


def flops_per_sample_step(C: int) -> int:
    """fp32 operations per valid sample and mean-shift step: C diffs,
    squares and (C - 1) adds, the scale, 1 - x and max, the K sum, and
    per channel max / multiply / add of the r_bar numerator."""
    return 4 * C + 5


def mean_shift_iters(params: DepthParams) -> int:
    """The mean-shift steps this sweep runs: ``mean_shift_max_iter``, at
    most :data:`FAST_MAX_ITER` in fast mode under linear interpolation
    (``sweep_pallas_pixel.py:515-520`` of the JAX package)."""
    if params.fast and params.interpolation == "linear":
        return min(params.mean_shift_max_iter, FAST_MAX_ITER)
    return params.mean_shift_max_iter


_SWEEP = cuda_build.Entry("sweep_pixel", "rslf_sweep_pixel",
                          "p iii p i pp ff ii ff iiii pppppp s")
_PLAN = cuda_build.Entry("sweep_pixel", "rslf_sweep_pixel_plan", "iiii p")


def launch_plan(S: int, C: int, with_k_best: bool = False,
                nearest: bool = False) -> dict:
    """What the launcher chose for ``S`` samples of ``C`` channels, with or
    without ``k_best``, under the linear or the nearest rule, on the
    current card: threads of a block, items of a window, bytes of shared
    memory a block, resident blocks an SM, SMs.  Raises
    NotImplementedError when no block size fits."""
    return cuda_build.read_plan(_PLAN, S, C, int(with_k_best), int(nearest),
                                size=f"S={S}, C={C}")


def sweep_pile_pixel(epis_v_s_u_c: torch.Tensor, dmin: float, dmax: float,
                     dim_d: int, s_hat: int, params: DepthParams,
                     active_v_u: torch.Tensor,
                     dmin_v_u: Optional[torch.Tensor] = None,
                     dmax_v_u: Optional[torch.Tensor] = None,
                     with_k_best: bool = False,
                     work_count: Optional[torch.Tensor] = None,
                     u_valid: Optional[Tuple[int, int]] = None
                     ) -> SweepResult:
    """Sweep the active pixels of one pass.

    Args:
      epis_v_s_u_c: ``[V, S, U, C]`` normalized volume.
      dmin, dmax: the level's uniform candidate bounds.
      active_v_u: ``[V, U]`` bool, the pixels to sweep.
      dmin_v_u / dmax_v_u: optional ``[V, U]`` per-pixel grid bounds.
      with_k_best: also return ``k_best`` ``[V, S, U]``, the winning
        candidate's kernel values (line mode).
      work_count: optional int64 CUDA tensor of one element; the kernel
        adds the valid samples times mean-shift steps it ran, the count
        its arithmetic bound is computed from.  None while tracing: the
        counter ``sweep.sample_steps`` (``utils.profiling``).
      u_valid: optional (lo, hi) window of valid sample columns (default
        (0, U - 1)); the columns read stay clamped to the volume.

    Returns:
      SweepResult; at inactive pixels the kernel leaves zeros and the
      plain version its dense values.  ``k_best`` is None on CUDA without
      ``with_k_best``.
    """
    V, S, U, C = epis_v_s_u_c.shape
    dev = epis_v_s_u_c.device
    iters = mean_shift_iters(params)
    if dev.type != "cuda":
        if dmin_v_u is None:
            dmin_v_u = torch.full((V, U), f32(dmin), dtype=DTYPE, device=dev)
            dmax_v_u = torch.full((V, U), f32(dmax), dtype=DTYPE, device=dev)
        return sweep_pile(
            epis_v_s_u_c, dmin_v_u, dmax_v_u, dim_d, s_hat,
            dataclasses.replace(params, mean_shift_max_iter=iters),
            with_k_best, u_valid=u_valid)

    if C not in (1, 3):
        raise NotImplementedError("the CUDA sweep supports C in (1, 3)")
    if not 1 <= dim_d <= MAX_DIM_D:
        raise NotImplementedError(f"the CUDA sweep supports dim_d <= "
                                  f"{MAX_DIM_D}")
    cuda_build.require("epis", epis_v_s_u_c, dev)
    cuda_build.require("active", active_v_u, dev, torch.bool)
    per_pixel = dmin_v_u is not None
    if per_pixel:
        cuda_build.require("dmin_v_u", dmin_v_u, dev)
        cuda_build.require("dmax_v_u", dmax_v_u, dev)
    work_count = sample_step_counter(work_count, dev)
    out, act, n_act = compact(active_v_u, S, C, with_k_best)
    if n_act == 0:
        return out

    with profiling.span("sweep.launch"):
        a_coef, lo, hi = kernel_scalars(U, C, params, u_valid)
        _SWEEP(epis_v_s_u_c, S, U, C, act, n_act,
               dmin_v_u if per_pixel else None,
               dmax_v_u if per_pixel else None, f32(dmin), f32(dmax), dim_d,
               int(s_hat), f32(params.slope_factor), a_coef, iters,
               int(params.interpolation == "nearest"), lo, hi,
               out.best_score, out.score_mean, out.best_depth, out.rbar,
               out.k_best, work_count, device=dev, no_fit=f"S={S}, C={C}")
    return out
