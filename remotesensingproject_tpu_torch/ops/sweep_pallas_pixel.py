"""Pixel-compacted sweep: wrapper of the CUDA kernel ``csrc/sweep_pixel.cu``.

Counterpart of ``remotesensingproject_tpu/ops/sweep_pallas_pixel.py``,
whose Pallas kernel ``_pixel_kernel`` the CUDA kernel replaces.  The
kernel sweeps only the active pixels of a pass, with the uniform candidate
grid or with each pixel's own [dmin, dmax] grid (the bounds-edited pyramid
levels), D <= 1024 candidates and C in {1, 3}.  The kernel is the
(pixel, candidate) core ``csrc/sweep_pc.cuh`` in its unmasked mode; its
launcher chooses the block size and the pixels of a group.

On a CPU tensor the wrapper runs the plain version, ``ops.sweep.sweep_pile``;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..config import DepthParams
from ..types import DTYPE, chan_scale, f32
from . import cuda_build
from .sweep import SweepResult, sweep_pile

MAX_DIM_D = 1024


def flops_per_sample_step(C: int) -> int:
    """fp32 operations per valid sample and mean-shift step: C diffs,
    squares and (C - 1) adds, the scale, 1 - x and max, the K sum, and
    per channel max / multiply / add of the r_bar numerator."""
    return 4 * C + 5


def _sweep_fn():
    lib = cuda_build.load("sweep_pixel")
    fn = lib.rslf_sweep_pixel
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, I, I, I, P, I, P, P, F, F, I, I, F, F, I,
                   P, P, P, P, P, P]
    fn.restype = ctypes.c_int
    plan = lib.rslf_sweep_pixel_plan
    plan.argtypes = [I, I, P]
    plan.restype = ctypes.c_int
    return lib, fn, plan


def launch_plan(S: int, C: int) -> dict:
    """What the launcher chose for ``S`` samples of ``C`` channels on the
    current card: threads of a block, items of a window, bytes of shared
    memory a block, resident blocks an SM, SMs.  Raises
    NotImplementedError when no block size fits."""
    lib, _, plan = _sweep_fn()
    return cuda_build.read_plan(lambda out: plan(S, C, out), lib,
                                "rslf_sweep_pixel_error_string",
                                "sweep_pixel", f"S={S}, C={C}")


def sweep_pile_pixel(epis_v_s_u_c: torch.Tensor, dmin: float, dmax: float,
                     dim_d: int, s_hat: int, params: DepthParams,
                     active_v_u: torch.Tensor,
                     dmin_v_u: Optional[torch.Tensor] = None,
                     dmax_v_u: Optional[torch.Tensor] = None,
                     work_count: Optional[torch.Tensor] = None
                     ) -> SweepResult:
    """Sweep the active pixels of one pass.

    Args:
      epis_v_s_u_c: ``[V, S, U, C]`` normalized volume.
      dmin, dmax: the level's uniform candidate bounds.
      active_v_u: ``[V, U]`` bool, the pixels to sweep.
      dmin_v_u / dmax_v_u: optional ``[V, U]`` per-pixel grid bounds.
      work_count: optional int64 CUDA tensor of one element; the kernel
        adds the valid samples times mean-shift steps it ran, the count
        its arithmetic bound is computed from.

    Returns:
      SweepResult; at inactive pixels the kernel leaves zeros and the
      plain version its dense values.  ``k_best`` (line mode) is not
      exported by the kernel: it is None on CUDA.
    """
    V, S, U, C = epis_v_s_u_c.shape
    dev = epis_v_s_u_c.device
    if dev.type != "cuda":
        if dmin_v_u is None:
            dmin_v_u = torch.full((V, U), f32(dmin), dtype=DTYPE, device=dev)
            dmax_v_u = torch.full((V, U), f32(dmax), dtype=DTYPE, device=dev)
        return sweep_pile(epis_v_s_u_c, dmin_v_u, dmax_v_u, dim_d, s_hat,
                          params)

    if params.interpolation != "linear":
        raise NotImplementedError("the CUDA sweep supports linear "
                                  "interpolation only")
    if C not in (1, 3):
        raise NotImplementedError("the CUDA sweep supports C in (1, 3)")
    if not 1 <= dim_d <= MAX_DIM_D:
        raise NotImplementedError(f"the CUDA sweep supports dim_d <= "
                                  f"{MAX_DIM_D}")
    if params.fast:
        raise NotImplementedError("fast mode is not ported yet")
    cuda_build.require("epis", epis_v_s_u_c, dev)
    cuda_build.require("active", active_v_u, dev, torch.bool)
    per_pixel = dmin_v_u is not None
    if per_pixel:
        cuda_build.require("dmin_v_u", dmin_v_u, dev)
        cuda_build.require("dmax_v_u", dmax_v_u, dev)
    if work_count is not None:
        cuda_build.require("work_count", work_count, dev, torch.int64)

    best_score = torch.zeros((V, U), dtype=DTYPE, device=dev)
    score_mean = torch.zeros((V, U), dtype=DTYPE, device=dev)
    best_depth = torch.zeros((V, U), dtype=DTYPE, device=dev)
    rbar = torch.zeros((V, U, C), dtype=DTYPE, device=dev)
    result = SweepResult(best_score, score_mean, best_depth, rbar, None)
    act = torch.nonzero(active_v_u.reshape(-1)).reshape(-1).to(torch.int32)
    n_act = act.numel()
    if n_act == 0:
        return result

    lib, fn, _ = _sweep_fn()
    a_coef = f32(chan_scale(C) / (params.kernel_h * params.kernel_h))
    err = fn(cuda_build.ptr(epis_v_s_u_c), S, U, C, cuda_build.ptr(act),
             n_act, cuda_build.ptr(dmin_v_u if per_pixel else None),
             cuda_build.ptr(dmax_v_u if per_pixel else None),
             f32(dmin), f32(dmax), dim_d, int(s_hat),
             f32(params.slope_factor), a_coef, params.mean_shift_max_iter,
             cuda_build.ptr(best_score), cuda_build.ptr(score_mean),
             cuda_build.ptr(best_depth), cuda_build.ptr(rbar),
             cuda_build.ptr(work_count), cuda_build.stream_ptr(dev))
    cuda_build.check(err, lib, "rslf_sweep_pixel_error_string",
                     "sweep_pixel", no_fit=f"S={S}, C={C}")
    sweep_pile_pixel.launches += 1
    return result


#: kernel launches since the count was last set to 0
sweep_pile_pixel.launches = 0
