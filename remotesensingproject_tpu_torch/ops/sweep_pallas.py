"""Dense row sweep over a uniform grid: the CUDA kernel ``csrc/sweep_rows.cu``
(a launcher of the (pixel, candidate) core ``csrc/sweep_pc.cuh`` under the
shared-shift position rule) and its plain version.

Counterpart of ``remotesensingproject_tpu/ops/sweep_pallas.py``, whose
Pallas kernel ``_sweep_kernel`` the CUDA kernel replaces.  Every pixel
shares the level's uniform candidate grid, and the sheared sample of
candidate d at row s sits at ``u + shift`` with ONE shift per (s, d) for
all u: ``shift = ((s_hat - s) * d) * slope``, ``i0 = floor(shift)``,
``t = shift - i0``; the sample is ``row[i0 + u]`` where ``t == 0`` and
``(1 - t) * row[i0 + u] + t * row[i0 + u + 1]`` elsewhere, valid iff
``-i0 <= u <= U - 1 - (i0 + (t > 0))``.  This rule can differ from the
per-pixel ``floor(u + shift)`` of ``ops/sweep.py`` in the last ulp of the
weight, so the plain version here computes it, not that of ``sweep.py``.
The candidate grid is the TPU wrapper's device expression,
``dmin + (d * (dmax - dmin)) / (D - 1)`` with true division.

On a CPU tensor the wrapper runs the plain version, densely over every
pixel; on a CUDA tensor it launches the kernel over the pixels it is told
are active, or raises.  Outputs are defined at active pixels only.  Fast
mode does not cap this sweep (the JAX package caps only its pixel kernel).
Nearest interpolation is refused: its per-pixel rounding is not this
shared-shift rule, so callers send it to the pixel or the tile sweep.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import DepthParams
from ..types import DTYPE, chan_scale, div, f32
from ..utils import profiling
from . import cuda_build
from .sweep import SweepResult, _mean_shift, _sum_s

#: the TPU kernel's activity granularity along u
CHUNK = 128


def candidate_grid(dmin: float, dmax: float, dim_d: int,
                   device) -> torch.Tensor:
    """``[D]`` uniform grid, ``dmin + (d * f32(dmax - dmin)) / (D - 1)``
    in float32 with true division (``sweep_pallas.py:394-399``)."""
    d = torch.arange(dim_d, dtype=DTYPE, device=device)
    rng = f32(f32(dmax) - f32(dmin))
    return f32(dmin) + div(d * rng, float(dim_d - 1))


def _row_samples(epis, dval, ds_s, u_idx, slope):
    """Samples of one candidate with the shift shared by all u.

    Returns (val ``[V, S, U, C]``, valid ``[S, U]`` bool)."""
    V, S, U, C = epis.shape
    shift = (ds_s * dval) * slope                      # [S]
    f0 = torch.floor(shift)
    t = shift - f0
    i0 = f0.to(torch.int64)[:, None]                   # [S, 1]
    ceil_off = i0 + (t > 0).to(torch.int64)[:, None]
    valid = (u_idx >= -i0) & (u_idx <= (U - 1) - ceil_off)   # [S, U]
    ia = i0 + u_idx

    def gather(i):
        ii = torch.clamp(i, 0, U - 1)[None, :, :, None].expand(V, S, U, C)
        return torch.gather(epis, 2, ii)

    a = gather(ia)
    b = gather(ia + 1)
    tt = t[None, :, None, None]
    val = torch.where(tt == 0, a, (1.0 - tt) * a + tt * b)
    return val, valid


def sweep_rows_plain(epis_v_s_u_c: torch.Tensor, dvec: torch.Tensor,
                     s_hat: int, params: DepthParams,
                     with_k_best: bool = False) -> SweepResult:
    """Plain version of the row sweep over every (v, u).

    Args:
      epis_v_s_u_c: ``[V, S, U, C]`` normalized volume.
      dvec: ``[D]`` candidate grid (:func:`candidate_grid`).
      s_hat: reference temporal line.

    Returns:
      SweepResult; ``k_best`` is ``[V, S, U]`` with ``with_k_best`` and
      None otherwise.
    """
    V, S, U, C = epis_v_s_u_c.shape
    dev = epis_v_s_u_c.device
    s_hat = int(s_hat)
    ds_s = float(s_hat) - torch.arange(S, dtype=DTYPE, device=dev)
    u_idx = torch.arange(U, device=dev)[None, :]
    slope = f32(params.slope_factor)
    rbar_init = epis_v_s_u_c[:, s_hat]
    zero = torch.zeros((), dtype=DTYPE, device=dev)

    best_score = torch.full((V, U), -1.0, dtype=DTYPE, device=dev)
    best_depth = torch.zeros((V, U), dtype=DTYPE, device=dev)
    score_sum = torch.zeros((V, U), dtype=DTYPE, device=dev)
    rbar_b = torch.zeros((V, U, C), dtype=DTYPE, device=dev)
    k_b = (torch.zeros((V, S, U), dtype=DTYPE, device=dev)
           if with_k_best else None)
    for d in range(dvec.shape[0]):
        dval = dvec[d]
        val, valid_su = _row_samples(epis_v_s_u_c, dval, ds_s, u_idx, slope)
        valid = valid_su[None].expand(V, S, U)
        valid_c = valid[..., None]
        valraw = torch.where(valid_c, val, zero)
        valpos = torch.where(valid_c, torch.clamp_min(val, 0.0), zero)
        card = _sum_s(valid.to(DTYPE))
        score_num, rbar, k_last = _mean_shift(valpos, valraw, valid,
                                              rbar_init, params)
        score = torch.where(card > 0, score_num / card, zero)

        better = score > best_score
        best_score = torch.where(better, score, best_score)
        best_depth = torch.where(better, dval, best_depth)
        rbar_b = torch.where(better[..., None], rbar, rbar_b)
        if with_k_best:
            k_b = torch.where(better[:, None, :], k_last, k_b)
        score_sum = score_sum + score
    return SweepResult(best_score=best_score,
                       score_mean=div(score_sum, float(dvec.shape[0])),
                       best_depth=best_depth, rbar=rbar_b, k_best=k_b)


def activity_mask(V: int, U: int, row_active=None, active_v_u=None,
                  device=None) -> torch.Tensor:
    """``[V, U]`` bool mask of the pixels to sweep: per-row ``[V]`` or
    per-128-lane-chunk ``[V, ceil(U / 128)]`` flags (the TPU kernels'
    granularity) expanded to pixels, ANDed with a per-pixel
    ``active_v_u``; all pixels when neither is given."""
    mask = torch.ones((V, U), dtype=torch.bool, device=device)
    if row_active is not None:
        f = row_active.to(device=device, dtype=torch.bool)
        if f.dim() == 1:
            f = f[:, None].expand(V, U)
        else:
            f = f.repeat_interleave(CHUNK, dim=1)[:, :U]
        mask = mask & f
    if active_v_u is not None:
        mask = mask & active_v_u.to(device=device, dtype=torch.bool)
    return mask


def sweep_outputs(V: int, S: int, U: int, C: int, with_k_best: bool,
                  device) -> SweepResult:
    """Zeroed kernel outputs (inactive pixels keep the zeros)."""
    def z(*shape):
        return torch.zeros(shape, dtype=DTYPE, device=device)

    return SweepResult(z(V, U), z(V, U), z(V, U), z(V, U, C),
                       z(V, S, U) if with_k_best else None)


def sample_step_counter(work_count: Optional[torch.Tensor],
                        device) -> Optional[torch.Tensor]:
    """The sweep's ``work_count`` operand: the caller's, else the counter
    ``sweep.sample_steps`` while tracing (``utils.profiling``), else None."""
    if work_count is None:
        work_count = profiling.device_counter("sweep.sample_steps", device)
    if work_count is not None:
        cuda_build.require("work_count", work_count, device, torch.int64)
    return work_count


def count_pixels(name: str, V: int, U: int, flags=None,
                 active_v_u: Optional[torch.Tensor] = None) -> None:
    """Add the pixels a plain version's caller asked for (the CPU route,
    which sweeps densely) to the host counter ``name`` while tracing, as
    the kernels' wrappers add the compaction's count."""
    if profiling.enabled():
        mask = activity_mask(V, U, flags, active_v_u)
        profiling.count(name, int(mask.sum()))


def compact(mask_v_u: torch.Tensor, S: int, C: int, with_k_best: bool
            ) -> Tuple[SweepResult, torch.Tensor, int]:
    """The zeroed outputs of a sweep over the pixels of ``mask_v_u``
    ``[V, U]``, those pixels' flat indices (int32) and their number, which
    the host reads: one sync, counted as ``syncs.sweep_compact``."""
    V, U = mask_v_u.shape
    with profiling.span("sweep.compact"):
        out = sweep_outputs(V, S, U, C, with_k_best, mask_v_u.device)
        act = torch.nonzero(mask_v_u.reshape(-1)).reshape(-1).to(torch.int32)
        profiling.count("syncs.sweep_compact")
    return out, act, act.numel()


def kernel_scalars(U: int, C: int, params: DepthParams,
                   u_valid: Optional[Tuple[int, int]] = None
                   ) -> Tuple[float, int, int]:
    """The kernel's ``a_coef`` (the mean shift's kernel scale) and the
    window of valid sample columns, (0, U - 1) unless ``u_valid`` says."""
    a_coef = f32(chan_scale(C) / (params.kernel_h * params.kernel_h))
    lo, hi = (0, U - 1) if u_valid is None else u_valid
    return a_coef, int(lo), int(hi)


_SWEEP = cuda_build.Entry("sweep_rows", "rslf_sweep_rows",
                          "p iii p i ff ii ff i pppppp s")
_PLAN = cuda_build.Entry("sweep_rows", "rslf_sweep_rows_plan", "iii p")


def launch_plan(S: int, C: int, with_k_best: bool = False) -> dict:
    """What the launcher chose for ``S`` samples of ``C`` channels, with or
    without ``k_best``, on the current card: threads of a block, items of a
    window, bytes of shared memory a block, resident blocks an SM, SMs.
    Raises NotImplementedError when no block size fits."""
    return cuda_build.read_plan(_PLAN, S, C, int(with_k_best),
                                size=f"S={S}, C={C}")


def sweep_pile_rows(epis_v_s_u_c: torch.Tensor, dmin: float, dmax: float,
                    dim_d: int, s_hat: int, params: DepthParams,
                    with_k_best: bool = False, row_active=None,
                    active_v_u: Optional[torch.Tensor] = None,
                    work_count: Optional[torch.Tensor] = None) -> SweepResult:
    """Uniform-grid sweep of the pixels of every active row or chunk.

    Args:
      epis_v_s_u_c: ``[V, S, U, C]`` normalized volume.
      dmin, dmax: the uniform candidate bounds.
      row_active: optional ``[V]`` or ``[V, ceil(U / 128)]`` flags, as
        the TPU wrapper takes them.
      active_v_u: optional ``[V, U]`` bool; only these pixels are swept.
      work_count: optional int64 CUDA tensor of one element; the kernel
        adds the valid samples times mean-shift steps it ran.  None while
        tracing: the counter ``sweep.sample_steps`` (``utils.profiling``).

    While tracing, the pixels swept are added to the host counter
    ``sweep.rows.pixels``.

    Returns:
      SweepResult; on CUDA zeros at the pixels not swept.
    """
    if params.interpolation != "linear":
        raise NotImplementedError("the row sweep implements linear "
                                  "interpolation only")
    V, S, U, C = epis_v_s_u_c.shape
    dev = epis_v_s_u_c.device
    if dev.type != "cuda":
        count_pixels("sweep.rows.pixels", V, U, row_active, active_v_u)
        return sweep_rows_plain(epis_v_s_u_c,
                                candidate_grid(dmin, dmax, dim_d, dev),
                                s_hat, params, with_k_best)

    cuda_build.require("epis", epis_v_s_u_c, dev)
    work_count = sample_step_counter(work_count, dev)
    out, act, n_act = compact(
        activity_mask(V, U, row_active, active_v_u, dev), S, C, with_k_best)
    profiling.count("sweep.rows.pixels", n_act)
    if n_act == 0:
        return out

    with profiling.span("sweep.launch"):
        # the kernel computes the grid itself, operation for operation as
        # candidate_grid does
        a_coef, _, _ = kernel_scalars(U, C, params)
        _SWEEP(epis_v_s_u_c, S, U, C, act, n_act, f32(dmin), f32(dmax),
               dim_d, int(s_hat), f32(params.slope_factor), a_coef,
               params.mean_shift_max_iter, out.best_score, out.score_mean,
               out.best_depth, out.rbar, out.k_best, work_count,
               device=dev, no_fit=f"S={S}, C={C}")
    return out
