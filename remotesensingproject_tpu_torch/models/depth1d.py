"""Single-EPI depth computation (one v, one s_hat).

Counterpart of ``remotesensingproject_tpu/models/depth1d.py`` (reference:
Depth1DComputer, rslf_depth_computation.hpp:256-416): edge confidence of
the s_hat row and a slope sweep of one EPI, with NO selective median
(Depth1DComputer::run calls only compute_1D_edge_confidence and
compute_1D_depth_epi).

The JAX package sweeps with its XLA ``sweep_epi``, which positions every
sample per pixel and always runs ``mean_shift_max_iter`` steps.  The port
sweeps the EPI as a volume of one row through
:func:`~.depth2d.sweep_pass` with explicit uniform ``[1, U]`` bounds and
``coarse_mode="pixel"``: the pixel kernel for C in {1, 3} and D <= 1024,
else the tile kernel on each pixel's own (here the uniform) grid; never
the row kernel, whose shared-shift positions round otherwise.  The sweep
runs with ``fast=False``: fast mode caps only the pixel sweep of the
passes, and ``sweep_epi`` is not capped.  The swept pixels are those of
the edge mask; every output outside ``mask & ok`` is zeroed, so sweeping
every pixel would give the same result.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..config import DEFAULT_PARAMS, DepthParams
from ..ops.edge_confidence import edge_confidence_frame
from ..ops.normalize import normalize_volume
from ..ops.sweep import SweepResult
from ..types import DTYPE, f32, resolve_device
from ..utils.plot import coloured_epi_lines
from .depth2d import _as_tensor, sweep_pass


class Depth1DResult(NamedTuple):
    edge_confidence: torch.Tensor  # [U]
    edge_mask: torch.Tensor        # [U] bool
    best_depth: torch.Tensor       # [U]
    disp_confidence: torch.Tensor  # [U]
    rbar: torch.Tensor             # [U, C]


def depth1d_result(ce: torch.Tensor, mask: torch.Tensor, res: SweepResult,
                   params: DepthParams) -> Depth1DResult:
    """The outputs of one EPI from its ``[U]`` edge confidence and mask and
    its sweep (row 0 of a ``[1, U]`` SweepResult): sub-threshold max
    scores zero the confidence and the mask, and every output is zeroed
    outside the kept mask (JAX ``depth1d.py:43-49``)."""
    zero = torch.zeros((), dtype=DTYPE, device=ce.device)
    best_score, score_mean = res.best_score[0], res.score_mean[0]
    ok = best_score > params.raw_score_threshold
    ce_out = torch.where(mask & ~ok, zero, ce)
    mask_out = mask & ok
    depth = torch.where(mask_out, res.best_depth[0], zero)
    conf = torch.where(mask_out, ce * torch.abs(best_score - score_mean),
                       zero)
    rbar = torch.where(mask_out[:, None], res.rbar[0], zero)
    return Depth1DResult(ce_out, mask_out, depth, conf, rbar)


class Depth1DComputer:
    """Mirrors the reference Depth1DComputer's ctor / run / getters.

    Runs on CUDA unless ``device`` names another device."""

    def __init__(self, epi_s_u_c, dmin: float, dmax: float, dim_d: int,
                 s_hat: int = -1, epi_scale_factor: float = -1.0,
                 params: DepthParams = DEFAULT_PARAMS, device=None):
        self.device = resolve_device(device)
        epi = _as_tensor(epi_s_u_c, self.device)
        if epi.dim() == 2:
            epi = epi[..., None]
        self.epi = normalize_volume(epi, epi_scale_factor).contiguous()
        S = self.epi.shape[0]
        self.s_hat = s_hat if 0 <= s_hat < S else int(S // 2)
        self.dim_d = dim_d
        self.dmin = float(dmin)
        self.dmax = float(dmax)
        self.params = params
        self.result: Optional[Depth1DResult] = None

    def run(self) -> Depth1DResult:
        p = self.params
        S, U, C = self.epi.shape
        ce, mask = edge_confidence_frame(self.epi[self.s_hat][None], p)
        bounds = [torch.full((1, U), f32(b), dtype=DTYPE, device=self.device)
                  for b in (self.dmin, self.dmax)]
        res = sweep_pass(self.epi[None], mask.contiguous(), self.s_hat,
                         self.dim_d, dataclasses.replace(p, fast=False),
                         (self.dmin, self.dmax), *bounds, coarse_mode="pixel")
        self.result = depth1d_result(ce[0], mask[0], res, p)
        return self.result

    def get_coloured_epi(self, colormap: str = "jet"):
        """EPI with disparity-coloured line overlays
        (rslf_depth_computation.hpp:373-416)."""
        return coloured_epi_lines(self.epi, self.result, self.s_hat,
                                  self.params, colormap)
