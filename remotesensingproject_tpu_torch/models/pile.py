"""Single-pass depth over all EPI rows (one s_hat, all v).

Counterpart of ``remotesensingproject_tpu/models/pile.py`` (reference:
Depth1DComputer_pile, rslf_depth_computation.hpp:425-641): normalize, edge
confidence of the s_hat frame, the dense row sweep over every (v, u)
(CUDA kernel ``csrc/sweep_rows.cu``), sub-threshold zeroing, disparity
confidence, then the selective median (CUDA kernel ``csrc/median.cu``).
Nearest interpolation, which the JAX package sweeps with its XLA
``sweep_pile`` (per-pixel rounding), takes the pass's per-pixel route
instead of the row sweep: the pixel kernel with every pixel active for
C in {1, 3}, the tile kernel on the uniform grid otherwise.  On the CPU the
plain versions run instead.  ``use_pallas=False`` runs the plain sweep on
each pixel's own (uniform) grid and the plain median on the computer's
device: the JAX package's XLA path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import DEFAULT_PARAMS, DepthParams
from ..ops.edge_confidence import edge_confidence_frame
from ..ops.median import selective_median
from ..ops.median_pallas import selective_median_cuda
from ..ops.normalize import normalize_volume
from ..ops.sweep import sweep_pile
from ..ops.sweep_pallas import sweep_pile_rows
from ..types import DTYPE, f32, resolve_device
from ..utils.plot import coloured_epi_from_pile, disparity_map_image
from .depth2d import _as_tensor, sweep_pass


class PileResult(NamedTuple):
    edge_confidence: torch.Tensor   # [V, U] (post-sweep zeroing)
    edge_mask: torch.Tensor         # [V, U] bool
    best_depth: torch.Tensor        # [V, U] median-filtered disparities
    best_depth_raw: torch.Tensor    # [V, U] pre-filter sweep disparities
    disp_confidence: torch.Tensor   # [V, U]
    rbar: torch.Tensor              # [V, U, C]


class Depth1DComputerPile:
    """Driver mirroring Depth1DComputer_pile's ctor / run / getters.

    Runs on CUDA unless ``device`` names another device; the kernels, or
    with ``use_pallas=False`` the plain versions."""

    def __init__(self, epis_v_s_u_c, dmin: float, dmax: float, dim_d: int,
                 s_hat: int = -1, epi_scale_factor: float = -1.0,
                 params: DepthParams = DEFAULT_PARAMS, device=None,
                 use_pallas: Optional[bool] = None):
        self.use_pallas = use_pallas
        self.device = resolve_device(device)
        epis = _as_tensor(epis_v_s_u_c, self.device)
        if epis.dim() == 3:
            epis = epis[..., None]
        self.epis = normalize_volume(epis, epi_scale_factor).contiguous()
        S = self.epis.shape[1]
        # default s_hat: floor(S / 2) (rslf_depth_computation.hpp:305)
        self.s_hat = s_hat if 0 <= s_hat < S else int(S // 2)
        self.dim_d = dim_d
        self.dmin = float(dmin)
        self.dmax = float(dmax)
        self.params = params
        self.result: Optional[PileResult] = None

    def run(self) -> PileResult:
        p = self.params
        frame = self.epis[:, self.s_hat].contiguous()     # [V, U, C]
        ce, mask = edge_confidence_frame(frame, p)
        median = selective_median_cuda
        if self.use_pallas is False:
            V, _, U, _ = self.epis.shape
            res = sweep_pile(self.epis, *(
                torch.full((V, U), f32(b), dtype=DTYPE, device=self.device)
                for b in (self.dmin, self.dmax)), self.dim_d, self.s_hat, p)
            median = selective_median
        elif p.interpolation == "nearest":
            every = torch.ones(mask.shape, dtype=torch.bool,
                               device=self.device)
            res = sweep_pass(self.epis, every, self.s_hat, self.dim_d, p,
                             (self.dmin, self.dmax))
        else:
            res = sweep_pile_rows(self.epis, self.dmin, self.dmax,
                                  self.dim_d, self.s_hat, p)

        # sub-threshold max scores zero the confidence and the mask
        # (core.hpp:653-657)
        zero = torch.zeros((), dtype=ce.dtype, device=ce.device)
        ok = res.best_score > p.raw_score_threshold
        ce_out = torch.where(mask & ~ok, zero, ce)
        mask_out = (mask & ok).contiguous()
        best_raw = torch.where(mask_out, res.best_depth, zero).contiguous()
        disp_conf = torch.where(
            mask_out, ce * torch.abs(res.best_score - res.score_mean), zero)
        rbar = torch.where(mask_out[..., None], res.rbar, zero)

        # selective median over the (v, u) disparity slice, gated by the
        # post-sweep edge mask and the s_hat frame (core.hpp:877-892)
        filtered = median(best_raw, frame, mask_out, p.median_filter_size,
                          p.median_filter_epsilon)
        self.result = PileResult(ce_out, mask_out, filtered, best_raw,
                                 disp_conf, rbar)
        return self.result

    def get_depths(self) -> torch.Tensor:
        return self.result.best_depth

    def get_coloured_epi(self, v: int = -1, colormap: str = "jet"):
        """Colour EPI at row v (rslf_depth_computation.hpp:567-618)."""
        if v < 0:
            v = self.epis.shape[0] // 2
        return coloured_epi_from_pile(self, v, colormap)

    def get_disparity_map(self, colormap: str = "jet"):
        """Colormapped disparity map, masked by edge confidence
        (rslf_depth_computation.hpp:620-641)."""
        return disparity_map_image(self.result.best_depth,
                                   self.result.edge_mask, colormap)
