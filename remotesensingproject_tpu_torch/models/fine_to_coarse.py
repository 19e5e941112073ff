"""Fine-to-coarse pyramid driver.

Counterpart of ``remotesensingproject_tpu/models/fine_to_coarse.py``
(reference: FineToCoarse, rslf_fine_to_coarse.hpp:26-322): a chain of
Depth2DComputers on 2x-downsampled (v, u) light fields (s untouched)
while both spatial dims exceed ``min_spatial_dim``, with slope_factor =
dim_u / start_dim_u per level; run fine to coarse, each coarser level's
per-pixel bounds derived from the nearest confident parents; the last
level accepts all measures; then a coarse-to-fine fusion.

Each level's computer normalizes its own input.  uint8 inputs stay in the
rounded uint8 domain through the pyramid (OpenCV's CV_8U saturate_cast):
each downsampled level is rounded half to even, as ``jnp.round`` does in
the JAX package, and clamped to [0, 255].
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from ..config import DEFAULT_PARAMS, DEFAULT_PYRAMID, DepthParams, \
    PyramidParams
from ..ops.pyramid import bounds_from_parent, downsample_epis, fuse_disp_maps
from ..types import DTYPE, resolve_device
from .depth2d import Depth2DComputer, _as_tensor


class FineToCoarse:
    """Runs on CUDA unless ``device`` names another device.
    ``coarse_mode`` is handed to every level's Depth2DComputer."""

    def __init__(self, epis_v_s_u_c, dmin: float, dmax: float, dim_d: int,
                 epi_scale_factor: float = -1.0,
                 params: DepthParams = DEFAULT_PARAMS,
                 pyramid: PyramidParams = DEFAULT_PYRAMID,
                 verbose: bool = False, device=None,
                 coarse_mode: str = "tile"):
        self.device = resolve_device(device)
        epis = _as_tensor(epis_v_s_u_c, self.device)
        if epis.dim() == 3:
            epis = epis[..., None]
        self.is_uint8 = epis.dtype == torch.uint8
        raw = epis.to(DTYPE)
        self.params = params
        self.pyramid = pyramid
        self.verbose = verbose
        self.computers: List[Depth2DComputer] = []
        self.level_params: List[DepthParams] = []
        # host seconds of each level's run(), filled by run()
        self.level_seconds: List[float] = []

        start_dim_u = raw.shape[2]
        max_depth = pyramid.max_pyr_depth
        if max_depth < 1:
            max_depth = np.iinfo(np.int32).max
        level = raw
        while (level.shape[0] > pyramid.min_spatial_dim
               and level.shape[2] > pyramid.min_spatial_dim
               and len(self.computers) < max_depth):
            lvl_params = params.with_slope_factor(level.shape[2] / start_dim_u)
            if verbose:
                print(f"level {len(self.computers)}: (v={level.shape[0]}, "
                      f"u={level.shape[2]}) "
                      f"slope_factor={lvl_params.slope_factor:.4f}")
            lvl_input = level.to(torch.uint8) if self.is_uint8 else level
            self.computers.append(Depth2DComputer(
                lvl_input, dmin, dmax, dim_d, epi_scale_factor, lvl_params,
                device=self.device, coarse_mode=coarse_mode))
            self.level_params.append(lvl_params)
            level = downsample_epis(level)
            if self.is_uint8:
                level = torch.clamp(torch.round(level), 0, 255)

        if pyramid.accept_all_last_scale:
            self.computers[-1].set_accept_all(True)

    def run(self):
        """Run all levels fine to coarse, deriving per-pixel bounds."""
        self.level_seconds = []
        for p, computer in enumerate(self.computers):
            t0 = time.perf_counter()
            computer.run()
            self.level_seconds.append(time.perf_counter() - t0)
            if self.verbose:
                print(f"level {p} done in {self.level_seconds[-1]:.2f}s "
                      f"({computer.passes_run} passes)")
            if p < len(self.computers) - 1:
                nxt = self.computers[p + 1]
                nxt.set_bounds(*bounds_from_parent(
                    computer.get_depths_s_v_u(),
                    computer.get_valid_depths_mask_s_v_u(),
                    nxt.dmin_s_v_u, nxt.dmax_s_v_u))
            # r_bar is only read while the level's own passes paint
            computer.state.rbar = torch.zeros((1, 1, 1, 1), dtype=DTYPE,
                                              device=self.device)

    def get_results(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fused disparity maps + validity at the finest scale
        (rslf_fine_to_coarse.hpp:302-322), ``[S, V, U]`` each."""
        return fuse_disp_maps(
            [c.get_depths_s_v_u() for c in self.computers],
            [c.get_valid_depths_mask_s_v_u() for c in self.computers],
            self.pyramid.final_median_filter_size)
