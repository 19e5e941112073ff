"""Algorithm configuration.

PyTorch port's copy of ``remotesensingproject_tpu/config.py``, field for
field: one dataclass for the depth pipeline's scalars and one for the
fine-to-coarse pyramid.  Defaults mirror the reference
(rslf_depth_computation_core.hpp:15-37, rslf_fine_to_coarse.hpp:8,
src/rslf_fine_to_coarse_core.cpp:4-5).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

from .types import SHADOW_NORMALIZED_LEVEL


@dataclasses.dataclass(frozen=True)
class DepthParams:
    """All scalar parameters of the Kim'13 depth pipeline."""

    interpolation: Literal["linear", "nearest"] = "linear"
    kernel_h: float = 0.2
    edge_score_threshold: float = 0.02
    line_score_threshold: float = 0.02
    disp_score_threshold: float = 0.01
    raw_score_threshold: float = 0.0
    mean_shift_max_iter: int = 10
    edge_confidence_filter_size: int = 9
    # opening applied only when > 1 (core.hpp:759-769)
    edge_confidence_opening_size: int = 1
    median_filter_size: int = 5
    median_filter_epsilon: float = 0.1
    propagation_epsilon: float = 0.1
    # rescaled per pyramid level to dim_u / start_dim_u
    slope_factor: float = 1.0
    cut_shadows: bool = True
    shadow_level: float = SHADOW_NORMALIZED_LEVEL
    score_version: Literal["edge", "disp", "line"] = "edge"
    # Fast mode: cap the truncated mean shift of the PIXEL sweep at 5
    # iterations instead of the reference's 10 (core.hpp:16), under linear
    # interpolation, as the JAX package's pixel kernel does.  Not bit-exact
    # against the reference: quality-gated by the REF_ANCHOR margin.  No
    # effect on the row and tile sweeps or on nearest interpolation, which
    # the JAX package runs uncapped (its dense-row and per-pixel kernels
    # and its XLA path).
    fast: bool = False

    def with_slope_factor(self, slope_factor: float) -> "DepthParams":
        return dataclasses.replace(self, slope_factor=slope_factor)


@dataclasses.dataclass(frozen=True)
class PyramidParams:
    """Fine-to-coarse pyramid constants."""

    min_spatial_dim: int = 10
    gaussian_ksize: int = 7
    final_median_filter_size: int = 3
    # <1 means no limit
    max_pyr_depth: int = -1
    accept_all_last_scale: bool = True


DEFAULT_PARAMS = DepthParams()
DEFAULT_PYRAMID = PyramidParams()


def params_from(obj, cls=DepthParams):
    """``cls`` built field by field from any object with the same
    attributes (for example the JAX package's config dataclasses)."""
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(cls)})
