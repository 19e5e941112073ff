"""Line painting: wrapper of the CUDA kernel ``csrc/paint.cu``.

Counterpart of ``remotesensingproject_tpu/ops/propagation_pallas.py``,
whose Pallas kernel ``_paint_kernel`` the CUDA kernel replaces.  Same
contract as the plain version, ``ops.propagation.propagate``, which the
wrapper runs on a CPU tensor, and bit for bit the same result; on a CUDA
tensor it launches the kernel or raises.  Claim and targets are updated
in place.  The kernel is driven from the sources (one offset rounding per
frame and source, the smallest qualifying source column wins a target), so
it takes the depths, the source mask and the slope factor as they are and
needs no offset range.  It carries one to three payloads: depth and
disp_conf, and line_conf in line mode.  With ``u_origin`` the sources may
be wider than the targets (the (v, u) mesh's u-haloed sources).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..types import chan_scale, f32
from ..utils import profiling
from . import cuda_build
from .propagation import propagate

#: the most target columns a block of the kernel takes
MAX_TILE = 8192
#: the most (target, source) payload pairs the kernel carries
MAX_PAYLOADS = 3


_PAINT = cuda_build.Entry("paint", "rslf_paint",
                          "ppppp iiiiiii fff i pppppp i s")


def propagate_cuda(claim_s_v_u: torch.Tensor, frames_s_v_u_c: torch.Tensor,
                   depth_f_v_u: torch.Tensor, rbar_v_u_c: torch.Tensor,
                   source_mask_v_u: torch.Tensor, s_hat: int,
                   slope_factor: float, epsilon: float,
                   payloads: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                   u_origin: int = 0, tile: int = 0):
    """Drop-in for ``ops.propagation.propagate`` (bitwise equal), with its
    ``u_origin``: the source planes may be ``Us`` >= U columns wide.

    ``tile`` is the number of target columns a block of the kernel takes,
    at most :data:`MAX_TILE`; 0 lets the launcher choose, and the result
    does not depend on it."""
    with profiling.span("paint"):
        dev = claim_s_v_u.device
        if dev.type != "cuda":
            return propagate(claim_s_v_u, frames_s_v_u_c, depth_f_v_u,
                             rbar_v_u_c, source_mask_v_u, s_hat, slope_factor,
                             epsilon, payloads, u_origin)
        S, V, U = claim_s_v_u.shape
        C = frames_s_v_u_c.shape[-1]
        Us = depth_f_v_u.shape[1]
        if not (Us >= U and 0 <= u_origin <= Us - U):
            raise ValueError(f"paint: sources {Us} columns wide cannot hold "
                             f"{U} target columns from column {u_origin}")
        if not 1 <= len(payloads) <= MAX_PAYLOADS:
            raise NotImplementedError(
                f"the CUDA paint carries 1 to {MAX_PAYLOADS} payloads")
        cuda_build.require("claim", claim_s_v_u, dev, torch.bool)
        cuda_build.require("frames", frames_s_v_u_c, dev)
        cuda_build.require("rbar", rbar_v_u_c, dev)
        for tgt, src in payloads:
            cuda_build.require("payload target", tgt, dev)
            cuda_build.require("payload source", src, dev)

        if not 0 <= tile <= MAX_TILE:
            raise ValueError(f"tile must be in [0, {MAX_TILE}]")
        depth_f_v_u = depth_f_v_u.contiguous()
        source_mask_v_u = source_mask_v_u.contiguous()
        cuda_build.require("depth", depth_f_v_u, dev)
        cuda_build.require("source mask", source_mask_v_u, dev, torch.bool)
        pairs = list(payloads) + [(None, None)] * (MAX_PAYLOADS
                                                   - len(payloads))
        _PAINT(claim_s_v_u, frames_s_v_u_c, depth_f_v_u, source_mask_v_u,
               rbar_v_u_c, S, V, U, C, Us, int(u_origin), int(s_hat),
               f32(slope_factor), chan_scale(C),
               float(np.float32(epsilon) ** 2), len(payloads),
               *(t for tgt, src in pairs for t in (src, tgt)), int(tile),
               device=dev)
        return claim_s_v_u, tuple(t for t, _ in payloads)
