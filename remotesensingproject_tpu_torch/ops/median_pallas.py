"""Selective median: wrapper of the CUDA kernel ``csrc/median.cu``.

Counterpart of ``remotesensingproject_tpu/ops/median_pallas.py``, whose
Pallas kernel ``_median_kernel`` the CUDA kernel replaces.  Bit for bit
equal to the plain version, ``ops.median.selective_median``, which the
wrapper runs on a CPU tensor; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..types import DTYPE, chan_scale, f32
from ..utils import profiling
from . import cuda_build
from .median import selective_median

MAX_SIZE = 17


_MEDIAN = cuda_build.Entry("median", "rslf_selective_median",
                           "ppp iiii ff p s")
_PLAN = cuda_build.Entry("median", "rslf_selective_median_plan", "ii p")


def launch_plan(size: int, C: int) -> dict:
    """The launcher's choice for window side ``size`` and ``C`` channels:
    threads a block, tile rows and columns, channels a stage, dynamic
    shared memory, and the instantiation it runs (``size_template``,
    ``channel_template``; 0 = the generic one)."""
    out = (ctypes.c_int * 7)()
    _PLAN(size, C, out)
    keys = ("threads", "tile_v", "tile_u", "channels_per_stage",
            "smem_bytes", "size_template", "channel_template")
    return dict(zip(keys, out))


def selective_median_cuda(src_v_u: torch.Tensor, frame_v_u_c: torch.Tensor,
                          mask_v_u: torch.Tensor, size: int,
                          epsilon: float) -> torch.Tensor:
    """Drop-in for ``ops.median.selective_median`` (bitwise equal)."""
    with profiling.span("median"):
        dev = src_v_u.device
        if dev.type != "cuda":
            return selective_median(src_v_u, frame_v_u_c, mask_v_u, size,
                                    epsilon)
        if size > MAX_SIZE or size < 1:
            raise NotImplementedError(f"median window must be 1..{MAX_SIZE}")
        V, U = src_v_u.shape
        C = frame_v_u_c.shape[-1]
        if (frame_v_u_c.shape != (V, U, C) or mask_v_u.shape != (V, U)
                or C < 1):
            raise ValueError(f"median: src {tuple(src_v_u.shape)}, frame "
                             f"{tuple(frame_v_u_c.shape)} and mask "
                             f"{tuple(mask_v_u.shape)} must be [V, U], "
                             f"[V, U, C >= 1] and [V, U]")
        cuda_build.require("src", src_v_u, dev)
        cuda_build.require("frame", frame_v_u_c, dev)
        cuda_build.require("mask", mask_v_u, dev, torch.bool)
        out = torch.empty((V, U), dtype=DTYPE, device=dev)
        if out.numel() == 0:
            return out
        _MEDIAN(src_v_u, mask_v_u, frame_v_u_c, V, U, C, size, f32(epsilon),
                chan_scale(C), out, device=dev)
        return out
