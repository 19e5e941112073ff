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


def _median_fn():
    lib = cuda_build.load("median")
    fn = lib.rslf_selective_median
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, P, P, I, I, I, I, F, F, P, P]
    fn.restype = ctypes.c_int
    return lib, fn


def launch_plan(size: int, C: int) -> dict:
    """The launcher's choice for window side ``size`` and ``C`` channels:
    threads a block, tile rows and columns, channels a stage, dynamic
    shared memory, and the instantiation it runs (``size_template``,
    ``channel_template``; 0 = the generic one)."""
    lib, _ = _median_fn()
    fn = lib.rslf_selective_median_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    cuda_build.check(fn(size, C, out), lib, "rslf_median_error_string",
                     "median plan")
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
        lib, fn = _median_fn()
        err = fn(cuda_build.ptr(src_v_u), cuda_build.ptr(mask_v_u),
                 cuda_build.ptr(frame_v_u_c), V, U, C, size, f32(epsilon),
                 chan_scale(C), cuda_build.ptr(out),
                 cuda_build.stream_ptr(dev))
        cuda_build.check(err, lib, "rslf_median_error_string", "median")
        selective_median_cuda.launches += 1
        return out


#: kernel launches since the count was last set to 0
selective_median_cuda.launches = 0
