"""Line confidence C_l: the plain version and the wrapper of the CUDA
kernel ``csrc/line_conf.cu``.

C_l = sum_s C_e(I) K / sum_s K along each pixel's winning line (JAX
``depth2d.py:68-135``, reference core.hpp:1032-1081), 0 outside the mask.
The JAX package computes it with XLA, not in a Pallas kernel.  The wrapper
runs the plain version on a CPU tensor and the kernel, bit for bit the
same, on a CUDA tensor.  The kernel reads ``C_e`` along each masked
pixel's line and ``k_best`` directly, and sums over s in the plain
version's order by halves, walking the tree depth first as
:func:`halves_program` says.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..types import DTYPE
from ..utils import profiling
from . import cuda_build

#: halving steps the kernel's walk keeps a pending sum for (its
#: ``kLevels``)
LEVELS = 11
#: the most frames S the kernel takes
MAX_S = 2 ** LEVELS
#: what a leaf's value does at a step of the walk, two bits a step: carried
#: as it is (an odd last element), added to the pending left sibling,
#: stored as a left child
PASS, ADD, STORE = 0, 1, 2
#: the bit of a program word where a leaf's step count starts
STEPS_SHIFT = 24


def line_confidence(ce_s_v_u: torch.Tensor, depth_v_u: torch.Tensor,
                    k_best_v_s_u: torch.Tensor, mask_v_u: torch.Tensor,
                    s_hat: int) -> torch.Tensor:
    """The plain version, on whatever device the tensors lie.  I = (s_hat
    - s) * d + u with the filtered depth d; the reference's index leaves
    out ``slope_factor``, and so does this one.  C_e is interpolated
    linearly along u; a sample counts iff floor(I) >= 0 and ceil(I) <= U -
    1.  One batched gather over ``[S, V, U]``, and sums over s by halves
    (:func:`_sum_halves`): a few launches whatever S is, and an order that
    does not depend on V, so a block of rows (a v-split mesh) sums as the
    whole plane does."""
    S, V, U = ce_s_v_u.shape
    dev = ce_s_v_u.device
    zero = torch.zeros((), dtype=DTYPE, device=dev)
    ds = float(s_hat) - torch.arange(S, dtype=DTYPE, device=dev)
    idx = ds[:, None, None] * depth_v_u + torch.arange(U, dtype=DTYPE,
                                                       device=dev)
    fi = torch.floor(idx)
    valid = (fi >= 0) & (torch.ceil(idx) <= U - 1)
    t = idx.sub_(fi)                                  # idx - floor(idx)
    i0 = fi.clamp_(0, U - 1).to(torch.int64)
    a = torch.gather(ce_s_v_u, 2, i0)
    b = torch.gather(ce_s_v_u, 2, i0.add_(1).clamp_(max=U - 1))
    del i0, fi
    ce_i = torch.where(valid, (1.0 - t) * a + t * b, zero)
    k = k_best_v_s_u.permute(1, 0, 2)                 # [S, V, U]
    num = _sum_halves(ce_i * k)
    den = _sum_halves(k)
    return torch.where(mask_v_u, num / den, zero)


def _sum_halves(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 by halves: x[:h] + x[h:2h], the odd last slice
    carried, until one is left.  Every add is elementwise, so the result
    does not depend on the other axes' extents (``torch.sum``'s order
    does)."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] + x[h:2 * h]
        x = torch.cat([y, x[2 * h:]]) if x.shape[0] % 2 else y
    return x[0]


def halves_program(S: int) -> np.ndarray:
    """The kernel's walk of :func:`_sum_halves`' tree for S leaves: int32
    ``[S, 2]``, one row a leaf in post-order: the leaf s, and a word that
    says what its value does at each step L on its way up, in bits 2L and
    2L + 1 (``STORE`` as a left child, its last step; ``ADD`` to the
    pending left sibling; ``PASS``), and from bit :data:`STEPS_SHIFT` how
    many steps it takes.  A node of step L + 1 is the sum of nodes j and j
    + h_L of step L (h_L = n_L // 2), so a walk needs one pending sum a
    step; the last leaf's value ends as the root."""
    if not 1 <= S <= MAX_S:
        raise ValueError(f"the line confidence kernel takes 1 to {MAX_S} "
                         f"frames, not {S}")
    sizes = [S]                                       # n_L, step by step
    while sizes[-1] > 1:
        sizes.append((sizes[-1] + 1) // 2)
    top = len(sizes) - 1
    prog = []

    def code(j):
        out = 0
        for L in range(top):
            h = sizes[L] // 2
            if j < h:
                return out | STORE << 2 * L
            if j < 2 * h:
                out, j = out | ADD << 2 * L, j - h
            else:
                j = h                                 # PASS
        return out

    def word(j):
        c = code(j)
        return c | (c.bit_length() + 1) // 2 << STEPS_SHIFT

    def walk(L, j):                                   # node j of step L
        if L == 0:
            prog.append((j, word(j)))
            return
        h = sizes[L - 1] // 2
        if j < h:
            walk(L - 1, j)
            walk(L - 1, j + h)
        else:
            walk(L - 1, 2 * h)

    walk(top, 0)
    return np.asarray(prog, dtype=np.int32)


_programs: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _program(S: int, dev: torch.device) -> torch.Tensor:
    """:func:`halves_program` on ``dev``, built once per S and device."""
    prog = _programs.get((dev, S))
    if prog is None:
        prog = _programs[dev, S] = torch.from_numpy(
            halves_program(S)).to(dev)
    return prog


_LINE_CONF = cuda_build.Entry("line_conf", "rslf_line_conf",
                              "pppppp iiii p s")


def line_confidence_cuda(ce_s_v_u: torch.Tensor, depth_v_u: torch.Tensor,
                         k_best_v_s_u: torch.Tensor, mask_v_u: torch.Tensor,
                         s_hat: int) -> torch.Tensor:
    """Drop-in for :func:`line_confidence` (bitwise equal).  On a CUDA
    tensor the kernel computes only the pixels of ``mask_v_u``, reading
    ``k_best`` there alone, and adds them to the device counter
    ``line_conf.pixels`` while tracing.  S is at most :data:`MAX_S`."""
    dev = ce_s_v_u.device
    if dev.type != "cuda":
        return line_confidence(ce_s_v_u, depth_v_u, k_best_v_s_u, mask_v_u,
                               s_hat)
    S, V, U = ce_s_v_u.shape
    if not 1 <= S <= MAX_S:
        raise NotImplementedError(f"the CUDA line confidence takes 1 to "
                                  f"{MAX_S} frames, not {S}")
    if (tuple(depth_v_u.shape) != (V, U) or tuple(mask_v_u.shape) != (V, U)
            or tuple(k_best_v_s_u.shape) != (V, S, U)):
        raise ValueError(f"line confidence: C_e {tuple(ce_s_v_u.shape)} "
                         f"needs depth and mask ({V}, {U}) and k_best "
                         f"({V}, {S}, {U}), got {tuple(depth_v_u.shape)}, "
                         f"{tuple(mask_v_u.shape)}, "
                         f"{tuple(k_best_v_s_u.shape)}")
    cuda_build.require("ce", ce_s_v_u, dev)
    cuda_build.require("k_best", k_best_v_s_u, dev)
    depth_v_u = depth_v_u.contiguous()
    mask_v_u = mask_v_u.contiguous()
    cuda_build.require("depth", depth_v_u, dev)
    cuda_build.require("mask", mask_v_u, dev, torch.bool)
    count = profiling.device_counter("line_conf.pixels", dev)
    out = torch.empty((V, U), dtype=DTYPE, device=dev)
    _LINE_CONF(ce_s_v_u, depth_v_u, k_best_v_s_u, mask_v_u, _program(S, dev),
               out, S, V, U, int(s_hat), count, device=dev)
    return out
