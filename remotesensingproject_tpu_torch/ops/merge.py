"""The pass's merge: the plain version and the wrapper of the CUDA kernel
``csrc/merge.cu``.

After a pass's sweep, its results at the pass's ``active`` pixels go into
the state's s_hat planes (JAX ``depth2d.py:433-455``): a pixel whose best
score passes ``raw_score_threshold`` (good) takes the sweep's depth and
r_bar and the confidence C_e |best score - mean score|; an active one that
fails (bad) loses its edge confidence and its mask bit (the claim bit
stays); every other pixel keeps its values.  The JAX package merges with
XLA, not in a Pallas kernel.  The wrapper runs the plain version on a CPU
tensor and the kernel, bit for bit the same, on a CUDA tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..types import DTYPE, f32
from ..utils import profiling
from . import cuda_build
from .sweep import SweepResult


class Merged(NamedTuple):
    """What the rest of the pass reads of the merge."""

    depth: torch.Tensor           # [V, U] view of best_depth[s_hat]
    mask: torch.Tensor            # [V, U] view of ce_mask[s_hat]
    conf: torch.Tensor            # [V, U] disp_conf[s_hat], its own buffer
    rbar: torch.Tensor            # [V, U, C] view of rbar[s_hat]
    good: Optional[torch.Tensor]  # [V, U] bool, with ``with_good`` only


def merge(state, s_hat: int, active: torch.Tensor, res: SweepResult,
          threshold: float, with_good: bool = False) -> Merged:
    """The plain version, on whatever device the tensors lie: updates the
    s_hat planes of ``state`` (a ``Depth2DState``: ``ce``, ``ce_mask``,
    ``disp_conf``, ``best_depth``, ``rbar``) in place.  ``conf`` shares no
    storage with ``state.disp_conf``: the paint reads it as the source of
    that plane's payload while writing the plane."""
    ce_p = state.ce[s_hat]
    mask_p = state.ce_mask[s_hat]
    zero = torch.zeros((), dtype=DTYPE, device=active.device)
    ok = res.best_score > threshold
    good = active & ok
    bad = active & ~ok
    ce_new = torch.where(bad, zero, ce_p)
    mask_new = mask_p & ~bad
    depth_new = torch.where(good, res.best_depth, state.best_depth[s_hat])
    conf_new = torch.where(
        good, ce_new * torch.abs(res.best_score - res.score_mean),
        state.disp_conf[s_hat])
    rbar_new = torch.where(good[..., None], res.rbar, state.rbar[s_hat])
    state.ce[s_hat] = ce_new
    state.ce_mask[s_hat] = mask_new
    state.disp_conf[s_hat] = conf_new
    state.best_depth[s_hat] = depth_new
    state.rbar[s_hat] = rbar_new
    return Merged(state.best_depth[s_hat], state.ce_mask[s_hat], conf_new,
                  state.rbar[s_hat], good if with_good else None)


_MERGE = cuda_build.Entry("merge", "rslf_merge", "ppppp f ppppppp iii s")


def merge_cuda(state, s_hat: int, active: torch.Tensor, res: SweepResult,
               threshold: float, with_good: bool = False) -> Merged:
    """Drop-in for :func:`merge` (bitwise equal).  On a CUDA tensor one
    kernel launch updates the planes, writes ``conf`` (a new buffer) and,
    with ``with_good``, the ``good`` plane; it counts ``merge.launches``
    while tracing."""
    dev = active.device
    if dev.type != "cuda":
        return merge(state, s_hat, active, res, threshold, with_good)
    V, U = active.shape
    S = state.ce.shape[0]
    C = state.rbar.shape[-1]
    planes = dict(ce=state.ce, ce_mask=state.ce_mask,
                  disp_conf=state.disp_conf, best_depth=state.best_depth)
    outs = dict(best_score=res.best_score, score_mean=res.score_mean,
                best_depth=res.best_depth)
    if (any(tuple(t.shape) != (S, V, U) for t in planes.values())
            or tuple(state.rbar.shape) != (S, V, U, C)
            or any(tuple(t.shape) != (V, U) for t in outs.values())
            or tuple(res.rbar.shape) != (V, U, C)
            or not 0 <= s_hat < S):
        raise ValueError(
            f"merge: active ({V}, {U}) needs state planes ({S}, {V}, {U}), "
            f"r_bar ({S}, {V}, {U}, {C}), sweep results ({V}, {U}) and "
            f"r_bar ({V}, {U}, {C}), 0 <= s_hat < {S}; got "
            + ", ".join(f"{k} {tuple(t.shape)}"
                        for k, t in {**planes, "rbar": state.rbar,
                                     **outs, "res.rbar": res.rbar}.items())
            + f", s_hat {s_hat}")
    cuda_build.require("active", active, dev, torch.bool)
    for name, t in planes.items():
        cuda_build.require(name, t, dev,
                           torch.bool if name == "ce_mask" else DTYPE)
    cuda_build.require("rbar", state.rbar, dev)
    outs = {k: t.contiguous() for k, t in outs.items()}
    rbar_in = res.rbar.contiguous()
    for name, t in (*outs.items(), ("res.rbar", rbar_in)):
        cuda_build.require(name, t, dev)
    conf = torch.empty((V, U), dtype=DTYPE, device=dev)
    good = torch.empty((V, U), dtype=torch.bool, device=dev) \
        if with_good else None
    views = {k: t[s_hat] for k, t in planes.items()}
    rbar = state.rbar[s_hat]
    _MERGE(active, outs["best_score"], outs["score_mean"], outs["best_depth"],
           rbar_in, f32(threshold), views["ce"], views["ce_mask"],
           views["disp_conf"], views["best_depth"], rbar, conf, good, V, U, C,
           device=dev)
    profiling.count("merge.launches")
    return Merged(views["best_depth"], views["ce_mask"], conf, rbar, good)
