"""The pass over a v-split mesh, with row halos for the selective median.

Counterpart of ``remotesensingproject_tpu/parallel/sharding.py``.  The
``[V, S, U, C]`` volume and every ``[S, V, U]`` state plane are split over
the ranks along v; each rank runs the single-device pass
(``models.depth2d._pass_fn``, one pass implementation) on its block with:

* no halo for the sweep (the EPIs are independent per v);
* a row halo for the selective median's (v, u) window
  (:func:`selective_median_sharded`), zero rows at the image's edges,
  which the median's mask excludes as it excludes taps outside the image;
* claims, depths and confidences updated on the block (the paint never
  crosses v);
* the remaining-pixel count summed over the ranks for the early stop.

How a halo travels.  On NCCL every collective exists, but two ranks that
share one card must use gloo, which has only ``all_reduce`` and
``broadcast`` for CUDA tensors.  So a halo exchange is one ``all_reduce``
that works on every backend and on either device: each rank writes the
bytes of its edge slices into its own slot of a zeroed ``[ring, 2,
bytes]`` uint8 buffer, the ranks of the ring sum the buffer, and each
reads its neighbours' slots.  Only one rank writes a slot, so the sum of
bytes is the bytes: bit for bit, -0.0 and NaN included.  Tensors of every
type travel as their bytes (bool planes as uint8), all halos of one
exchange in one buffer.  It moves ring-size times the halo bytes; the
halos are a few rows a pass.  Gathers for the getters
(:func:`gather_blocks`) work the same way.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import DepthParams
from ..models.depth2d import Depth2DState, _pass_fn, plain_stages
from ..ops.median_pallas import selective_median_cuda

#: bytes a slice's place in an exchange buffer is rounded up to, so that
#: every slice can be viewed back as its type
_ALIGN = 8


def sum_bytes_(buf: torch.Tensor, group=None) -> torch.Tensor:
    """``all_reduce(SUM)`` of a contiguous tensor's bytes over ``group``,
    in place (exact where at most one rank holds a non-zero byte)."""
    dist.all_reduce(buf.view(torch.uint8), op=dist.ReduceOp.SUM,
                    group=group)
    return buf


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.uint8).reshape(-1)


def _from_bytes(b: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    return b.clone().view(like.dtype).reshape(shape)


def exchange_halos(xs: Sequence[torch.Tensor], width: int, dim: int,
                   ring, fills: Sequence) -> list:
    """Each tensor of ``xs`` with ``width`` slices of the previous and the
    next rank of ``ring`` concatenated along ``dim``; the ring's first and
    last ranks get ``fills`` (the image's edge).  One ``all_reduce`` for
    all of them.  A halo comes from the immediate neighbour, so it may be
    no wider than the block."""
    for x in xs:
        assert width <= x.shape[dim], (
            f"halo width {width} exceeds the local block extent "
            f"{x.shape[dim]} on dim {dim}: shard this axis less (halos "
            f"come from immediate ring neighbours)")
    if width == 0:
        return list(xs)
    n, i = ring.size, ring.index
    edges = [(x.narrow(dim, 0, width), x.narrow(dim, x.shape[dim] - width,
                                                width)) for x in xs]
    sizes = [-(-_as_bytes(first).numel() // _ALIGN) * _ALIGN
             for first, _ in edges]
    buf = None
    if n > 1:
        buf = torch.zeros((n, 2, sum(sizes)), dtype=torch.uint8,
                          device=xs[0].device)
        off = 0
        for (first, last), nb in zip(edges, sizes):
            for k, e in enumerate((first, last)):
                b = _as_bytes(e)
                buf[i, k, off:off + b.numel()] = b
            off += nb
        sum_bytes_(buf, ring.group)
    out, off = [], 0
    for x, (first, last), nb, fill in zip(xs, edges, sizes, fills):
        nbytes = _as_bytes(first).numel()

        def halo(j, k):
            if j < 0 or j >= n:
                return torch.full(first.shape, fill, dtype=x.dtype,
                                  device=x.device)
            return _from_bytes(buf[j, k, off:off + nbytes], x, first.shape)

        # the previous rank's last slices, then the next rank's first
        out.append(torch.cat([halo(i - 1, 1), x, halo(i + 1, 0)], dim))
        off += nb
    return out


def exchange_v_halo(x_local: torch.Tensor, width: int, mesh,
                    fill=0) -> torch.Tensor:
    """``x_local`` with ``width`` rows of the previous and the next rank
    along v (axis 0); the edge ranks receive ``fill`` rows."""
    return exchange_halos([x_local], width, 0, mesh.v_ring, [fill])[0]


def gather_blocks(x: torch.Tensor, full_shape, starts: Sequence[int],
                  ring=None) -> torch.Tensor:
    """The global tensor of ``full_shape`` from the block ``x`` of every
    rank of ``ring`` (None: of every rank), which starts at ``starts`` (one
    start per leading axis of ``x``): each rank writes its block into a
    zeroed global tensor and the ranks sum its bytes.  The blocks must not
    overlap."""
    full = torch.zeros(tuple(full_shape), dtype=x.dtype, device=x.device)
    full[tuple(slice(s, s + n) for s, n in zip(starts, x.shape))] = x
    if ring is None:
        if dist.get_world_size() > 1:
            sum_bytes_(full)
    elif ring.size > 1:
        sum_bytes_(full, ring.group)
    return full


def shard_volume(epis_v_s_u_c: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of a ``[V, S, U, C]`` volume whose V (and, on a
    (v, u) mesh, U) the mesh divides."""
    return _block(epis_v_s_u_c, mesh, 0, 2)


def shard_planes(planes_s_v_u: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of ``[S, V, U(, C)]`` planes (v on axis 1)."""
    return _block(planes_s_v_u, mesh, 1, 2)


def _block(x: torch.Tensor, mesh, v_axis: int, u_axis: int):
    (nv, nu), out = mesh.shape, x
    for axis, n, idx in ((v_axis, nv, mesh.v_index),
                         (u_axis, nu, mesh.u_index)):
        if x.shape[axis] % n:
            raise ValueError(f"axis {axis} of {tuple(x.shape)} does not "
                             f"split into {n} blocks")
        b = x.shape[axis] // n
        out = out.narrow(axis, idx * b, b)
    return out.contiguous()


def selective_median_sharded(src_v_u, frame_v_u_c, mask_v_u, size: int,
                             epsilon: float, mesh,
                             median=selective_median_cuda):
    """``median`` (the kernel, or the plain version) on the block with
    size // 2 rows of the neighbouring ranks above and below, cropped back
    (the window's rows v - w .. v - w + size - 1, w = (size - 1) // 2).  A
    ring of one rank has no neighbours: its block's edges are the image's,
    where the median skips the taps as it skips zero rows, so it takes no
    halo."""
    h = size // 2 if mesh.v_ring.size > 1 else 0
    src_h, frame_h, mask_h = exchange_halos(
        [src_v_u, frame_v_u_c, mask_v_u], h, 0, mesh.v_ring,
        [0.0, 0.0, False])
    out = median(src_h, frame_h, mask_h, size, epsilon)
    return out[h:h + src_v_u.shape[0]].contiguous()


def remaining_count(state: Depth2DState) -> int:
    """Confident pixels left unclaimed, summed over the ranks."""
    n = torch.sum(state.ce_mask & state.claim).reshape(1)
    dist.all_reduce(n, op=dist.ReduceOp.SUM)
    return int(n)


def stage_hooks(mesh, epis, dim_d: int, params: DepthParams,
                d_bounds: Tuple[float, float], use_pallas=None) -> dict:
    """The 1-D mesh's stage hooks: the kernels (or, with
    ``use_pallas=False``, the plain versions) with the halo median."""
    hooks = {}
    median = selective_median_cuda
    if use_pallas is False:
        hooks = plain_stages(epis, dim_d, params, d_bounds)
        median = hooks["median_fn"]
    hooks["median_fn"] = functools.partial(selective_median_sharded,
                                           mesh=mesh, median=median)
    return hooks


def run_schedule(pass_one, state: Depth2DState, s_hats,
                 early_stop: bool = True):
    """Passes ``pass_one(state, s_hat)`` over ``s_hats``; with
    ``early_stop`` the loop ends once the summed remaining count is 0, as
    the single-device driver's does.  Returns (state, passes run,
    remaining)."""
    done, left = 0, -1
    for s_hat in s_hats:
        pass_one(state, s_hat)
        done += 1
        if early_stop:
            left = remaining_count(state)
            if left == 0:
                break
    if not early_stop:
        left = remaining_count(state)
    return state, done, left


def sharded_pass(mesh, dim_d: int, params: DepthParams,
                 d_bounds: Tuple[float, float], use_pallas=None,
                 coarse_mode: str = "tile"):
    """One pass on a v-split mesh: ``fn(epis, frames, state, s_hat,
    dmin_s_v_u=None, dmax_s_v_u=None) -> (state, remaining)``, the
    single-device ``_pass_fn`` on the rank's block with the halo median and
    the remaining count summed over the ranks.  ``state`` is updated in
    place; the bound planes are None at uniform levels."""
    def fn(epis, frames, state, s_hat, dmin_s_v_u=None, dmax_s_v_u=None):
        _pass_fn(epis, frames, state, int(s_hat), dim_d=dim_d,
                 params=params, d_bounds=d_bounds, dmin_s_v_u=dmin_s_v_u,
                 dmax_s_v_u=dmax_s_v_u, coarse_mode=coarse_mode,
                 **stage_hooks(mesh, epis, dim_d, params, d_bounds,
                               use_pallas))
        return state, remaining_count(state)
    return fn


def sharded_schedule(mesh, dim_d: int, params: DepthParams,
                     d_bounds: Tuple[float, float], use_pallas=None,
                     coarse_mode: str = "tile", early_stop: bool = True):
    """The passes of a schedule on a v-split mesh: ``fn(epis, frames,
    state, s_hats, dmin_s_v_u=None, dmax_s_v_u=None) -> (state, passes
    run, remaining)``."""
    def fn(epis, frames, state, s_hats, dmin_s_v_u=None, dmax_s_v_u=None):
        hooks = stage_hooks(mesh, epis, dim_d, params, d_bounds, use_pallas)

        def pass_one(st, s_hat):
            _pass_fn(epis, frames, st, int(s_hat), dim_d=dim_d,
                     params=params, d_bounds=d_bounds,
                     dmin_s_v_u=dmin_s_v_u, dmax_s_v_u=dmax_s_v_u,
                     coarse_mode=coarse_mode, **hooks)

        return run_schedule(pass_one, state, s_hats, early_stop)
    return fn
