"""Mesh-parallel Depth2DComputer.

Counterpart of ``remotesensingproject_tpu/parallel/driver.py``: the whole
2-D propagation with every state plane split over the ranks of a mesh, the
single-device pass per block (``parallel/sharding.py``, or on a mesh that
splits u as well ``parallel/sharding2d.py``), so every score version,
interpolation, sweep route and coarse mode of the single-device driver
runs here, and the result is the single-device driver's bit for bit.

Each rank holds only its block: the volume's rows (and columns) and its
block of every plane.  V (and U on a (v, u) mesh) is padded with zero
rows (columns) to a multiple of the mesh's split: zero radiance falls
below the shadow cut, so padded pixels never take part.  The
normalisation max is an ``all_reduce(MAX)``; edge confidence runs per
block (it has no v window, and a block holds whole rows when it runs),
except that its optional opening, which has one, runs on the gathered
mask.  The getters return the full unpadded ``[S, V, U]`` planes on every
rank, as the JAX package's global arrays are: only they pay for a gather,
never the passes, and like every collective every rank must call them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..config import DEFAULT_PARAMS, DepthParams
from ..models.depth2d import (COARSE_MODES, Depth2DState, _as_tensor,
                              center_outward_schedule)
from ..ops.edge_confidence import _morph_open_vu, edge_confidence_volume
from ..ops.normalize import normalize_volume
from ..types import DTYPE, f32
from .distributed import LocalBlock, local_v_range
from .mesh import make_mesh
from .sharding import gather_blocks, shard_planes, sharded_schedule
from .sharding2d import sharded_schedule_2d


def _pad_to(x: torch.Tensor, axis: int, size: int, value) -> torch.Tensor:
    extra = size - x.shape[axis]
    if extra <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = extra
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], axis)


class ShardedDepth2DComputer:
    """Mesh-parallel Depth2DComputer (all score versions; line mode not on
    a mesh that splits u).

    ``epis_v_s_u_c`` is the full volume (each rank keeps its block) or this
    rank's block from ``distributed.volume_from_local``.  ``mesh`` defaults
    to ``make_mesh()`` over the default process group, ``device`` to the
    mesh's (the rank's card).  ``use_pallas=False`` runs the plain versions
    of the stages, as ``Depth2DComputer``'s does."""

    def __init__(self, epis_v_s_u_c, dmin: float, dmax: float, dim_d: int,
                 mesh=None, epi_scale_factor: float = -1.0,
                 params: DepthParams = DEFAULT_PARAMS,
                 verbose: bool = False, early_stop: bool = True,
                 use_pallas: Optional[bool] = None,
                 coarse_mode: str = "tile", device=None):
        if coarse_mode not in COARSE_MODES:
            raise ValueError(f"coarse_mode must be one of {COARSE_MODES}")
        self.mesh = mesh if mesh is not None else make_mesh()
        self.device = (torch.device(device) if device is not None
                       else self.mesh.device)
        nv, nu = self.mesh.shape
        if nu > 1 and params.score_version == "line":
            raise NotImplementedError(
                "u-sharding does not support score_version='line'")
        self.dim_d = dim_d
        self.dmin = float(dmin)
        self.dmax = float(dmax)
        self.params = params
        self.verbose = verbose
        self.early_stop = early_stop
        self.use_pallas = use_pallas
        self.coarse_mode = coarse_mode
        self.accept_all = False
        self.passes_run = 0

        if isinstance(epis_v_s_u_c, LocalBlock):
            block, V = epis_v_s_u_c.data, epis_v_s_u_c.total_v
        else:
            block, V = epis_v_s_u_c, epis_v_s_u_c.shape[0]
            lo, hi = local_v_range(V, self.mesh)
            block = block[lo:hi]
        local = _as_tensor(block, self.device)
        if local.dim() == 3:
            local = local[..., None]
        _, S, U, C = local.shape
        self._orig_v, self._orig_u = V, U
        self._block_v = -(-V // nv)
        self._block_u = -(-U // nu)
        self._v0 = self.mesh.v_index * self._block_v
        self._u0 = self.mesh.u_index * self._block_u
        local = self._normalize(local.contiguous(), epi_scale_factor)
        ce, mask = self._edge_confidence(local)
        # pad the rows to the block, then take the rank's columns
        self.epis = self._cut_u(_pad_to(local, 0, self._block_v, 0.0), 2)
        self._ce = self._cut_u(_pad_to(ce, 0, self._block_v, 0.0), 2)
        self._ce_mask = self._cut_u(_pad_to(mask, 0, self._block_v, False),
                                    2)
        self._dmin_arr: Optional[torch.Tensor] = None
        self._dmax_arr: Optional[torch.Tensor] = None
        self._bounds_edited = False
        self.local_state: Optional[Depth2DState] = None

    # -- set-up ------------------------------------------------------------

    def _normalize(self, local: torch.Tensor, scale_factor: float):
        """``normalize_volume`` of the global volume, on the block: by its
        max, taken over every rank's block, unless the input is uint8 or a
        scale factor is given."""
        if local.dtype != torch.uint8 and not (scale_factor is not None
                                               and scale_factor > 0):
            v = local.to(DTYPE)
            m = (torch.amax(v) if v.numel() else
                 torch.tensor(float("-inf"), device=v.device)).reshape(1)
            dist.all_reduce(m, op=dist.ReduceOp.MAX)
            scale_factor = float(m)
        return normalize_volume(local, scale_factor)

    def _edge_confidence(self, local: torch.Tensor):
        """C_e and its mask ``[V_l, S, U]`` of the block's real rows."""
        p = self.params
        n_open = p.edge_confidence_opening_size
        ce, mask = edge_confidence_volume(
            local, dataclasses.replace(p, edge_confidence_opening_size=1))
        if n_open > 1:
            # the opening's window spans rows: open the mask of whole rows
            # gathered over the v ring
            _, S, U = mask.shape
            full = gather_blocks(_pad_to(mask, 0, self._block_v, False),
                                 (self._block_v * self.mesh.shape[0], S, U),
                                 (self._v0, 0, 0), self.mesh.v_ring)
            opened = _morph_open_vu(full[:self._orig_v], n_open)
            mask = opened[self._v0:self._v0 + local.shape[0]]
        return ce, mask

    def _cut_u(self, x: torch.Tensor, axis: int, fill=0) -> torch.Tensor:
        """The rank's columns of a block of whole rows, padded with
        ``fill``."""
        x = _pad_to(x, axis, self._block_u * self.mesh.shape[1], fill)
        return x.narrow(axis, self._u0, self._block_u).contiguous()

    def _planes_block(self, full_s_v_u: torch.Tensor, fill=0):
        """The rank's block of global [S, V, U(, C)] planes."""
        nv, nu = self.mesh.shape
        x = _pad_to(full_s_v_u.to(self.device), 1, self._block_v * nv, fill)
        return shard_planes(_pad_to(x, 2, self._block_u * nu, fill),
                            self.mesh)

    def _is_plane(self, x: torch.Tensor) -> bool:
        """A block of [S, V, U(, C)] planes (not line_conf's or a dropped
        r_bar's placeholder)."""
        return tuple(x.shape[1:3]) == tuple(self.epis.shape[0:3:2])

    def _gather(self, x_local: torch.Tensor) -> torch.Tensor:
        """Global unpadded ``[S, V, U, ...]`` planes from every block."""
        nv, nu = self.mesh.shape
        full = (x_local.shape[0], self._block_v * nv, self._block_u * nu) \
            + tuple(x_local.shape[3:])
        g = gather_blocks(x_local, full, (0, self._v0, self._u0))
        return g[:, :self._orig_v, :self._orig_u]

    # -- pyramid hooks ------------------------------------------------------

    def set_accept_all(self, accept_all: bool):
        self.accept_all = accept_all

    def _full_bounds(self, value: float) -> torch.Tensor:
        S = self.epis.shape[1]
        return torch.full((S, self._orig_v, self._orig_u), f32(value),
                          dtype=DTYPE, device=self.device)

    @property
    def dmin_s_v_u(self) -> torch.Tensor:
        """The global per-pixel lower bounds (gathered when edited)."""
        if self._bounds_edited:
            return self._gather(self._dmin_arr)
        return self._full_bounds(self.dmin)

    @property
    def dmax_s_v_u(self) -> torch.Tensor:
        if self._bounds_edited:
            return self._gather(self._dmax_arr)
        return self._full_bounds(self.dmax)

    def set_bounds(self, dmin_s_v_u, dmax_s_v_u):
        """Per-pixel bounds: global ``[S, V, U]`` planes, or this rank's
        rows from ``distributed.planes_from_local``; padding takes the ctor
        bounds."""
        blocks = []
        for b, fill in ((dmin_s_v_u, self.dmin), (dmax_s_v_u, self.dmax)):
            if isinstance(b, LocalBlock):
                x = _as_tensor(b.data, self.device)
                x = self._cut_u(_pad_to(x, 1, self._block_v, f32(fill)), 2,
                                f32(fill))
            else:
                x = self._planes_block(_as_tensor(b, self.device),
                                       f32(fill))
            blocks.append(x.to(DTYPE).contiguous())
        self._dmin_arr, self._dmax_arr = blocks
        self._bounds_edited = True

    def rebuild_bounds(self):
        """Back to the ctor's uniform bounds (a checkpoint of a uniform
        level loaded into a computer whose bounds were edited)."""
        self._dmin_arr = self._dmax_arr = None
        self._bounds_edited = False

    # -- run ------------------------------------------------------------------

    def initial_state(self) -> Depth2DState:
        """The block's planes before the first pass."""
        Vl, S, Ul, C = self.epis.shape

        def zeros(*shape):
            return torch.zeros(shape, dtype=DTYPE, device=self.device)

        ce = self._ce.permute(1, 0, 2).contiguous()
        ce_mask = self._ce_mask.permute(1, 0, 2).contiguous()
        lc_shape = (S, Vl, Ul) if self.params.score_version == "line" \
            else (1, 1, 1)
        return Depth2DState(ce=ce, ce_mask=ce_mask,
                            disp_conf=zeros(S, Vl, Ul),
                            line_conf=zeros(*lc_shape),
                            best_depth=zeros(S, Vl, Ul),
                            rbar=zeros(S, Vl, Ul, C), claim=ce_mask.clone())

    def run(self) -> Depth2DState:
        """All passes; returns this rank's block of the state."""
        S = self.epis.shape[1]
        frames = self.epis.permute(1, 0, 2, 3).contiguous()
        d_bounds = (self.dmin, self.dmax)
        if self.mesh.shape[1] > 1:
            fwd = sharded_schedule_2d(self.mesh, self.dim_d, self.params,
                                      d_bounds, self._orig_u,
                                      self.use_pallas, self.early_stop)
        else:
            fwd = sharded_schedule(self.mesh, self.dim_d, self.params,
                                   d_bounds, self.use_pallas,
                                   self.coarse_mode, self.early_stop)
        schedule = center_outward_schedule(S)
        t0 = time.perf_counter()
        state, self.passes_run, left = fwd(
            self.epis, frames, self.initial_state(), schedule,
            self._dmin_arr, self._dmax_arr)
        self.local_state = state
        if self.verbose and self.mesh.rank == 0:
            print(f"sharded schedule: {self.passes_run}/{len(schedule)} "
                  f"passes, remaining px {left} "
                  f"({time.perf_counter() - t0:.1f}s)")
        return state

    def drop_rbar(self):
        """Free the r_bar planes: only the level's own passes read them."""
        self.local_state.rbar = torch.zeros((1, 1, 1, 1), dtype=DTYPE,
                                            device=self.device)

    # -- getters mirroring the single-device driver (collectives) ----------

    @property
    def state(self) -> Depth2DState:
        """The global unpadded state (gathered on every rank)."""
        st = self.local_state
        return Depth2DState(**{
            f.name: (self._gather(x) if self._is_plane(x) else x)
            for f in dataclasses.fields(st) for x in [getattr(st, f.name)]})

    @state.setter
    def state(self, full: Depth2DState):
        """Keep this rank's block of a global state (a loaded checkpoint)."""
        V, U = self._orig_v, self._orig_u
        self.local_state = Depth2DState(**{
            f.name: (self._planes_block(x) if tuple(x.shape[1:3]) == (V, U)
                     else x.to(self.device))
            for f in dataclasses.fields(full) for x in [getattr(full, f.name)]})

    def get_depths_s_v_u(self) -> torch.Tensor:
        return self._gather(self.local_state.best_depth)

    def get_valid_depths_mask_s_v_u(self) -> torch.Tensor:
        st, p = self.local_state, self.params
        if self.accept_all:
            return torch.ones((st.ce.shape[0], self._orig_v, self._orig_u),
                              dtype=torch.bool, device=self.device)
        if p.score_version == "disp":
            valid = st.disp_conf > p.disp_score_threshold
        elif p.score_version == "line":
            valid = st.line_conf > p.line_score_threshold
        else:
            valid = st.ce > p.edge_score_threshold
        return self._gather(valid)

    def get_epis(self) -> torch.Tensor:
        """The normalized global ``[V, S, U, C]`` volume (gathered)."""
        g = self._gather(self.epis.permute(1, 0, 2, 3).contiguous())
        return g.permute(1, 0, 2, 3)
