"""Full 2-D depth computation with temporal propagation.

Counterpart of ``remotesensingproject_tpu/models/depth2d.py`` (reference:
Depth2DComputer, rslf_depth_computation.hpp:651-915, and
rslf_depth_computation_core.hpp:901-1133):

* edge confidence C_e for every (s, v, u), once;
* claim masks initialized to the C_e masks;
* passes over s_hat in center-outward order (the schedule never visits
  plane 0 when S is even, as in the reference), stopping early once no
  confident pixel is left unclaimed;
* each pass: sweep of the still-unclaimed confident pixels of the s_hat
  plane, merge, selective median, line painting, each a CUDA kernel; on
  the CPU the plain versions run instead.  The sweep is routed as the JAX
  package routes it (its depth2d.py:334-431): the pixel kernel for C in
  {1, 3} and D <= 1024, else the row kernel at uniform levels and the tile
  kernel at bounds-edited ones, with grid bounds quantized per 128-lane
  tile (``coarse_mode="tile"``) or each pixel's own (``"pixel"``).
  Nearest interpolation, which the JAX package sweeps on its XLA path, goes
  to the pixel kernel or the tile kernel on each pixel's own grid.
* line mode (``score_version="line"``): the line confidence C_l of the
  swept pixels, from the sweep's ``k_best`` (a CUDA kernel that computes
  those pixels alone), gates propagation and is painted as a third
  payload.

Reference quirks kept on purpose:
* the median-filtered disparities drive propagation but are not written
  back to the stored s_hat plane (except where the s = s_hat leg of the
  painting re-paints a pixel with its filtered value);
* a failed sweep (max score <= raw threshold) zeroes C_e and its mask at
  that pixel but leaves the claim bit set;
* propagation sources are all pixels passing the criterion, including
  pixels claimed in earlier passes.

The state lives on one device and each pass updates it in place.  The
JAX package's TPU workarounds (v-slabs, static pass chunks, host-paced
dispatch) have no counterpart: a Python loop over the schedule has the
same semantics.  On a card no pass reads a device value on the host: the
sweeps' compaction keeps its count in device memory, and the early-stop
flag of pass N is read once pass N + 1 is queued (:class:`LateFlag`), so
the host runs up to one pass ahead of the card.  A pass's sweep, median
and paint are stage hooks of :func:`_pass_fn`, as in the JAX package:
the mesh-parallel drivers
(``parallel/``) pass halo-exchanging ones, and ``use_pallas=False`` passes
the plain versions (:func:`plain_stages`), the JAX package's XLA path.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_PARAMS, DepthParams
from ..ops.edge_confidence import edge_confidence_volume
from ..ops.line_confidence import line_confidence_cuda
from ..ops.median import selective_median
from ..ops.median_pallas import selective_median_cuda
from ..ops.merge import merge_cuda
from ..ops.normalize import normalize_volume
from ..ops.propagation import propagate
from ..ops.propagation_pallas import propagate_cuda
from ..ops.sweep import SweepResult, sweep_pile
from ..ops.sweep_pallas import sweep_pile_rows
from ..ops.sweep_pallas_perpixel import sweep_pile_tiles, \
    tile_quantized_bounds
from ..ops.sweep_pallas_pixel import MAX_DIM_D, sweep_pile_pixel
from ..types import DTYPE, f32, resolve_device
from ..utils import profiling
from ..utils.plot import coloured_epi_2d, disparity_map_image


@dataclasses.dataclass
class Depth2DState:
    """All mutable per-(s, v, u) planes of the 2-D computation."""

    ce: torch.Tensor          # [S, V, U] edge confidence (sweep-mutated)
    ce_mask: torch.Tensor     # [S, V, U] bool
    disp_conf: torch.Tensor   # [S, V, U]
    line_conf: torch.Tensor   # [S, V, U] in line mode, else [1, 1, 1]
    best_depth: torch.Tensor  # [S, V, U]
    rbar: torch.Tensor        # [S, V, U, C]
    claim: torch.Tensor       # [S, V, U] bool (True = unclaimed)


def state_from_numpy(arrays: Mapping[str, np.ndarray],
                     device) -> Depth2DState:
    """A state from numpy arrays in the JAX package's layout (the fields
    of its ``Depth2DState``: ``[S, V, U]`` planes, ``rbar`` ``[S, V, U,
    C]``), so one JAX pass and one port pass can start from the same
    mid-run state."""
    dev = torch.device(device)

    def conv(name, dtype):
        return torch.as_tensor(np.array(arrays[name]),
                               device=dev).to(dtype).contiguous()

    return Depth2DState(
        ce=conv("ce", DTYPE), ce_mask=conv("ce_mask", torch.bool),
        disp_conf=conv("disp_conf", DTYPE),
        line_conf=conv("line_conf", DTYPE),
        best_depth=conv("best_depth", DTYPE), rbar=conv("rbar", DTYPE),
        claim=conv("claim", torch.bool))


def center_outward_schedule(dim_s: int) -> list:
    """The reference's s_hat visiting order (core.hpp:981-990)."""
    s_hat = int(np.floor(dim_s / 2.0))
    order = [s_hat]
    for off in range(1, dim_s - s_hat):
        order.append(s_hat + off)
        if s_hat - off > -1:
            order.append(s_hat - off)
    return order


COARSE_MODES = ("tile", "pixel")
#: passes between two progress lines of a verbose run (the JAX package's
#: ``pass_chunk``)
PASS_CHUNK = 8


def sweep_pass(epis: torch.Tensor, active: torch.Tensor, s_hat: int,
               dim_d: int, params: DepthParams, d_bounds: Tuple[float, float],
               dmin_v_u: Optional[torch.Tensor] = None,
               dmax_v_u: Optional[torch.Tensor] = None,
               coarse_mode: str = "tile",
               with_k_best: bool = False,
               u_valid: Optional[Tuple[int, int]] = None) -> SweepResult:
    """The sweep of one pass over the ``active`` pixels, on the first
    route that applies: the pixel kernel (C in {1, 3}, D <= 1024); the row
    kernel at a uniform level (``dmin_v_u`` None); the tile kernel with
    grid bounds shared per 128-lane tile and each pixel's range masked
    (``"tile"``), or on each pixel's own grid (``"pixel"``).  Nearest
    interpolation takes the pixel kernel or the tile kernel on each pixel's
    own grid (the uniform one at uniform levels) whatever ``coarse_mode``
    says, as the JAX package's XLA path sweeps it.  ``u_valid`` (the window
    of valid sample columns of a u-haloed block) is taken by the pixel and
    the tile kernel only: a caller that gives it passes per-pixel bounds
    or takes the pixel kernel's route.  While tracing, each route's call
    is a span (``sweep.pixel``, ``sweep.rows``, ``sweep.tiles``; the tile
    mode's grid bounds ``sweep.tile_bounds`` inside ``sweep.tiles``)."""
    V, S, U, C = epis.shape
    if C in (1, 3) and dim_d <= MAX_DIM_D:
        with profiling.span("sweep.pixel"):
            return sweep_pile_pixel(epis, d_bounds[0], d_bounds[1], dim_d,
                                    s_hat, params, active, dmin_v_u,
                                    dmax_v_u, with_k_best, u_valid=u_valid)
    if params.interpolation == "nearest":
        if dmin_v_u is None:
            dmin_v_u, dmax_v_u = (
                torch.full((V, U), f32(b), dtype=DTYPE, device=epis.device)
                for b in d_bounds)
        coarse_mode = "pixel"
    elif dmin_v_u is None:
        if u_valid is not None:
            raise ValueError("the row sweep takes no u_valid window")
        with profiling.span("sweep.rows"):
            return sweep_pile_rows(epis, d_bounds[0], d_bounds[1], dim_d,
                                   s_hat, params, with_k_best,
                                   active_v_u=active)
    if coarse_mode == "tile":
        if u_valid is not None:
            raise ValueError("the tile mode takes no u_valid window")
        with profiling.span("sweep.tiles"):
            with profiling.span("sweep.tile_bounds"):
                qmin, qmax = tile_quantized_bounds(active, dmin_v_u,
                                                   dmax_v_u, d_bounds)
            return sweep_pile_tiles(epis, qmin, qmax, dim_d, s_hat, params,
                                    with_k_best, active_v_u=active,
                                    pdmin_v_u=dmin_v_u, pdmax_v_u=dmax_v_u)
    with profiling.span("sweep.tiles"):
        return sweep_pile_tiles(epis, dmin_v_u, dmax_v_u, dim_d, s_hat,
                                params, with_k_best, active_v_u=active,
                                u_valid=u_valid)


def _line_confidence(ce_s_v_u: torch.Tensor, depth_v_u: torch.Tensor,
                     k_best_v_s_u: torch.Tensor, mask_v_u: torch.Tensor,
                     s_hat: int) -> torch.Tensor:
    """Line confidence C_l = sum_s C_e(I) K / sum_s K along each pixel's
    winning line, 0 outside ``mask_v_u``: the CUDA kernel on a CUDA tensor,
    which computes only the pixels of the mask, else the plain version
    (``ops/line_confidence.py``)."""
    with profiling.span("pass.line_conf"):
        return line_confidence_cuda(ce_s_v_u, depth_v_u, k_best_v_s_u,
                                    mask_v_u, s_hat)


def plain_stages(epis: torch.Tensor, dim_d: int, params: DepthParams,
                 d_bounds: Tuple[float, float]) -> dict:
    """The stage hooks of ``use_pallas=False``: the JAX package's XLA path
    (its ``_pass_fn`` without Pallas), on whatever device ``epis`` lies.
    The plain sweep on each pixel's own grid (the ctor bounds at uniform
    levels: no row rule, no tile quantisation, no fast cap), the plain
    median and the plain paint."""
    V, S, U, C = epis.shape
    line = params.score_version == "line"

    def sweep_fn(active, dmin_v_u, dmax_v_u, s_hat):
        if dmin_v_u is None:
            dmin_v_u, dmax_v_u = (
                torch.full((V, U), f32(b), dtype=DTYPE, device=epis.device)
                for b in d_bounds)
        return sweep_pile(epis, dmin_v_u, dmax_v_u, dim_d, s_hat, params,
                          with_k_best=line)

    def prop_fn(claim, frames, filtered, rbar, source_mask, s_hat,
                payloads):
        return propagate(claim, frames, filtered, rbar, source_mask, s_hat,
                         params.slope_factor, params.propagation_epsilon,
                         payloads)

    return dict(sweep_fn=sweep_fn, median_fn=selective_median,
                prop_fn=prop_fn)


def _pass_fn(epis: torch.Tensor, frames: torch.Tensor, state: Depth2DState,
             s_hat: int, *, dim_d: int, params: DepthParams,
             d_bounds: Tuple[float, float],
             dmin_s_v_u: Optional[torch.Tensor] = None,
             dmax_s_v_u: Optional[torch.Tensor] = None,
             coarse_mode: str = "tile", sweep_fn=None, median_fn=None,
             prop_fn=None, live: Optional[torch.Tensor] = None
             ) -> Depth2DState:
    """One center-outward pass (sweep + merge + median + propagation),
    updating ``state`` in place.  Per-pixel bounds are given at the
    bounds-edited levels and None at uniform ones.

    ``live`` (a 0-d bool tensor on the state's device, or None) is whether
    any confident pixel was left unclaimed before this pass.  Where it is
    False the pass paints nothing: on such a state the sweep has no pixel
    and the merge changes nothing, and with no source the pass is an exact
    no-op.  (Without the gate, sources never swept, whose r_bar is still
    0, could paint a dark target that a failed sweep left unclaimed.)  The
    pass loop gives it when it reads the early-stop flag a pass late.

    The stage hooks, as in the JAX package's ``_pass_fn``, replace one stage
    each (None: the kernels): ``sweep_fn(active, dmin_v_u, dmax_v_u, s_hat)
    -> SweepResult`` (the bound planes None at uniform levels),
    ``median_fn(src, frame, mask, size, epsilon)`` with the signature of
    ``selective_median``, and ``prop_fn(claim, frames, filtered, rbar,
    source_mask, s_hat, payloads)``, which paints in place.  Every merge
    and state update is made here (the sweep's through ``merge_cuda``: the
    kernel on the card, the plain version elsewhere), so there is one pass
    implementation."""
    with profiling.span("depth2d.pass"):
        # every pass queued, a late one on a converged state too
        profiling.count("passes")
        line = params.score_version == "line"
        if sweep_fn is None:
            def sweep_fn(act, dmin_v_u, dmax_v_u, sh):
                return sweep_pass(epis, act, sh, dim_d, params, d_bounds,
                                  dmin_v_u, dmax_v_u, coarse_mode,
                                  with_k_best=line)
        if median_fn is None:
            median_fn = selective_median_cuda
        if prop_fn is None:
            def prop_fn(claim, frames_, filtered, rbar, source_mask, sh,
                        payloads):
                return propagate_cuda(claim, frames_, filtered, rbar,
                                      source_mask, sh, params.slope_factor,
                                      params.propagation_epsilon, payloads)
        mask_p = state.ce_mask[s_hat]

        # the reference ANDs the edge mask into the claim plane in place
        # before collecting pixels (core.hpp:510-513)
        active = mask_p & state.claim[s_hat]
        state.claim[s_hat] = active

        dmin_v_u = dmax_v_u = None
        if dmin_s_v_u is not None:
            dmin_v_u = dmin_s_v_u[s_hat].contiguous()
            dmax_v_u = dmax_s_v_u[s_hat].contiguous()
        res = sweep_fn(active, dmin_v_u, dmax_v_u, s_hat)

        with profiling.span("pass.merge"):
            depth_new, mask_new, conf_new, rbar_new, good = merge_cuda(
                state, s_hat, active, res, params.raw_score_threshold,
                with_good=line)

        # selective median of the s_hat plane, gated by the post-sweep mask;
        # the filtered values drive propagation but are not stored
        filtered = median_fn(depth_new, frames[s_hat], mask_new,
                             params.median_filter_size,
                             params.median_filter_epsilon)
        payloads = [(state.best_depth, filtered),
                    (state.disp_conf, conf_new)]
        if line:
            # C_l is refreshed only where this pass's sweep succeeded
            # (k_best is the winning line's there), so it is computed
            # there alone (good lies in mask_new); elsewhere the plane
            # keeps its value
            lc = torch.where(good, _line_confidence(state.ce, filtered,
                                                    res.k_best, good, s_hat),
                             state.line_conf[s_hat])
            state.line_conf[s_hat] = lc
            source_mask = lc > params.line_score_threshold
            payloads.append((state.line_conf, lc))
        elif params.score_version == "disp":
            source_mask = conf_new > params.disp_score_threshold
        else:
            source_mask = mask_new
        if live is not None:
            source_mask = source_mask & live
        prop_fn(state.claim, frames, filtered, rbar_new, source_mask, s_hat,
                payloads)
        return state


def _unclaimed(state: Depth2DState) -> torch.Tensor:
    """Whether any confident pixel is left unclaimed: a 0-d bool tensor on
    the state's device (the early-stop flag)."""
    return torch.any(state.ce_mask & state.claim)


class LateFlag:
    """The early-stop flag of each pass, read a pass late, on a card.

    :meth:`post` queues the flag of the pass just queued: the card works it
    out, copies the byte without blocking into pinned host memory and
    records an event.  :meth:`read`, called once the host has queued the
    next pass, returns that flag: it waits on the event only if the card
    has not reached it, and counts that wait as ``syncs.early_stop``, so
    that counter over ``passes`` is the share of passes at which the card
    set the pace.  The host reads the slot before it posts the next flag
    into it, and the card is still running the pass just queued, so one
    slot loses no overlap.  The cost is one pass a level queued on a
    converged state, which the pass loop gates to an exact no-op
    (``_pass_fn``'s ``live``), keeps out of ``passes_run`` and counts as
    ``Depth2DComputer.late_passes`` and ``depth2d.late_passes``.
    """

    def __init__(self, device: torch.device):
        self.host = torch.zeros(1, dtype=torch.bool, pin_memory=True)
        self.event = torch.cuda.Event()
        # the stream the passes and the copy are queued on
        self.stream = torch.cuda.current_stream(device)
        self.posted = False

    def post(self, flag: torch.Tensor) -> None:
        self.host.copy_(flag, non_blocking=True)
        self.event.record(self.stream)
        self.posted = True

    def read(self) -> Optional[bool]:
        """The flag posted last (None before the first post)."""
        if not self.posted:
            return None
        if not self.event.query():
            profiling.count("syncs.early_stop")
            self.event.synchronize()
        return bool(self.host[0])


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    if t.dtype == torch.float64:
        t = t.to(DTYPE)
    return t.to(device)


class Depth2DComputer:
    """Driver mirroring Depth2DComputer's ctor / run / getters.

    Runs on CUDA unless ``device`` names another device.  ``coarse_mode``
    picks the tile kernel's grids at bounds-edited levels (see
    :func:`sweep_pass`); the pixel kernel's route ignores it.
    ``early_stop=False`` runs every pass of the schedule; ``verbose``
    prints a progress line every :data:`PASS_CHUNK` passes, as the JAX
    package does after each chunk of passes (one more host sync each).
    ``use_pallas=False`` runs the plain versions of the sweep, median and
    paint on the computer's device (:func:`plain_stages`, the JAX package's
    XLA path); the default (None) and True run the kernels.

    The early stop reads its flag after each pass on CPU tensors and with
    ``verbose``; on a card it reads it a pass late (:class:`LateFlag`), so
    the card may run one pass more a level, on a converged state, gated to
    an exact no-op: the maps stay the same.  ``passes_run`` counts the
    level's passes on an unconverged state, as the immediate read (and the
    JAX package) counts them; ``late_passes`` (0 or 1) the pass queued
    after them, which the trace counts as ``depth2d.late_passes``."""

    def __init__(self, epis_v_s_u_c, dmin: float, dmax: float, dim_d: int,
                 epi_scale_factor: float = -1.0,
                 params: DepthParams = DEFAULT_PARAMS,
                 verbose: bool = False, early_stop: bool = True,
                 device=None, coarse_mode: str = "tile",
                 use_pallas: Optional[bool] = None):
        if coarse_mode not in COARSE_MODES:
            raise ValueError(f"coarse_mode must be one of {COARSE_MODES}")
        self.coarse_mode = coarse_mode
        self.use_pallas = use_pallas
        self.device = resolve_device(device)
        epis = _as_tensor(epis_v_s_u_c, self.device)
        if epis.dim() == 3:
            epis = epis[..., None]
        self.epis = normalize_volume(epis, epi_scale_factor).contiguous()
        self.dim_d = dim_d
        self.dmin = float(dmin)
        self.dmax = float(dmax)
        self.params = params
        self.verbose = verbose
        self.early_stop = early_stop
        self.accept_all = False
        # per-pixel bounds, editable by the pyramid; materialized lazily
        self._dmin_arr: Optional[torch.Tensor] = None
        self._dmax_arr: Optional[torch.Tensor] = None
        self._bounds_edited = False
        self.state: Optional[Depth2DState] = None
        self.passes_run = 0
        self.late_passes = 0

    def _full_bounds(self, value: float) -> torch.Tensor:
        V, S, U, _ = self.epis.shape
        return torch.full((S, V, U), f32(value), dtype=DTYPE,
                          device=self.device)

    @property
    def dmin_s_v_u(self) -> torch.Tensor:
        if self._dmin_arr is None:
            self._dmin_arr = self._full_bounds(self.dmin)
        return self._dmin_arr

    @property
    def dmax_s_v_u(self) -> torch.Tensor:
        if self._dmax_arr is None:
            self._dmax_arr = self._full_bounds(self.dmax)
        return self._dmax_arr

    # -- pyramid hooks (rslf_depth_computation.hpp:196-215) -------------

    def set_accept_all(self, accept_all: bool):
        self.accept_all = accept_all

    def set_bounds(self, dmin_s_v_u: torch.Tensor, dmax_s_v_u: torch.Tensor):
        self._dmin_arr = dmin_s_v_u.to(self.device, DTYPE).contiguous()
        self._dmax_arr = dmax_s_v_u.to(self.device, DTYPE).contiguous()
        self._bounds_edited = True

    def rebuild_bounds(self):
        """Back to the ctor's uniform bounds (a checkpoint of a uniform
        level loaded into a computer whose bounds were edited)."""
        self._dmin_arr = None
        self._dmax_arr = None
        self._bounds_edited = False

    def drop_rbar(self):
        """Free the r_bar planes: only the level's own passes read them."""
        self.state.rbar = torch.zeros((1, 1, 1, 1), dtype=DTYPE,
                                      device=self.device)

    # -------------------------------------------------------------------

    def initial_state(self) -> Depth2DState:
        """Edge confidence and the zeroed planes before the first pass."""
        with profiling.span("depth2d.init"):
            V, S, U, C = self.epis.shape
            ce_vsu, mask_vsu = edge_confidence_volume(self.epis, self.params)
            ce = ce_vsu.permute(1, 0, 2).contiguous()
            ce_mask = mask_vsu.permute(1, 0, 2).contiguous()

            def zeros(*shape):
                return torch.zeros(shape, dtype=DTYPE, device=self.device)

            # line_conf is read and written only in line mode
            lc_shape = (S, V, U) if self.params.score_version == "line" \
                else (1, 1, 1)
            return Depth2DState(
                ce=ce, ce_mask=ce_mask, disp_conf=zeros(S, V, U),
                line_conf=zeros(*lc_shape), best_depth=zeros(S, V, U),
                rbar=zeros(S, V, U, C), claim=ce_mask.clone())

    def run(self) -> Depth2DState:
        V, S, U, C = self.epis.shape
        frames = self.epis.permute(1, 0, 2, 3).contiguous()  # [S, V, U, C]
        state = self.initial_state()
        bounds = {}
        if self._bounds_edited:
            bounds = dict(dmin_s_v_u=self.dmin_s_v_u,
                          dmax_s_v_u=self.dmax_s_v_u)
        hooks = {}
        if self.use_pallas is False:
            hooks = plain_stages(self.epis, self.dim_d, self.params,
                                 (self.dmin, self.dmax))
        schedule = center_outward_schedule(S)
        self.passes_run = 0
        self.late_passes = 0
        t_chunk = time.perf_counter()
        late = (self.early_stop and not self.verbose
                and self.device.type == "cuda")
        flag = LateFlag(self.device) if late else None
        live = None
        for s_hat in schedule:
            _pass_fn(self.epis, frames, state, s_hat, dim_d=self.dim_d,
                     params=self.params, d_bounds=(self.dmin, self.dmax),
                     coarse_mode=self.coarse_mode, live=live, **bounds,
                     **hooks)
            if late:
                # the previous pass's flag is read now that this pass is
                # queued behind it; then this pass's flag is queued
                with profiling.span("depth2d.early_stop"):
                    if flag.read() is False:
                        # this pass ran on a converged state, gated to a
                        # no-op: not one of the level's passes
                        self.late_passes = 1
                        profiling.count("depth2d.late_passes")
                        break
                    live = _unclaimed(state)
                    flag.post(live)
                self.passes_run += 1
                continue
            self.passes_run += 1
            # a pass on a state with nothing left to claim is a no-op
            done = False
            if self.early_stop:
                with profiling.span("depth2d.early_stop"):
                    profiling.count("syncs.early_stop")
                    done = not bool(_unclaimed(state))
            if self.verbose and (done or self.passes_run % PASS_CHUNK == 0
                                 or self.passes_run == len(schedule)):
                now = time.perf_counter()
                profiling.count("syncs.verbose")
                left = int(torch.sum(state.ce_mask & state.claim))
                print(f"passes {self.passes_run}/{len(schedule)} "
                      f"(+{now - t_chunk:.1f}s, remaining px {left})")
                t_chunk = now
            if done:
                if self.verbose:
                    print(f"early stop after {self.passes_run} passes")
                break
        self.state = state
        return state

    # -- getters mirroring the reference --------------------------------

    def get_depths_s_v_u(self) -> torch.Tensor:
        return self.state.best_depth

    def get_valid_depths_mask_s_v_u(self) -> torch.Tensor:
        """Validity per score_version (rslf_depth_computation.hpp:893-915);
        the edge branch thresholds the C_e values, not the stored mask."""
        if self.accept_all:
            return torch.ones_like(self.state.ce, dtype=torch.bool)
        if self.params.score_version == "edge":
            return self.state.ce > self.params.edge_score_threshold
        return self._criterion_mask()

    def get_epis(self) -> torch.Tensor:
        return self.epis

    def get_coloured_epi(self, v: int = -1, colormap: str = "jet"):
        """Slope-coloured EPI at row v
        (Depth2DComputer::get_coloured_epi,
        rslf_depth_computation.hpp:807-860)."""
        if v < 0:
            v = self.epis.shape[0] // 2
        return coloured_epi_2d(self.state.best_depth,
                               self._criterion_mask(), v, colormap)

    def get_disparity_map(self, s: int = -1, colormap: str = "jet"):
        """Colormapped disparity map at frame s
        (rslf_depth_computation.hpp:862-891)."""
        if s < 0:
            s = self.epis.shape[1] // 2
        return disparity_map_image(self.state.best_depth[s],
                                   self._criterion_mask()[s], colormap)

    def _criterion_mask(self) -> torch.Tensor:
        """The painting criterion per score_version
        (rslf_depth_computation.hpp:836-846,865-880): edge takes the stored
        mask; disp and line threshold their confidences."""
        p = self.params
        if p.score_version == "disp":
            return self.state.disp_conf > p.disp_score_threshold
        if p.score_version == "line":
            return self.state.line_conf > p.line_score_threshold
        return self.state.ce_mask
