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

With a ``mesh`` (``parallel.mesh``) every rank builds the pyramid from the
full volume and each level is a ``ShardedDepth2DComputer`` over the mesh;
the bounds of the next level and the fusion run on the gathered maps, so
every rank holds the same results (every rank must call the getters).

While the port's tracing is on (``utils.profiling``), ``FineToCoarse``
records ``ftc.levels`` (the levels built), ``ftc.level<p>.held_bytes``
(what level p's computer holds once it has run: :func:`held_bytes`) and,
on CUDA, ``ftc.level<p>.peak_rise_bytes`` (how far the allocator's peak
during level p's run, with the next level's bounds, rose above what was
allocated when the level started).  Each is a reading of the last
``FineToCoarse`` built or run, which the next one replaces
(``profiling.record``), so a traced block over many scenes reads one
scene's levels.  To scope each level's peak, tracing on a CUDA device
resets the allocator's peak (``torch.cuda.reset_peak_memory_stats``) as
each level starts: a process's whole peak is read outside tracing.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_PARAMS, DEFAULT_PYRAMID, DepthParams, \
    PyramidParams
from ..ops.pyramid import bounds_from_parent, downsample_epis, fuse_disp_maps
from ..types import DTYPE, resolve_device
from ..utils import profiling
from ..utils.checkpoint import load_level, save_level
from ..utils.plot import (ImageConverterUint8, coloured_depth_maps,
                          depth_pyramid_images, side_by_side)
from .depth2d import Depth2DComputer, Depth2DState, _as_tensor


def held_bytes(computer) -> int:
    """Bytes of the distinct storages behind the tensors a level's
    computer holds, in its attributes and in its state's planes (its EPIs,
    the planes, the bounds; a mesh rank's own block), counted from the
    tensors: the same on any device."""
    held = []
    for v in vars(computer).values():
        held.extend(vars(v).values() if isinstance(v, Depth2DState) else [v])
    storages = {(t.device, t.untyped_storage().data_ptr()):
                t.untyped_storage().nbytes()
                for t in held if isinstance(t, torch.Tensor)}
    return sum(storages.values())


def _level_peak_start(device: torch.device) -> Optional[int]:
    """On CUDA, resets the allocator's peak and returns what is allocated:
    the base of a level's peak rise; else None."""
    if device.type != "cuda":
        return None
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


class FineToCoarse:
    """Runs on CUDA unless ``device`` names another device (with a
    ``mesh``: the mesh's device unless ``device`` names one).
    ``coarse_mode``, ``early_stop`` and ``use_pallas`` (False: the plain
    versions, the JAX package's XLA path) are handed to every level's
    computer.  ``verbose`` prints a line per level; ``pass_progress``
    (default: ``verbose``) also prints the levels' pass progress."""

    def __init__(self, epis_v_s_u_c, dmin: float, dmax: float, dim_d: int,
                 epi_scale_factor: float = -1.0,
                 params: DepthParams = DEFAULT_PARAMS,
                 pyramid: PyramidParams = DEFAULT_PYRAMID,
                 early_stop: bool = True, verbose: bool = False,
                 pass_progress: Optional[bool] = None, device=None,
                 coarse_mode: str = "tile",
                 use_pallas: Optional[bool] = None, mesh=None):
        with profiling.span("ftc.init"):
            if pass_progress is None:
                pass_progress = verbose
            if mesh is not None and device is None:
                device = mesh.device
            self.device = resolve_device(device)
            self.mesh = mesh
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
            #: (V, S, U) of each level
            self.level_shapes: List[Tuple[int, int, int]] = []
            # host seconds of each level's run(), filled by run() (the
            # span ``ftc.level`` opens and closes with its clock reads)
            self.level_seconds: List[float] = []

            start_dim_u = raw.shape[2]
            max_depth = pyramid.max_pyr_depth
            if max_depth < 1:
                max_depth = np.iinfo(np.int32).max
            level = raw
            while (level.shape[0] > pyramid.min_spatial_dim
                   and level.shape[2] > pyramid.min_spatial_dim
                   and len(self.computers) < max_depth):
                lvl_params = params.with_slope_factor(
                    level.shape[2] / start_dim_u)
                if verbose and (mesh is None or mesh.rank == 0):
                    print(f"level {len(self.computers)}: (v={level.shape[0]}, "
                          f"u={level.shape[2]}) "
                          f"slope_factor={lvl_params.slope_factor:.4f}")
                lvl_input = level.to(torch.uint8) if self.is_uint8 else level
                if mesh is not None:
                    from ..parallel.driver import ShardedDepth2DComputer
                    self.computers.append(ShardedDepth2DComputer(
                        lvl_input, dmin, dmax, dim_d, mesh=mesh,
                        epi_scale_factor=epi_scale_factor, params=lvl_params,
                        verbose=pass_progress, early_stop=early_stop,
                        use_pallas=use_pallas, coarse_mode=coarse_mode,
                        device=self.device))
                else:
                    self.computers.append(Depth2DComputer(
                        lvl_input, dmin, dmax, dim_d, epi_scale_factor,
                        lvl_params, verbose=pass_progress,
                        early_stop=early_stop, device=self.device,
                        coarse_mode=coarse_mode, use_pallas=use_pallas))
                self.level_params.append(lvl_params)
                self.level_shapes.append(tuple(level.shape[:3]))
                level = downsample_epis(level)
                if self.is_uint8:
                    level = torch.clamp(torch.round(level), 0, 255)

            if pyramid.accept_all_last_scale:
                self.computers[-1].set_accept_all(True)
            profiling.record("ftc.levels", len(self.computers))

    def run(self, ckpt_dir: Optional[str] = None):
        """Run all levels fine to coarse, deriving per-pixel bounds.

        Args:
          ckpt_dir: when given, each level found there is restored instead
            of run (it runs no pass), and each level run is saved there
            (``utils.checkpoint``, the JAX package's file format).
        """
        self.level_seconds = []
        counting = profiling.enabled()
        for p, computer in enumerate(self.computers):
            base = _level_peak_start(self.device) if counting else None
            with profiling.span("ftc.level"), \
                    profiling.counting_allocs(self.device):
                t0 = time.perf_counter()
                restored = bool(ckpt_dir) and load_level(ckpt_dir, p,
                                                         computer)
                if not restored:
                    computer.run()
                    if ckpt_dir:
                        save_level(ckpt_dir, p, computer)
                self.level_seconds.append(time.perf_counter() - t0)
            if self.verbose and (self.mesh is None or self.mesh.rank == 0):
                what = "restored" if restored else "done"
                print(f"level {p} {what} in {self.level_seconds[-1]:.2f}s "
                      f"({computer.passes_run} passes)")
            if p < len(self.computers) - 1:
                nxt = self.computers[p + 1]
                nxt.set_bounds(*bounds_from_parent(
                    computer.get_depths_s_v_u(),
                    computer.get_valid_depths_mask_s_v_u(),
                    nxt.dmin_s_v_u, nxt.dmax_s_v_u))
            # r_bar is only read while the level's own passes paint
            computer.drop_rbar()
            if counting:
                profiling.record(f"ftc.level{p}.held_bytes",
                                 held_bytes(computer))
                if base is not None:
                    profiling.record(
                        f"ftc.level{p}.peak_rise_bytes",
                        torch.cuda.max_memory_allocated(self.device) - base)

    def get_results(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fused disparity maps + validity at the finest scale
        (rslf_fine_to_coarse.hpp:302-322), ``[S, V, U]`` each."""
        with profiling.span("ftc.fuse"):
            return fuse_disp_maps(
                [c.get_depths_s_v_u() for c in self.computers],
                [c.get_valid_depths_mask_s_v_u() for c in self.computers],
                self.pyramid.final_median_filter_size)

    def get_coloured_depth_maps(self, colormap: str = "jet",
                                saturate: bool = True) -> np.ndarray:
        """Colormapped fused maps ``[S, V, U, 3]`` uint8
        (rslf_fine_to_coarse.hpp:324-377)."""
        fused, validity = self.get_results()
        return coloured_depth_maps(fused, validity,
                                   self.computers[0].get_epis(), self.params,
                                   colormap, saturate)

    def get_coloured_depth_maps_and_imgs(self, colormap: str = "jet",
                                         saturate: bool = True):
        """Depth maps juxtaposed with the input frames
        (rslf_fine_to_coarse.hpp:380-429)."""
        maps = self.get_coloured_depth_maps(colormap, saturate)
        epis = self.computers[0].get_epis().cpu().numpy()
        conv = ImageConverterUint8().fit(epis[:, 0], saturate=False)
        out = []
        for s in range(maps.shape[0]):
            frame = conv.copy_and_scale(epis[:, s])
            if frame.shape[-1] == 1:
                frame = frame[..., 0]
            out.append(side_by_side(frame, maps[s]))
        return out

    def get_coloured_epi_pyr(self, v: int = -1, colormap: str = "jet",
                             saturate: bool = True):
        """Per-level slope-coloured EPI at (scaled) row v
        (rslf_fine_to_coarse.hpp:431-487)."""
        V0 = self.level_shapes[0][0]
        if v < 0:
            v = int(round(V0 / 2.0))  # half to even, as in the JAX package
        slices, masks = [], []
        for c, shape in zip(self.computers, self.level_shapes):
            vs = int(round(v * shape[0] / V0))
            d = c.get_depths_s_v_u()[:, vs, :]
            m = c.get_valid_depths_mask_s_v_u()[:, vs, :]
            slices.append(torch.where(m, d, torch.zeros((), dtype=d.dtype,
                                                        device=d.device)))
            masks.append(m)
        return depth_pyramid_images(slices, masks, saturate, colormap)

    def get_coloured_depth_pyr(self, s: int = -1, colormap: str = "jet",
                               saturate: bool = True):
        """Per-level colormapped disparity maps at frame s
        (rslf_fine_to_coarse.hpp:490-518)."""
        S = self.level_shapes[0][1]
        if s < 0:
            s = int(round(S / 2.0))  # half to even, as in the JAX package
        slices = [c.get_depths_s_v_u()[s] for c in self.computers]
        masks = [c.get_valid_depths_mask_s_v_u()[s] for c in self.computers]
        return depth_pyramid_images(slices, masks, saturate, colormap)
