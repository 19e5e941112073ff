"""Checkpoint / resume for the fine-to-coarse pipeline.

Counterpart of ``remotesensingproject_tpu/utils/checkpoint.py``, in its
file format: one ``level_XX.npz`` a pyramid level, with the level's state
(``ce``, ``ce_mask``, ``disp_conf``, ``line_conf``, ``best_depth``,
``rbar``, ``claim``), ``accept_all``, and the bounds: the ``[S, V, U]``
planes ``dmin`` / ``dmax`` at a bounds-edited level, the scalars
``dmin_scalar`` / ``dmax_scalar`` at a uniform one.  A directory written
by either package resumes in the other.  The reference has no
checkpointing (SURVEY §5).

Under a mesh (``ShardedDepth2DComputer``) the format stays the same: to
save, every rank gathers the planes, rank 0 writes, and the ranks meet at a
barrier; to load, every rank reads the file and keeps its block.  Both are
collectives: every rank calls them.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.depth2d import state_from_numpy


def _path(path_dir: str, level: int) -> str:
    return os.path.join(path_dir, f"level_{level:02d}.npz")


def save_level(path_dir: str, level: int, computer) -> str:
    """Save one pyramid level's results (after ``computer.run()``)."""
    mesh = getattr(computer, "mesh", None)
    st = computer.state  # a sharded computer gathers here
    # uniform levels keep their bound planes unmade; store the scalars
    if computer._bounds_edited:
        bounds = dict(dmin=computer.dmin_s_v_u.cpu().numpy(),
                      dmax=computer.dmax_s_v_u.cpu().numpy())
    else:
        bounds = dict(dmin_scalar=np.float32(computer.dmin),
                      dmax_scalar=np.float32(computer.dmax))
    path = _path(path_dir, level)
    if mesh is None or mesh.rank == 0:
        os.makedirs(path_dir, exist_ok=True)
        np.savez_compressed(
            path, **{name: getattr(st, name).cpu().numpy()
                     for name in ("ce", "ce_mask", "disp_conf", "line_conf",
                                  "best_depth", "rbar", "claim")},
            accept_all=np.asarray(computer.accept_all), **bounds)
    if mesh is not None:
        dist.barrier()
    return path


def load_level(path_dir: str, level: int, computer) -> bool:
    """Restore a saved level into ``computer`` (a sharded computer keeps
    its block); False when there is none.

    Outside line mode ``line_conf`` is kept as ``(1, 1, 1)`` whatever
    shape the file holds.  A level saved with scalar bounds resets the
    computer's bound planes and its bounds-edited flag, so a reused
    computer keeps no stale planes."""
    path = _path(path_dir, level)
    if not os.path.exists(path):
        return False
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    state = state_from_numpy(arrays, computer.device)
    if computer.params.score_version != "line":
        state.line_conf = torch.zeros((1, 1, 1), dtype=state.line_conf.dtype,
                                      device=computer.device)
    computer.state = state
    if "dmin" in arrays:
        computer.set_bounds(torch.as_tensor(arrays["dmin"]),
                            torch.as_tensor(arrays["dmax"]))
    else:
        computer.dmin = float(arrays["dmin_scalar"])
        computer.dmax = float(arrays["dmax_scalar"])
        computer.rebuild_bounds()
    computer.accept_all = bool(arrays["accept_all"])
    computer.passes_run = 0
    return True


def run_with_checkpoints(ftc, ckpt_dir: Optional[str]):
    """``FineToCoarse.run`` with per-level save and resume in ``ckpt_dir``
    (a plain run when it is None)."""
    ftc.run(ckpt_dir=ckpt_dir)
