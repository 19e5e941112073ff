"""Ranks for the port's torch.distributed tests on the CPU.

The test modules start the ranks with ``torch.multiprocessing`` under
``spawn`` (``distributed.spawn``), over gloo with a ``file://`` rendezvous
in the test's own directory, so parallel test workers never share a port.
A rank imports torch, numpy, the port and ``oracle`` only (no JAX), runs
the tasks it is given on the CPU, and rank 0 writes each task's gathered
arrays to ``<out>/<tag>.npz`` (the halo task: every rank, its own file);
the test process compares them with the port's single-device path and the
JAX package's sharded path.
"""

from __future__ import annotations

import os

import numpy as np
import torch

import oracle
from remotesensingproject_tpu_torch.config import DepthParams, PyramidParams
from remotesensingproject_tpu_torch.parallel import distributed

DMIN, DMAX = -1.0, 1.5
STATE_FIELDS = ("ce", "ce_mask", "disp_conf", "line_conf", "best_depth",
                "rbar", "claim")


def scene(S, V, U, C=1, seed=0, n_objects=3, bands=None):
    """The light field ``[V, S, U, C]`` of ``oracle.make_synthetic_lf``;
    with ``bands``, its first channel under that many fixed gains."""
    vol, _ = oracle.make_synthetic_lf(S=S, V=V, U=U, C=C,
                                      n_objects=n_objects, seed=seed,
                                      dmin=DMIN, dmax=DMAX)
    vol = np.asarray(vol, np.float32)
    if bands:
        vol = vol[..., :1] * np.linspace(1.0, 0.5, bands, dtype=np.float32)
    return np.ascontiguousarray(vol)


def halo_input(rank, rows=3, cols=4):
    """Rank-specific planes: values, a bool mask and a two-channel frame."""
    base = torch.arange(rows * cols, dtype=torch.float32).reshape(rows, cols)
    x = base + 100.0 * rank - 0.5
    return x, (x.to(torch.int64) % 3) == 0, torch.stack([x, -x], -1)


def _mesh(shape):
    from remotesensingproject_tpu_torch.parallel.mesh import make_mesh_2d

    return make_mesh_2d(shape, device="cpu")


def _save(out, tag, **arrays):
    np.savez(os.path.join(out, f"{tag}.npz"),
             **{k: v.numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in arrays.items()})


def task_halo(rank, out, mesh_shape, width=2):
    from remotesensingproject_tpu_torch.parallel.sharding import (
        exchange_halos, exchange_v_halo)

    mesh = _mesh(mesh_shape)
    x, m, f = halo_input(rank)
    v = exchange_halos([x, m, f], width, 0, mesh.v_ring, [0.0, False, 0.0])
    u = exchange_halos([x, m, f], width, 1, mesh.u_ring, [7.0, True, 7.0])
    _save(out, f"halo_{rank}", v_x=v[0], v_m=v[1], v_f=v[2], u_x=u[0],
          u_m=u[1], u_f=u[2],
          single=exchange_v_halo(x, width, mesh, fill=-1.0))


def _computer(mesh_shape, scene_kw, params_kw=None, use_pallas=None,
              local=False, **kw):
    from remotesensingproject_tpu_torch.parallel.driver import (
        ShardedDepth2DComputer)

    mesh = _mesh(mesh_shape)
    vol = scene(**scene_kw)
    if local:
        # this rank loads only its own rows
        lo, hi = distributed.local_v_range(vol.shape[0], mesh)
        vol = distributed.volume_from_local(vol[lo:hi], vol.shape[0], mesh)
    return ShardedDepth2DComputer(
        vol, DMIN, DMAX, kw.pop("dim_d", 5), mesh=mesh,
        params=DepthParams(**(params_kw or {})), early_stop=False,
        use_pallas=use_pallas, **kw)


def task_pass(rank, out, tag, mesh_shape, scene_kw, s_hat, local=False):
    """One sharded pass from the initial state."""
    from remotesensingproject_tpu_torch.parallel.sharding import sharded_pass

    c = _computer(mesh_shape, scene_kw, local=local)
    frames = c.epis.permute(1, 0, 2, 3).contiguous()
    fn = sharded_pass(c.mesh, c.dim_d, c.params, (DMIN, DMAX))
    state, remaining = fn(c.epis, frames, c.initial_state(), s_hat)
    c.local_state = state
    full = c.state
    if rank == 0:
        _save(out, tag, remaining=remaining,
              **{k: getattr(full, k) for k in STATE_FIELDS})


def task_driver(rank, out, tag, mesh_shape, scene_kw, params_kw=None,
                use_pallas=None, bounds_seed=None, local=False):
    """``ShardedDepth2DComputer.run()``, optionally at a bounds-edited
    level (bounds from ``edited_bounds``); with ``local`` the rank loads
    only its rows of the volume and of the bounds."""
    c = _computer(mesh_shape, scene_kw, params_kw, use_pallas, local=local)
    if bounds_seed is not None:
        V, S, U = scene_kw["V"], scene_kw["S"], scene_kw["U"]
        bounds = edited_bounds(S, V, U, bounds_seed)
        if local:
            lo, hi = distributed.local_v_range(V, c.mesh)
            bounds = [distributed.planes_from_local(b[:, lo:hi], V, c.mesh)
                      for b in bounds]
        else:
            bounds = [torch.from_numpy(b) for b in bounds]
        c.set_bounds(*bounds)
    c.run()
    full = c.state
    valid = c.get_valid_depths_mask_s_v_u()
    if rank == 0:
        _save(out, tag, valid=valid, passes=c.passes_run,
              **{k: getattr(full, k) for k in STATE_FIELDS})


def task_ftc(rank, out, tag, mesh_shape, scene_kw, min_spatial_dim=10,
             use_pallas=None, ckpt=False):
    """``FineToCoarse(..., mesh=)``; with ``ckpt`` it runs twice with a
    checkpoint directory ``<out>/<tag>_ckpt``, the second time restoring
    every level (its passes are saved as ``resumed_passes``)."""
    from remotesensingproject_tpu_torch.models.fine_to_coarse import (
        FineToCoarse)

    def run():
        f = FineToCoarse(scene(**scene_kw), DMIN, DMAX, 5,
                         pyramid=PyramidParams(
                             min_spatial_dim=min_spatial_dim),
                         early_stop=False, use_pallas=use_pallas,
                         mesh=_mesh(mesh_shape))
        f.run(ckpt_dir=os.path.join(out, f"{tag}_ckpt") if ckpt else None)
        return f, f.get_results()

    f, (fused, valid) = run()
    extra = {}
    if ckpt:
        f2, (fused2, valid2) = run()
        extra = dict(resumed_fused=fused2, resumed_valid=valid2,
                     resumed_passes=[c.passes_run for c in f2.computers])
    if rank == 0:
        _save(out, tag, fused=fused, valid=valid, **extra)


def edited_bounds(S, V, U, seed):
    """Per-pixel bounds of a bounds-edited level: ranges of 0.6 around a
    random centre, a third of the pixels left at the ctor bounds."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(DMIN, DMAX, (V, U)).astype(np.float32)
    lo = np.clip(center - 0.3, DMIN, DMAX)
    hi = np.clip(center + 0.3, DMIN, DMAX)
    unref = rng.random((V, U)) < 0.3
    lo[unref], hi[unref] = DMIN, DMAX
    return (np.ascontiguousarray(np.broadcast_to(lo, (S, V, U))),
            np.ascontiguousarray(np.broadcast_to(hi, (S, V, U))))


TASKS = {"halo": task_halo, "pass": task_pass, "driver": task_driver,
         "ftc": task_ftc}


def _rank(rank, out, tasks):
    torch.set_num_threads(1)
    for name, kw in tasks:
        TASKS[name](rank, out, **kw)


def run_ranks(out_dir, world, tasks):
    """Run ``tasks`` ([(task name, keyword arguments)]) on ``world`` CPU
    ranks over gloo; returns when every rank has ended."""
    out = str(out_dir)
    distributed.spawn(_rank, world, args=(out, tasks), backend="gloo",
                      device="cpu",
                      init_method=f"file://{os.path.join(out, 'rdzv')}")


def load(out_dir, tag):
    with np.load(os.path.join(str(out_dir), f"{tag}.npz")) as z:
        return {k: z[k] for k in z.files}
