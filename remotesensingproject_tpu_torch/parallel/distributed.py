"""Process-group start-up, the rank's device and host-sharded ingest.

Counterpart of ``remotesensingproject_tpu/parallel/distributed.py``.  The
JAX package starts ``jax.distributed`` and assembles global arrays from
each host's block; here one process is one rank with one device, started
by ``torchrun`` (or :func:`spawn`), and a rank holds only its own block:
:func:`volume_from_local` and :func:`planes_from_local` record the block
and the global V, and assemble nothing.

Backend: NCCL when every rank of a host has a card of its own, gloo when
ranks share a card (NCCL refuses two ranks on one device) and for CPU
tensors.  :func:`initialize` prints the choice.  The collectives the port
calls (``all_reduce``, see ``parallel/sharding.py``, and a ``barrier``
after a checkpoint) exist on both, for CUDA tensors too: on gloo the process group stages a CUDA tensor
through the host itself; the port never moves a tensor off its device.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..types import resolve_device

#: this process's device, set by :func:`initialize`
_DEVICE: Optional[torch.device] = None


def choose_backend(device: torch.device, local_world: int,
                   card_each: bool = True) -> Tuple[str, str]:
    """(backend, reason) for ``local_world`` ranks of a host on
    ``device``'s type; ``card_each`` False when the ranks were all given
    the same device."""
    if device.type != "cuda":
        return "gloo", "CPU tensors"
    n = torch.cuda.device_count()
    if local_world == 1 or (card_each and local_world <= n):
        return "nccl", f"{local_world} rank(s) on {n} card(s): a card each"
    return "gloo", (f"{local_world} ranks share {n} card(s); NCCL refuses "
                    f"two ranks on one device")


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               device=None) -> torch.device:
    """Start the default process group and return this rank's device.

    With no arguments everything comes from the environment ``torchrun``
    sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``).  ``device`` defaults to card
    ``LOCAL_RANK`` modulo the host's cards (ranks beyond the cards share
    them), and raises without a card; ``device="cpu"`` runs the plain
    versions; a ``device`` given here is taken to be every rank's.
    ``backend`` defaults to :func:`choose_backend`'s."""
    global _DEVICE
    env = os.environ
    if rank is None:
        rank = int(env["RANK"])
    if world_size is None:
        world_size = int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    card_each = device is None
    if device is None:
        resolve_device(None)  # raises without a card
        device = f"cuda:{local_rank % torch.cuda.device_count()}"
    dev = torch.device(device)
    reason = "given"
    if backend is None:
        backend, reason = choose_backend(dev, local_world, card_each)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    if rank == 0:
        print(f"torch.distributed: {world_size} rank(s), backend {backend} "
              f"({reason}), rank 0 on {dev}")
    _DEVICE = dev
    return dev


def rank_device() -> torch.device:
    """This rank's device: the one :func:`initialize` chose, else card
    ``LOCAL_RANK`` modulo the cards (raising without a card)."""
    if _DEVICE is not None:
        return _DEVICE
    resolve_device(None)
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device(f"cuda:{local_rank % torch.cuda.device_count()}")


def free_port() -> int:
    """A free TCP port on this host (for ``tcp://127.0.0.1:<port>``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(rank, fn, world, init_method, backend, device, args):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        initialize(init_method, world, rank, backend, device)
        fn(rank, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, args=(), backend: Optional[str] = None,
          device=None, init_method: Optional[str] = None):
    """Run ``fn(rank, *args)`` in ``world`` new processes (start method
    ``spawn``), each a rank of a fresh process group; returns when every
    rank has ended and raises if one failed.  ``fn`` must be importable by
    name.  ``device`` is every rank's device, or None for a card each
    (:func:`initialize`); ``init_method`` defaults to a free localhost
    port."""
    import torch.multiprocessing as mp

    if init_method is None:
        init_method = f"tcp://127.0.0.1:{free_port()}"
    mp.start_processes(_spawned, args=(fn, world, init_method, backend,
                                       device, args),
                       nprocs=world, join=True, start_method="spawn")


@dataclasses.dataclass
class LocalBlock:
    """This rank's rows (``local_v_range``) of a v-sharded array of
    ``total_v`` rows: a ``[V, S, U, C]`` volume's or ``[S, V, U(, C)]``
    planes'."""

    data: Union[torch.Tensor, np.ndarray]
    total_v: int


def local_v_range(total_v: int, mesh) -> Tuple[int, int]:
    """The [lo, hi) rows of the v axis this rank loads: blocks of
    ceil(total_v / n_v) rows in rank order along the mesh's v axis."""
    block = -(-total_v // mesh.shape[0])
    lo = min(total_v, mesh.v_index * block)
    return lo, min(total_v, lo + block)


def _local(local, total_v: int, mesh, axis: int) -> LocalBlock:
    lo, hi = local_v_range(total_v, mesh)
    if local.shape[axis] != hi - lo:
        raise ValueError(f"rank {mesh.rank} loads rows [{lo}, {hi}) of "
                         f"{total_v}; got {local.shape[axis]} rows")
    return LocalBlock(local, total_v)


def volume_from_local(local_epis_v_s_u_c, total_v: int, mesh) -> LocalBlock:
    """This rank's block of the global ``[V, S, U(, C)]`` volume (rows
    ``local_v_range``), for ``ShardedDepth2DComputer``."""
    return _local(local_epis_v_s_u_c, total_v, mesh, 0)


def planes_from_local(local_s_v_u, total_v: int, mesh) -> LocalBlock:
    """This rank's block of global ``[S, V, U(, C)]`` planes (v on axis
    1), for ``ShardedDepth2DComputer.set_bounds``."""
    return _local(local_s_v_u, total_v, mesh, 1)
