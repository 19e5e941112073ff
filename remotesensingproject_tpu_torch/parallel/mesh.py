"""Process meshes over torch.distributed.

Counterpart of ``remotesensingproject_tpu/parallel/mesh.py``.  The JAX
package lays devices out on a ``jax.sharding.Mesh`` with named axes; here
one process is one rank with one device, and a :class:`Mesh` records
where this rank sits on a (v, u) grid of ranks (rank r at
(r // n_u, r % n_u)), its device, and the two rings its halos travel on:
the ranks that share its u index (the v ring) and those that share its v
index (the u ring), each with its process group.  Every rank creates
every subgroup with ``dist.new_group``, in the same order, as
torch.distributed requires.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .distributed import rank_device

V_AXIS = "v"
U_AXIS = "u"


@dataclasses.dataclass(frozen=True)
class Ring:
    """The ranks of one mesh axis through this rank: their process group
    (None: the default group), their number and this rank's index."""

    group: object
    size: int
    index: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a (n_v, n_u) grid of ranks."""

    shape: Tuple[int, int]
    rank: int
    device: torch.device
    v_ring: Ring
    u_ring: Ring

    @property
    def world(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def v_index(self) -> int:
        return self.v_ring.index

    @property
    def u_index(self) -> int:
        return self.u_ring.index


def _rings(shape: Tuple[int, int]):
    """This rank's (v ring, u ring).  Groups of the whole world are the
    default group, groups of one rank need none; every other one is made
    on every rank in the same order: the v rings by u index, then the u
    rings by v index."""
    nv, nu = shape
    world = dist.get_world_size()
    rank = dist.get_rank()
    if nv * nu != world:
        raise ValueError(f"a {nv} x {nu} mesh needs {nv * nu} ranks; the "
                         f"process group has {world}")
    ranks = np.arange(world).reshape(nv, nu)

    def make(members):
        if len(members) in (1, world):
            return {}
        return {tuple(members): dist.new_group(list(members))}

    groups = {}
    for iu in range(nu):
        groups.update(make(ranks[:, iu].tolist()))
    for iv in range(nv):
        groups.update(make(ranks[iv, :].tolist()))
    iv, iu = divmod(rank, nu)
    v_members = tuple(ranks[:, iu].tolist())
    u_members = tuple(ranks[iv, :].tolist())
    return (Ring(groups.get(v_members), nv, iv),
            Ring(groups.get(u_members), nu, iu))


def make_mesh_2d(shape=(2, 4), device=None) -> Mesh:
    """A (v, u) mesh over the default process group, which must hold
    ``shape[0] * shape[1]`` ranks.  v stays the primary data-parallel axis;
    the u axis also splits image columns, read across through u-halos
    (``parallel/sharding2d.py``).  ``device`` defaults to the rank's
    (``distributed.rank_device``)."""
    shape = (int(shape[0]), int(shape[1]))
    v_ring, u_ring = _rings(shape)
    dev = torch.device(device) if device is not None else rank_device()
    return Mesh(shape, dist.get_rank(), dev, v_ring, u_ring)


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """1-D mesh over the scanline (v) axis: every rank of the default
    process group (``n_devices``, if given, must be their number)."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"the process group has {world} ranks, not "
                         f"{n_devices}")
    return make_mesh_2d((world, 1), device)
