"""Mesh-parallel execution over torch.distributed.

Counterpart of ``remotesensingproject_tpu/parallel/``.  The reference's
only parallelism is an OpenMP ``parallel for`` over v, the EPI-row axis
(rslf_depth_computation_core.hpp:799).  Here v is split over the ranks of
a process group: every stage of a pass is v-independent except the
(v, u)-windowed selective median, which exchanges row halos, and the
global reductions (the normalisation max, the remaining-pixel count),
which are ``all_reduce``s.  A (v, u) mesh also splits the columns, with
u-halos for the sweep, the median and the paint (``sharding2d``).
"""

from .driver import ShardedDepth2DComputer
from .mesh import make_mesh, make_mesh_2d
from .sharding import exchange_v_halo, shard_volume, sharded_pass

__all__ = ["ShardedDepth2DComputer", "make_mesh", "make_mesh_2d",
           "shard_volume", "sharded_pass", "exchange_v_halo"]
