"""Host-sharded ingest on torch.distributed, a mirror of
tests/multihost_worker.py: two gloo ranks on the CPU each load only their
own rows (``local_v_range``, ``volume_from_local``), the normalisation max
comes from an ``all_reduce``, and one sharded pass equals the
single-device pass on the whole volume bitwise."""

import numpy as np
import pytest
import torch

import torch_dist_worker as w
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.models import depth2d as td
from remotesensingproject_tpu_torch.ops.edge_confidence import (
    edge_confidence_volume)
from remotesensingproject_tpu_torch.ops.normalize import normalize_volume
from remotesensingproject_tpu_torch.parallel.distributed import (
    local_v_range, volume_from_local)
from remotesensingproject_tpu_torch.parallel.mesh import Mesh, Ring
from remotesensingproject_tpu_torch.parallel.sharding import (shard_planes,
                                                              shard_volume)

SCENE = dict(S=5, V=8, U=32, seed=0)
S_HAT = 2


def _rank_of(shape, iv):
    return Mesh(shape, iv * shape[1], torch.device("cpu"),
                Ring(None, shape[0], iv), Ring(None, shape[1], 0))


@pytest.mark.parametrize("V,nv,want", [
    (8, 2, [(0, 4), (4, 8)]), (17, 3, [(0, 6), (6, 12), (12, 17)]),
    (9, 4, [(0, 3), (3, 6), (6, 9), (9, 9)])])
def test_local_v_range(V, nv, want):
    assert [local_v_range(V, _rank_of((nv, 1), i)) for i in range(nv)] == \
        want


def test_volume_from_local_checks_the_rows():
    mesh = _rank_of((2, 1), 1)
    block = volume_from_local(np.zeros((4, 5, 32, 1)), 8, mesh)
    assert block.total_v == 8 and block.data.shape[0] == 4
    with pytest.raises(ValueError, match="rows"):
        volume_from_local(np.zeros((5, 5, 32, 1)), 8, mesh)


def test_shard_volume_and_planes_take_the_ranks_block():
    """Rank (1, 0) of a (2, 2) mesh holds rows 4..7 and columns 0..15."""
    mesh = Mesh((2, 2), 2, torch.device("cpu"), Ring(None, 2, 1),
                Ring(None, 2, 0))
    vol = torch.arange(8 * 3 * 32 * 1.0).reshape(8, 3, 32, 1)
    assert torch.equal(shard_volume(vol, mesh), vol[4:8, :, :16])
    planes = vol.permute(1, 0, 2, 3)
    assert torch.equal(shard_planes(planes, mesh), planes[:, 4:8, :16])
    with pytest.raises(ValueError, match="split"):
        shard_volume(vol[:7], mesh)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("multihost")
    w.run_ranks(out, 2, [
        ("pass", dict(tag="pass", mesh_shape=(2, 1), scene_kw=SCENE,
                      s_hat=S_HAT, local=True)),
        ("driver", dict(tag="edited", mesh_shape=(2, 1), scene_kw=SCENE,
                        bounds_seed=3, local=True))])
    return out


def test_two_ranks_load_their_rows_and_pass_as_one(two_ranks):
    got = w.load(two_ranks, "pass")
    epis = normalize_volume(torch.from_numpy(w.scene(**SCENE)))
    frames = epis.permute(1, 0, 2, 3).contiguous()
    params = DepthParams()
    ce, mask = edge_confidence_volume(epis, params)
    ce, mask = (x.permute(1, 0, 2).contiguous() for x in (ce, mask))
    V, S, U, C = epis.shape
    state = td.Depth2DState(
        ce=ce, ce_mask=mask, disp_conf=torch.zeros((S, V, U)),
        line_conf=torch.zeros((1, 1, 1)), best_depth=torch.zeros((S, V, U)),
        rbar=torch.zeros((S, V, U, C)), claim=mask.clone())
    ref = td._pass_fn(epis, frames, state, S_HAT, dim_d=5, params=params,
                      d_bounds=(w.DMIN, w.DMAX))
    np.testing.assert_array_equal(got["best_depth"], ref.best_depth.numpy())
    np.testing.assert_array_equal(got["claim"], ref.claim.numpy())
    assert int(got["remaining"]) == int((ref.ce_mask & ref.claim).sum())


def test_two_ranks_load_their_rows_of_the_bounds(two_ranks):
    """``planes_from_local``: each rank sets only its rows of a
    bounds-edited level's planes; the run equals the single-device one."""
    got = w.load(two_ranks, "edited")
    c = td.Depth2DComputer(w.scene(**SCENE), w.DMIN, w.DMAX, 5,
                           early_stop=False, device="cpu")
    c.set_bounds(*(torch.from_numpy(b) for b in w.edited_bounds(
        SCENE["S"], SCENE["V"], SCENE["U"], 3)))
    ref = c.run()
    for k in w.STATE_FIELDS:
        np.testing.assert_array_equal(got[k], getattr(ref, k).numpy(), k)
