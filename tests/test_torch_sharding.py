"""The 1-D v mesh of the port (``parallel/``) on torch.distributed: gloo,
CPU ranks at world 2 and 3 (``torch_dist_worker``), against the port's
single-device path bitwise, and against the JAX package's sharded path on
its 8-device CPU mesh at the sizes of tests/test_sharding.py: claims and
masks exact, depth within 1e-6, disp_conf and r_bar within 2e-5 (the
sweep's last-ulp divergence, ROADMAP Queue 3); the fine-to-coarse as
tests/test_torch_fine_to_coarse.py holds it (validity exact, fused within
1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as w
from remotesensingproject_tpu.config import PyramidParams as JPyr
from remotesensingproject_tpu.models import depth2d as jd
from remotesensingproject_tpu.models.fine_to_coarse import (
    FineToCoarse as JFTC)
from remotesensingproject_tpu.ops.edge_confidence import (
    edge_confidence_volume as j_edge)
from remotesensingproject_tpu.parallel.mesh import make_mesh as j_mesh
from remotesensingproject_tpu.parallel.sharding import (
    shard_planes, shard_volume, sharded_pass as j_sharded_pass)
from remotesensingproject_tpu_torch.config import DepthParams, PyramidParams
from remotesensingproject_tpu_torch.models import depth2d as td
from remotesensingproject_tpu_torch.models.fine_to_coarse import FineToCoarse
from remotesensingproject_tpu_torch.ops.edge_confidence import (
    edge_confidence_volume)
from remotesensingproject_tpu_torch.ops.normalize import normalize_volume

PASS_SCENE = dict(S=6, V=16, U=24, seed=9)
S_HAT = 3
# V = 17: divisible by neither world size, so the last rank pads
DRIVER_SCENE = dict(S=6, V=17, U=24, seed=13)
FTC_SCENE = dict(S=6, V=24, U=32, seed=14)
VERSIONS = {"edge": {}, "disp": {"score_version": "disp"},
            "line": {"score_version": "line"},
            "opening": {"edge_confidence_opening_size": 3}}


@pytest.fixture(scope="module", params=[2, 3])
def world(request, tmp_path_factory):
    """(n, the output directory of world n's ranks); the ranks run every
    task in one start."""
    n = request.param
    out = tmp_path_factory.mktemp(f"v_mesh_{n}")
    mesh = (n, 1)
    w.run_ranks(out, n, [
        ("halo", dict(mesh_shape=mesh)),
        ("pass", dict(tag="pass", mesh_shape=mesh, scene_kw=PASS_SCENE,
                      s_hat=S_HAT)),
        *[("driver", dict(tag=f"driver_{k}", mesh_shape=mesh,
                          scene_kw=DRIVER_SCENE, params_kw=p))
          for k, p in VERSIONS.items()],
        # world 3 runs the plain stages (use_pallas=False)
        ("ftc", dict(tag="ftc", mesh_shape=mesh, scene_kw=FTC_SCENE,
                     use_pallas=False if n == 3 else None, ckpt=True))])
    return n, out


def _first_pass_inputs():
    epis = normalize_volume(torch.from_numpy(w.scene(**PASS_SCENE)))
    frames = epis.permute(1, 0, 2, 3).contiguous()
    ce, mask = edge_confidence_volume(epis, DepthParams())
    ce, mask = ce.permute(1, 0, 2), mask.permute(1, 0, 2)
    V, S, U, C = epis.shape
    z = torch.zeros((S, V, U))
    state = td.Depth2DState(ce=ce.contiguous(), ce_mask=mask.contiguous(),
                            disp_conf=z.clone(), line_conf=torch.zeros(
                                (1, 1, 1)), best_depth=z.clone(),
                            rbar=torch.zeros((S, V, U, C)),
                            claim=mask.contiguous().clone())
    return epis, frames, state


def test_exchange_v_halo_against_slicing(world):
    n, out = world
    width = 2
    xs = [w.halo_input(r) for r in range(n)]
    for r in range(n):
        got = w.load(out, f"halo_{r}")
        for k, i, fill in (("v_x", 0, 0.0), ("v_m", 1, False),
                           ("v_f", 2, 0.0)):
            mine = xs[r][i].numpy()
            top = (xs[r - 1][i].numpy()[-width:] if r > 0
                   else np.full_like(mine[:width], fill))
            bot = (xs[r + 1][i].numpy()[:width] if r < n - 1
                   else np.full_like(mine[:width], fill))
            np.testing.assert_array_equal(
                got[k], np.concatenate([top, mine, bot], 0), k)
        # a 1-D mesh has no u neighbours: both u halos are the fill
        u = np.full((3, width), 7.0, np.float32)
        np.testing.assert_array_equal(
            got["u_x"], np.concatenate([u, xs[r][0].numpy(), u], 1))
        assert got["u_m"][:, :width].all() and got["u_m"][:, -width:].all()
        assert got["single"].shape == (3 + 2 * width, 4)
        if r == 0:
            assert (got["single"][:width] == -1.0).all()


def test_sharded_pass_equals_single_device_pass(world):
    n, out = world
    got = w.load(out, "pass")
    epis, frames, state = _first_pass_inputs()
    ref = td._pass_fn(epis, frames, state, S_HAT, dim_d=5,
                      params=DepthParams(), d_bounds=(w.DMIN, w.DMAX))
    for k in w.STATE_FIELDS:
        np.testing.assert_array_equal(got[k], getattr(ref, k).numpy(), k)
    assert int(got["remaining"]) == int((ref.ce_mask & ref.claim).sum())
    assert (got["best_depth"] != 0).any()


@pytest.fixture(scope="module")
def jax_pass():
    """The JAX package's sharded pass on its 8-device mesh."""
    from remotesensingproject_tpu.config import DepthParams as JParams

    vol = jnp.asarray(w.scene(**PASS_SCENE))
    epis = vol / jnp.max(vol)
    V, S, U, C = epis.shape
    ce, mask = j_edge(epis, JParams())
    ce = jnp.transpose(ce, (1, 0, 2))
    mask = jnp.transpose(mask, (1, 0, 2))
    mesh = j_mesh()
    sp = lambda x: shard_planes(x, mesh)  # noqa: E731
    state = jd.Depth2DState(
        ce=sp(ce), ce_mask=sp(mask), disp_conf=sp(jnp.zeros((S, V, U))),
        line_conf=sp(jnp.zeros((S, V, U))),
        best_depth=sp(jnp.zeros((S, V, U))),
        rbar=sp(jnp.zeros((S, V, U, C))), claim=sp(mask.copy()))
    fn = j_sharded_pass(mesh, 5, JParams(), (w.DMIN, w.DMAX))
    st, remaining = fn(shard_volume(epis, mesh),
                       sp(jnp.transpose(epis, (1, 0, 2, 3))),
                       sp(jnp.full((S, V, U), w.DMIN, jnp.float32)),
                       sp(jnp.full((S, V, U), w.DMAX, jnp.float32)),
                       jnp.zeros((1,), jnp.float32), state, jnp.int32(S_HAT))
    return {k: np.asarray(v) for k, v in st._asdict().items()}, \
        int(remaining)


def test_sharded_pass_matches_jax_sharded_pass(world, jax_pass):
    n, out = world
    got = w.load(out, "pass")
    ref, remaining = jax_pass
    for k in ("claim", "ce_mask"):
        np.testing.assert_array_equal(got[k], ref[k], k)
    for k, atol in (("ce", 1e-6), ("best_depth", 1e-6), ("disp_conf", 2e-5),
                    ("rbar", 2e-5)):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol,
                                   err_msg=k)
    assert int(got["remaining"]) == remaining


@pytest.mark.parametrize("version", list(VERSIONS))
def test_sharded_driver_equals_depth2d_computer(world, version):
    """Every score version, and the edge mask's opening (a v window, run on
    the gathered mask), with V divisible by neither world size."""
    n, out = world
    got = w.load(out, f"driver_{version}")
    single = td.Depth2DComputer(w.scene(**DRIVER_SCENE), w.DMIN, w.DMAX, 5,
                                params=DepthParams(**VERSIONS[version]),
                                early_stop=False, device="cpu")
    ref = single.run()
    for k in w.STATE_FIELDS:
        np.testing.assert_array_equal(got[k], getattr(ref, k).numpy(), k)
    np.testing.assert_array_equal(
        got["valid"], single.get_valid_depths_mask_s_v_u().numpy())
    assert int(got["passes"]) == single.passes_run
    assert got["valid"].any()


@pytest.fixture(scope="module")
def jax_ftc():
    """The JAX package's FineToCoarse on its 8-device mesh (XLA path)."""
    j = JFTC(jnp.asarray(w.scene(**FTC_SCENE)), w.DMIN, w.DMAX, 5,
             pyramid=JPyr(min_spatial_dim=10), use_pallas=False,
             early_stop=False, mesh=j_mesh())
    j.run()
    fused, valid = j.get_results()
    return np.asarray(fused), np.asarray(valid)


def test_sharded_fine_to_coarse(world, jax_ftc):
    """Bitwise the port's single-device FineToCoarse; the JAX sharded one
    within the tolerances of tests/test_torch_fine_to_coarse.py."""
    n, out = world
    got = w.load(out, "ftc")
    t = FineToCoarse(w.scene(**FTC_SCENE), w.DMIN, w.DMAX, 5,
                     pyramid=PyramidParams(min_spatial_dim=10),
                     early_stop=False, device="cpu")
    t.run()
    fused, valid = t.get_results()
    np.testing.assert_array_equal(got["fused"], fused.numpy())
    np.testing.assert_array_equal(got["valid"], valid.numpy())
    np.testing.assert_array_equal(got["valid"], jax_ftc[1])
    np.testing.assert_allclose(got["fused"], jax_ftc[0], rtol=0, atol=1e-4)


def test_sharded_checkpoints_resume_in_either_package_format(world):
    """Checkpoints under a mesh: rank 0 writes the gathered levels in the
    single-device format; a second sharded run restores every level, runs
    no pass and gives the same maps, and a single-device run resumes from
    the same directory."""
    n, out = world
    got = w.load(out, "ftc")
    assert got["resumed_passes"].tolist() == [0, 0]
    np.testing.assert_array_equal(got["resumed_fused"], got["fused"])
    np.testing.assert_array_equal(got["resumed_valid"], got["valid"])
    t = FineToCoarse(w.scene(**FTC_SCENE), w.DMIN, w.DMAX, 5,
                     pyramid=PyramidParams(min_spatial_dim=10),
                     early_stop=False, device="cpu")
    t.run(ckpt_dir=str(out / "ftc_ckpt"))
    assert [c.passes_run for c in t.computers] == [0, 0]
    fused, valid = t.get_results()
    np.testing.assert_array_equal(got["fused"], fused.numpy())
    np.testing.assert_array_equal(got["valid"], valid.numpy())
