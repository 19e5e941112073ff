"""The (v, u) mesh of the port (``parallel/sharding2d.py``) on
torch.distributed: gloo, CPU ranks at world 4 ((2, 2) and (1, 4)) and
world 2 ((1, 2)), at the sizes of tests/test_sharding2d.py.  Bitwise the
port's single-device Depth2DComputer (the halos are exact and the sweep
takes positions in the image's columns), and within 1e-6 of depth (claims
exact, disp_conf within 2e-5) the JAX package's ``sharded_schedule_2d``,
on its XLA path and on its Pallas route in interpret mode.  Also: the
plain versions' ``u_valid`` and ``u_origin`` against the JAX package's,
the halo-width guard and the refusal of line mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as w
from remotesensingproject_tpu.config import DepthParams as JParams
from remotesensingproject_tpu.models import depth2d as jd
from remotesensingproject_tpu.ops.edge_confidence import (
    edge_confidence_volume as j_edge)
from remotesensingproject_tpu.ops.propagation import propagate as j_prop
from remotesensingproject_tpu.ops.sweep import sweep_pile as j_sweep
from remotesensingproject_tpu.parallel.mesh import make_mesh_2d as j_mesh_2d
from remotesensingproject_tpu.parallel.sharding2d import (
    shard_planes_2d, shard_volume_2d, sharded_schedule_2d as j_schedule_2d)
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.models.depth2d import Depth2DComputer
from remotesensingproject_tpu_torch.ops.propagation import propagate
from remotesensingproject_tpu_torch.ops.sweep import (candidate_disparities,
                                                      sweep_pile)
from remotesensingproject_tpu_torch.parallel.driver import (
    ShardedDepth2DComputer)
from remotesensingproject_tpu_torch.parallel.mesh import Mesh, Ring
from remotesensingproject_tpu_torch.parallel.sharding import exchange_halos
from remotesensingproject_tpu_torch.parallel.sharding2d import (
    halo_widths, sharded_schedule_2d)

SCENE = dict(S=6, V=16, U=64, seed=9)
# four bands: the (v, u) mesh sweeps them per pixel (the tile kernel on
# each pixel's own grid, as the JAX package's 2-D path does), where one
# device takes the row and tile rules: it equals use_pallas=False there
BANDS = dict(SCENE, bands=4)
# (tag, mesh, params, use_pallas, bounds seed, scene)
RUNS = {4: [("edge", (2, 2), {}, None, None, SCENE),
            ("plain", (2, 2), {}, False, None, SCENE),
            ("edited", (1, 4), {}, None, 5, SCENE),
            ("nearest", (1, 4), {"interpolation": "nearest"}, None, None,
             SCENE)],
        2: [("edge", (1, 2), {}, None, None, SCENE),
            ("disp", (1, 2), {"score_version": "disp"}, None, 5, SCENE),
            ("bands", (1, 2), {}, None, 5, BANDS)]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(n)``: the output directory of world n's ranks, which run
    every task of RUNS[n] in one start (made at the first call)."""
    outs = {}

    def get(n):
        if n not in outs:
            out = tmp_path_factory.mktemp(f"vu_mesh_{n}")
            tasks = [("halo", dict(mesh_shape=RUNS[n][0][1]))]
            tasks += [("driver", dict(tag=tag, mesh_shape=mesh,
                                      scene_kw=sc, params_kw=p,
                                      use_pallas=pallas, bounds_seed=seed))
                      for tag, mesh, p, pallas, seed, sc in RUNS[n]]
            w.run_ranks(out, n, tasks)
            outs[n] = out
        return outs[n]
    return get


def _single(params_kw, bounds_seed, scene=SCENE):
    c = Depth2DComputer(w.scene(**scene), w.DMIN, w.DMAX, 5,
                        params=DepthParams(**params_kw), early_stop=False,
                        device="cpu",
                        use_pallas=False if scene.get("bands") else None)
    if bounds_seed is not None:
        c.set_bounds(*(torch.from_numpy(b) for b in w.edited_bounds(
            SCENE["S"], SCENE["V"], SCENE["U"], bounds_seed)))
    return c, c.run()


@pytest.mark.parametrize("n", [4, 2])
def test_exchange_halos_on_both_rings(ranks, n):
    """The v ring brings the rows of the rank above and below, the u ring
    the columns of the rank left and right; the mesh's edges get fills."""
    out = ranks(n)
    nv, nu = RUNS[n][0][1]
    width = 2
    xs = [w.halo_input(r)[0].numpy() for r in range(n)]
    for r in range(n):
        iv, iu = divmod(r, nu)
        got = w.load(out, f"halo_{r}")
        fill = np.zeros((width, 4), np.float32)
        top = xs[r - nu][-width:] if iv > 0 else fill
        bot = xs[r + nu][:width] if iv < nv - 1 else fill
        np.testing.assert_array_equal(got["v_x"],
                                      np.concatenate([top, xs[r], bot], 0))
        fill = np.full((3, width), 7.0, np.float32)
        left = xs[r - 1][:, -width:] if iu > 0 else fill
        right = xs[r + 1][:, :width] if iu < nu - 1 else fill
        np.testing.assert_array_equal(got["u_x"],
                                      np.concatenate([left, xs[r], right], 1))


@pytest.mark.parametrize("n,run", [(n, i) for n in RUNS
                                   for i in range(len(RUNS[n]))])
def test_2d_mesh_equals_depth2d_computer(ranks, n, run):
    tag, mesh, params_kw, pallas, seed, scene = RUNS[n][run]
    got = w.load(ranks(n), tag)
    single, ref = _single(params_kw, seed, scene)
    for k in w.STATE_FIELDS:
        np.testing.assert_array_equal(got[k], getattr(ref, k).numpy(),
                                      f"{mesh} {tag} {k}")
    np.testing.assert_array_equal(
        got["valid"], single.get_valid_depths_mask_s_v_u().numpy())
    assert got["claim"].sum() < got["ce_mask"].sum() * 2  # it painted


def _jax_2d(use_pallas, mesh_shape=(2, 4)):
    """The JAX package's 2-D schedule (tests/test_sharding2d.py's run)."""
    S, V, U = SCENE["S"], SCENE["V"], SCENE["U"]
    params = JParams()
    vol = jnp.asarray(w.scene(**SCENE))
    epis = vol / jnp.max(vol)
    ce, mask = j_edge(epis, params)
    ce = jnp.transpose(ce, (1, 0, 2))
    mask = jnp.transpose(mask, (1, 0, 2))
    mesh = j_mesh_2d(mesh_shape)
    sp = lambda x: shard_planes_2d(x, mesh)  # noqa: E731
    state = jd.Depth2DState(
        ce=sp(ce), ce_mask=sp(mask), disp_conf=sp(jnp.zeros((S, V, U))),
        line_conf=sp(jnp.zeros((S, V, U))),
        best_depth=sp(jnp.zeros((S, V, U))),
        rbar=sp(jnp.zeros((S, V, U, 1))), claim=sp(mask.copy()))
    fwd = j_schedule_2d(mesh, 5, params, (w.DMIN, w.DMAX), u_global=U,
                        use_pallas=use_pallas)
    state, _, _ = fwd(shard_volume_2d(epis, mesh),
                      sp(jnp.transpose(epis, (1, 0, 2, 3))),
                      sp(jnp.full((S, V, U), w.DMIN, jnp.float32)),
                      sp(jnp.full((S, V, U), w.DMAX, jnp.float32)),
                      jnp.zeros((1,), jnp.float32), state,
                      jnp.asarray(jd.center_outward_schedule(S), jnp.int32))
    return {k: np.asarray(v) for k, v in state._asdict().items()}


@pytest.fixture(scope="module", params=[False, True],
                ids=["jax-xla", "jax-pallas-interpret"])
def jax_2d(request):
    return _jax_2d(request.param)


@pytest.mark.parametrize("n", [4, 2])
def test_2d_mesh_matches_jax_schedule_2d(ranks, n, jax_2d):
    got = w.load(ranks(n), "edge")
    for k in ("claim", "ce_mask"):
        np.testing.assert_array_equal(got[k], jax_2d[k], k)
    np.testing.assert_allclose(got["best_depth"], jax_2d["best_depth"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["disp_conf"], jax_2d["disp_conf"],
                               rtol=0, atol=2e-5)


def _block(x, u0, width, halo, axis):
    """Columns [u0 - halo, u0 + width + halo) of ``x``, zeros beyond it."""
    U = x.shape[axis]
    a, b = u0 - halo, u0 + width + halo
    pad = [(0, 0)] * x.ndim
    pad[axis] = (max(0, -a), max(0, b - U))
    core = np.take(x, np.arange(max(a, 0), min(b, U)), axis=axis)
    return np.ascontiguousarray(np.pad(core, pad))


@pytest.mark.parametrize("u0,interp", [(0, "linear"), (16, "linear"),
                                       (48, "nearest")])
def test_plain_sweep_u_valid_matches_jax(u0, interp):
    """The plain sweep on a u-haloed 16-column block with the image's
    window: within the sweep tolerances of the JAX sweep with the same
    ``u_valid``, and bitwise the whole image's sweep at the block."""
    vol = w.scene(**SCENE)
    epis = vol / vol.max()
    V, S, U, _ = epis.shape
    Ul = 16
    hu, _ = halo_widths(S, (w.DMIN, w.DMAX), 1.0)
    epis_h = _block(epis, u0, Ul, hu, 2)
    lo, hi = (np.full((V, Ul + 2 * hu), b, np.float32)
              for b in (w.DMIN, w.DMAX))
    window = (hu - u0, U - 1 - u0 + hu)
    p = DepthParams(interpolation=interp)
    got = sweep_pile(torch.from_numpy(epis_h), torch.from_numpy(lo),
                     torch.from_numpy(hi), 5, 3, p, u_valid=window)
    want = j_sweep(jnp.asarray(epis_h), jnp.asarray(lo), jnp.asarray(hi), 5,
                   3, JParams(interpolation=interp), u_valid=window)
    whole = sweep_pile(torch.from_numpy(epis), *(torch.full((V, U), b)
                                                 for b in (w.DMIN, w.DMAX)),
                       5, 3, p)
    core = slice(hu, hu + Ul)
    for name, atol in (("best_depth", 1e-6), ("best_score", 2e-5),
                       ("score_mean", 2e-5), ("rbar", 2e-5)):
        g = getattr(got, name)[:, core].numpy()
        np.testing.assert_allclose(g, np.asarray(getattr(want, name))[
            :, core], rtol=0, atol=atol, err_msg=name)
        np.testing.assert_array_equal(
            g, getattr(whole, name)[:, u0:u0 + Ul].numpy(), name)


@pytest.mark.parametrize("u0", [0, 24, 48])
def test_plain_paint_u_origin_matches_jax(u0):
    """Targets of a 24-column block painted from sources haloed by pado,
    ``u_origin = pado``: bitwise the JAX propagate with the same origin and
    the whole image's paint on the block."""
    rng = np.random.default_rng(u0)
    S, V, U, C, Ul, s_hat = 7, 5, 72, 1, 24, 3
    claim = rng.random((S, V, U)) < 0.7
    frames = rng.uniform(0.3, 0.5, (S, V, U, C)).astype(np.float32)
    depth = candidate_disparities(w.DMIN, w.DMAX, 11)[
        rng.integers(0, 11, (V, U))]
    rbar = frames[S // 2] + rng.normal(0, 0.02, (V, U, C)).astype(np.float32)
    sm = rng.random((V, U)) < 0.5
    tgt = rng.uniform(-1, 1, (S, V, U)).astype(np.float32)
    _, pado = halo_widths(S, (w.DMIN, w.DMAX), 1.0)
    hs = [_block(x, u0, Ul, pado, 1) for x in (depth, rbar, sm)]
    cut = lambda x: np.ascontiguousarray(x[:, :, u0:u0 + Ul])  # noqa: E731
    cl_j, (t_j,) = j_prop(jnp.asarray(cut(claim)), jnp.asarray(cut(frames)),
                          *map(jnp.asarray, hs), s_hat, (w.DMIN, w.DMAX),
                          1.0, 0.1, [(jnp.asarray(cut(tgt)),
                                      jnp.asarray(hs[0]))], u_origin=pado)
    t = torch.from_numpy(cut(tgt))
    cl = propagate(torch.from_numpy(cut(claim)), torch.from_numpy(
        cut(frames)), *map(torch.from_numpy, hs), s_hat, 1.0, 0.1,
        [(t, torch.from_numpy(hs[0]))], u_origin=pado)[0]
    np.testing.assert_array_equal(cl.numpy(), np.asarray(cl_j))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))
    t_whole = torch.from_numpy(tgt.copy())
    cl_whole = propagate(torch.from_numpy(claim.copy()),
                         torch.from_numpy(frames), torch.from_numpy(depth),
                         torch.from_numpy(rbar), torch.from_numpy(sm), s_hat,
                         1.0, 0.1, [(t_whole, torch.from_numpy(depth))])[0]
    np.testing.assert_array_equal(cl.numpy(), cut(cl_whole.numpy()))
    np.testing.assert_array_equal(t.numpy(), cut(t_whole.numpy()))
    assert (cl.numpy() != cut(claim)).any()


def _lone_mesh(shape):
    """A mesh record for checks that fail before any collective."""
    return Mesh(shape, 0, torch.device("cpu"), Ring(None, shape[0], 0),
                Ring(None, shape[1], 0))


def test_halo_wider_than_the_block_is_refused():
    """Halos come from the immediate neighbour: a block narrower than the
    sweep's halo fails, as the JAX package's exchange_halo asserts."""
    with pytest.raises(AssertionError, match="halo width"):
        exchange_halos([torch.zeros((4, 8))], 10, 1, Ring(None, 2, 0),
                       [0.0])
    epis = torch.zeros((4, 6, 8, 1))           # 8 columns, hu = 10
    fn = sharded_schedule_2d(_lone_mesh((1, 2)), 5, DepthParams(),
                             (w.DMIN, w.DMAX), u_global=16)
    with pytest.raises(AssertionError, match="halo width"):
        fn(epis, epis.permute(1, 0, 2, 3), None, [3])


def test_line_mode_is_refused_on_a_u_split():
    line = DepthParams(score_version="line")
    with pytest.raises(NotImplementedError, match="line"):
        sharded_schedule_2d(_lone_mesh((1, 2)), 5, line, (w.DMIN, w.DMAX),
                            u_global=16)
    with pytest.raises(NotImplementedError, match="line"):
        ShardedDepth2DComputer(w.scene(**SCENE), w.DMIN, w.DMAX, 5,
                               mesh=_lone_mesh((1, 2)), params=line)
