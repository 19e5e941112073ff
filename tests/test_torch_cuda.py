"""The CUDA kernels against their plain PyTorch versions on the card.

CUDA kernels have no CPU mode, so these tests skip without a card; on a
machine with an H100 (and no JAX) run them with
``python -m pytest tests/test_torch_cuda.py --noconftest -q``.
Every kernel must be bitwise equal to its plain version (the first pixel
sweep test keeps the tolerances of tests/test_torch_sweep.py).  The pixel
and the tile sweep share the (pixel, candidate) core ``csrc/sweep_pc.cuh``;
their tests cover the sizes its layout must survive: D that is not a
multiple of a warp, D beyond a window's list, every channel
instantiation, pixels with no allowed candidate, a list of one pixel and
lists that do not fill their last group, and C = 3 at the RGB scene's
depth S = 100 and at odd depths (part of an item's samples in registers)
under every rule and mode.  The row sweep is a third launcher
of that core (shared-shift positions, two item orders); the paint is driven
from its sources, in tiles of target columns and runs of frames.  The
median works on tiles staged in shared memory: its tests take every
instantiation (sizes 3 and 5 at C = 1, 3, 4; the generic size; channels in
stages), images smaller than a tile or a window, eps <= 0 and an empty
mask.  Line mode, fast mode and nearest interpolation: the pixel sweep's
k_best and its fast cap, the nearest rule in the pixel and the tile sweep,
the paint with one to three payloads, and whole runs in each mode against
the CPU.  The (v, u) mesh's operands: the pixel and the tile sweep on a
u-haloed block with its ``u_valid`` window, and the paint from haloed
sources with ``u_origin``, each bitwise against its plain version and
against the whole image's result at the block's pixels.  A pass that never
waits on the card: the three sweeps with the compaction's count in device
memory (0, 1, 37, all, and more pixels than the resident blocks hold at
the smallest group size), and whole runs under ``torch.cuda.set_sync_debug_mode("error")``
bitwise the immediate early stop's."""

import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.models.depth2d import (
    Depth2DComputer, center_outward_schedule)
from remotesensingproject_tpu_torch.ops import cuda_build
from remotesensingproject_tpu_torch.ops.median import selective_median
from remotesensingproject_tpu_torch.ops.median_pallas import (
    launch_plan as median_launch_plan, selective_median_cuda)
from remotesensingproject_tpu_torch.ops.propagation import propagate
from remotesensingproject_tpu_torch.ops.propagation_pallas import (
    propagate_cuda)
from remotesensingproject_tpu_torch.ops.sweep import sweep_pile
from remotesensingproject_tpu_torch.ops.sweep_pallas import (
    candidate_grid, sweep_pile_rows, sweep_rows_plain)
from remotesensingproject_tpu_torch.ops.sweep_pallas_perpixel import (
    sweep_pile_tiles, tile_quantized_bounds)
from remotesensingproject_tpu_torch.ops.sweep_pallas_pixel import (
    sweep_pile_pixel)

pytestmark = pytest.mark.cuda
TOL = {"best_score": 2e-5, "best_depth": 1e-6, "score_mean": 5e-5,
       "rbar": 2e-5}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _vol(C, S=12, V=16, U=96, seed=0):
    vol, _ = oracle.make_synthetic_lf(S=S, V=V, U=U, C=min(C, 3), seed=seed,
                                      dmin=-1.0, dmax=1.5)
    vol = vol / vol.max()
    if C > 3:  # more bands: fixed gains on one channel
        vol = vol[..., :1] * np.linspace(1.0, 0.5, C).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(vol))


def _same_sweep(got, want, m, with_k):
    for name in ("best_score", "score_mean", "best_depth", "rbar"):
        assert torch.equal(getattr(got, name)[m], getattr(want, name)[m]), \
            name
    if with_k:
        assert torch.equal(got.k_best.permute(0, 2, 1)[m],
                           want.k_best.permute(0, 2, 1)[m])


@pytest.mark.parametrize("C,with_k,D", [(1, False, 24), (1, True, 24),
                                        (4, True, 24), (1, False, 1030),
                                        (6, True, 9)])
def test_rows_kernel_bitwise(dev, C, with_k, D):
    epis = _vol(C).to(dev)
    V, S, U, _ = epis.shape
    g = torch.Generator().manual_seed(C + D)
    active = (torch.rand((V, U), generator=g) < 0.5).to(dev)
    n0 = cuda_build.launches["sweep_rows"]
    got = sweep_pile_rows(epis, -1.0, 1.5, D, S // 2, DepthParams(),
                          with_k_best=with_k, active_v_u=active)
    assert cuda_build.launches["sweep_rows"] == n0 + 1
    want = sweep_rows_plain(epis, candidate_grid(-1.0, 1.5, D, dev), S // 2,
                            DepthParams(), with_k_best=with_k)
    _same_sweep(got, want, active, with_k)


@pytest.mark.parametrize(
    "S,U,C,D",
    [(S, U, C, D) for S, U in ((7, 45), (100, 77))
     for C, D in ((1, 120), (3, 7), (4, 130), (5, 9))]
    + [(7, 45, 1, 1030)])      # D beyond a window's list
def test_rows_core_odd_sizes_bitwise(dev, S, U, C, D):
    """U not a multiple of a warp, short and long sample columns, every
    channel instantiation."""
    epis = _vol(C, S=S, V=5, U=U, seed=S + C).to(dev)
    V = epis.shape[0]
    g = torch.Generator().manual_seed(S + U + C + D)
    active = (torch.rand((V, U), generator=g) < 0.7).to(dev)
    s_hat = S // 3
    got = sweep_pile_rows(epis, -1.0, 1.5, D, s_hat, DepthParams(),
                          with_k_best=True, active_v_u=active)
    want = sweep_rows_plain(epis, candidate_grid(-1.0, 1.5, D, dev), s_hat,
                            DepthParams(), with_k_best=True)
    _same_sweep(got, want, active, True)
    assert not got.best_depth[~active].any()


@pytest.mark.parametrize("n_active", [1, 3, 33, 70])
def test_rows_core_short_lists_bitwise(dev, n_active):
    """A late pass: a handful of active pixels scattered over the rows."""
    epis = _vol(4, S=10, V=6, U=70).to(dev)
    V, S, U, _ = epis.shape
    g = torch.Generator().manual_seed(n_active)
    flat = torch.zeros(V * U, dtype=torch.bool)
    flat[torch.randperm(V * U, generator=g)[:n_active]] = True
    active = flat.reshape(V, U).to(dev)
    got = sweep_pile_rows(epis, -3.0, 4.0, 24, 2, DepthParams(),
                          with_k_best=True, active_v_u=active)
    want = sweep_rows_plain(epis, candidate_grid(-3.0, 4.0, 24, dev), 2,
                            DepthParams(), with_k_best=True)
    _same_sweep(got, want, active, True)
    assert not got.k_best.permute(0, 2, 1)[~active].any()


@pytest.mark.parametrize("C,with_k", [(1, False), (4, True), (5, True)])
def test_rows_launch_plan(dev, C, with_k):
    from remotesensingproject_tpu_torch.ops import sweep_pallas

    plan = sweep_pallas.launch_plan(12, C, with_k)
    assert plan["threads"] in (32, 64, 128, 256)
    assert plan["blocks_per_sm"] >= 1


@pytest.mark.parametrize("C,masked,with_k", [(1, False, True), (1, True, False),
                                             (4, True, True), (4, False, False),
                                             (6, True, True)])
def test_tiles_kernel_bitwise(dev, C, masked, with_k):
    epis = _vol(C).to(dev)
    V, S, U, _ = epis.shape
    g = torch.Generator().manual_seed(10 + C)
    active = (torch.rand((V, U), generator=g) < 0.6).to(dev)
    c = torch.rand((V, U), generator=g).to(dev) * 1.7 - 0.6
    lo = torch.clamp(c - 0.4, -1.0, 1.5).contiguous()
    hi = torch.clamp(c + 0.4, -1.0, 1.5).contiguous()
    kw = {}
    if masked:
        qlo, qhi = tile_quantized_bounds(active, lo, hi, (-1.0, 1.5))
        kw = dict(pdmin_v_u=lo, pdmax_v_u=hi)
        lo, hi = qlo, qhi
    n0 = cuda_build.launches["sweep_tiles"]
    got = sweep_pile_tiles(epis, lo, hi, 24, S // 2, DepthParams(),
                           with_k_best=with_k, active_v_u=active, **kw)
    assert cuda_build.launches["sweep_tiles"] == n0 + 1
    want = sweep_pile(epis, lo, hi, 24, S // 2, DepthParams(),
                      with_k_best=with_k, **kw)
    _same_sweep(got, want, active, with_k)


@pytest.mark.parametrize("C,per_pixel,D", [(1, False, 24), (1, True, 24),
                                           (3, True, 24), (1, False, 200)])
def test_sweep_kernel_matches_plain(dev, C, per_pixel, D):
    epis = _vol(C).to(dev)
    V, S, U, _ = epis.shape
    g = torch.Generator().manual_seed(C)
    active = (torch.rand((V, U), generator=g) < 0.5).to(dev)
    lo = torch.full((V, U), -1.0, device=dev)
    hi = torch.full((V, U), 1.5, device=dev)
    if per_pixel:
        c = torch.rand((V, U), generator=g).to(dev) * 1.7 - 0.6
        lo, hi = torch.clamp(c - 0.4, -1.0, 1.5), torch.clamp(c + 0.4, -1.0, 1.5)
    kw = dict(dmin_v_u=lo, dmax_v_u=hi) if per_pixel else {}
    n0 = cuda_build.launches["sweep_pixel"]
    got = sweep_pile_pixel(epis, -1.0, 1.5, D, S // 2, DepthParams(), active,
                           **kw)
    assert cuda_build.launches["sweep_pixel"] == n0 + 1
    want = sweep_pile(epis, lo, hi, D, S // 2, DepthParams())
    m = active
    for name, atol in TOL.items():
        torch.testing.assert_close(getattr(got, name)[m],
                                   getattr(want, name)[m], rtol=0, atol=atol)


def _ranges(V, U, dev, seed):
    g = torch.Generator().manual_seed(seed)
    c = torch.rand((V, U), generator=g).to(dev) * 1.7 - 0.6
    lo = torch.clamp(c - 0.4, -1.0, 1.5).contiguous()
    hi = torch.clamp(c + 0.4, -1.0, 1.5).contiguous()
    active = (torch.rand((V, U), generator=g) < 0.6).to(dev)
    return lo, hi, active


@pytest.mark.parametrize(
    "D,C,masked",
    [(D, C, m) for D in (7, 120, 130) for C in (1, 3, 4, 5)
     for m in (False, True)]
    # D beyond a window's list
    + [(1030, 1, True), (1030, 5, True), (1030, 4, False)])
def test_core_sizes_through_tiles_bitwise(dev, D, C, masked):
    epis = _vol(C, S=10, V=6, U=64).to(dev)
    V, S, U, _ = epis.shape
    lo, hi, active = _ranges(V, U, dev, 100 + C + D)
    if int(active.sum()) % 8 == 0:       # keep the last group ragged
        active[tuple(torch.nonzero(active)[0])] = False
    kw = {}
    if masked:
        # some pixels whose allowed range misses the grid: n_allowed = 0
        lo[0, :5], hi[0, :5] = 7.0, 8.0
        active[0, :4] = True
        qlo, qhi = tile_quantized_bounds(active, torch.clamp(lo, -1.0, 1.5),
                                         torch.clamp(hi, -1.0, 1.5),
                                         (-1.0, 1.5))
        kw = dict(pdmin_v_u=lo, pdmax_v_u=hi)
        lo, hi = qlo, qhi
    got = sweep_pile_tiles(epis, lo, hi, D, S // 2, DepthParams(),
                           with_k_best=True, active_v_u=active, **kw)
    want = sweep_pile(epis, lo, hi, D, S // 2, DepthParams(),
                      with_k_best=True, **kw)
    _same_sweep(got, want, active, True)
    if masked:
        assert (got.best_score[0, :4] == -1.0).all()
        assert not got.k_best[0, :, :4].any()


@pytest.mark.parametrize("D", [7, 120, 130])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_core_sizes_through_pixel_bitwise(dev, D, C, per_pixel):
    epis = _vol(C, S=10, V=6, U=64).to(dev)
    V, S, U, _ = epis.shape
    lo, hi, active = _ranges(V, U, dev, 200 + C + D)
    if not per_pixel:
        lo, hi = torch.full_like(lo, -1.0), torch.full_like(hi, 1.5)
    kw = dict(dmin_v_u=lo, dmax_v_u=hi) if per_pixel else {}
    got = sweep_pile_pixel(epis, -1.0, 1.5, D, S // 2, DepthParams(), active,
                           **kw)
    want = sweep_pile(epis, lo, hi, D, S // 2, DepthParams())
    _same_sweep(got, want, active, False)


@pytest.mark.parametrize("n_active", [1, 2, 9, 17, 65])
def test_core_short_lists_bitwise(dev, n_active):
    """One active pixel, and lists that leave the last group ragged."""
    epis = _vol(1, S=10, V=6, U=64).to(dev)
    V, S, U, _ = epis.shape
    lo, hi, _ = _ranges(V, U, dev, 300)
    g = torch.Generator().manual_seed(n_active)
    flat = torch.zeros(V * U, dtype=torch.bool)
    flat[torch.randperm(V * U, generator=g)[:n_active]] = True
    active = flat.reshape(V, U).to(dev)
    p = DepthParams()
    got = sweep_pile_pixel(epis, -1.0, 1.5, 24, S // 2, p, active,
                           dmin_v_u=lo, dmax_v_u=hi)
    want = sweep_pile(epis, lo, hi, 24, S // 2, p, with_k_best=True)
    _same_sweep(got, want, active, False)
    assert not got.best_depth[~active].any()
    qlo, qhi = tile_quantized_bounds(active, lo, hi, (-1.0, 1.5))
    got = sweep_pile_tiles(epis, qlo, qhi, 24, S // 2, p, with_k_best=True,
                           active_v_u=active, pdmin_v_u=lo, pdmax_v_u=hi)
    want = sweep_pile(epis, qlo, qhi, 24, S // 2, p, True, lo, hi)
    _same_sweep(got, want, active, True)


def test_core_raises_when_no_block_size_fits(dev):
    """2,000 samples a column: 32 threads' columns exceed a block's shared
    memory, so all three launchers raise and launch nothing."""
    epis = torch.rand((1, 2000, 8, 1), device=dev)
    plane = torch.zeros((1, 8), device=dev)
    active = torch.ones((1, 8), dtype=torch.bool, device=dev)
    n0 = cuda_build.launches["sweep_pixel"], cuda_build.launches["sweep_tiles"]
    nr = cuda_build.launches["sweep_rows"]
    with pytest.raises(NotImplementedError, match="shared memory"):
        sweep_pile_rows(epis, -1.0, 1.5, 5, 1000, DepthParams())
    assert nr == cuda_build.launches["sweep_rows"]
    with pytest.raises(NotImplementedError, match="shared memory"):
        sweep_pile_pixel(epis, -1.0, 1.5, 5, 1000, DepthParams(), active)
    with pytest.raises(NotImplementedError, match="shared memory"):
        sweep_pile_tiles(epis, plane, plane + 1.0, 5, 1000, DepthParams(),
                         active_v_u=active)
    assert n0 == (cuda_build.launches["sweep_pixel"], cuda_build.launches["sweep_tiles"])


def _median_inputs(dev, V, U, C, seed, p_mask=0.6):
    g = torch.Generator().manual_seed(seed)
    src = (torch.randint(-8, 17, (V, U), generator=g) / 8.0).to(dev)
    frame = (torch.rand((V, U, C), generator=g) * 0.3 + 0.3).to(dev)
    mask = (torch.rand((V, U), generator=g) < p_mask).to(dev)
    return src, frame, mask


def _median_same(dev, src, frame, mask, size, eps):
    n0 = cuda_build.launches["median"]
    got = selective_median_cuda(src, frame, mask, size, eps)
    torch.cuda.synchronize()
    assert cuda_build.launches["median"] == n0 + 1
    want = selective_median(src, frame, mask, size, eps)
    assert torch.equal(got, want)
    return got


# 17 x 30 is level 5 of the bench pyramid, 48 x 96 data/strips16; sizes 3
# and 5 run their own instantiations, 4, 9 and 17 the generic one; C = 7
# the staged channels
@pytest.mark.parametrize("V,U", [(17, 30), (48, 96), (70, 129)])
@pytest.mark.parametrize("C", [1, 3, 4, 7])
@pytest.mark.parametrize("size", [3, 4, 5, 9, 17])
def test_median_kernel_bitwise(dev, size, C, V, U):
    src, frame, mask = _median_inputs(dev, V, U, C, size * 100 + C + V)
    # at eps 2 every colour test passes: the halo's mask alone decides
    for eps in (0.1, 2.0):
        _median_same(dev, src, frame, mask, size, eps)


@pytest.mark.parametrize("eps", [0.0, -0.5])
@pytest.mark.parametrize("size", [3, 4, 5])
def test_median_kernel_eps_not_positive(dev, size, eps):
    src, frame, mask = _median_inputs(dev, 48, 96, 3, size)
    got = _median_same(dev, src, frame, mask, size, eps)
    assert bool(torch.isinf(got[mask]).all())


@pytest.mark.parametrize("size", [3, 4, 5])
def test_median_kernel_all_false_mask(dev, size):
    src, frame, mask = _median_inputs(dev, 48, 96, 4, size, p_mask=0.0)
    got = _median_same(dev, src, frame, mask, size, 0.1)
    assert not bool(got.any())


@pytest.mark.parametrize("size,C", [(17, 64), (5, 400), (3, 300)])
def test_median_kernel_large_c(dev, size, C):
    """Shorter tiles (size 17, C = 64), then channels in stages."""
    plan = median_launch_plan(size, C)
    assert plan["tile_v"] < 8 or plan["channels_per_stage"] < C
    src, frame, mask = _median_inputs(dev, 19, 70, C, C)
    _median_same(dev, src, frame, mask, size, 0.5)


def test_median_kernel_unaligned_four_channels(dev):
    """A C = 4 frame off a 16-byte boundary takes the generic channels."""
    src, frame, mask = _median_inputs(dev, 40, 70, 4, 3)
    base = torch.zeros(40 * 70 * 4 + 1, device=dev)
    odd = base[1:].view(40, 70, 4)
    odd.copy_(frame)
    _median_same(dev, src, odd, mask, 5, 0.1)


def test_median_launch_plan(dev):
    p5 = median_launch_plan(5, 1)
    assert (p5["threads"], p5["tile_v"], p5["tile_u"]) == (256, 8, 32)
    assert (p5["size_template"], p5["channel_template"]) == (5, 1)
    assert median_launch_plan(5, 4)["channel_template"] == 4
    assert median_launch_plan(5, 7)["channel_template"] == 0
    assert median_launch_plan(4, 1)["size_template"] == 0
    for bad in ((0, 1), (18, 1), (5, 0)):
        with pytest.raises(RuntimeError):
            median_launch_plan(*bad)
    with pytest.raises(NotImplementedError):
        selective_median_cuda(*_median_inputs(dev, 8, 8, 1, 0), 18, 0.1)


@pytest.mark.parametrize("C", [1, 3, 4, 6])
def test_paint_kernel_bitwise(dev, C):
    g = torch.Generator().manual_seed(10 + C)
    S, V, U = 9, 12, 80
    claim = (torch.rand((S, V, U), generator=g) < 0.7).to(dev)
    frames = (torch.rand((S, V, U, C), generator=g) * 0.2 + 0.3).to(dev)
    depth = (torch.randint(0, 11, (V, U), generator=g) * 0.25 - 1.0).to(dev)
    rbar = frames[S // 2] + 0.01
    sm = (torch.rand((V, U), generator=g) < 0.5).to(dev)
    conf = torch.rand((V, U), generator=g).to(dev)
    tgts = [torch.rand((S, V, U), generator=g).to(dev) for _ in range(2)]

    def run(fn):
        cl, t = claim.clone(), [x.clone() for x in tgts]
        fn(cl, frames, depth, rbar, sm, 4, 1.0, 0.1,
           [(t[0], depth), (t[1], conf)])
        return cl, t

    cl_k, t_k = run(propagate_cuda)
    cl_p, t_p = run(propagate)
    assert torch.equal(cl_k, cl_p)
    assert not torch.equal(cl_k, claim)
    for a, b in zip(t_k, t_p):
        assert torch.equal(a, b)


def _paint_scene(S, V, U, C, seed, p_source=0.5, p_open=0.7, slope=1.0):
    g = torch.Generator().manual_seed(seed)
    claim = torch.rand((S, V, U), generator=g) < p_open
    frames = torch.rand((S, V, U, C), generator=g) * 0.2 + 0.3
    depth = torch.randint(0, 21, (V, U), generator=g) * 0.25 - 1.0
    rbar = frames[S // 2] + 0.01
    sm = torch.rand((V, U), generator=g) < p_source
    conf = torch.rand((V, U), generator=g)
    tgts = [torch.rand((S, V, U), generator=g) for _ in range(2)]
    return claim, frames, depth, rbar, sm, conf, tgts, slope


def _paint_both(dev, scene, s_hat, **kw):
    claim, frames, depth, rbar, sm, conf, tgts, slope = scene
    claim, frames, depth, rbar, sm, conf = (
        t.to(dev) for t in (claim, frames, depth, rbar, sm, conf))
    tgts = [t.to(dev) for t in tgts]

    def run(fn, **kw_):
        cl, t = claim.clone(), [x.clone() for x in tgts]
        fn(cl, frames, depth, rbar, sm, s_hat, slope, 0.1,
           [(t[0], depth), (t[1], conf)], **kw_)
        return cl, t

    cl_k, t_k = run(propagate_cuda, **kw)
    cl_p, t_p = run(propagate)
    assert torch.equal(cl_k, cl_p)
    for a, b in zip(t_k, t_p):
        assert torch.equal(a, b)
    return int((claim & ~cl_k).sum())


@pytest.mark.parametrize("tile,S,V,U",
                         [(0, 7, 6, 45), (32, 7, 6, 45), (7, 7, 6, 45),
                          (45, 7, 6, 45), (0, 100, 6, 77), (32, 100, 6, 77),
                          (0, 7, 1500, 45), (32, 7, 900, 45)])
@pytest.mark.parametrize("C", [1, 3, 4, 5])
def test_paint_scatter_odd_sizes_bitwise(dev, tile, S, V, U, C):
    """U not a multiple of a warp, forced tile widths that split the row,
    every channel instantiation, s_hat at the border and inside, both signs
    of the slope; with many rows a block takes a run of several frames."""
    for s_hat, slope in ((0, 1.0), (S // 2, -0.7), (S - 1, 0.3)):
        scene = _paint_scene(S, V, U, C, seed=S + U + C, slope=slope)
        assert _paint_both(dev, scene, s_hat, tile=tile) > 0


@pytest.mark.parametrize("tile", [0, 16])
def test_paint_scatter_few_sources_and_none(dev, tile):
    """A late pass: a handful of sources, few open targets; then no source
    at all, which must leave everything as it was."""
    scene = _paint_scene(9, 12, 80, 1, seed=3, p_source=0.01, p_open=0.05)
    _paint_both(dev, scene, 4, tile=tile)
    scene = _paint_scene(9, 12, 80, 1, seed=4, p_source=0.0)
    assert _paint_both(dev, scene, 4, tile=tile) == 0


def test_paint_rejects_bad_launch_shape(dev):
    scene = _paint_scene(3, 2, 16, 1, seed=0)
    n0 = cuda_build.launches["paint"]
    with pytest.raises(ValueError, match="tile"):
        _paint_both(dev, scene, 1, tile=10 ** 6)
    assert cuda_build.launches["paint"] == n0


def test_depth2d_on_card_matches_cpu(dev):
    vol = _vol(1, S=8, V=12, U=64, seed=3).numpy()
    ref = Depth2DComputer(vol, -1.0, 1.5, 9, device="cpu")
    ref.run()
    out = Depth2DComputer(vol, -1.0, 1.5, 9, device=dev)
    out.run()
    for name in ("claim", "ce_mask"):
        assert torch.equal(getattr(out.state, name).cpu(),
                           getattr(ref.state, name))
    torch.testing.assert_close(out.state.best_depth.cpu(),
                               ref.state.best_depth, rtol=0, atol=1e-4)


# ---- line mode, fast mode, nearest interpolation ----

NEAREST = DepthParams(interpolation="nearest")


@pytest.mark.parametrize("C,per_pixel,D", [(1, False, 24), (1, True, 24),
                                           (3, True, 9), (1, True, 130)])
@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_pixel_k_best_bitwise(dev, C, per_pixel, D, interp):
    """k_best of the pixel sweep, under both rules, zeros where not swept."""
    epis = _vol(C, S=10, V=6, U=64).to(dev)
    V, S, U, _ = epis.shape
    lo, hi, active = _ranges(V, U, dev, 400 + C + D)
    if not per_pixel:
        lo, hi = torch.full_like(lo, -1.0), torch.full_like(hi, 1.5)
    kw = dict(dmin_v_u=lo, dmax_v_u=hi) if per_pixel else {}
    p = DepthParams(interpolation=interp)
    n0 = cuda_build.launches["sweep_pixel"]
    got = sweep_pile_pixel(epis, -1.0, 1.5, D, S // 2, p, active,
                           with_k_best=True, **kw)
    assert cuda_build.launches["sweep_pixel"] == n0 + 1
    want = sweep_pile(epis, lo, hi, D, S // 2, p, with_k_best=True)
    _same_sweep(got, want, active, True)
    assert not got.k_best.permute(0, 2, 1)[~active].any()
    assert got.k_best.permute(0, 2, 1)[active].any()


@pytest.mark.parametrize("C,per_pixel", [(1, False), (1, True), (3, False)])
def test_pixel_fast_bitwise(dev, C, per_pixel):
    """Fast mode: the pixel sweep against the plain sweep with 5 steps."""
    epis = _vol(C, S=10, V=6, U=64).to(dev)
    V, S, U, _ = epis.shape
    lo, hi, active = _ranges(V, U, dev, 500 + C)
    if not per_pixel:
        lo, hi = torch.full_like(lo, -1.0), torch.full_like(hi, 1.5)
    kw = dict(dmin_v_u=lo, dmax_v_u=hi) if per_pixel else {}
    got = sweep_pile_pixel(epis, -1.0, 1.5, 24, S // 2,
                           DepthParams(fast=True), active, with_k_best=True,
                           **kw)
    want = sweep_pile(epis, lo, hi, 24, S // 2,
                      DepthParams(mean_shift_max_iter=5), with_k_best=True)
    _same_sweep(got, want, active, True)


@pytest.mark.parametrize("C,masked,D", [(1, False, 24), (4, False, 24),
                                        (4, False, 130), (5, False, 9),
                                        (4, True, 24)])
def test_tiles_nearest_bitwise(dev, C, masked, D):
    epis = _vol(C, S=10, V=6, U=64).to(dev)
    V, S, U, _ = epis.shape
    lo, hi, active = _ranges(V, U, dev, 600 + C + D)
    kw = {}
    if masked:
        qlo, qhi = tile_quantized_bounds(active, lo, hi, (-1.0, 1.5))
        kw = dict(pdmin_v_u=lo, pdmax_v_u=hi)
        lo, hi = qlo, qhi
    n0 = cuda_build.launches["sweep_tiles"]
    got = sweep_pile_tiles(epis, lo, hi, D, S // 2, NEAREST,
                           with_k_best=True, active_v_u=active, **kw)
    assert cuda_build.launches["sweep_tiles"] == n0 + 1
    want = sweep_pile(epis, lo, hi, D, S // 2, NEAREST, with_k_best=True,
                      **kw)
    _same_sweep(got, want, active, True)
    lin = sweep_pile_tiles(epis, lo, hi, D, S // 2, DepthParams(),
                           active_v_u=active, **kw)
    assert not torch.equal(lin.rbar[active], got.rbar[active])


@pytest.mark.parametrize("C,with_k", [(1, True), (3, False), (4, True)])
def test_sweep_launch_plans_of_new_modes(dev, C, with_k):
    from remotesensingproject_tpu_torch.ops import (sweep_pallas_perpixel,
                                                    sweep_pallas_pixel)

    plans = [sweep_pallas_perpixel.launch_plan(12, C, with_k, False, True)]
    if C in (1, 3):
        plans += [sweep_pallas_pixel.launch_plan(12, C, with_k, nearest)
                  for nearest in (False, True)]
    for plan in plans:
        assert plan["threads"] in (32, 64, 128, 256)
        assert plan["blocks_per_sm"] >= 1
        assert plan["resident_warps"] == \
            plan["threads"] * plan["blocks_per_sm"] // 32
    if C == 3:
        # the RGB scene's depth: at least 8 resident warps an SM, against
        # the 5 of a whole run in shared memory (32-thread blocks, 5 an
        # SM).  8 is the most an item a thread can have at S = 100, C = 3:
        # a third warp on one of the SM's four register sub-partitions
        # (16,384 registers each) leaves a thread 168 registers, and 9 or
        # more warps' runs of 1,200 bytes do not fit in those beside the
        # working registers and in 228 KB of shared memory
        for nearest in (False, True):
            plan = sweep_pallas_pixel.launch_plan(100, 3, with_k, nearest)
            assert plan["resident_warps"] >= 8, plan


C3_MODES = ("linear", "nearest", "window", "nearest window", "k_best",
            "nearest k_best", "fast", "per-pixel", "per-pixel nearest k_best")


@pytest.mark.parametrize("mode", C3_MODES)
@pytest.mark.parametrize("S", [100, 37, 101])
def test_pixel_c3_full_depth_bitwise(dev, S, mode):
    """The pixel sweep at C = 3 at the RGB scene's depth (S = 100) and at
    odd depths (the register segment's hand-over to the column, batch
    tails), under every rule and mode, bitwise ``sweep_pile``: linear and
    nearest, both windowed rules, k_best, the fast cap (against 5 steps),
    uniform and per-pixel grids."""
    epis = _vol(3, S=S, V=4, U=160, seed=S).to(dev)
    V, _, U, _ = epis.shape
    s_hat, D = S // 2, 24
    lo, hi, active = _ranges(V, U, dev, 800 + S)
    if "per-pixel" not in mode:
        lo, hi = torch.full_like(lo, -1.0), torch.full_like(hi, 1.5)
    kw = dict(dmin_v_u=lo, dmax_v_u=hi) if "per-pixel" in mode else {}
    p = NEAREST if "nearest" in mode else DepthParams()
    if mode == "fast":
        p, plain_p = DepthParams(fast=True), DepthParams(mean_shift_max_iter=5)
    else:
        plain_p = p
    with_k = "k_best" in mode
    window = None
    if "window" in mode:  # a u-haloed block's window; its pixels only
        window = (9, U - 13)
        active[:, :9] = False
        active[:, U - 12:] = False
    n0 = cuda_build.launches["sweep_pixel"]
    got = sweep_pile_pixel(epis, -1.0, 1.5, D, s_hat, p, active,
                           with_k_best=with_k, u_valid=window, **kw)
    assert cuda_build.launches["sweep_pixel"] == n0 + 1
    want = sweep_pile(epis, lo, hi, D, s_hat, plain_p, with_k_best=with_k,
                      u_valid=window)
    _same_sweep(got, want, active, with_k)
    assert (got.best_depth[active] != 0).any()


@pytest.mark.parametrize("n_payloads", [1, 2, 3])
@pytest.mark.parametrize("C", [1, 4])
def test_paint_payloads_bitwise(dev, C, n_payloads):
    claim, frames, depth, rbar, sm, conf, tgts, slope = _paint_scene(
        9, 12, 80, C, seed=20 + C)
    g = torch.Generator().manual_seed(n_payloads)
    line = torch.rand(depth.shape, generator=g)
    tgts = tgts + [torch.rand(claim.shape, generator=g)]
    claim, frames, depth, rbar, sm = (
        t.to(dev) for t in (claim, frames, depth, rbar, sm))
    srcs = [x.to(dev) for x in (depth, conf, line)][:n_payloads]
    tgts = [x.to(dev) for x in tgts][:n_payloads]

    def run(fn):
        cl, t = claim.clone(), [x.clone() for x in tgts]
        fn(cl, frames, depth, rbar, sm, 4, slope, 0.1, list(zip(t, srcs)))
        return cl, t

    n0 = cuda_build.launches["paint"]
    cl_k, t_k = run(propagate_cuda)
    assert cuda_build.launches["paint"] == n0 + 1
    cl_p, t_p = run(propagate)
    assert torch.equal(cl_k, cl_p)
    assert not torch.equal(cl_k, claim)
    for a, b in zip(t_k, t_p):
        assert torch.equal(a, b)


def test_paint_rejects_payload_counts(dev):
    claim, frames, depth, rbar, sm, conf, tgts, slope = (
        x.to(dev) if torch.is_tensor(x) else x
        for x in _paint_scene(3, 2, 16, 1, seed=0))
    n0 = cuda_build.launches["paint"]
    for pay in ([], [(tgts[0].to(dev), depth)] * 4):
        with pytest.raises(NotImplementedError, match="payloads"):
            propagate_cuda(claim, frames, depth, rbar, sm, 1, slope, 0.1,
                           pay)
    assert cuda_build.launches["paint"] == n0


@pytest.mark.parametrize("C,mode", [(1, "line"), (1, "fast"),
                                    (1, "nearest"), (4, "line"),
                                    (4, "nearest"), (3, "nearest")])
def test_depth2d_modes_on_card_match_cpu(dev, C, mode):
    """A whole run in each mode: the kernels against the plain versions,
    through the routes the mode takes, at uniform and bounds-edited
    levels."""
    params = {"line": DepthParams(score_version="line"),
              "fast": DepthParams(fast=True), "nearest": NEAREST}[mode]
    vol = _vol(C, S=8, V=12, U=64, seed=3).numpy()
    g = torch.Generator().manual_seed(C)
    c = torch.rand((12, 64), generator=g) * 1.7 - 0.6
    lo = torch.clamp(c - 0.4, -1.0, 1.5).expand(8, 12, 64).contiguous()
    hi = torch.clamp(c + 0.4, -1.0, 1.5).expand(8, 12, 64).contiguous()
    for edited in (False, True):
        comps = []
        for device in ("cpu", dev):
            comp = Depth2DComputer(vol, -1.0, 1.5, 9, params=params,
                                   device=device)
            if edited:
                comp.set_bounds(lo, hi)
            comp.run()
            comps.append(comp)
        ref, out = comps
        # as test_depth2d_on_card_matches_cpu: the kernels are bitwise, the
        # PyTorch operations around them (edge confidence, the C_l sums)
        # round in their own order on each device
        for name in ("claim", "ce_mask"):
            assert torch.equal(getattr(out.state, name).cpu(),
                               getattr(ref.state, name)), (edited, name)
        for name, atol in (("best_depth", 1e-4), ("line_conf", 1e-5)):
            torch.testing.assert_close(getattr(out.state, name).cpu(),
                                       getattr(ref.state, name), rtol=0,
                                       atol=atol)
        assert torch.equal(out.get_valid_depths_mask_s_v_u().cpu(),
                           ref.get_valid_depths_mask_s_v_u())


# ---- depth1d: one EPI row (V = 1) on the pixel and the tile kernel ----

def _depth1d_plain(comp):
    """The plain version of ``comp.run()`` on the same device: the plain
    sweep (uncapped, as depth1d sweeps) on uniform [1, U] bounds."""
    import dataclasses

    from remotesensingproject_tpu_torch.models.depth1d import depth1d_result
    from remotesensingproject_tpu_torch.ops.edge_confidence import (
        edge_confidence_frame)

    p = comp.params
    ce, mask = edge_confidence_frame(comp.epi[comp.s_hat][None], p)
    U = comp.epi.shape[1]
    lo, hi = (torch.full((1, U), b, device=comp.epi.device)
              for b in (comp.dmin, comp.dmax))
    res = sweep_pile(comp.epi[None], lo, hi, comp.dim_d, comp.s_hat,
                     dataclasses.replace(p, fast=False))
    return depth1d_result(ce[0], mask[0], res, p)


@pytest.mark.parametrize("C,D,params,wrapper", [
    (1, 24, DepthParams(), "pixel"), (3, 24, DepthParams(fast=True), "pixel"),
    (1, 24, NEAREST, "pixel"), (4, 24, DepthParams(), "tiles"),
    (1, 1030, DepthParams(), "tiles"), (4, 9, NEAREST, "tiles")])
def test_depth1d_bitwise_on_both_routes(dev, C, D, params, wrapper):
    """Depth1DComputer on the card against its plain version on the card,
    bitwise: the pixel kernel at C in {1, 3}, D <= 1024, the tile kernel in
    pixel mode otherwise, the row kernel never."""
    from remotesensingproject_tpu_torch import Depth1DComputer

    epi = _vol(C, S=9, V=4, U=96, seed=C + D).numpy()[1]
    epi[:, 30:38] = 0.01  # a shadow: holes in the edge mask
    libs = {"pixel": "sweep_pixel", "tiles": "sweep_tiles",
            "rows": "sweep_rows"}
    n0 = {k: cuda_build.launches[lib] for k, lib in libs.items()}
    comp = Depth1DComputer(epi, -1.0, 1.5, D, params=params, device=dev)
    got = comp.run()
    moved = {k for k, lib in libs.items()
             if cuda_build.launches[lib] != n0[k]}
    assert moved == {wrapper}
    want = _depth1d_plain(comp)
    assert got.edge_mask.any() and not got.edge_mask.all()
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
        assert a.is_cuda


def test_depth1d_on_card_at_c3_matches_cpu(dev):
    """V = 1 at C = 3 through the pixel kernel against the CPU run, within
    tests/test_torch_depth1d.py's tolerances (the PyTorch operations around
    the kernel round in their own order on each device)."""
    from remotesensingproject_tpu_torch import Depth1DComputer

    epi = _vol(3, S=9, V=4, U=96, seed=11).numpy()[2]
    ref = Depth1DComputer(epi, -1.0, 1.5, 24, device="cpu").run()
    out = Depth1DComputer(epi, -1.0, 1.5, 24, device=dev).run()
    assert torch.equal(out.edge_mask.cpu(), ref.edge_mask)
    for name, atol in (("edge_confidence", 1e-6), ("best_depth", 1e-6),
                       ("disp_confidence", 2e-5), ("rbar", 2e-5)):
        torch.testing.assert_close(getattr(out, name).cpu(),
                                   getattr(ref, name), rtol=0, atol=atol)


def _u_block(x, u0, width, halo, axis):
    """Columns [u0 - halo, u0 + width + halo) of ``x`` along ``axis``, zeros
    beyond the image: a rank's u-haloed block."""
    U = x.shape[axis]
    a, b = u0 - halo, u0 + width + halo
    core = x.narrow(axis, max(a, 0), min(b, U) - max(a, 0))

    def zeros(n):
        shape = list(x.shape)
        shape[axis] = n
        return torch.zeros(shape, dtype=x.dtype, device=x.device)

    return torch.cat([zeros(max(0, -a)), core, zeros(max(0, b - U))],
                     axis).contiguous()


@pytest.mark.parametrize("kind,C,per_pixel", [
    ("pixel", 1, False), ("pixel", 3, True), ("pixel-nearest", 1, True),
    ("tiles", 1, True), ("tiles", 4, True), ("tiles-nearest", 4, True)])
@pytest.mark.parametrize("u0", [0, 40])
def test_sweep_u_valid_bitwise(dev, kind, C, per_pixel, u0):
    """A block of 40 columns haloed by hu with the image's window: the
    kernel equals its plain version bitwise, and both equal the whole
    image's sweep at the block's pixels (positions in the window's
    columns)."""
    params = NEAREST if kind.endswith("nearest") else DepthParams()
    epis = _vol(C, S=12, V=16, U=80, seed=7).to(dev)
    V, S, U, _ = epis.shape
    Ul, D, s_hat = 40, 24, S // 2
    hu = int(np.ceil((S - 1) * 1.5)) + 2
    lo, hi, active = _ranges(V, U, dev, 700 + C + u0)
    if not per_pixel:
        lo, hi = (torch.full((V, U), b, device=dev) for b in (-1.0, 1.5))
    core = torch.zeros((V, U), dtype=torch.bool, device=dev)
    core[:, u0:u0 + Ul] = True
    active = active & core
    act_h, lo_h, hi_h = (_u_block(x, u0, Ul, hu, 1)
                         for x in (active, lo, hi))
    epis_h = _u_block(epis, u0, Ul, hu, 2)
    window = (hu - u0, U - 1 - u0 + hu)
    if kind.startswith("pixel"):
        kw = dict(dmin_v_u=lo_h, dmax_v_u=hi_h) if per_pixel else {}
        n0 = cuda_build.launches["sweep_pixel"]
        got = sweep_pile_pixel(epis_h, -1.0, 1.5, D, s_hat, params, act_h,
                               u_valid=window, **kw)
        assert cuda_build.launches["sweep_pixel"] == n0 + 1
    else:
        n0 = cuda_build.launches["sweep_tiles"]
        got = sweep_pile_tiles(epis_h, lo_h, hi_h, D, s_hat, params,
                               active_v_u=act_h, u_valid=window)
        assert cuda_build.launches["sweep_tiles"] == n0 + 1
    want = sweep_pile(epis_h, lo_h, hi_h, D, s_hat, params, u_valid=window)
    _same_sweep(got, want, act_h, False)
    whole = sweep_pile(epis, lo, hi, D, s_hat, params)
    for name in ("best_score", "score_mean", "best_depth", "rbar"):
        assert torch.equal(getattr(got, name)[:, hu:hu + Ul][active[:, u0:u0 + Ul]],
                           getattr(whole, name)[active]), name


@pytest.mark.parametrize("C,n_payloads", [(1, 2), (4, 3)])
@pytest.mark.parametrize("u0", [0, 24, 48])
def test_paint_u_origin_bitwise(dev, C, n_payloads, u0):
    """Targets of a 24-column block painted from sources haloed by pado
    with u_origin = pado: the kernel equals the plain version bitwise, and
    both equal the whole image's paint on the block."""
    claim, frames, depth, rbar, sm, conf, tgts, slope = (
        x.to(dev) if torch.is_tensor(x) else x
        for x in _paint_scene(7, 5, 72, C, seed=40 + C))
    tgts = [t.to(dev) for t in tgts] + [torch.rand(claim.shape).to(dev)]
    S, V, U = claim.shape
    Ul, s_hat = 24, 3
    pado = int(np.ceil(4.0 * slope * (S - 1))) + 1
    srcs = [depth, conf, depth * 0.5][:n_payloads]
    whole_cl, whole_t = claim.clone(), [t.clone() for t in tgts]
    propagate(whole_cl, frames, depth, rbar, sm, s_hat, slope, 0.1,
              list(zip(whole_t, srcs)))

    def run(fn):
        cl = claim[:, :, u0:u0 + Ul].clone()
        t = [x[:, :, u0:u0 + Ul].clone() for x in tgts[:n_payloads]]
        h = [_u_block(x, u0, Ul, pado, 1) for x in [depth, rbar, sm] + srcs]
        fn(cl, frames[:, :, u0:u0 + Ul].contiguous(), h[0], h[1], h[2],
           s_hat, slope, 0.1, list(zip(t, h[3:])), u_origin=pado)
        return cl, t

    n0 = cuda_build.launches["paint"]
    cl_k, t_k = run(propagate_cuda)
    assert cuda_build.launches["paint"] == n0 + 1
    cl_p, t_p = run(propagate)
    assert torch.equal(cl_k, cl_p)
    assert torch.equal(cl_k, whole_cl[:, :, u0:u0 + Ul])
    for a, b, w in zip(t_k, t_p, whole_t):
        assert torch.equal(a, b)
        assert torch.equal(a, w[:, :, u0:u0 + Ul])


# ---- a pass that never waits on the card ----

_SWEEP_LIB = {"pixel": "sweep_pixel", "rows": "sweep_rows",
              "tiles": "sweep_tiles"}


class _sync_errors:
    """``torch.cuda.set_sync_debug_mode("error")`` for a ``with`` block:
    any operation that waits for the card raises."""

    def __enter__(self):
        self.before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self.before)
        return False


def _count_on_card_call(dev, kind, n_active, V=6, U=70):
    """One sweep of ``kind`` over ``n_active`` pixels ("all": every one),
    and its plain version; returns (got, want, active, with_k)."""
    C = 1 if kind == "pixel" else 4
    epis = _vol(C, S=10, V=V, U=U, seed=V + U).to(dev)
    S = epis.shape[1]
    g = torch.Generator().manual_seed(V * U + (0 if n_active == "all"
                                               else n_active))
    flat = torch.zeros(V * U, dtype=torch.bool)
    n = V * U if n_active == "all" else n_active
    flat[torch.randperm(V * U, generator=g)[:n]] = True
    active = flat.reshape(V, U).to(dev)
    lo, hi, _ = _ranges(V, U, dev, V + U)
    p = DepthParams()
    if kind == "pixel":
        return (lambda: sweep_pile_pixel(epis, -1.0, 1.5, 24, S // 2, p,
                                         active, dmin_v_u=lo, dmax_v_u=hi),
                lambda: sweep_pile(epis, lo, hi, 24, S // 2, p),
                active, False)
    if kind == "rows":
        return (lambda: sweep_pile_rows(epis, -1.0, 1.5, 24, S // 2, p,
                                        with_k_best=True, active_v_u=active),
                lambda: sweep_rows_plain(epis,
                                         candidate_grid(-1.0, 1.5, 24, dev),
                                         S // 2, p, with_k_best=True),
                active, True)
    qlo, qhi = tile_quantized_bounds(active, lo, hi, (-1.0, 1.5))
    return (lambda: sweep_pile_tiles(epis, qlo, qhi, 24, S // 2, p,
                                     with_k_best=True, active_v_u=active,
                                     pdmin_v_u=lo, pdmax_v_u=hi),
            lambda: sweep_pile(epis, qlo, qhi, 24, S // 2, p, True, lo, hi),
            active, True)


@pytest.mark.parametrize("kind", ["pixel", "rows", "tiles"])
@pytest.mark.parametrize("n_active", [0, 1, 37, "all"])
def test_sweeps_with_the_count_in_device_memory_bitwise(dev, kind,
                                                        n_active):
    """The host reads no count: every call launches, an empty one too, and
    the kernel's blocks read the count and find their groups."""
    run, plain, active, with_k = _count_on_card_call(dev, kind, n_active)
    lib = _SWEEP_LIB[kind]
    n0 = cuda_build.launches[lib]
    with _sync_errors():
        got = run()
    assert cuda_build.launches[lib] == n0 + 1
    _same_sweep(got, plain(), active, with_k)
    assert not got.best_depth[~active].any()
    assert not got.best_score[~active].any()


@pytest.mark.parametrize("kind", ["pixel", "rows", "tiles"])
def test_sweeps_draw_more_groups_than_resident_blocks(dev, kind):
    """49,152 pixels: more groups than the card's resident blocks, at the
    largest group size; then a short list and the long one again, so that
    each launch reads its own plan (the count and group size the device
    works out and leaves in constant memory), not the last one's."""
    run, plain, active, with_k = _count_on_card_call(dev, kind, "all",
                                                     V=128, U=384)
    run_s, plain_s, active_s, _ = _count_on_card_call(dev, kind, 37)
    want, want_s = plain(), plain_s()
    for _ in range(2):
        _same_sweep(run(), want, active, with_k)
        _same_sweep(run_s(), want_s, active_s, with_k)


def _converging_vol(C, S=12, V=16, U=96):
    """Every frame the same: the first pass's paint claims every confident
    pixel of every frame, so the level converges after one pass and the
    flag read a pass late queues one pass more."""
    vol = _vol(C, S=S, V=V, U=U, seed=9).numpy()
    return np.ascontiguousarray(np.repeat(vol[:, S // 2:S // 2 + 1], S, 1))


@pytest.mark.parametrize("C,edited", [(1, False), (1, True), (4, False),
                                      (4, True)])
@pytest.mark.parametrize("scene", ["layers", "static"])
def test_run_makes_no_sync_and_matches_the_immediate_stop(dev, capsys, C,
                                                          edited, scene):
    """A whole ``Depth2DComputer.run`` (C=1: the pixel sweep; C=4: the row
    sweep, and the tile sweep at a bounds-edited level) under
    ``set_sync_debug_mode("error")``: nothing waits for the card.  Its
    state and ``passes_run`` are those of the early stop read after every
    pass (a verbose run, which reads it so); the one pass it queues on a
    converged state is a no-op, counted apart in ``late_passes``."""
    S = 12
    if scene == "layers":
        vol = _vol(C, S=S, V=16, U=96, seed=9).numpy()
        g = torch.Generator().manual_seed(C)
        c = torch.rand((16, 96), generator=g) * 1.7 - 0.6
        lo = torch.clamp(c - 0.4, -1.0, 1.5).expand(S, 16, 96).contiguous()
        hi = torch.clamp(c + 0.4, -1.0, 1.5).expand(S, 16, 96).contiguous()
    else:
        # every pixel's grid holds d = 0, the static scene's disparity
        vol = _converging_vol(C, S=S)
        lo = torch.full((S, 16, 96), -1.0)
        hi = torch.full((S, 16, 96), 1.0)
    comps = []
    for verbose in (True, False):
        comp = Depth2DComputer(vol, -1.0, 1.0, 9, device=dev,
                               verbose=verbose)
        if edited:
            comp.set_bounds(lo.to(dev), hi.to(dev))
        if verbose:
            comp.run()
        else:
            with _sync_errors():
                comp.run()
        comps.append(comp)
    now, late = comps
    assert late.passes_run == now.passes_run
    # a pass is queued late where the immediate read stopped early
    stopped = now.passes_run < len(center_outward_schedule(S))
    assert (now.late_passes, late.late_passes) == (0, int(stopped))
    if scene == "static":
        assert late.late_passes == 1
    for name in ("ce", "ce_mask", "disp_conf", "line_conf", "best_depth",
                 "rbar", "claim"):
        assert torch.equal(getattr(late.state, name),
                           getattr(now.state, name)), name
    capsys.readouterr()
