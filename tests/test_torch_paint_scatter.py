"""The order the CUDA paint (``csrc/paint.cu``) works in, on the CPU
against the plain version (``ops/propagation.py`` ``propagate``).

The kernel is driven from the sources: per frame s each source (v, u')
rounds its offset once, looks at its one target (s, v, u' + o), and bids
for it where the target is open and passes the colour test; a target takes
the smallest bidding u' (a minimum, so the order of the bids does not
matter), then its payloads and its claim are resolved.  Blocks take tiles
of target columns.  The PyTorch emulation below does exactly that and must
equal the plain version's descending-offset, first-writer-wins scan bit
for bit: claim and every payload (one to three: depth, disp_conf and, in
line mode, line_conf).
"""

import numpy as np
import pytest
import torch

from remotesensingproject_tpu_torch.ops.propagation import propagate
from remotesensingproject_tpu_torch.types import (f32, normsq,
                                                  round_half_away)

NONE = 2 ** 31 - 1


def scatter_paint(claim, frames, depth, rbar, mask, s_hat, slope, epsilon,
                  payloads, tile=0):
    """The kernel's order in PyTorch, in place; ``tile`` target columns a
    block (0: the whole row)."""
    S, V, U = claim.shape
    tile = U if tile == 0 else min(tile, U)
    eps_sq = float(np.float32(epsilon) ** 2)
    us = torch.arange(U)[None, :].expand(V, U)
    vs = torch.arange(V)[:, None].expand(V, U)
    fus = us.to(torch.float32)
    for s in range(S):
        ds = float(s_hat - s)
        # one rounding per (s, source)
        of = round_half_away((depth * f32(slope)) * ds)
        for u0 in range(0, U, tile):
            nt = min(tile, U - u0)
            reach = mask & (of >= (u0 - fus)) & (of <= (u0 + nt - 1 - fus))
            sv, su = vs[reach], us[reach]
            tu = su + of[reach].to(torch.int64)
            is_open = claim[s, sv, tu]
            close = normsq(frames[s, sv, tu] - rbar[sv, su]) < eps_sq
            bid = is_open & close
            win = torch.full((V * nt,), NONE, dtype=torch.int64)
            win.scatter_reduce_(0, (sv * nt + tu - u0)[bid], su[bid], "amin")
            win = win.reshape(V, nt)
            # resolve
            tv, ti = torch.nonzero(win != NONE, as_tuple=True)
            w = win[tv, ti]
            for tgt, src in payloads:
                tgt[s, tv, u0 + ti] = src[tv, w]
            claim[s, tv, u0 + ti] = False
    return claim, tuple(t for t, _ in payloads)


def _scene(S, V, U, C, seed, p_source=0.5, p_open=0.7, spread=0.2):
    g = np.random.default_rng(seed)
    claim = torch.from_numpy(g.uniform(size=(S, V, U)) < p_open)
    frames = torch.from_numpy(
        (g.uniform(size=(S, V, U, C)) * spread + 0.3).astype(np.float32))
    # quarter-pixel depths: products with ds land on .5 often
    depth = torch.from_numpy(
        (g.integers(0, 21, (V, U)) * 0.25 - 1.0).astype(np.float32))
    rbar = frames[S // 2] + 0.01
    mask = torch.from_numpy(g.uniform(size=(V, U)) < p_source)
    conf = torch.from_numpy(g.uniform(size=(V, U)).astype(np.float32))
    tgts = [torch.from_numpy(g.uniform(size=(S, V, U)).astype(np.float32))
            for _ in range(2)]
    return claim, frames, depth, rbar, mask, conf, tgts


def _both(scene, s_hat, slope, tile=0, epsilon=0.1):
    claim, frames, depth, rbar, mask, conf, tgts = scene

    def run(fn, **kw):
        cl, t = claim.clone(), [x.clone() for x in tgts]
        fn(cl, frames, depth, rbar, mask, s_hat, slope, epsilon,
           [(t[0], depth), (t[1], conf)], **kw)
        return cl, t

    cl_e, t_e = run(scatter_paint, tile=tile)
    cl_p, t_p = run(propagate)
    assert torch.equal(cl_e, cl_p)
    for a, b in zip(t_e, t_p):
        assert torch.equal(a, b)
    return claim & ~cl_e, t_e


@pytest.mark.parametrize("C", [1, 3, 4])
@pytest.mark.parametrize("slope", [1.0, -0.7])
@pytest.mark.parametrize("s_hat", [0, 4, 8])
def test_scatter_order_equals_propagate(C, slope, s_hat):
    scene = _scene(9, 5, 50, C, seed=10 * C + s_hat)
    painted, _ = _both(scene, s_hat, slope)
    # targets were painted on other frames than s_hat, and contested
    assert int(painted.sum()) > int(painted[s_hat].sum()) > 0


@pytest.mark.parametrize("tile", [1, 7, 16, 49, 50, 64])
def test_tile_width_splits_the_row(tile):
    scene = _scene(7, 4, 50, 3, seed=tile)
    painted, _ = _both(scene, 3, 1.0, tile=tile)
    assert int(painted.sum()) > 0


def test_contested_target_takes_the_smallest_source_column():
    """Two qualifying sources reach one target: u' = 3 (offset +2) and
    u' = 5 (offset 0) both point at u = 5 on frame s_hat - 2."""
    S, V, U, s_hat = 5, 1, 12, 2
    claim = torch.ones((S, V, U), dtype=torch.bool)
    frames = torch.full((S, V, U, 1), 0.5)
    depth = torch.zeros((V, U))
    depth[0, 3] = 1.0
    mask = torch.zeros((V, U), dtype=torch.bool)
    mask[0, 3] = mask[0, 5] = True
    rbar = torch.full((V, U, 1), 0.5)
    conf = torch.arange(U, dtype=torch.float32)[None] + 100.0
    tgts = [torch.zeros((S, V, U)) for _ in range(2)]
    painted, (t0, t1) = _both((claim, frames, depth, rbar, mask, conf, tgts),
                              s_hat, 1.0)
    assert bool(painted[0, 0, 5])
    assert float(t1[0, 0, 5]) == 103.0 and float(t0[0, 0, 5]) == 1.0
    # on the other side of s_hat the two do not meet
    assert float(t1[4, 0, 1]) == 103.0 and float(t1[4, 0, 5]) == 105.0
    # a source whose colour is off does not bid, and the other one wins
    rbar[0, 3] = 0.9
    painted, (_, t1) = _both((claim, frames, depth, rbar, mask, conf, tgts),
                             s_hat, 1.0)
    assert float(t1[0, 0, 5]) == 105.0


@pytest.mark.parametrize("tile", [0, 8])
def test_targets_off_the_row_ends(tile):
    """Steep lines leave the row on both sides; nothing wraps around."""
    scene = list(_scene(9, 3, 30, 1, seed=2, p_source=0.9, p_open=1.0,
                        spread=0.0))
    g = np.random.default_rng(5)
    scene[2] = torch.from_numpy(g.uniform(-12.0, 12.0, (3, 30))
                                .astype(np.float32))
    painted, _ = _both(tuple(scene), 4, 1.0, tile=tile)
    assert bool(painted[0].any()) and not bool(painted[0].all())


def test_s_hat_plane_paints_open_sources_onto_themselves():
    scene = _scene(5, 3, 20, 1, seed=9, spread=0.0)
    claim, _, depth, _, mask, conf, _ = scene
    painted, (t0, t1) = _both(scene, 2, 1.0)
    assert torch.equal(painted[2], mask & claim[2])
    assert torch.equal(t0[2][painted[2]], depth[painted[2]])
    assert torch.equal(t1[2][painted[2]], conf[painted[2]])


@pytest.mark.parametrize("tile", [0, 16])
def test_no_source_at_all(tile):
    scene = _scene(5, 3, 40, 3, seed=1, p_source=0.0)
    painted, t = _both(scene, 2, 1.0, tile=tile)
    assert not bool(painted.any())
    for got, before in zip(t, scene[6]):
        assert torch.equal(got, before)


def test_late_pass_few_sources_few_open_targets():
    scene = _scene(9, 6, 64, 4, seed=4, p_source=0.03, p_open=0.05)
    _both(scene, 5, -1.0, tile=32)


@pytest.mark.parametrize("n_payloads", [1, 2, 3])
def test_scatter_order_with_one_to_three_payloads(n_payloads):
    """Every payload of a painted target comes from the same winning
    source; the kernel writes them in payload order."""
    claim, frames, depth, rbar, mask, conf, tgts = _scene(9, 6, 50, 1, 11)
    g = np.random.default_rng(12)
    line = torch.from_numpy(g.uniform(size=depth.shape).astype(np.float32))
    tgts.append(torch.from_numpy(
        g.uniform(size=claim.shape).astype(np.float32)))
    srcs = [depth, conf, line][:n_payloads]

    def run(fn):
        cl, t = claim.clone(), [x.clone() for x in tgts[:n_payloads]]
        fn(cl, frames, depth, rbar, mask, 4, 1.0, 0.1, list(zip(t, srcs)))
        return cl, t

    cl_e, t_e = run(scatter_paint)
    cl_p, t_p = run(propagate)
    assert torch.equal(cl_e, cl_p)
    assert (claim & ~cl_e).any()
    for a, b in zip(t_e, t_p):
        assert torch.equal(a, b)
