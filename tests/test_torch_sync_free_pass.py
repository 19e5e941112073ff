"""The pieces of a pass that no longer read the card, on CPU tensors.

On a card no pass reads a device value on the host: the sweeps'
compaction keeps its count in device memory (``sweep_pallas.
compact_pixels``), the tile mode's grid bounds make no device value from
a host one (``tile_quantized_bounds``), a level's edge confidence builds
its reflect index on the device, and the pass loop reads the early-stop
flag a pass late, gating the pass after convergence to an exact no-op
(``_pass_fn``'s ``live``).  These run the same code on the CPU: the
compaction against ``torch.nonzero``, the bounds against the formula that
read back (kept here), the index against ``np.pad``, and a gated pass on
a converged state against the state before it.  The card's side (a full
run under ``torch.cuda.set_sync_debug_mode("error")``, the sweeps at 0,
1, 37 and all active pixels) is in ``tests/test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu_torch import Depth2DComputer, DepthParams
from remotesensingproject_tpu_torch.models import depth2d
from remotesensingproject_tpu_torch.ops.edge_confidence import (
    _reflect101_index)
from remotesensingproject_tpu_torch.ops.sweep_pallas import (
    CHUNK, compact, compact_pixels)
from remotesensingproject_tpu_torch.ops.sweep_pallas_perpixel import (
    tile_quantized_bounds)
from remotesensingproject_tpu_torch.types import DTYPE, f32


def _mask(V, U, share, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((V, U), generator=g) < share


MASKS = {
    "empty": lambda: torch.zeros((7, 33), dtype=torch.bool),
    "single first": lambda: torch.zeros((7, 33), dtype=torch.bool)
    .index_put_((torch.tensor([0]), torch.tensor([0])), torch.tensor(True)),
    "single last": lambda: torch.zeros((7, 33), dtype=torch.bool)
    .index_put_((torch.tensor([6]), torch.tensor([32])), torch.tensor(True)),
    "full": lambda: torch.ones((7, 33), dtype=torch.bool),
    "one pixel": lambda: torch.ones((1, 1), dtype=torch.bool),
    "sparse": lambda: _mask(40, 129, 0.01, 1),
    "half": lambda: _mask(40, 129, 0.5, 2),
    "dense": lambda: _mask(40, 129, 0.97, 3),
    # the four-band cell's level 0: 540 x 960, a first pass's density
    "four-band level 0": lambda: _mask(540, 960, 0.91, 4),
    "four-band late pass": lambda: _mask(540, 960, 0.004, 5),
}


@pytest.mark.parametrize("name", list(MASKS))
def test_compaction_lists_nonzero_in_order(name):
    mask = MASKS[name]()
    act, count = compact_pixels(mask)
    want = torch.nonzero(mask.reshape(-1)).reshape(-1)
    assert act.dtype == count.dtype == torch.int32
    assert act.shape == (mask.numel(),) and act.is_contiguous()
    assert count.shape == (1,)
    n = int(count.item())
    assert n == want.numel()
    assert torch.equal(act[:n].to(torch.int64), want)
    assert torch.all(act[n:] == mask.numel())


@pytest.mark.parametrize("with_k", [False, True])
def test_compact_gives_zeroed_outputs_and_the_list(with_k):
    mask = _mask(12, 70, 0.3, 6)
    out, act, count = compact(mask, 5, 3, with_k)
    for name, shape in (("best_score", (12, 70)), ("score_mean", (12, 70)),
                        ("best_depth", (12, 70)), ("rbar", (12, 70, 3))):
        t = getattr(out, name)
        assert t.shape == shape and not t.any(), name
    assert (out.k_best is not None) == with_k
    n = int(count.item())
    assert torch.equal(act[:n].to(torch.int64),
                       torch.nonzero(mask.reshape(-1)).reshape(-1))


def _bounds_read_back(active_v_u, dmin_v_u, dmax_v_u, d_bounds):
    """``tile_quantized_bounds`` as it was with a 0-d tensor for the fill,
    read back by ``float(fill)``: the result the new one must give."""
    V, U = active_v_u.shape
    n_tiles = -(-U // CHUNK)
    pad = n_tiles * CHUNK - U
    inf = torch.tensor(float("inf"), dtype=DTYPE, device=dmin_v_u.device)

    def reduce(x, lowest):
        fill = inf if lowest else -inf
        xt = torch.where(active_v_u, x, fill)
        xt = torch.nn.functional.pad(xt, (0, pad), value=float(fill))
        xt = xt.reshape(V, n_tiles, CHUNK)
        red = xt.amin(dim=2) if lowest else xt.amax(dim=2)
        fallback = f32(d_bounds[0] if lowest else d_bounds[1])
        red = torch.where(torch.isfinite(red), red,
                          torch.full_like(red, fallback))
        return red.repeat_interleave(CHUNK, dim=1)[:, :U].contiguous()

    return reduce(dmin_v_u, True), reduce(dmax_v_u, False)


@pytest.mark.parametrize("V,U,share", [(5, 128, 0.5), (9, 300, 0.3),
                                       (3, 77, 0.0), (4, 257, 1.0),
                                       (6, 640, 0.002)])
def test_tile_bounds_bitwise_the_read_back_formula(V, U, share):
    """Tiles with and without active pixels, U a multiple of 128 and not,
    a last tile of one column."""
    g = torch.Generator().manual_seed(V * U)
    active = torch.rand((V, U), generator=g) < share
    # some tiles left without an active pixel
    active[:, :CHUNK] &= torch.arange(V)[:, None] % 2 == 0
    c = torch.rand((V, U), generator=g) * 6.0 - 2.0
    lo = c - torch.rand((V, U), generator=g)
    hi = c + torch.rand((V, U), generator=g)
    d_bounds = (-2.0, 8.0)
    got = tile_quantized_bounds(active, lo, hi, d_bounds)
    want = _bounds_read_back(active, lo, hi, d_bounds)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == DTYPE and a.shape == (V, U)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    empty = ~active.reshape(V, -1)[:, :CHUNK].any(1)
    assert torch.all(got[0][empty, :CHUNK] == f32(-2.0))


@pytest.mark.parametrize("n", [1, 2, 3, 9, 64, 960])
def test_reflect_index_is_np_pad_reflect(n):
    for w in (0, 1, 4, 7, 2 * n + 3):
        want = np.pad(np.arange(n), (w, w), mode="reflect")
        got = _reflect101_index(n, w)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want), w


def _mid_run_state(S=8, V=12, U=48, passes=3, seed=7):
    vol, _ = oracle.make_synthetic_lf(S=S, V=V, U=U, C=1, n_objects=3,
                                      seed=seed, dmin=-1.0, dmax=1.5)
    comp = Depth2DComputer(vol, -1.0, 1.5, 9, device="cpu")
    frames = comp.epis.permute(1, 0, 2, 3).contiguous()
    state = comp.initial_state()
    schedule = depth2d.center_outward_schedule(S)
    for s_hat in schedule[:passes]:
        depth2d._pass_fn(comp.epis, frames, state, s_hat, dim_d=9,
                         params=comp.params, d_bounds=(-1.0, 1.5))
    return comp, frames, state, schedule[passes]


FIELDS = tuple(f.name for f in dataclasses.fields(depth2d.Depth2DState))


def _planes(state):
    return {n: getattr(state, n).clone() for n in FIELDS}


@pytest.mark.parametrize("score", ["edge", "disp", "line"])
def test_gated_pass_on_a_converged_state_is_a_no_op(score):
    """Every confident pixel claimed, and targets that a paint from
    sources never swept (r_bar 0) would take: dark frames, failed-sweep
    pixels left unclaimed.  With ``live`` False the pass changes no
    plane; ungated, it paints."""
    comp, frames, state, s_next = _mid_run_state()
    comp.params = DepthParams(score_version=score)
    if score == "line":
        state.line_conf = torch.full_like(state.ce, 0.9)
    state.claim &= ~state.ce_mask             # converged
    assert not bool(depth2d._unclaimed(state))
    # unclaimed pixels that are not confident, as failed sweeps leave them
    # on the planes already swept
    for s in range(state.claim.shape[0]):
        if s != s_next:
            state.claim[s] |= ~state.ce_mask[s]
    state.disp_conf.fill_(1.0)
    dark = torch.zeros_like(frames)

    def one_pass(live):
        st = depth2d.Depth2DState(**_planes(state))
        depth2d._pass_fn(comp.epis, dark, st, s_next, dim_d=9,
                         params=comp.params, d_bounds=(-1.0, 1.5),
                         live=live)
        return _planes(st)

    before = _planes(state)
    gated = one_pass(torch.tensor(False))
    for n in FIELDS:
        assert torch.equal(gated[n], before[n]), n
    painted = one_pass(None)
    assert not torch.equal(painted["claim"], before["claim"])
    same = one_pass(torch.tensor(True))
    for n in FIELDS:
        assert torch.equal(same[n], painted[n]), n


def test_cpu_reads_the_flag_after_each_pass():
    """On CPU tensors the loop keeps the immediate read: a run equals one
    that tests the flag after every pass by hand, pass for pass."""
    comp, frames, state, _ = _mid_run_state(passes=0)
    comp.run()
    S = comp.epis.shape[1]
    state = comp.initial_state()
    n = 0
    for s_hat in depth2d.center_outward_schedule(S):
        depth2d._pass_fn(comp.epis, frames, state, s_hat, dim_d=9,
                         params=comp.params, d_bounds=(-1.0, 1.5))
        n += 1
        if not bool(depth2d._unclaimed(state)):
            break
    assert comp.passes_run == n
    for name in FIELDS:
        assert torch.equal(getattr(comp.state, name), getattr(state, name))
