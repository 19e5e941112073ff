"""Line confidence C_l: the CUDA kernel ``csrc/line_conf.cu`` and its walk.

On the CPU (no JAX): the kernel's walk of the sums by halves
(``halves_program``, run here as the kernel runs it) reproduces
``_sum_halves`` bitwise for every S up to 300; a numpy mirror of the
kernel's arithmetic reproduces the plain ``line_confidence`` bitwise; and a
line-mode pass gives the same state whether C_l is computed at the pass's
good pixels (as ``_pass_fn`` does) or over the whole post-sweep mask.

On the card (marker ``cuda``; ``python -m pytest
tests/test_torch_line_conf.py --noconftest -q``): the kernel against the
plain version, bitwise (NaN where the plain one gives NaN), over S, depths
on and between columns, lines that leave the image on both sides, masks
empty, sparse and full, ``s_hat`` at both ends and in the middle, a block
of rows, one pass of a line-mode ``Depth2DComputer``, the
``line_conf.pixels`` counter, and the cases where the wrapper raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.models import depth2d as td
from remotesensingproject_tpu_torch.ops import cuda_build
from remotesensingproject_tpu_torch.ops import line_confidence as lc
from remotesensingproject_tpu_torch.utils import profiling

LINE = DepthParams(score_version="line")


def _walk(prog, leaves):
    """The kernel's walk: ``leaves(s)`` is leaf s's value (any array); one
    pending value a step, every step taken, the root after the last
    leaf."""
    pend = [None] * lc.LEVELS
    for s, word in prog:
        x = leaves(int(s))
        steps = int(word) >> lc.STEPS_SHIFT
        assert steps <= lc.LEVELS
        assert int(word) & ((1 << lc.STEPS_SHIFT) - 1) < 4 ** steps
        for L in range(steps):
            c = (int(word) >> 2 * L) & 3
            assert c in (lc.PASS, lc.ADD, lc.STORE)
            if c == lc.ADD:
                x = pend[L] + x
            elif c == lc.STORE:
                pend[L] = x
    return x


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def test_halves_program_reproduces_sum_halves():
    rng = np.random.default_rng(0)
    order_matters = 0
    for S in range(1, 301):
        # magnitudes over eight decades and both signs: every order of the
        # adds rounds differently
        x = (rng.uniform(-1.0, 1.0, (S, 64))
             * 10.0 ** rng.uniform(-4.0, 4.0, (S, 64))).astype(np.float32)
        prog = lc.halves_program(S)
        assert sorted(prog[:, 0].tolist()) == list(range(S))
        got = _walk(prog, lambda s: x[s])
        want = lc._sum_halves(torch.from_numpy(x)).numpy()
        assert np.array_equal(_bits(got), _bits(want)), S
        seq = np.zeros(64, np.float32)
        for s in range(S):
            seq = seq + x[s]
        order_matters += not np.array_equal(_bits(seq), _bits(want))
    assert order_matters > 250


def test_halves_program_limits():
    # the largest S fills every step; one more does not fit
    prog = lc.halves_program(lc.MAX_S)
    assert prog.shape == (lc.MAX_S, 2)
    x = np.random.default_rng(1).uniform(0, 1, (lc.MAX_S, 4)).astype(
        np.float32)
    assert np.array_equal(
        _bits(_walk(prog, lambda s: x[s])),
        _bits(lc._sum_halves(torch.from_numpy(x)).numpy()))
    for S in (0, lc.MAX_S + 1):
        with pytest.raises(ValueError, match="frames"):
            lc.halves_program(S)
    # S = 1: the leaf is the root; S = 3: (x0 + x1) + x2
    assert lc.halves_program(1).tolist() == [[0, 0]]
    one, two = 1 << lc.STEPS_SHIFT, 2 << lc.STEPS_SHIFT
    assert lc.halves_program(3).tolist() == [
        [0, lc.STORE | one], [1, lc.ADD | lc.STORE << 2 | two],
        [2, lc.PASS | lc.ADD << 2 | two]]


def _line_inputs(S, V, U, depths, seed):
    g = torch.Generator().manual_seed(seed)
    ce = torch.rand((S, V, U), generator=g)
    if depths == "integer":
        depth = torch.randint(-4, 5, (V, U), generator=g).float()
    else:
        depth = torch.rand((V, U), generator=g) * 8.0 - 4.0
    k = torch.rand((V, S, U), generator=g)
    k[torch.rand(k.shape, generator=g) < 0.3] = 0.0
    k[:, :, ::7] = 0.0                     # sums of k that are 0: NaN
    return ce, depth, k


def _mask(kind, V, U, seed):
    g = torch.Generator().manual_seed(seed + 100)
    share = {"empty": 0.0, "sparse": 0.05, "full": 1.01}[kind]
    return torch.rand((V, U), generator=g) < share


def _kernel_mirror(ce, depth, k, mask, s_hat):
    """The kernel's arithmetic in numpy float32, pixel by pixel (all
    pixels at once), walking the leaves as the kernel does."""
    ce, depth, k = ce.numpy(), depth.numpy(), k.numpy()
    S, V, U = ce.shape
    vv, uu = np.meshgrid(np.arange(V), np.arange(U), indexing="ij")
    fu = uu.astype(np.float32)
    last = np.float32(U - 1)

    def leaf(s):
        idx = np.float32(s_hat - s) * depth + fu
        fi = np.floor(idx)
        valid = (fi >= 0) & (np.ceil(idx) <= last)
        t = idx - fi
        i0 = np.clip(fi, 0, last).astype(np.int64)
        i1 = np.minimum(i0 + 1, U - 1)
        ce_i = np.where(valid, (np.float32(1) - t) * ce[s, vv, i0]
                        + t * ce[s, vv, i1], np.float32(0))
        return np.stack([ce_i * k[:, s], k[:, s]])

    with np.errstate(invalid="ignore", divide="ignore"):
        num, den = _walk(lc.halves_program(S), leaf)
        return np.where(mask.numpy(), num / den, np.float32(0))


@pytest.mark.parametrize("S", [1, 2, 7, 100])
@pytest.mark.parametrize("depths", ["integer", "between"])
def test_kernel_mirror_matches_plain(S, depths):
    V, U = 5, 48
    ce, depth, k = _line_inputs(S, V, U, depths, seed=S)
    mask = _mask("full", V, U, S)
    for s_hat in sorted({0, S // 2, S - 1}):
        want = lc.line_confidence(ce, depth, k, mask, s_hat).numpy()
        got = _kernel_mirror(ce, depth, k, mask, s_hat)
        nan = np.isnan(want)
        assert np.array_equal(nan, np.isnan(got))
        assert nan.any()
        assert np.array_equal(_bits(got)[~nan], _bits(want)[~nan]), s_hat


def _carried_line_state(device, passes=3, seed=3):
    """A line-mode computer on a small scene and its state after the first
    ``passes`` passes of the schedule; the next s_hat."""
    vol, _ = oracle.make_synthetic_lf(S=8, V=10, U=64, C=1, seed=seed,
                                      dmin=-1.0, dmax=1.5)
    comp = td.Depth2DComputer(vol, -1.0, 1.5, 9, params=LINE, device=device)
    frames = comp.epis.permute(1, 0, 2, 3).contiguous()
    state = comp.initial_state()
    sched = td.center_outward_schedule(comp.epis.shape[1])
    for s_hat in sched[:passes]:
        td._pass_fn(comp.epis, frames, state, s_hat, dim_d=comp.dim_d,
                    params=LINE, d_bounds=(comp.dmin, comp.dmax))
    return comp, frames, state, sched[passes]


def _copy(state):
    return td.Depth2DState(**{f.name: getattr(state, f.name).clone()
                              for f in dataclasses.fields(state)})


def _one_pass(comp, frames, state, s_hat):
    return td._pass_fn(comp.epis, frames, state, s_hat, dim_d=comp.dim_d,
                       params=LINE, d_bounds=(comp.dmin, comp.dmax))


def _same_state(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bool
                           else x.view(torch.int32),
                           y.view(torch.uint8) if y.dtype == torch.bool
                           else y.view(torch.int32)), f.name


def test_line_pass_same_at_good_or_post_sweep_mask(monkeypatch):
    comp, frames, carried, s_hat = _carried_line_state("cpu")
    at_good = _one_pass(comp, frames, _copy(carried), s_hat)

    masks = []
    wide = _copy(carried)
    orig = td._line_confidence

    def over_mask_new(ce, depth, k, mask, sh):
        mask_new = wide.ce_mask[sh]          # set by the merge already
        masks.append((mask.clone(), mask_new.clone()))
        return orig(ce, depth, k, mask_new, sh)

    monkeypatch.setattr(td, "_line_confidence", over_mask_new)
    at_mask_new = _one_pass(comp, frames, wide, s_hat)
    (good, mask_new), = masks
    # good lies in the post-sweep mask, and the pass is one where they
    # differ, and where C_l moved
    assert not (good & ~mask_new).any()
    assert int(mask_new.sum()) > 2 * int(good.sum()) > 0
    assert not torch.equal(at_good.line_conf[s_hat],
                           carried.line_conf[s_hat])
    _same_state(at_good, at_mask_new)


def test_line_confidence_on_cpu_is_the_plain_version():
    ce, depth, k = _line_inputs(9, 4, 32, "between", seed=5)
    mask = _mask("sparse", 4, 32, 5) | (depth > 0)
    want = lc.line_confidence(ce, depth, k, mask, 4)
    n0 = cuda_build.launches["line_conf"]
    for fn in (lc.line_confidence_cuda, td._line_confidence):
        got = fn(ce, depth, k, mask, 4)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
    assert cuda_build.launches["line_conf"] == n0


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bitwise(got, want):
    """Equal bit for bit, NaN where ``want`` is NaN."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", ["empty", "sparse", "full"])
@pytest.mark.parametrize("S", [1, 2, 3, 7, 64, 100, 101, 257])
def test_line_conf_kernel_bitwise(dev, S, mask_kind):
    V, U = 6, 80
    for depths in ("integer", "between"):
        ce, depth, k = _line_inputs(S, V, U, depths, seed=S)
        mask = _mask(mask_kind, V, U, S)
        cpu = (ce, depth, k, mask)
        ce, depth, k, mask = (t.to(dev) for t in cpu)
        for s_hat in sorted({0, S // 2, S - 1}):
            n0 = cuda_build.launches["line_conf"]
            got = lc.line_confidence_cuda(ce, depth, k, mask, s_hat)
            assert cuda_build.launches["line_conf"] == n0 + 1
            want = lc.line_confidence(ce, depth, k, mask, s_hat)
            _bitwise(got, want)
            _bitwise(got.cpu(), lc.line_confidence(*cpu, s_hat))
            assert not got[~mask].any()
            if mask_kind == "full" and S > 1:
                assert torch.isnan(got).any()        # a sum of k of 0
                assert (got[~torch.isnan(got)] > 0).any()
    if mask_kind == "full" and S >= 7:
        # lines left the image on both sides at the far frames
        ds = s_hat - torch.arange(S, device=dev)[:, None, None]
        idx = ds * depth + torch.arange(U, device=dev)
        assert (idx < 0).any() and (idx > U - 1).any()


@pytest.mark.cuda
def test_line_conf_kernel_row_block(dev):
    """C_l of a block of rows equals the same rows of the whole plane (a
    v-split mesh computes it on its block)."""
    S, V, U = 100, 12, 96
    ce, depth, k = (t.to(dev) for t in _line_inputs(S, V, U, "between", 9))
    mask = _mask("sparse", V, U, 9).to(dev) | (depth > 0)
    whole = lc.line_confidence_cuda(ce, depth, k, mask, 37)
    for v0, v1 in ((0, 4), (4, 9), (9, 12)):
        block = lc.line_confidence_cuda(
            ce[:, v0:v1].contiguous(), depth[v0:v1], k[v0:v1].contiguous(),
            mask[v0:v1], 37)
        _bitwise(block, whole[v0:v1])
    _bitwise(whole, lc.line_confidence(ce, depth, k, mask, 37))


@pytest.mark.cuda
def test_line_conf_kernel_counts_pixels(dev):
    S, V, U = 16, 7, 200
    ce, depth, k = (t.to(dev) for t in _line_inputs(S, V, U, "between", 4))
    mask = _mask("sparse", V, U, 4).to(dev)
    profiling.reset()
    lc.line_confidence_cuda(ce, depth, k, mask, 3)       # tracing off
    assert "line_conf.pixels" not in profiling.counters()
    with profiling.tracing():
        for _ in range(2):
            lc.line_confidence_cuda(ce, depth, k, mask, 3)
    assert profiling.counters()["line_conf.pixels"] == 2 * int(mask.sum())
    profiling.reset()


@pytest.mark.cuda
def test_line_conf_kernel_limits_and_refusals(dev):
    V, U = 2, 40
    ce, depth, k = (t.to(dev) for t in _line_inputs(lc.MAX_S, V, U,
                                                    "between", 2))
    mask = torch.ones((V, U), dtype=torch.bool, device=dev)
    _bitwise(lc.line_confidence_cuda(ce, depth, k, mask, 1000),
             lc.line_confidence(ce, depth, k, mask, 1000))
    n0 = cuda_build.launches["line_conf"]
    big = torch.zeros((lc.MAX_S + 1, V, U), device=dev)
    with pytest.raises(NotImplementedError, match="frames"):
        lc.line_confidence_cuda(
            big, depth, torch.zeros((V, lc.MAX_S + 1, U), device=dev), mask,
            0)
    ce, depth, k = (t.to(dev) for t in _line_inputs(9, V, U, "between", 2))
    bad = [(ce.double(), depth, k, mask),          # dtype
           (ce, depth, k, mask.float()),
           (ce, depth.cpu(), k, mask),             # a CPU tensor
           (ce, depth, k.cpu(), mask),
           (ce, depth, k[:, :8].contiguous(), mask),   # shape
           (ce, depth[:, :8], k, mask),
           (ce, depth, k.transpose(0, 2).contiguous().transpose(0, 2),
            mask)]                                 # strided k_best
    for args in bad:
        with pytest.raises(ValueError):
            lc.line_confidence_cuda(*args, 4)
    assert cuda_build.launches["line_conf"] == n0


@pytest.mark.cuda
def test_line_pass_kernel_matches_plain(dev, monkeypatch):
    """One pass of a line-mode ``Depth2DComputer`` on the card from a
    carried state: with the kernel, and with the plain C_l on the card over
    the post-sweep mask (the pass's code before the kernel); the states
    equal bit for bit."""
    comp, frames, carried, s_hat = _carried_line_state(dev)
    n0 = cuda_build.launches["line_conf"]
    with_kernel = _one_pass(comp, frames, _copy(carried), s_hat)
    assert cuda_build.launches["line_conf"] == n0 + 1
    plain = _copy(carried)

    def plain_over_mask_new(ce, depth, k, mask, sh):
        return lc.line_confidence(ce, depth, k, plain.ce_mask[sh], sh)

    monkeypatch.setattr(td, "_line_confidence", plain_over_mask_new)
    _one_pass(comp, frames, plain, s_hat)
    assert not torch.equal(with_kernel.line_conf, carried.line_conf)
    _same_state(with_kernel, plain)
