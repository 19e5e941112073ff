"""The pass's merge: the CUDA kernel ``csrc/merge.cu`` and its plain route.

On the CPU (no JAX): ``merge_cuda`` runs the plain route, which is bitwise
the pass's merge as it was written inline in ``_pass_fn`` before the kernel
(frozen below as ``_inline_merge``), for C = 1, 3 and 4, no active pixel and
every pixel active, scores at the threshold, a negative threshold and one
that float32 cannot hold; a whole pass in edge, disp and line mode is the
same with either merge; ``conf`` never shares storage with the
``disp_conf`` plane that the paint writes from it.

On the card (marker ``cuda``; ``python -m pytest tests/test_torch_merge.py
--noconftest -q``): the kernel against the plain route, bitwise, on random
states; the ``merge.launches`` counter; the cases where the wrapper
raises; and one whole pass on the card against the same pass with the
plain stages (``use_pallas=False``) and the plain merge, at a pass whose
paint repaints the s_hat plane.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.models import depth2d as td
from remotesensingproject_tpu_torch.ops import cuda_build
from remotesensingproject_tpu_torch.ops import merge as mg
from remotesensingproject_tpu_torch.ops.sweep import SweepResult
from remotesensingproject_tpu_torch.utils import profiling

PLANES = ("ce", "ce_mask", "disp_conf", "best_depth", "rbar")


def _inline_merge(state, s_hat, active, res, threshold, with_good=False):
    """The pass's merge as ``_pass_fn`` wrote it inline, returning what the
    pass read of it."""
    ce_p = state.ce[s_hat]
    mask_p = state.ce_mask[s_hat]
    zero = torch.zeros((), dtype=torch.float32, device=active.device)
    ok = res.best_score > threshold
    good = active & ok
    bad = active & ~ok
    ce_new = torch.where(bad, zero, ce_p)
    mask_new = mask_p & ~bad
    depth_new = torch.where(good, res.best_depth, state.best_depth[s_hat])
    conf_new = torch.where(
        good, ce_new * torch.abs(res.best_score - res.score_mean),
        state.disp_conf[s_hat])
    rbar_new = torch.where(good[..., None], res.rbar, state.rbar[s_hat])
    state.ce[s_hat] = ce_new
    state.ce_mask[s_hat] = mask_new
    state.disp_conf[s_hat] = conf_new
    state.best_depth[s_hat] = depth_new
    state.rbar[s_hat] = rbar_new
    return mg.Merged(depth_new, mask_new, conf_new, rbar_new,
                     good if with_good else None)


def _inputs(C, kind, threshold=0.0, S=5, V=6, U=40, seed=0, s_hat=2):
    """A random state (a namespace of the merge's planes), the pass's
    active pixels (``kind``: none, sparse, all) and sweep results whose
    best scores straddle ``threshold``, some exactly at it."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=g)
    ce = rand(S, V, U)
    ce[rand(S, V, U) < 0.2] = 0.0
    state = types.SimpleNamespace(
        ce=ce, ce_mask=rand(S, V, U) < 0.6, disp_conf=rand(S, V, U),
        best_depth=rand(S, V, U) * 8 - 4, rbar=rand(S, V, U, C))
    if kind == "all":
        state.ce_mask[s_hat] = True
    claim = rand(V, U) < 0.7
    active = {"none": torch.zeros((V, U), dtype=torch.bool),
              "sparse": state.ce_mask[s_hat] & claim,
              "all": torch.ones((V, U), dtype=torch.bool)}[kind]
    t = np.float32(threshold)
    score = (rand(V, U) * 2 - 1) * 4 + torch.tensor(float(t))
    at = rand(V, U) < 0.15
    score[at] = torch.tensor(t)
    # the float32 neighbours of the threshold: good above, bad below
    near = rand(V, U) < 0.1
    up = torch.from_numpy(np.full((V, U), np.nextafter(t, np.float32(9))))
    score = torch.where(near & (rand(V, U) < 0.5), up, score)
    score[0, 0] = float("nan")                    # a failed sweep: bad
    res = SweepResult(best_score=score, score_mean=rand(V, U) * 2 - 1,
                      best_depth=rand(V, U) * 8 - 4, rbar=rand(V, U, C),
                      k_best=None)
    return state, active, res


def _copy(state):
    return types.SimpleNamespace(**{n: getattr(state, n).clone()
                                    for n in PLANES})


def _bits(t):
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    return t.view(torch.int32)


def _bitwise(got, want):
    """Equal bit for bit; a NaN where ``want`` has one (of any payload)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.bool:
        assert torch.equal(got, want)
        return
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])


def _same_merge(got_state, got, want_state, want):
    for n in PLANES:
        _bitwise(getattr(got_state, n), getattr(want_state, n))
    for n in ("depth", "mask", "conf", "rbar"):
        _bitwise(getattr(got, n), getattr(want, n))
    if want.good is None:
        assert got.good is None
    else:
        assert torch.equal(got.good, want.good)


@pytest.mark.parametrize("with_good", [False, True])
@pytest.mark.parametrize("kind", ["none", "sparse", "all"])
@pytest.mark.parametrize("C", [1, 3, 4])
def test_plain_route_is_the_inline_merge(C, kind, with_good):
    state, active, res = _inputs(C, kind, seed=C)
    s_hat = 2
    want_state = _copy(state)
    want = _inline_merge(want_state, s_hat, active, res, 0.0, with_good)
    n0 = cuda_build.launches["merge"]
    got = mg.merge_cuda(state, s_hat, active, res, 0.0, with_good)
    assert cuda_build.launches["merge"] == n0
    _same_merge(state, got, want_state, want)
    # every kind of pixel is there
    ok = res.best_score > 0.0
    if kind != "none":
        assert (active & ok).any() and (active & ~ok).any()
    if kind != "all":
        assert (~active).any()


@pytest.mark.parametrize("threshold", [0.0, -0.75, 0.1, 1.0 / 3.0])
def test_plain_route_thresholds(threshold):
    """A score at the threshold is bad; the threshold is rounded to float32
    and compared there, so a score just above float32(0.1) is good and one
    at float32(0.1), above 0.1 in float64, is bad."""
    state, active, res = _inputs(3, "all", threshold, seed=7)
    want_state = _copy(state)
    want = _inline_merge(want_state, 2, active, res, threshold, True)
    got = mg.merge_cuda(state, 2, active, res, threshold, True)
    _same_merge(state, got, want_state, want)
    t = np.float32(threshold)
    at = res.best_score == torch.tensor(t)
    above = res.best_score == torch.tensor(
        np.nextafter(t, np.float32(9)))
    assert at.any() and above.any()
    assert not got.good[at].any() and got.good[above].all()
    assert not state.ce_mask[2][at].any()
    assert torch.equal(state.ce[2][at], torch.zeros(int(at.sum())))
    assert not got.good[0, 0]                     # NaN score


def test_plain_route_conf_has_its_own_storage():
    state, active, res = _inputs(1, "sparse", seed=3)
    got = mg.merge_cuda(state, 2, active, res, 0.0)
    plane = state.disp_conf.untyped_storage().data_ptr()
    assert got.conf.untyped_storage().data_ptr() != plane
    assert torch.equal(got.conf, state.disp_conf[2])
    # the others are views of the state's planes at s_hat
    assert got.depth.data_ptr() == state.best_depth[2].data_ptr()
    assert got.mask.data_ptr() == state.ce_mask[2].data_ptr()
    assert got.rbar.data_ptr() == state.rbar[2].data_ptr()


def _pass_inputs(device, score_version, C=1, passes=2, seed=5):
    """A computer on a small scene, its state after the first ``passes``
    passes, the next s_hat."""
    params = DepthParams(score_version=score_version)
    vol, _ = oracle.make_synthetic_lf(S=8, V=10, U=48, C=C, seed=seed,
                                      dmin=-1.0, dmax=1.5)
    comp = td.Depth2DComputer(vol, -1.0, 1.5, 9, params=params,
                              device=device)
    frames = comp.epis.permute(1, 0, 2, 3).contiguous()
    state = comp.initial_state()
    sched = td.center_outward_schedule(comp.epis.shape[1])
    for s_hat in sched[:passes]:
        _one_pass(comp, frames, state, s_hat)
    return comp, frames, state, sched[passes]


def _one_pass(comp, frames, state, s_hat, **hooks):
    return td._pass_fn(comp.epis, frames, state, s_hat, dim_d=comp.dim_d,
                       params=comp.params, d_bounds=(comp.dmin, comp.dmax),
                       **hooks)


def _state_copy(state):
    return td.Depth2DState(**{f.name: getattr(state, f.name).clone()
                              for f in dataclasses.fields(state)})


def _same_state(a, b):
    for f in dataclasses.fields(a):
        _bitwise(getattr(a, f.name), getattr(b, f.name))


@pytest.mark.parametrize("score_version", ["edge", "disp", "line"])
def test_pass_same_with_the_inline_merge(monkeypatch, score_version):
    comp, frames, carried, s_hat = _pass_inputs("cpu", score_version)
    got = _one_pass(comp, frames, _state_copy(carried), s_hat)
    monkeypatch.setattr(td, "merge_cuda", _inline_merge)
    want = _one_pass(comp, frames, _state_copy(carried), s_hat)
    _same_state(got, want)
    # the pass swept, merged and painted
    active = carried.ce_mask[s_hat] & carried.claim[s_hat]
    assert active.any()
    assert not torch.equal(got.best_depth[s_hat], carried.best_depth[s_hat])
    assert (active & ~got.claim[s_hat]).any()


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(dev, state, active, res):
    return (types.SimpleNamespace(**{n: getattr(state, n).to(dev)
                                     for n in PLANES}),
            active.to(dev),
            SweepResult(*(None if x is None else x.to(dev) for x in res)))


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [0.0, -0.75, 0.1])
@pytest.mark.parametrize("kind", ["none", "sparse", "all"])
@pytest.mark.parametrize("C", [1, 3, 4])
def test_kernel_bitwise(dev, C, kind, threshold):
    for seed, (V, U) in enumerate(((6, 40), (37, 301), (1, 1))):
        state, active, res = _on(dev, *_inputs(C, kind, threshold, V=V, U=U,
                                               seed=seed))
        for with_good in (False, True):
            want_state = _copy(state)
            want = mg.merge(want_state, 2, active, res, threshold, with_good)
            got_state = _copy(state)
            n0 = cuda_build.launches["merge"]
            got = mg.merge_cuda(got_state, 2, active, res, threshold,
                                with_good)
            assert cuda_build.launches["merge"] == n0 + 1
            _same_merge(got_state, got, want_state, want)
            assert got.conf.untyped_storage().data_ptr() != \
                got_state.disp_conf.untyped_storage().data_ptr()
            assert got.depth.data_ptr() == \
                got_state.best_depth[2].data_ptr()
            # the other planes are untouched
            for n in PLANES:
                a, b = getattr(got_state, n), getattr(state, n)
                _bitwise(torch.cat([a[:2], a[3:]]),
                         torch.cat([b[:2], b[3:]]))


@pytest.mark.cuda
def test_kernel_counts_launches(dev):
    state, active, res = _on(dev, *_inputs(1, "sparse"))
    profiling.reset()
    mg.merge_cuda(state, 2, active, res, 0.0)        # tracing off
    assert "merge.launches" not in profiling.counters()
    with profiling.tracing():
        for _ in range(3):
            mg.merge_cuda(state, 2, active, res, 0.0)
    assert profiling.counters()["merge.launches"] == 3
    profiling.reset()


@pytest.mark.cuda
def test_kernel_refusals(dev):
    state, active, res = _on(dev, *_inputs(3, "sparse"))
    n0 = cuda_build.launches["merge"]
    bad = [
        (state, active[:, :8], res, 2),                       # shapes
        (state, active, res._replace(rbar=res.rbar[..., :1]), 2),
        (state, active, res._replace(best_score=res.best_score[:3]), 2),
        (state, active, res, 5),                              # s_hat
        (state, active.float(), res, 2),                      # dtype
        (types.SimpleNamespace(**{**vars(state),
                                  "ce_mask": state.ce_mask.float()}),
         active, res, 2),
        (types.SimpleNamespace(**{**vars(state),
                                  "disp_conf": state.disp_conf.cpu()}),
         active, res, 2),                                     # a CPU plane
        (state, active, res._replace(score_mean=res.score_mean.cpu()), 2),
        (types.SimpleNamespace(**{**vars(state), "ce": state.ce.transpose(
            1, 2).contiguous().transpose(1, 2)}), active, res, 2),  # strided
    ]
    for st, act, r, s_hat in bad:
        with pytest.raises(ValueError):
            mg.merge_cuda(st, s_hat, act, r, 0.0)
    assert cuda_build.launches["merge"] == n0


@pytest.mark.cuda
@pytest.mark.parametrize("score_version", ["edge", "disp", "line"])
def test_pass_kernel_matches_plain(dev, monkeypatch, score_version):
    """One pass on the card from a carried state: with the kernels (the
    merge's among them), and with the plain stages (``use_pallas=False``)
    and the plain merge; the states equal bit for bit.  The pass's paint
    repaints plane s_hat from ``conf``, which the merge wrote as it wrote
    that plane."""
    comp, frames, carried, s_hat = _pass_inputs(dev, score_version)
    n0 = cuda_build.launches["merge"]
    got = _one_pass(comp, frames, _state_copy(carried), s_hat)
    assert cuda_build.launches["merge"] == n0 + 1
    monkeypatch.setattr(td, "merge_cuda", mg.merge)
    hooks = td.plain_stages(comp.epis, comp.dim_d, comp.params,
                            (comp.dmin, comp.dmax))
    want = _one_pass(comp, frames, _state_copy(carried), s_hat, **hooks)
    assert cuda_build.launches["merge"] == n0 + 1
    active = carried.ce_mask[s_hat] & carried.claim[s_hat]
    assert (active & ~got.claim[s_hat]).any()
    assert not torch.equal(got.disp_conf[s_hat], carried.disp_conf[s_hat])
    _same_state(got, want)
