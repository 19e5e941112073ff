"""The two facts the (pixel, candidate) core of the CUDA pixel and tile
sweeps (``csrc/sweep_pc.cuh``) relies on, on the CPU in float32 against
the plain version's own intermediate values (``ops/sweep.py``):

(a) per (pixel, candidate) the valid samples form one run in s, and the
    core's position arithmetic (ceil from floor, validity from the
    position, the ceil column read only where it differs; under the
    nearest rule one rounded column with weight 0) gives the plain
    version's samples bit for bit;
(b) the core's item layout, emulated in PyTorch (groups of listed pixels,
    windows that compact the allowed (pixel, candidate) slots, each item
    scored with the plain arithmetic, one fold per pixel in candidate
    order across windows), equals ``sweep_pile`` bitwise in the plain, the
    pixel and the masked mode, with ``n_allowed = 0`` pixels and ``k_best``.
"""

import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.ops.sweep import (_mean_shift,
                                                      _radiances, _sum_s,
                                                      sweep_pile)
from remotesensingproject_tpu_torch.ops.sweep_pallas_perpixel import (
    tile_quantized_bounds)
from remotesensingproject_tpu_torch.types import DTYPE, f32, round_half_away

GMIN, GMAX = -3.0, 4.0
OUTS = ("best_score", "score_mean", "best_depth", "rbar")


def _scene(C, V=3, S=7, U=40, seed=7):
    vol, _ = oracle.make_synthetic_lf(S=S, V=V, U=U, C=1, n_objects=3,
                                      seed=seed, dmin=-1.0, dmax=1.5)
    base = vol[..., 0]
    gains = np.linspace(1.0, 0.4, C).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(
        (base[..., None] * gains).astype(np.float32)))


def _bounds(V, U, mode, seed=0):
    """Grid bounds [V, U]: the level's uniform ones, or per pixel (some
    wide, some narrow, some degenerate)."""
    if mode == "uniform":
        return (torch.full((V, U), f32(GMIN)), torch.full((V, U), f32(GMAX)))
    rng = np.random.default_rng(seed)
    lo = rng.uniform(GMIN, 0.0, (V, U)).astype(np.float32)
    hi = rng.uniform(0.1, GMAX, (V, U)).astype(np.float32)
    wide = rng.uniform(size=(V, U)) < 0.2
    lo[wide], hi[wide] = GMIN, GMAX
    flat = rng.uniform(size=(V, U)) < 0.05
    hi[flat] = lo[flat]
    return torch.from_numpy(lo), torch.from_numpy(hi)


def _candidate(lo, hi, d, dim_d):
    den = torch.full_like(lo, float(dim_d - 1))
    return lo + ((hi - lo) * float(d)) / den


def _core_samples(epis, delta, s_hat, slope):
    """The core's staging of one candidate plane ``delta`` [V, U]: samples
    [V, S, U, C] (garbage where invalid) and valid [V, S, U]."""
    V, S, U, C = epis.shape
    ds = float(s_hat) - torch.arange(S, dtype=DTYPE)
    u = torch.arange(U, dtype=DTYPE)
    idx = u + (ds[None, :, None] * delta[:, None, :]) * slope
    fi = torch.floor(idx)
    t = idx - fi
    ok = (idx >= 0) & (idx <= U - 1)
    up = ok & (t > 0)
    i0 = torch.where(ok, fi, torch.zeros_like(fi)).to(torch.int64)
    i1 = i0 + up.to(torch.int64)

    def gather(i):
        return torch.gather(epis, 2, i[..., None].expand(V, S, U, C))

    a = gather(i0)
    b = torch.where(up[..., None], gather(i1), a)
    tt = t[..., None]
    return (1.0 - tt) * a + tt * b, ok


@pytest.mark.parametrize("mode", ["uniform", "per_pixel"])
@pytest.mark.parametrize("s_hat", [3, 0, 6])
def test_valid_samples_form_one_run(mode, s_hat):
    epis = _scene(1)
    V, S, U, _ = epis.shape
    lo, hi = _bounds(V, U, mode)
    ds = float(s_hat) - torch.arange(S, dtype=DTYPE)
    u_idx = torch.arange(U, dtype=DTYPE)
    dim_d, cut = 33, 0
    for d in range(dim_d):
        delta = _candidate(lo, hi, d, dim_d)
        _, _, valid = _radiances(epis, delta, ds, u_idx, f32(1.0), "linear")
        card = valid.sum(1)                                   # [V, U]
        s = torch.arange(S)[None, :, None].expand(V, S, U)
        first = torch.where(valid, s, S).amin(1)
        last = torch.where(valid, s, -1).amax(1)
        run = torch.where(card > 0, last - first + 1, 0)
        assert torch.equal(run, card), d
        cut += int((card < S).sum())
    assert cut > 0  # the borders did cut samples of some candidates


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("mode", ["uniform", "per_pixel"])
def test_core_positions_match_plain_samples(C, mode):
    epis = _scene(C)
    V, S, U, _ = epis.shape
    lo, hi = _bounds(V, U, mode, seed=1)
    s_hat, slope = 2, f32(0.5)
    ds = float(s_hat) - torch.arange(S, dtype=DTYPE)
    u_idx = torch.arange(U, dtype=DTYPE)
    for d in range(17):
        delta = _candidate(lo, hi, d, 17)
        _, valraw, valid = _radiances(epis, delta, ds, u_idx, slope, "linear")
        val, ok = _core_samples(epis, delta, s_hat, slope)
        assert torch.equal(ok, valid), d
        got = torch.where(ok[..., None], val, torch.zeros(()))
        assert torch.equal(got, valraw), d


def _core_nearest_samples(epis, delta, s_hat, slope):
    """The core's staging under PcRuleNearest: column round_half_away(I),
    weight t = 0 and no second column, so (1 - t) * a + t * a."""
    V, S, U, C = epis.shape
    ds = float(s_hat) - torch.arange(S, dtype=DTYPE)
    u = torch.arange(U, dtype=DTYPE)
    idx = u + (ds[None, :, None] * delta[:, None, :]) * slope
    r = round_half_away(idx)
    ok = (r >= 0) & (r <= U - 1)
    i0 = torch.where(ok, r, torch.zeros_like(r)).to(torch.int64)
    a = torch.gather(epis, 2, i0[..., None].expand(V, S, U, C))
    t = torch.zeros(())
    return (1.0 - t) * a + t * a, ok


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("mode", ["uniform", "per_pixel"])
@pytest.mark.parametrize("s_hat", [0, 3, 6])
def test_core_nearest_positions_match_plain_samples(C, mode, s_hat):
    """PcRuleNearest gives the plain nearest samples bit for bit, and its
    valid samples form one run in s (the core's mean shift walks one run)."""
    epis = _scene(C)
    V, S, U, _ = epis.shape
    lo, hi = _bounds(V, U, mode, seed=2)
    slope = f32(0.5) if C == 4 else f32(1.0)
    ds = float(s_hat) - torch.arange(S, dtype=DTYPE)
    u_idx = torch.arange(U, dtype=DTYPE)
    s = torch.arange(S)[None, :, None].expand(V, S, U)
    halves = 0
    for d in range(17):
        delta = _candidate(lo, hi, d, 17)
        _, valraw, valid = _radiances(epis, delta, ds, u_idx, slope,
                                      "nearest")
        val, ok = _core_nearest_samples(epis, delta, s_hat, slope)
        assert torch.equal(ok, valid), d
        got = torch.where(ok[..., None], val, torch.zeros(()))
        assert torch.equal(got, valraw), d
        card = valid.sum(1)
        first = torch.where(valid, s, S).amin(1)
        last = torch.where(valid, s, -1).amax(1)
        assert torch.equal(torch.where(card > 0, last - first + 1, 0), card)
        idx = u_idx + (ds[None, :, None] * delta[:, None, :]) * slope
        halves += int((idx - torch.floor(idx) == 0.5).sum())
    assert halves > 0  # some positions fell on a half: away from zero


def _emulate_core(epis, lo, hi, dim_d, s_hat, params, active, plo=None,
                  phi=None, with_k=False, group=4, threads=8, ncap=16):
    """The core's layout in PyTorch: ``group`` listed pixels a block,
    windows of at most ``ncap`` allowed (pixel, candidate) slots compacted
    ``threads`` slots at a time, items scored with the plain arithmetic,
    one fold per pixel in candidate order.  Returns the outputs as the
    kernel leaves them (zeros at unlisted pixels) and the window count."""
    V, S, U, C = epis.shape
    slope = f32(params.slope_factor)
    masked = plo is not None
    den = torch.full((), float(dim_d - 1))
    out = {n: torch.zeros((V, U)) for n in OUTS[:3]}
    out["rbar"] = torch.zeros((V, U, C))
    out["k_best"] = torch.zeros((V, S, U))
    pix = torch.nonzero(active.reshape(-1)).reshape(-1).tolist()
    windows = 0
    for p0 in range(0, len(pix), group):
        px = pix[p0:p0 + group]
        vs = [p // U for p in px]
        us = [p % U for p in px]
        g_lo = torch.stack([lo[v, u] for v, u in zip(vs, us)])
        g_rng = torch.stack([hi[v, u] - lo[v, u] for v, u in zip(vs, us)])
        if masked:
            tol = g_rng / den
            g_plo = torch.stack([plo[v, u] for v, u in zip(vs, us)]) - tol
            g_phi = torch.stack([phi[v, u] for v, u in zip(vs, us)]) + tol
        state = [dict(best=torch.tensor(-1.0), sum=torch.tensor(0.0), bd=-1,
                      nal=0, rb=None, k=None) for _ in px]
        n_slots, pos = len(px) * dim_d, 0
        while pos < n_slots:
            items = []
            while pos < n_slots and len(items) + threads <= ncap:
                for r in range(pos, min(pos + threads, n_slots)):
                    p, d = divmod(r, dim_d)
                    dl = g_lo[p] + (d * g_rng[p]) / den
                    if not masked or bool((dl >= g_plo[p]) & (dl <= g_phi[p])):
                        items.append(r)
                pos += threads
            windows += 1
            if not items:
                continue
            # every item of the window at once, each on its own row
            ip = torch.tensor([r // dim_d for r in items])
            idd = torch.tensor([r % dim_d for r in items], dtype=DTYPE)
            delta = g_lo[ip] + (idd * g_rng[ip]) / den               # [N]
            rows = epis[torch.tensor(vs)[ip]]                        # [N,S,U,C]
            ucol = torch.tensor(us)[ip]
            val, ok = _core_samples(rows, delta[:, None].expand(-1, U),
                                    s_hat, slope)
            n = torch.arange(len(items))
            val, ok = val[n, :, ucol][:, :, None], ok[n, :, ucol][:, :, None]
            zero = torch.zeros(())
            valraw = torch.where(ok[..., None], val, zero)
            valpos = torch.where(ok[..., None], val.clamp_min(0.0), zero)
            r0 = rows[n, s_hat, ucol][:, None]                       # [N,1,C]
            num, rbar, k_last = _mean_shift(valpos, valraw, ok, r0, params)
            card = _sum_s(ok.to(DTYPE))
            score = torch.where(card > 0, num / card, zero)[:, 0]
            # the fold: each pixel's items of this window, in list order
            for j, r in enumerate(items):
                st = state[r // dim_d]
                st["nal"] += 1
                if score[j] > st["best"]:
                    st.update(best=score[j], bd=r % dim_d, rb=rbar[j, 0],
                              k=k_last[j, :, 0])
                st["sum"] = st["sum"] + score[j]
        fd = torch.tensor(float(dim_d))
        for p, st in enumerate(state):
            v, u = vs[p], us[p]
            out["best_score"][v, u] = st["best"]
            if st["bd"] >= 0:
                out["best_depth"][v, u] = g_lo[p] + (st["bd"] * g_rng[p]) / den
                out["rbar"][v, u] = st["rb"]
                out["k_best"][v, :, u] = st["k"]
            out["score_mean"][v, u] = (
                ((st["sum"] * fd) / float(max(st["nal"], 1))) / fd
                if masked else st["sum"] / fd)
    if not with_k:
        out.pop("k_best")
    return out, windows


def _check(out, want, active, with_k):
    for name in OUTS:
        assert torch.equal(out[name][active], getattr(want, name)[active]), \
            name
        assert not out[name][~active].any(), name
    if with_k:
        assert torch.equal(out["k_best"].permute(0, 2, 1)[active],
                           want.k_best.permute(0, 2, 1)[active])


@pytest.mark.parametrize("C,dim_d", [(1, 9), (3, 7), (4, 9), (5, 7)])
@pytest.mark.parametrize("mode", ["uniform", "per_pixel"])
def test_item_layout_equals_plain_sweep(C, dim_d, mode):
    epis = _scene(C, V=2, U=24)
    V, S, U, _ = epis.shape
    lo, hi = _bounds(V, U, mode, seed=C)
    g = np.random.default_rng(C + dim_d)
    active = torch.from_numpy(g.uniform(size=(V, U)) < 0.7)
    if int(active.sum()) % 4 == 0:          # keep the last group ragged
        active[tuple(torch.nonzero(active)[0])] = False
    params = DepthParams(slope_factor=0.5)
    out, windows = _emulate_core(epis, lo, hi, dim_d, 3, params, active,
                                 with_k=True)
    assert windows > -(-int(active.sum()) // 4)   # pixels span windows
    _check(out, sweep_pile(epis, lo, hi, dim_d, 3, params, True), active,
           True)


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("with_k", [False, True])
def test_item_layout_equals_plain_sweep_masked(C, with_k):
    epis = _scene(C, V=2, U=24, seed=3)
    V, S, U, _ = epis.shape
    rng = np.random.default_rng(10 + C)
    c = rng.uniform(-0.6, 1.1, (V, U)).astype(np.float32)
    plo = torch.from_numpy(np.clip(c - 0.3, -1.0, 1.5))
    phi = torch.from_numpy(np.clip(c + 0.3, -1.0, 1.5))
    active = torch.from_numpy(rng.uniform(size=(V, U)) < 0.8)
    qlo, qhi = tile_quantized_bounds(active, plo, phi, (-1.0, 1.5))
    # pixels whose allowed range lies outside the grid: n_allowed = 0
    plo[0, :3], phi[0, :3] = 7.0, 8.0
    active[0, :3] = True
    dim_d, params = 9, DepthParams()
    out, _ = _emulate_core(epis, qlo, qhi, dim_d, 3, params, active, plo,
                           phi, with_k=with_k)
    want = sweep_pile(epis, qlo, qhi, dim_d, 3, params, with_k, plo, phi)
    assert (want.best_score[0, :3] == -1.0).all()
    assert not want.score_mean[0, :3].any()
    _check(out, want, active, with_k)
