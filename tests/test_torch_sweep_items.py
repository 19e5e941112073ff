"""The two facts the (pixel, candidate) core of the CUDA pixel and tile
sweeps (``csrc/sweep_pc.cuh``) relies on, on the CPU in float32 against
the plain version's own intermediate values (``ops/sweep.py``):

(a) per (pixel, candidate) the valid samples form one run in s, and the
    core's position arithmetic (ceil from floor, validity from the
    position, the ceil column read only where it differs; under the
    nearest rule one rounded column with weight 0) gives the plain
    version's samples bit for bit;
(b) the core's item layout, emulated in PyTorch (groups of listed pixels,
    windows that compact the allowed (pixel, candidate) slots, each item's
    mean shift adding its terms in the core's order, one fold per pixel in
    candidate order across windows), equals ``sweep_pile`` bitwise in the
    plain, the pixel and the masked mode, with ``n_allowed = 0`` pixels and
    ``k_best``.  The core's order: the valid run [s_a, s_b] in s order, in
    three parts where the thread holds a segment of R samples in registers
    (``CORE_REGS``; C = 3): the run's samples before the segment, the
    segment's batches (``CORE_UM``) that meet the run, whose samples
    outside it read FLT_MAX and add exact zeros, and the run's samples
    after it.
"""

import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.ops.sweep import (_radiances, _sum_s,
                                                      sweep_pile)
from remotesensingproject_tpu_torch.ops.sweep_pallas_perpixel import (
    tile_quantized_bounds)
from remotesensingproject_tpu_torch.types import (DTYPE, chan_scale,
                                                  channel_sumsq, f32,
                                                  round_half_away)

GMIN, GMAX = -3.0, 4.0
OUTS = ("best_score", "score_mean", "best_depth", "rbar")
#: the core's rslf_pc_regs and rslf_pc_um per channel count: the samples
#: of an item its thread holds in registers and the samples of a mean-shift
#: batch (tests/test_torch_sweep_core_host.py holds them to the header's);
#: any other C takes the `any C` item, no registers and one sample at a time
CORE_REGS = {1: 0, 2: 0, 3: 32, 4: 0}
CORE_UM = {1: 8, 2: 8, 3: 4, 4: 8}


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


def _core_terms(ok, s_hat, R, UM):
    """The samples the core's mean shift adds, in its order, per item: [N,
    L] sample indices, -1 for a term that reads FLT_MAX (a register sample
    outside the run, or past the last one: padding, exact zeros too)."""
    N, S = ok.shape
    r0 = max(0, min(s_hat - R // 2, S - R)) & ~3 if R else 0
    rows = []
    for okr in ok:
        run = torch.nonzero(okr).reshape(-1).tolist()
        t = []
        if run:
            s_a, s_b = run[0], run[-1]
            t += range(s_a, min(s_b + 1, r0))
            for b in range(0, R, UM):
                if r0 + b + UM > s_a and r0 + b <= s_b:
                    t += [s if s_a <= s <= s_b else -1
                          for s in range(r0 + b, r0 + b + UM)]
            t += range(max(s_a, r0 + R), s_b + 1)
        rows.append(t)
    L = max(1, max(len(t) for t in rows))
    return torch.tensor([t + [-1] * (L - len(t)) for t in rows])


def _core_mean_shift(val, ok, rbar0, s_hat, params):
    """The core's truncated mean shift of items with samples ``val`` [N, S,
    C] (garbage where not ``ok``) from r_bar ``rbar0`` [N, C], the plain
    version's arithmetic over the core's terms.  Returns (sum K of the last
    step, r_bar, K of the last step [N, S], zeros off the run)."""
    N, S, C = val.shape
    terms = _core_terms(ok, s_hat, CORE_REGS.get(C, 0), CORE_UM.get(C, 1))
    big = torch.full((N, 1, C), np.finfo(np.float32).max)
    x = torch.cat([val, big], 1)[torch.arange(N)[:, None],
                                 torch.where(terms < 0, S, terms)]
    a = f32(chan_scale(C) / (params.kernel_h * params.kernel_h))
    zero = torch.zeros(())
    rbar = rbar0
    k = torch.zeros(terms.shape)
    for _ in range(params.mean_shift_max_iter):
        k = torch.clamp_min(1.0 - a * channel_sumsq(x - rbar[:, None]), 0.0)
        sum_k = _sum_s(k)[:, None]
        sum_rk = _sum_s(torch.clamp_min(x, 0.0) * k[..., None])
        rbar = torch.where(sum_k > 0, sum_rk / sum_k, zero)
    k_s = torch.zeros((N, S + 1)).scatter_(1, torch.where(terms < 0, S, terms),
                                           k)[:, :S]
    return _sum_s(k), rbar, k_s


def test_core_sentinel_adds_exact_zeros():
    """A term that reads FLT_MAX has K = 0 and numerator term 0 under the
    plain arithmetic, for any r_bar of the images' range: it leaves both
    sums as they are, bit for bit."""
    big = np.finfo(np.float32).max
    p = DepthParams()
    rb = torch.tensor([[0.0, 0.5, 1.0], [1.2, 0.0, 0.3]])
    for C in (1, 3, 4):
        a = f32(chan_scale(C) / (p.kernel_h * p.kernel_h))
        x = torch.full((2, C), big)
        k = torch.clamp_min(1.0 - a * channel_sumsq(x - rb[:, :1].expand(2, C)),
                            0.0)
        assert torch.equal(k, torch.zeros(2))
        assert torch.equal(torch.clamp_min(x, 0.0) * k[:, None],
                           torch.zeros((2, C)))
    s = torch.tensor([0.0, 0.25, 3.5])
    assert torch.equal(s + torch.zeros(3), s)


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
            val, ok = val[n, :, ucol], ok[n, :, ucol]                # [N,S(,C)]
            r0 = rows[n, s_hat, ucol]                                # [N, C]
            num, rbar, k_last = _core_mean_shift(val, ok, r0, s_hat, params)
            card = _sum_s(ok.to(DTYPE))
            score = torch.where(card > 0, num / card, torch.zeros(()))
            # the fold: each pixel's items of this window, in list order
            for j, r in enumerate(items):
                st = state[r // dim_d]
                st["nal"] += 1
                if score[j] > st["best"]:
                    st.update(best=score[j], bd=r % dim_d, rb=rbar[j],
                              k=k_last[j])
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


@pytest.mark.parametrize("S,s_hat", [(100, 50), (61, 13)])
@pytest.mark.parametrize("mode", ["uniform", "per_pixel"])
def test_item_layout_c3_full_depth_equals_plain_sweep(S, s_hat, mode):
    """C = 3 at the RGB scene's depth (S = 100) and at an odd one: runs that
    start before the register segment and end after it, runs the borders
    cut, a segment from r0 = 0; bitwise ``sweep_pile`` with ``k_best``."""
    epis = _scene(3, V=2, S=S, U=24, seed=S)
    V, _, U, _ = epis.shape
    lo, hi = _bounds(V, U, mode, seed=S)
    active = torch.from_numpy(np.random.default_rng(S).uniform(size=(V, U))
                              < 0.6)
    params = DepthParams(slope_factor=0.1)
    R, dim_d = CORE_REGS[3], 5
    r0 = max(0, min(s_hat - R // 2, S - R)) & ~3
    spans = cut = 0
    for d in (0, dim_d - 1):
        _, ok = _core_samples(epis, _candidate(lo, hi, d, dim_d), s_hat,
                              f32(params.slope_factor))
        s = torch.arange(S)[None, :, None]
        s_a = torch.where(ok, s, S).amin(1)[active]
        s_b = torch.where(ok, s, -1).amax(1)[active]
        spans += int(((s_a < r0) & (s_b >= r0 + R)).sum())
        cut += int((s_b - s_a + 1 < S).sum())
    assert R > 0 and cut > 0 and (spans > 0 or r0 == 0)
    out, _ = _emulate_core(epis, lo, hi, dim_d, s_hat, params, active,
                           with_k=True)
    _check(out, sweep_pile(epis, lo, hi, dim_d, s_hat, params, True), active,
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
