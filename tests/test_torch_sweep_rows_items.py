"""What the row sweep relies on as a launcher of the (pixel, candidate)
core (``csrc/sweep_rows.cu`` on ``csrc/sweep_pc.cuh``), on the CPU in
float32 against the plain version's own intermediate values
(``ops/sweep_pallas.py``):

(a) under the shared-shift position rule the valid samples of a (pixel,
    candidate) item form one run in s, and the core's arithmetic for that
    rule (validity compared on floats, the second column read only where
    the weight is not 0, one interpolation formula for every weight) gives
    the plain version's samples bit for bit;
(b) the core's candidate grid is ``candidate_grid`` bit for bit;
(c) the core's item layout under that rule, emulated in PyTorch in both
    item orders (slots p * D + d and d * G + p), equals
    ``sweep_rows_plain`` bitwise, with an activity mask and ``k_best``.
"""

import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.ops.sweep import _mean_shift, _sum_s
from remotesensingproject_tpu_torch.ops.sweep_pallas import (
    _row_samples, candidate_grid, sweep_rows_plain)
from remotesensingproject_tpu_torch.types import DTYPE, f32

OUTS = ("best_score", "score_mean", "best_depth", "rbar")


def _scene(C, V=3, S=7, U=40, seed=7):
    vol, _ = oracle.make_synthetic_lf(S=S, V=V, U=U, C=1, n_objects=3,
                                      seed=seed, dmin=-1.0, dmax=1.5)
    gains = np.linspace(1.0, 0.4, C).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(
        (vol[..., 0][..., None] * gains).astype(np.float32)))


def _core_row_positions(delta, s_hat, S, U, slope):
    """PcRuleRow::pos for candidates ``delta`` [N] at every (s, u): weight
    t [N, S, 1], floor column i0 [N, S, U] (0 where invalid), up and ok
    [N, S, U]."""
    ds = float(s_hat) - torch.arange(S, dtype=DTYPE)
    shift = (ds[None, :] * delta[:, None]) * slope            # [N, S]
    f0 = torch.floor(shift)
    t = shift - f0
    fu = torch.arange(U, dtype=DTYPE)[None, None, :]
    top = f0 + (t > 0).to(DTYPE)
    ok = (fu >= -f0[..., None]) & (fu <= float(U - 1) - top[..., None])
    up = ok & (t > 0)[..., None]
    i0 = torch.where(ok, f0[..., None] + fu, torch.zeros(())).to(torch.int64)
    return t[..., None], i0, up, ok


def _core_row_samples(rows, delta, s_hat, slope):
    """The core's staging under the row rule: ``rows`` [N, S, U, C] (the EPI
    of each item's pixel), ``delta`` [N].  Returns samples [N, S, U, C]
    (garbage where invalid) and ok [N, S, U]."""
    N, S, U, C = rows.shape
    t, i0, up, ok = _core_row_positions(delta, s_hat, S, U, slope)

    def gather(i):
        return torch.gather(rows, 2, i[..., None].expand(N, S, U, C))

    a = gather(i0)
    b = torch.where(up[..., None], gather(i0 + up.to(torch.int64)), a)
    tt = t[..., None]
    return (1.0 - tt) * a + tt * b, ok


@pytest.mark.parametrize("s_hat", [3, 0, 6])
@pytest.mark.parametrize("bounds", [(-3.0, 4.0), (-4.0, -0.5), (0.25, 3.0)])
def test_row_rule_valid_samples_form_one_run(s_hat, bounds):
    S, U, dim_d = 7, 40, 33
    ds = float(s_hat) - torch.arange(S, dtype=DTYPE)
    u_idx = torch.arange(U)[None, :]
    epis = torch.zeros((1, S, U, 1))
    cut = 0
    for dval in candidate_grid(*bounds, dim_d, "cpu"):
        _, valid = _row_samples(epis, dval, ds, u_idx, f32(1.0))   # [S, U]
        card = valid.sum(0)
        s = torch.arange(S)[:, None].expand(S, U)
        first = torch.where(valid, s, S).amin(0)
        last = torch.where(valid, s, -1).amax(0)
        run = torch.where(card > 0, last - first + 1, 0)
        assert torch.equal(run, card), float(dval)
        cut += int((card < S).sum())
    assert cut > 0  # the borders did cut samples of some candidates


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("s_hat,slope", [(2, 0.5), (0, 1.0), (6, -0.75)])
def test_core_row_positions_match_row_samples(C, s_hat, slope):
    epis = _scene(C)
    V, S, U, _ = epis.shape
    slope = f32(slope)
    ds = float(s_hat) - torch.arange(S, dtype=DTYPE)
    u_idx = torch.arange(U)[None, :]
    zero = torch.zeros(())
    n_weightless = 0
    for dval in candidate_grid(-3.0, 4.0, 29, "cpu"):
        val, valid = _row_samples(epis, dval, ds, u_idx, slope)
        got, ok = _core_row_samples(epis, dval.expand(V), s_hat, slope)
        assert torch.equal(ok, valid[None].expand(V, S, U)), float(dval)
        assert torch.equal(torch.where(ok[..., None], got, zero),
                           torch.where(valid[None, ..., None], val, zero))
        shift = (ds * dval) * slope
        n_weightless += int((shift == torch.floor(shift)).sum())
    assert n_weightless > 29  # weight 0 beyond the s_hat row too


def test_weight_zero_keeps_the_sample():
    """(1 - t) * a + t * a == a where t == 0, for every finite a: the core
    needs no select for the samples that sit on a column."""
    rng = np.random.default_rng(0)
    a = np.concatenate([
        rng.standard_normal(4096).astype(np.float32),
        (rng.standard_normal(4096) * 1e30).astype(np.float32),
        (rng.standard_normal(4096) * 1e-42).astype(np.float32),  # denormals
        np.array([0.0, -0.0, np.finfo(np.float32).max,
                  -np.finfo(np.float32).max, np.finfo(np.float32).tiny],
                 np.float32)])
    a = torch.from_numpy(a)
    t = torch.zeros(())
    got = (1.0 - t) * a + t * a
    assert torch.equal(got, a)
    assert torch.equal(torch.signbit(got), torch.signbit(a))


@pytest.mark.parametrize("dim_d", [120, 130, 1030])
@pytest.mark.parametrize("bounds", [(-1.0, 4.0), (-1.0, 1.5), (-0.3, 0.7)])
def test_core_grid_equals_candidate_grid(dim_d, bounds):
    """The core's lo + (d * rng) / (D - 1), rng = dmax - dmin, one float32
    operation at a time, is ``candidate_grid``."""
    lo, hi = np.float32(bounds[0]), np.float32(bounds[1])
    rng = np.float32(hi - lo)
    den = np.float32(dim_d - 1)
    core = np.array([np.float32(lo + np.float32(np.float32(d) * rng) / den)
                     for d in range(dim_d)], np.float32)
    np.testing.assert_array_equal(
        core, candidate_grid(*bounds, dim_d, "cpu").numpy())


def _emulate_rows_core(epis, dmin, dmax, dim_d, s_hat, params, active,
                       by_pixel, group=6, threads=16, ncap=64):
    """The core's unmasked layout under the row rule, in PyTorch: ``group``
    listed pixels a block, their slots (p * D + d, or d * gp + p with
    ``by_pixel``) walked in windows of ``ncap`` items, each item scored with
    the plain arithmetic on the core's samples, one fold per pixel in
    candidate order across windows (the fold finds a pixel's items as the
    kernel does).  Returns the outputs as the kernel leaves them."""
    V, S, U, C = epis.shape
    slope = f32(params.slope_factor)
    lo = torch.tensor(f32(dmin))
    rng = torch.tensor(f32(dmax)) - lo
    den = torch.full((), float(dim_d - 1))
    out = {n: torch.zeros((V, U)) for n in OUTS[:3]}
    out["rbar"] = torch.zeros((V, U, C))
    out["k_best"] = torch.zeros((V, S, U))
    pix = torch.nonzero(active.reshape(-1)).reshape(-1).tolist()
    zero = torch.zeros(())
    for p0 in range(0, len(pix), group):
        px = pix[p0:p0 + group]
        gp = len(px)
        vs = torch.tensor([p // U for p in px])
        us = torch.tensor([p % U for p in px])
        state = [dict(best=torch.tensor(-1.0), sum=torch.tensor(0.0), bd=-1,
                      rb=None, k=None) for _ in px]
        n_slots = gp * dim_d
        for w0 in range(0, n_slots, ncap):
            slots = torch.arange(w0, min(w0 + ncap, n_slots))
            if by_pixel:
                ip, idd = slots % gp, slots // gp
            else:
                ip, idd = slots // dim_d, slots % dim_d
            delta = lo + (idd.to(DTYPE) * rng) / den                  # [N]
            rows = epis[vs[ip]]                                  # [N,S,U,C]
            val, ok = _core_row_samples(rows, delta, s_hat, slope)
            n = torch.arange(len(slots))
            ucol = us[ip]
            val, ok = val[n, :, ucol][:, :, None], ok[n, :, ucol][:, :, None]
            valraw = torch.where(ok[..., None], val, zero)
            valpos = torch.where(ok[..., None], val.clamp_min(0.0), zero)
            r0 = rows[n, s_hat, ucol][:, None]                     # [N,1,C]
            num, rbar, k_last = _mean_shift(valpos, valraw, ok, r0, params)
            card = _sum_s(ok.to(DTYPE))
            score = torch.where(card > 0, num / card, zero)[:, 0]
            for p, st in enumerate(state):
                if by_pixel:
                    js = range((p - w0) % gp, len(slots), gp)
                else:
                    js = [j for j in range(len(slots))
                          if p * dim_d <= w0 + j < (p + 1) * dim_d]
                for j in js:
                    d = (w0 + j) // gp if by_pixel else w0 + j - p * dim_d
                    assert int(ip[j]) == p and int(idd[j]) == d
                    if score[j] > st["best"]:
                        st.update(best=score[j], bd=d, rb=rbar[j, 0],
                                  k=k_last[j, :, 0])
                    st["sum"] = st["sum"] + score[j]
        fd = torch.tensor(float(dim_d))
        for p, st in enumerate(state):
            v, u = int(vs[p]), int(us[p])
            out["best_score"][v, u] = st["best"]
            if st["bd"] >= 0:
                out["best_depth"][v, u] = lo + (st["bd"] * rng) / den
                out["rbar"][v, u] = st["rb"]
                out["k_best"][v, :, u] = st["k"]
            out["score_mean"][v, u] = st["sum"] / fd
    return out


@pytest.mark.parametrize("with_k", [False, True])
@pytest.mark.parametrize("C,dim_d,by_pixel",
                         [(1, 9, False), (3, 9, True), (4, 9, False),
                          (5, 9, True), (1, 130, True), (3, 130, False),
                          (4, 130, True), (5, 130, False)])
def test_row_item_layout_equals_rows_plain(C, dim_d, by_pixel, with_k):
    epis = _scene(C, V=2, U=24)
    V, S, U, _ = epis.shape
    g = np.random.default_rng(C + dim_d)
    active = torch.from_numpy(g.uniform(size=(V, U)) < 0.6)
    if int(active.sum()) % 6 == 0:          # keep the last group ragged
        active[tuple(torch.nonzero(active)[0])] = False
    params = DepthParams(slope_factor=0.5)
    # with_k also moves s_hat, so both halves of the cases differ
    s_hat = 3 if with_k else 1
    out = _emulate_rows_core(epis, -3.0, 4.0, dim_d, s_hat, params, active,
                             by_pixel)
    want = sweep_rows_plain(epis, candidate_grid(-3.0, 4.0, dim_d, "cpu"),
                            s_hat, params, with_k)
    for name in OUTS:
        assert torch.equal(out[name][active], getattr(want, name)[active]), \
            name
        assert not out[name][~active].any(), name
    if with_k:
        assert torch.equal(out["k_best"].permute(0, 2, 1)[active],
                           want.k_best.permute(0, 2, 1)[active])
