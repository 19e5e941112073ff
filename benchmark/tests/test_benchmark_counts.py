"""The benchmark's operation and byte counts against hand counts."""

import numpy as np
import pytest
import torch

from benchmark import counts

F = np.float32


def hand_valid(active, S, s_hat, D, lo, hi, slope, interpolation):
    """Valid samples by loops over pixels, candidates and frames, in
    numpy float32 with the reference's order of operations."""
    V, U = active.shape
    n = 0
    for v in range(V):
        for u in range(U):
            if not active[v, u]:
                continue
            a, b = F(lo[v, u]), F(hi[v, u])
            for d in range(D):
                delta = F(a + F(F(F(b - a) * F(d)) / F(D - 1)))
                for s in range(S):
                    idx = F(F(u) + F(F(F(s_hat - s) * delta) * F(slope)))
                    if interpolation == "nearest":
                        r = np.sign(idx) * np.floor(abs(idx) + F(0.5))
                        n += 0 <= r <= U - 1
                    else:
                        n += np.floor(idx) >= 0 and np.ceil(idx) <= U - 1
    return n


@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("interpolation", ["linear", "nearest"])
def test_sweep_count_matches_a_hand_count(per_pixel, C, interpolation):
    rng = np.random.default_rng(3)
    V, U, S, D, s_hat, slope = 3, 17, 9, 7, 4, 0.5
    active = rng.random((V, U)) < 0.6
    if per_pixel:
        lo = rng.uniform(-1.5, 1.0, (V, U)).astype(F)
        hi = (lo + rng.uniform(0.0, 3.0, (V, U))).astype(F)
    else:
        lo = np.full((V, U), F(-1.0))
        hi = np.full((V, U), F(4.0))
    want = hand_valid(active, S, s_hat, D, lo, hi, slope, interpolation)
    got = counts.sweep_valid_samples(
        torch.as_tensor(active), S, s_hat, D, -1.0, 4.0, slope,
        interpolation, torch.as_tensor(lo) if per_pixel else None,
        torch.as_tensor(hi) if per_pixel else None, chunk=5)
    assert got == want
    steps = counts.mean_shift_steps(False, interpolation)
    assert counts.sweep_flops(got, steps, C) == want * 10 * (4 * C + 5)


def test_mean_shift_steps():
    assert counts.mean_shift_steps(False, "linear") == 10
    assert counts.mean_shift_steps(True, "linear") == 5
    assert counts.mean_shift_steps(True, "nearest") == 10


@pytest.mark.parametrize("V,U,C", [(540, 960, 1), (720, 1146, 3), (17, 30, 4)])
def test_median_bytes_from_shapes(V, U, C):
    src, mask, frame, out = V * U * 4, V * U * 1, V * U * C * 4, V * U * 4
    assert counts.median_bytes(V, U, C) == src + mask + frame + out


def test_roofline_needs_device_time():
    assert counts.roofline_pct(1.0, 0.0) is None
    assert counts.roofline_pct(0.25, 1.0) == 25.0


def _active(rng, V, U):
    active = torch.as_tensor(rng.random((V, U)) < 0.5)
    active[0, :140] = False
    return active


@pytest.mark.parametrize("slope", [1.0, 0.5625])
def test_row_count_is_the_plain_row_sweeps_valid_samples(slope):
    from remotesensingproject_tpu_torch.ops.sweep_pallas import (
        _row_samples, candidate_grid)
    rng = np.random.default_rng(5)
    V, U, S, D, s_hat = 3, 300, 9, 13, 4
    active = _active(rng, V, U)
    dvec = candidate_grid(-1.0, 4.0, D, "cpu")
    ds = float(s_hat) - torch.arange(S, dtype=torch.float32)
    u = torch.arange(U)[None, :]
    want = 0
    for d in range(D):
        _, valid = _row_samples(torch.zeros((1, S, U, 1)), dvec[d], ds, u,
                                counts.f32(slope))
        want += int((valid[None] & active[:, None, :]).sum())
    got = counts.row_valid_samples(active, S, s_hat, D, -1.0, 4.0, slope)
    assert got == want
    # the row rule's count is the pixel rule's up to rounding, not always
    # to the sample
    near = counts.sweep_valid_samples(active, S, s_hat, D, -1.0, 4.0, slope,
                                      "linear")
    assert abs(got - near) <= 0.001 * got


@pytest.mark.parametrize("interpolation", ["linear", "nearest"])
def test_tile_count_is_the_plain_masked_sweeps_allowed_samples(
        interpolation):
    from remotesensingproject_tpu_torch.ops.sweep import _radiances
    from remotesensingproject_tpu_torch.ops.sweep_pallas_perpixel import \
        tile_quantized_bounds
    rng = np.random.default_rng(6)
    V, U, S, D, s_hat, slope = 3, 300, 9, 13, 4, 0.5
    active = _active(rng, V, U)
    lo = torch.as_tensor(rng.uniform(-1.0, 2.0, (V, U)).astype(F))
    hi = lo + torch.as_tensor(rng.uniform(0.0, 2.0, (V, U)).astype(F))
    glo, ghi = tile_quantized_bounds(active, lo, hi, (-1.0, 4.0))
    # sweep_pile's masked mode, candidate by candidate
    drange = ghi - glo
    den = torch.full_like(drange, float(D - 1))
    tol = drange / den
    ds = float(s_hat) - torch.arange(S, dtype=torch.float32)
    u = torch.arange(U, dtype=torch.float32)
    epis = torch.zeros((V, S, U, 1))
    want = every = 0
    for d in range(D):
        delta = glo + (drange * float(d)) / den
        _, _, valid = _radiances(epis, delta, ds, u, counts.f32(slope),
                                 interpolation)
        allowed = (delta >= lo - tol) & (delta <= hi + tol) & active
        want += int((valid & allowed[:, None, :]).sum())
        every += int((valid & active[:, None, :]).sum())
    got = counts.sweep_valid_samples(active, S, s_hat, D, -1.0, 4.0, slope,
                                     interpolation, glo, ghi, chunk=100,
                                     pdmin_v_u=lo, pdmax_v_u=hi)
    assert got == want < every
    assert counts.sweep_valid_samples(active, S, s_hat, D, -1.0, 4.0, slope,
                                      interpolation, glo, ghi) == every
