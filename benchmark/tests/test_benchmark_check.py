"""The check that decides ``correct``: sound runs read nothing, the
control and planted faults come out not correct."""

import io

import pytest
import torch

from benchmark import check, harness, scenes

D2 = "remotesensingproject_tpu_torch.models.depth2d"


def tiny_check(root, workload, seed, control=False, device="cpu"):
    cell = harness.load_cell(root, workload)
    dev = torch.device(device)
    vol, _ = scenes.make_scene(cell.config, seed, dev)
    run_scene = harness.make_pipeline(cell, [vol], dev)
    fused, valid, passes = run_scene(0)
    return cell, check.run_check(harness.check_scene(cell, vol),
                                 lambda: run_scene(0), passes, seed, fused,
                                 valid, control=control)


@pytest.mark.parametrize("workload", ["tiny.edge", "tiny.line", "tiny.rgb"])
def test_control_fails_and_program_reads_nothing(tiny_root, workload):
    cell, chk = tiny_check(tiny_root, workload, 11, control=True)
    assert chk.checked_passes >= 3
    assert all(v == 0.0 for v in chk.readings.values()), chk.readings
    over = [n for n, v in chk.control_readings.items()
            if v > cell.limits[n]]
    assert over, chk.control_readings


def _state_unchanged(orig):
    def pass_fn(epis, frames, state, s_hat, **kw):
        return state
    return pass_fn


def _half_batch(orig):
    """The sweep leaves every other column of the pass out: the kernel's
    zeroed outputs stay there."""
    def sweep(*a, **k):
        res = orig(*a, **k)
        drop = torch.zeros_like(res.best_depth, dtype=torch.bool)
        drop[:, 1::2] = True
        zero = torch.zeros(())
        return res._replace(
            best_score=torch.where(drop, zero, res.best_score),
            score_mean=torch.where(drop, zero, res.score_mean),
            best_depth=torch.where(drop, zero, res.best_depth),
            rbar=torch.where(drop[..., None], zero, res.rbar))
    return sweep


def _altered_depth(orig):
    """Every seventh column's pick moved to the next candidate."""
    def sweep(epis, dmin, dmax, dim_d, *a, **k):
        res = orig(epis, dmin, dmax, dim_d, *a, **k)
        depth = res.best_depth.clone()
        depth[:, ::7] += (dmax - dmin) / (dim_d - 1)
        return res._replace(best_depth=depth)
    return sweep


def _altered_median(orig):
    def median(*a, **k):
        out = orig(*a, **k).clone()
        out[::3, ::5] += 0.25
        return out
    return median


FAULTS = {
    "state_unchanged": (f"{D2}:_pass_fn", _state_unchanged),
    "half_batch": (f"{D2}:sweep_pile_pixel", _half_batch),
    "altered_depth": (f"{D2}:sweep_pile_pixel", _altered_depth),
    "altered_median": (f"{D2}:selective_median_cuda", _altered_median),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_underneath_is_not_correct(tiny_root, fault):
    from benchmark.hooks import Patches
    target, make = FAULTS[fault]
    with Patches() as p:
        assert p.wrap(target, make)
        rec = harness.run_cell(tiny_root, "tiny.edge", 13, 0.01, False,
                               "cpu", out=io.StringIO())
    assert rec["correct"] is False, rec["checks"]
    assert rec["failed"] == rec["attempted"]


def test_differs_tolerates_rounding_only():
    a = torch.tensor([1.0, 1.0, float("nan"), 0.0, 2.0])
    b = torch.tensor([1.0 + 1e-7, 1.01, float("nan"), 1e-8, 2.0])
    assert check.differs(a, b).tolist() == [False, True, False, False, False]
