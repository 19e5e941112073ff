"""The port's benchmark (``remotesensingproject_tpu_torch/bench.py``)
against the repository's ``bench.py`` (the JAX package's), on the CPU.

The scenes are bench.py's bit for bit (volume and ground truth, JAX on the
CPU), at bench.py's BENCH_SMALL sizes and at a small size with the HR
range; the edge mask of the gate equals bench.py's; the gates and exit
codes follow bench.py's on made-up errors; ``main`` runs end to end on the
CPU at a tiny size and prints one record with bench.py's keys."""

import dataclasses
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import bench as jbench
from remotesensingproject_tpu.config import DEFAULT_PARAMS as J_PARAMS
from remotesensingproject_tpu_torch import bench
from remotesensingproject_tpu_torch.config import DEFAULT_PARAMS
from remotesensingproject_tpu_torch.models.fine_to_coarse import FineToCoarse

#: the keys of bench.py's record (its optional ``cold_spread``, the TPU's
#: process-to-process spread, is not printed beside the card's numbers)
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "cold_s",
               "steadystate_s", "compile_s", "quality_rmse_px",
               "quality_p50_px", "quality_p90_px", "quality_ref_rmse_px",
               "quality_ok", "cold_ok"}


@pytest.mark.parametrize("S,V,U,dmin,dmax", [
    (24, 128, 256, -1.0, 4.0),   # BENCH_SMALL
    (12, 32, 384, -2.0, 8.0),    # the HR range
])
def test_scene_equals_bench_py(S, V, U, dmin, dmax):
    want, want_gt = jbench.synthetic_sequence(S, V, U, dmin=dmin, dmax=dmax)
    got, got_gt = bench.synthetic_sequence(S, V, U, dmin=dmin, dmax=dmax,
                                           device="cpu")
    assert got.dtype == torch.float32 and got.shape == (V, S, U, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_gt, want_gt)
    assert got_gt.dtype == want_gt.dtype


@pytest.mark.parametrize("S,V,U", [(24, 128, 256), (10, 24, 300)])
def test_rgb_scene_equals_bench_py(S, V, U):
    """uint8 after round half to even of two roundings (multiply, add), as
    XLA computes it on the CPU."""
    want, want_gt = jbench.synthetic_sequence_rgb(S, V, U)
    got, got_gt = bench.synthetic_sequence_rgb(S, V, U, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (V, S, U, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_gt, want_gt)


@pytest.mark.parametrize("rgb", [False, True])
def test_edge_mask_equals_bench_py(rgb):
    S, V, U = 24, 128, 256
    make = bench.synthetic_sequence_rgb if rgb else bench.synthetic_sequence
    vol, _ = make(S, V, U, device="cpu")
    got = bench.edge_mask(vol, DEFAULT_PARAMS)
    want = jbench.edge_mask(vol.numpy(), J_PARAMS)
    assert got.shape == want.shape == (S, V, U)
    np.testing.assert_array_equal(got.numpy(), want)


def test_error_stats_match_numpy():
    rng = np.random.default_rng(3)
    fused = rng.normal(0, 2, (6, 8, 40)).astype(np.float32)
    gt = rng.normal(0, 2, (6, 40)).astype(np.float32)
    mask = rng.random((6, 8, 40)) < 0.7
    rmse, p50, p90, cover = bench.error_stats(
        torch.from_numpy(fused), gt, torch.from_numpy(mask))
    err = np.abs(fused - np.broadcast_to(gt[:, None], fused.shape))[mask]
    assert rmse == pytest.approx(float(np.sqrt(np.mean(err ** 2))),
                                 rel=1e-6)
    for got, q in ((p50, 50), (p90, 90)):
        assert got == pytest.approx(float(np.percentile(err, q)), abs=1e-6)
    assert cover == pytest.approx(mask.mean())
    assert all(np.isnan(bench.error_stats(
        torch.from_numpy(fused), gt, torch.zeros(mask.shape,
                                                 dtype=torch.bool))[:3]))


ANCHOR = {"rmse_px": 1.4181, "p90_px": 3.4468}


@pytest.mark.parametrize("score,ref,errors,ok", [
    # edge: RMSE and P90 each within 0.1 px of the anchor
    ("edge", ANCHOR, (1.5180, 0.9, 3.5467), True),
    ("edge", ANCHOR, (1.5182, 0.0, 3.0), False),
    ("edge", ANCHOR, (1.0, 0.0, 3.5469), False),
    # disp and line: RMSE within 0.5 px, P90 not gated
    ("disp", ANCHOR, (1.9180, 0.9, 9.0), True),
    ("line", ANCHOR, (1.9182, 0.0, 3.0), False),
    # no anchor: P50 <= 0.5 px
    ("edge", None, (9.0, 0.5, 9.0), True),
    ("disp", None, (0.1, 0.5001, 0.1), False),
])
def test_quality_gate(score, ref, errors, ok):
    rmse, p50, p90 = errors
    assert bench.quality_ok(score, ref, rmse, p50, p90) is ok


@pytest.mark.parametrize("quality,cold,small,code", [
    (True, True, False, 0), (True, False, False, 1), (True, False, True, 0),
    (False, True, False, 1), (False, True, True, 1)])
def test_exit_code(quality, cold, small, code):
    assert bench.exit_code({"quality_ok": quality, "cold_ok": cold},
                           small) == code


@pytest.mark.parametrize("env,metric,key,shape,baseline", [
    ({}, "skysatLR18_synthetic_end_to_end_throughput", "100x540x960x120",
     (100, 540, 960, 120, -1.0, 4.0), 448.0),
    ({"BENCH_D240": "1"}, "skysatLR18_240_synthetic_end_to_end_throughput",
     "100x540x960x240", (100, 540, 960, 240, -1.0, 4.0), 804.0),
    ({"BENCH_HR": "1"}, "skysatHR18_synthetic_end_to_end_throughput",
     "100x1080x1920x120", (100, 1080, 1920, 120, -2.0, 8.0), 1714.0),
    ({"BENCH_RGB": "1"}, "mansionLR_synthetic_rgb_end_to_end_throughput",
     "100x720x1146x120rgb", (100, 720, 1146, 120, 0.0, 4.0), 7409.0),
    ({"BENCH_SCORE": "disp"},
     "skysatLR18_synthetic_end_to_end_throughput_disp", "100x540x960x120",
     (100, 540, 960, 120, -1.0, 4.0), 1462.0),
    ({"BENCH_HR": "1", "BENCH_SCORE": "line", "BENCH_FAST": "1"},
     "skysatHR18_synthetic_end_to_end_throughput_line_fast",
     "100x1080x1920x120", (100, 1080, 1920, 120, -2.0, 8.0), 1714.0),
    ({"BENCH_RGB": "1", "BENCH_SMALL": "1"},
     "mansionLR_synthetic_rgb_end_to_end_throughput", "24x128x256x32rgb",
     (24, 128, 256, 32, 0.0, 4.0), 7409.0 * 24 * 128 * 256 / 82512000),
])
def test_config_is_bench_py(env, metric, key, shape, baseline):
    """bench.py's configurations: each scene's anchor exists, and the
    metric, sizes, range, baseline and params follow its variables."""
    cfg = bench.bench_config(env)
    assert cfg.metric == metric and cfg.anchor_key == key
    assert (cfg.S, cfg.V, cfg.U, cfg.D, cfg.dmin, cfg.dmax) == shape
    assert cfg.baseline_s == pytest.approx(baseline)
    assert cfg.params == dataclasses.replace(
        DEFAULT_PARAMS, score_version=env.get("BENCH_SCORE", "edge"),
        fast="BENCH_FAST" in env)
    assert bench.reference_anchor(key) is not None


def test_main_runs_on_cpu(capsys):
    """``main`` at a tiny size on the CPU: one JSON line with bench.py's
    keys and the card, cold and warm runs, the warm run's fused map that
    of a FineToCoarse run on the scene, and the no-anchor gate."""
    env = {"BENCH_SMALL": "1"}
    shape = (8, 24, 64, 8)
    run = bench.main(env, device="cpu", shape=shape)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    assert set(rec) == RECORD_KEYS | {"card"} and rec["card"] == "cpu"
    assert rec == run.record
    assert rec["metric"] == "skysatLR18_synthetic_end_to_end_throughput"
    assert rec["quality_ref_rmse_px"] is None
    assert rec["quality_ok"] == (rec["quality_p50_px"] <= 0.5)
    assert rec["cold_s"] > 0 and rec["steadystate_s"] > 0
    vol, gt = bench.synthetic_sequence(8, 24, 64, device="cpu")
    f = FineToCoarse(vol, -1.0, 4.0, 8, device="cpu")
    f.run()
    fused, _ = f.get_results()
    assert run.levels == len(f.computers) == 2
    assert torch.equal(run.fused, fused)
    want = bench.error_stats(fused, gt, bench.edge_mask(vol, DEFAULT_PARAMS))
    assert [rec[k] for k in ("quality_rmse_px", "quality_p50_px",
                             "quality_p90_px")] == list(want[:3])


def test_main_exits_1_on_a_failed_gate(monkeypatch):
    """The record is printed before a failed gate exits 1 (bench.py)."""
    monkeypatch.setattr(bench, "quality_ok", lambda *a: False)
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(SystemExit) as e:
        bench.main({"BENCH_SMALL": "1", "BENCH_COLD_ONLY": "1"},
                   device="cpu", shape=(6, 16, 48, 5))
    assert e.value.code == 1
    rec = json.loads(buf.getvalue())
    assert rec["quality_ok"] is False
    assert rec["cold_s"] == rec["steadystate_s"]

