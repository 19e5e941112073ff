"""The harness on the card at a test size: the trace places every kernel
and reads every per-layer metric, and the control fails.  Marked ``cuda``;
skips without a card (decided inside each test)."""

import io

import pytest
import torch

from benchmark import harness

from .test_benchmark_check import tiny_check


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tiny.edge", "tiny.line", "tiny.rgb"])
def test_traced_run_on_the_card(tiny_root, workload):
    need_card()
    rec = harness.run_cell(tiny_root, workload, 21, 0.01, True, "cuda",
                           out=io.StringIO())
    assert rec["correct"], rec["checks"]
    for name in ("device.idle_pct", "torch_ops.device_ms",
                 "sweep_pixel.device_ms", "sweep_pixel_roofline",
                 "median.device_ms", "median_roofline",
                 "paint.device_ms"):
        assert name in rec["metrics"], name
    assert 0 < rec["metrics"]["sweep_pixel_roofline"]["value"] <= 100
    assert 0 < rec["device"]["busy_s"] <= rec["device"]["window_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tiny.edge", "tiny.rgb"])
def test_control_fails_on_the_card(tiny_root, workload):
    need_card()
    cell, chk = tiny_check(tiny_root, workload, 23, control=True,
                           device="cuda")
    assert all(v == 0.0 for v in chk.readings.values()), chk.readings
    assert [n for n, v in chk.control_readings.items()
            if v > cell.limits[n]]
