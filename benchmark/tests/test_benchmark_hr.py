"""SkysatHR18 at a test size: the cell tiny.hr (8 x 24 x 48, D=16) keeps
the configuration's d in [-2, 8], so a line reaches 32 of 48 columns.  It
is added to a copy of the benchmark as files and entries, beside the
cells of ``conftest.make_copy``.  The scene generator is held against the
port's ``bench`` HR scene, and the ``pyramid.device_ms`` reader against a
made-up trace.  The card cases are marked ``cuda`` and skip without a
card (decided inside each test)."""

import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, scenes, tracing
from remotesensingproject_tpu_torch import bench

from .conftest import ROOT, TINY, make_copy
from .test_benchmark_check import tiny_check
from .test_benchmark_cuda import need_card
from .test_benchmark_run import KEYS, run_tiny
from .test_benchmark_tracing import SWEEP

CELL = "tiny.hr"


def add_hr_cell(root: Path) -> Path:
    """The configuration tiny_skysat_hr18 and the cell tiny.hr (the
    copy's tiny_edge traffic) added to a copy made by ``make_copy``."""
    here = root / "benchmark"
    bench_json = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((here / "configs" / "skysat_hr18.json").read_text())
    conf.update(name="tiny_skysat_hr18", **TINY)
    (here / "configs" / "tiny_skysat_hr18.json").write_text(json.dumps(conf))
    bench_json["configs"].append({
        "name": "tiny_skysat_hr18", "source": conf["source"],
        "file": "benchmark/configs/tiny_skysat_hr18.json",
        "reduced": ["S", "V", "U", "scene_seeds"], "why": "a test size"})
    bench_json["workloads"].append({"name": CELL,
                                    "config": "tiny_skysat_hr18",
                                    "traffic": "tiny_edge", "chips": 1,
                                    "why": "a test size"})
    for m in bench_json["per_layer"]:
        if "workloads" in m and m["name"] != "extra.scenes":
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json, indent=1))
    return root


@pytest.fixture(scope="module")
def hr_root(tmp_path_factory) -> Path:
    return add_hr_cell(make_copy(tmp_path_factory.mktemp("bench_hr")))


def test_tiny_hr_cell_keeps_the_range_and_prints_one_correct_record(hr_root):
    cell = harness.load_cell(hr_root, CELL)
    assert (cell.config["dmin"], cell.config["dmax"]) == (-2.0, 8.0)
    rec = run_tiny(hr_root, CELL)
    assert all(k in rec for k in KEYS)
    assert list(rec)[-1] == "checks"
    assert rec["correct"], rec["checks"]
    assert rec["attempted"] >= 1 and rec["failed"] == 0
    assert set(rec["metrics"]) == {"mpix_per_s", "setup_s"}
    assert rec["metrics"]["mpix_per_s"]["value"] > 0


def test_tiny_hr_control_fails_and_program_reads_nothing(hr_root):
    cell, chk = tiny_check(hr_root, CELL, 11, control=True)
    assert chk.checked_passes >= 3
    assert all(v == 0.0 for v in chk.readings.values()), chk.readings
    assert [n for n, v in chk.control_readings.items()
            if v > cell.limits[n]]


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_hr_scene_is_the_ports_bench_hr(seed):
    conf = json.loads((ROOT / "benchmark" / "configs" / "skysat_hr18.json")
                      .read_text())
    cfg = bench.bench_config({"BENCH_HR": "1"}, shape=(12, 10, 40, 16))
    assert (conf["dmin"], conf["dmax"]) == (cfg.dmin, cfg.dmax)
    vol, gt = scenes.make_scene(dict(conf, S=12, V=10, U=40), seed, "cpu")
    want, want_gt = bench.synthetic_sequence(cfg.S, cfg.V, cfg.U, seed=seed,
                                             dmin=cfg.dmin, dmax=cfg.dmax,
                                             device="cpu")
    assert torch.equal(vol, want) and np.array_equal(gt, want_gt)


def test_pyramid_reader_counts_the_pyramid_spans_only():
    mod = harness.load_module(
        ROOT / "benchmark" / "metrics" / "pyramid.device_ms.py", "pyramid")
    K = tracing.Kernel
    kernels = [
        K("down", 1e-3, ("pyramid.downsample_epis",)),
        K("bounds", 2e-3, ("Depth2DComputer.run",
                           "pyramid.bounds_from_parent")),
        K("fuse", 4e-3, ("FineToCoarse.get_results",
                         "pyramid.fuse_disp_maps")),
        K(SWEEP, 8e-3, ("Depth2DComputer.run", "depth2d.sweep_pile_pixel")),
        K("merge", 16e-3, ("depth2d._pass_fn",)),
        K("unplaced", 32e-3, ()),
    ]
    tr = tracing.Trace(scenes=2, walls=[1.0, 1.0], window_s=2.0, busy_s=0.1,
                       kernels=kernels, idle_gaps=[], device_ops=[],
                       passes=[3, 3])
    assert mod.read(tr, None) == pytest.approx(1e3 * 7e-3 / 2)
    tr.kernels = kernels[3:]
    assert mod.read(tr, None) is None
    tr.kernels = []
    assert mod.read(tr, None) is None


@pytest.mark.cuda
def test_tiny_hr_traced_run_on_the_card(hr_root):
    need_card()
    rec = harness.run_cell(hr_root, CELL, 21, 0.01, True, "cuda",
                           out=io.StringIO())
    assert rec["correct"], rec["checks"]
    for name in ("device.idle_pct", "torch_ops.device_ms",
                 "sweep_pixel.device_ms", "sweep_pixel_roofline",
                 "median.device_ms", "median_roofline",
                 "paint.device_ms", "pyramid.device_ms"):
        assert name in rec["metrics"], name
    assert 0 < rec["metrics"]["sweep_pixel_roofline"]["value"] <= 100
    assert 0 < rec["device"]["busy_s"] <= rec["device"]["window_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tiny.edge", "tiny.line", "tiny.rgb"])
def test_pyramid_reads_in_every_tiny_cell_on_the_card(hr_root, workload):
    need_card()
    rec = harness.run_cell(hr_root, workload, 21, 0.01, True, "cuda",
                           out=io.StringIO())
    assert rec["correct"], rec["checks"]
    assert rec["metrics"]["pyramid.device_ms"]["value"] > 0


@pytest.mark.cuda
def test_tiny_hr_control_fails_on_the_card(hr_root):
    need_card()
    cell, chk = tiny_check(hr_root, CELL, 23, control=True, device="cuda")
    assert all(v == 0.0 for v in chk.readings.values()), chk.readings
    assert [n for n, v in chk.control_readings.items()
            if v > cell.limits[n]]
