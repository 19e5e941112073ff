"""The four-band configuration ``skysat_lr18_4band`` and the readers of
the row and the tile sweep.  The configuration is held against
SkysatLR18's.  A copy of it at a test size (the cell tiny.4band, 9 x 44 x
600 x 4, D=9: three levels, the coarser two of three and two tiles a row)
is added to a copy of the benchmark as files and entries and runs on the
CPU, where its replay counts both sweeps' operations.  The readers are
held against a made-up trace.  The card cases are marked ``cuda`` and
skip without a card (decided inside each test)."""

import io
import json
from pathlib import Path

import pytest
import torch

from benchmark import counts, harness, scenes, tracing
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.models import depth2d
from remotesensingproject_tpu_torch.utils import profiling

from .conftest import ROOT, make_copy
from .test_benchmark_cuda import need_card
from .test_benchmark_run import run_tiny
from .test_benchmark_tracing import MEDIAN, SWEEP

CELL = "skysat_lr18_4band.edge_d120"
TINY_CELL = "tiny.4band"
ROUTE_METRICS = ("sweep_rows.device_ms", "sweep_rows_roofline",
                 "sweep_tiles.device_ms", "sweep_tiles_roofline")


def _kernel(rule):
    return ("void (anonymous namespace)::sweep_pc_kernel<4, (anonymous "
            f"namespace)::{rule}>((anonymous namespace)::PcArgs)")


ROW, TILE = _kernel("PcRuleRow"), _kernel("PcRulePixel")


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json")
                      .read_text())


def add_band_cell(root: Path) -> Path:
    """The configuration tiny_skysat_lr18_4band (the four-band file at 9 x
    44 x 600, one scene) and the cell tiny.4band (D=9, edge score) added to
    a copy made by ``make_copy``, in every metric list that names the
    four-band cell."""
    here = root / "benchmark"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = _config("skysat_lr18_4band")
    conf.update(name="tiny_skysat_lr18_4band", S=9, V=44, U=600,
                scene_seeds=[0])
    (here / "configs" / "tiny_skysat_lr18_4band.json").write_text(
        json.dumps(conf))
    (here / "traffic" / "tiny_d9.json").write_text(json.dumps(
        {"D": 9, "params": {"score_version": "edge"}}))
    bench["configs"].append({
        "name": "tiny_skysat_lr18_4band", "source": conf["source"],
        "file": "benchmark/configs/tiny_skysat_lr18_4band.json",
        "reduced": ["S", "V", "U", "scene_seeds"], "why": "a test size"})
    bench["workloads"].append({"name": TINY_CELL,
                               "config": "tiny_skysat_lr18_4band",
                               "traffic": "tiny_d9", "chips": 1,
                               "why": "a test size"})
    for m in bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="module")
def band_root(tmp_path_factory) -> Path:
    return add_band_cell(make_copy(tmp_path_factory.mktemp("bench_4band")))


def test_configuration_is_skysat_lr18_at_four_bands():
    conf, lr = _config("skysat_lr18_4band"), _config("skysat_lr18")
    for key in ("S", "V", "U", "dtype", "dmin", "dmax", "scene_seeds"):
        assert conf[key] == lr[key], key
    assert (conf["C"], lr["C"]) == (4, 1)
    assert conf["scene"] == "synthetic_sequence_bands"
    assert "anchor_seed0" not in conf
    assert conf["assumed"]["scene"].startswith("synthetic")
    assert "made up" in conf["assumed"]["band_gains"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"]
                 if c["name"] == "skysat_lr18_4band")
    assert entry["reduced"] == [] and entry["source"] == conf["source"]
    assert len(conf["source"]) <= 200
    cell = harness.load_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.traffic == json.loads(
        (ROOT / "benchmark" / "traffic" / "edge_d120.json").read_text())
    names = {m["name"] for m, _ in cell.per_layer}
    assert set(ROUTE_METRICS) <= names
    assert not {n for n in names if n.startswith("sweep_pixel")}


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 3])
def test_configuration_draws_the_bands_scene(seed):
    conf = dict(_config("skysat_lr18_4band"), S=6, V=5, U=40)
    vol, gt = scenes.make_scene(conf, seed, "cpu")
    want, want_gt = scenes.synthetic_sequence_bands(6, 5, 40, seed, -1.0,
                                                    4.0, "cpu")
    assert vol.shape == (5, 6, 40, 4) and vol.dtype == torch.float32
    assert torch.equal(vol, want) and (gt == want_gt).all()


def _trace(kernels, counters=None):
    return tracing.Trace(scenes=2, walls=[1.0, 1.0], window_s=2.0,
                         busy_s=0.1, kernels=kernels, idle_gaps=[],
                         device_ops=[], passes=[3, 3],
                         counters=counters or {})


def _reader(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                               name.replace(".", "_"))


def test_readers_take_their_own_routes_kernels():
    K = tracing.Kernel
    kernels = [
        K(ROW, 1e-3, ("Depth2DComputer.run", "depth2d.sweep_pile_rows")),
        K(TILE, 2e-3, ("Depth2DComputer.run", "depth2d.sweep_pile_tiles")),
        K(SWEEP, 4e-3, ("Depth2DComputer.run", "depth2d.sweep_pile_pixel")),
        K(ROW, 8e-3, ("depth2d.sweep_pile_tiles",)),
        K(TILE, 16e-3, ("depth2d.sweep_pile_rows",)),
        K(MEDIAN, 32e-3, ("depth2d.sweep_pile_tiles",)),
        K(ROW, 64e-3, ()),
    ]
    flops = {"sweep_rows.flops": 3.35e8, "sweep_tiles.flops": 6.7e8,
             "sweep_pixel.flops": 1.34e9}
    tr = _trace(kernels, flops)
    ms = {n: _reader(n).read(tr, None)
          for n in ("sweep_rows.device_ms", "sweep_tiles.device_ms",
                    "sweep_pixel.device_ms")}
    assert ms == pytest.approx({"sweep_rows.device_ms": 0.5,
                                "sweep_tiles.device_ms": 1.0,
                                "sweep_pixel.device_ms": 2.0})
    for name, route in (("sweep_rows", "sweep_rows"),
                        ("sweep_tiles", "sweep_tiles"),
                        ("sweep_pixel", "sweep_pixel")):
        want = 100 * flops[f"{route}.flops"] / counts.PEAK_FP32 / (
            ms[f"{name}.device_ms"] * 1e-3)
        got = _reader(f"{name}_roofline").read(tr, None)
        assert got == pytest.approx(want) and 0 < got <= 100
    # the pixel sweep's kernels alone: the route readers find nothing
    tr = _trace(kernels[2:3], flops)
    for name in ROUTE_METRICS:
        assert _reader(name).read(tr, None) is None, name
    # nor without their counter
    tr = _trace(kernels)
    for name in ("sweep_rows_roofline", "sweep_tiles_roofline"):
        assert _reader(name).read(tr, None) is None, name


def test_tiny_band_cell_is_correct_and_counts_both_sweeps(band_root):
    rec = run_tiny(band_root, TINY_CELL, seed=2 ** 31 + 17)
    assert rec["correct"], rec["checks"]
    assert all(c["value"] == 0.0 for c in rec["checks"].values())
    cell = harness.load_cell(band_root, TINY_CELL)
    vol, _ = scenes.make_scene(cell.config, 0, "cpu")
    run_scene = harness.make_pipeline(cell, [vol], torch.device("cpu"))
    totals = {}
    with harness.counter_patches(cell, totals):
        run_scene(0)
    per_sample = counts.MEAN_SHIFT_STEPS * counts.flops_per_sample_step(4)
    for name in ("sweep_rows.flops", "sweep_tiles.flops"):
        assert totals[name] > 0 and totals[name] % per_sample == 0, name
    assert "sweep_pixel.flops" not in totals       # not in the cell


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.cuda
def test_route_counts_are_the_kernels_work_on_the_card(band_root, steps):
    """One C=4 pass through ``sweep_pass`` by each route, with the counters
    of the rooflines and of the program (``sweep.sample_steps``, the
    kernel's valid samples x mean-shift steps run).  The readers count the
    steps the parameters fix, each item all of them; the kernel ends an
    item's mean shift at a fixed point of r_bar (later steps would repeat
    it bit for bit).  With one step the two agree to the sample; with ten
    the kernel runs no more than counted."""
    need_card()
    dev = torch.device("cuda")
    cell = harness.load_cell(band_root, TINY_CELL)
    c = cell.config
    vol, _ = scenes.make_scene(c, 5, dev)
    V, S, U, C = vol.shape
    g = torch.Generator().manual_seed(7)
    active = (torch.rand((V, U), generator=g) < 0.4).to(dev)
    lo = (torch.rand((V, U), generator=g) * 3.0 - 1.0).to(dev)
    hi = lo + (torch.rand((V, U), generator=g) * 2.0).to(dev)
    params = DepthParams(mean_shift_max_iter=steps)
    bounds = (c["dmin"], c["dmax"])
    per_sample = counts.MEAN_SHIFT_STEPS * counts.flops_per_sample_step(C)
    for name, edited in (("sweep_rows.flops", None), ("sweep_tiles.flops",
                                                      (lo, hi))):
        totals = {}
        profiling.reset()
        with harness.counter_patches(cell, totals), profiling.tracing():
            depth2d.sweep_pass(vol, active, S // 2, 9, params, bounds,
                               *(edited or ()))
        samples = totals[name] / per_sample
        work = profiling.counters()["sweep.sample_steps"]
        if steps == 1:
            assert work == samples > 0, name
        else:
            assert samples < work <= samples * steps, name
    profiling.reset()


@pytest.mark.cuda
def test_tiny_band_traced_run_on_the_card(band_root):
    need_card()
    rec = harness.run_cell(band_root, TINY_CELL, 21, 0.01, True, "cuda",
                           out=io.StringIO())
    assert rec["correct"], rec["checks"]
    for name in ROUTE_METRICS + ("median.device_ms", "paint.device_ms",
                                 "device.idle_pct", "pyramid.device_ms"):
        assert name in rec["metrics"], name
    for name in ("sweep_rows_roofline", "sweep_tiles_roofline"):
        assert 0 < rec["metrics"][name]["value"] <= 100, name
    assert not [n for n in rec["metrics"] if n.startswith("sweep_pixel")]
