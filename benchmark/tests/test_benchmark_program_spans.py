"""The program's own spans (``rslf/<name>``, opened by the port's
``utils/profiling.py`` while its tracing is on) in a trace, on events made
up for the test: every per-layer metric reads what it reads without them,
whether the reduction keeps them as spans or not, and the device's busy
time does not count their copies on the device timeline."""

import json

import pytest

from benchmark import harness, tracing

from .conftest import ROOT
from .test_benchmark_tracing import CPU, CUDA, Ev, events

ACCEPTED = {"depth2d._pass_fn", "depth2d.sweep_pile_pixel"}
PROGRAM = {"rslf/depth2d.pass", "rslf/sweep.launch", "rslf/pass.merge"}


class Annotation(Ev):
    """A span's copy on the device timeline, as Kineto gives it."""

    def activity_type(self):
        return "gpu_user_annotation"


def program_events():
    return events() + [
        Ev("rslf/depth2d.pass", CPU, 60, 590, corr=90),
        Ev("rslf/sweep.launch", CPU, 140, 170, corr=91),
        Ev("rslf/pass.merge", CPU, 380, 545, corr=92),
        Annotation("rslf/depth2d.pass", CUDA, 200, 560, corr=90),
        Annotation("rslf/sweep.launch", CUDA, 200, 400, corr=91),
    ]


def readers():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [(m["name"], harness.load_module(
        ROOT / "benchmark" / "metrics" / f"{m['name']}.py",
        f"program_spans_{i}")) for i, m in enumerate(bench["per_layer"])]


@pytest.mark.parametrize("kept", [False, True])
def test_program_spans_move_no_reading(kept):
    base = tracing.reduce_events(events(), ACCEPTED, [3])
    names = ACCEPTED | PROGRAM if kept else ACCEPTED
    got = tracing.reduce_events(program_events(), names, [3])
    assert got.busy_s == base.busy_s
    assert got.window_s == base.window_s
    assert got.device_ops == base.device_ops
    assert (got.by_runtime, got.unplaced) == (base.by_runtime, base.unplaced)
    assert [k.name for k in got.kernels] == [k.name for k in base.kernels]
    counters = {"sweep_pixel.flops": 1e6, "median.bytes": 1e5}
    base.counters, got.counters = dict(counters), dict(counters)
    for name, mod in readers():
        assert mod.read(got, None) == mod.read(base, None), name
    if kept:
        assert got.kernels[0].spans == (
            "depth2d._pass_fn", "rslf/depth2d.pass",
            "depth2d.sweep_pile_pixel", "rslf/sweep.launch")
        assert got.kernels[1].spans == ("depth2d._pass_fn",
                                        "rslf/depth2d.pass",
                                        "rslf/pass.merge")
        # an idle gap takes the innermost span open when it starts
        gaps = dict(got.idle_gaps)
        assert gaps["rslf/pass.merge"] == pytest.approx(130e-9)
        assert gaps["rslf/depth2d.pass"] == pytest.approx(140e-9)
    else:
        assert got.idle_gaps == base.idle_gaps
