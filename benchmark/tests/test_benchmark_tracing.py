"""The reduction of a profiler trace, on events made up for the test."""

import pytest
import torch

from benchmark import tracing

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
SWEEP = ("void (anonymous namespace)::sweep_pc_kernel<1, (anonymous "
         "namespace)::PcRulePixel>((anonymous namespace)::PcArgs)")
MEDIAN = ("void (anonymous namespace)::selective_median_kernel<5, 1>("
          "float const*, unsigned char const*, float const*, float*, int, "
          "int, float)")


class Ev:
    def __init__(self, name, dev, t0, t1, corr=0, linked=0):
        self._v = (name, dev, t0, t1, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def events():
    return [
        Ev(tracing.SCENE_SPAN, CPU, 0, 1000, corr=1),
        Ev("depth2d._pass_fn", CPU, 50, 600, corr=2),
        Ev("depth2d.sweep_pile_pixel", CPU, 100, 300, corr=3),
        Ev("cudaLaunchKernel", CPU, 150, 160, corr=7001),
        Ev("aten::copy_", CPU, 500, 520, corr=42),
        Ev(SWEEP, CUDA, 200, 400, corr=7001, linked=3),
        Ev(MEDIAN, CUDA, 530, 560, corr=7002, linked=42),
        Ev("Memset (Device)", CUDA, 700, 720, corr=7003),
        # outside every traced scene: not counted
        Ev(SWEEP, CUDA, 2000, 2500, corr=7004),
    ]


def test_kernels_belong_to_the_spans_open_at_launch():
    tr = tracing.reduce_events(events(), {"depth2d._pass_fn",
                                          "depth2d.sweep_pile_pixel"}, [3])
    assert tr.scenes == 1 and tr.walls == [pytest.approx(1e-6)]
    assert [k.spans for k in tr.kernels] == [
        ("depth2d._pass_fn", "depth2d.sweep_pile_pixel"),
        ("depth2d._pass_fn",)]
    assert tr.by_runtime == 1 and tr.unplaced == 0
    assert tr.busy_s == pytest.approx((200 + 30 + 20) * 1e-9)
    assert tr.device_ops[0] == ("sweep_pc_kernel<1,PcRulePixel>",
                                pytest.approx(200e-9))
    gaps = dict(tr.idle_gaps)
    # 0-200 (scene span: no layer span open at 0), 400-530 and 560-700
    # inside _pass_fn until 600, 720-1000 after it
    assert gaps["no span"] == pytest.approx((200 + 280) * 1e-9)
    assert gaps["depth2d._pass_fn"] == pytest.approx((130 + 140) * 1e-9)


def test_open_spans_nest():
    o = tracing._OpenSpans([("a", 0, 100), ("b", 10, 50), ("c", 20, 30),
                            ("b", 60, 90)])
    assert o.at(25) == ("a", "b", "c")
    assert o.at(55) == ("a",)
    assert o.at(60) == ("a", "b")
    assert o.at(150) == ()
