"""Kernel names and the file's names and units."""

import json
import re

import pytest

from benchmark import check, kernel_names

from .conftest import ROOT

# g++ manglings and c++filt demanglings of the port's kernel templates
# (internal linkage, as in csrc/): chip_smoke.py's cases
CASES = [
    ("_ZN12_GLOBAL__N_115sweep_pc_kernelILi1ENS_11PcRulePixelEEEvNS_6PcArgsE",
     "void (anonymous namespace)::sweep_pc_kernel<1, (anonymous namespace)::"
     "PcRulePixel>((anonymous namespace)::PcArgs)",
     "sweep_pc_kernel<1,PcRulePixel>", "PcRulePixel"),
    ("_ZN12_GLOBAL__N_115sweep_pc_kernelILi3ENS_11PcRulePixelEEEvNS_6PcArgsE",
     "void (anonymous namespace)::sweep_pc_kernel<3, (anonymous namespace)::"
     "PcRulePixel>((anonymous namespace)::PcArgs)",
     "sweep_pc_kernel<3,PcRulePixel>", "PcRulePixel"),
    ("_ZN12_GLOBAL__N_115sweep_pc_kernelILi1ENS_13PcRuleNearestEEEvNS_6"
     "PcArgsE",
     "void (anonymous namespace)::sweep_pc_kernel<1, (anonymous namespace)::"
     "PcRuleNearest>((anonymous namespace)::PcArgs)",
     "sweep_pc_kernel<1,PcRuleNearest>", "PcRuleNearest"),
    ("_ZN12_GLOBAL__N_115sweep_pc_kernelILi1ENS_9PcRuleRowEEEvNS_6PcArgsE",
     "void (anonymous namespace)::sweep_pc_kernel<1, (anonymous namespace)::"
     "PcRuleRow>((anonymous namespace)::PcArgs)",
     "sweep_pc_kernel<1,PcRuleRow>", "PcRuleRow"),
    ("_ZN12_GLOBAL__N_115sweep_pc_kernelILi4ENS_17PcRulePixelWindowEEEvNS_6"
     "PcArgsE",
     "void (anonymous namespace)::sweep_pc_kernel<4, (anonymous namespace)::"
     "PcRulePixelWindow>((anonymous namespace)::PcArgs)",
     "sweep_pc_kernel<4,PcRulePixelWindow>", "PcRulePixelWindow"),
    ("_ZN12_GLOBAL__N_123selective_median_kernelILi5ELi1EEEvPKfPKhS2_Pfiif",
     "void (anonymous namespace)::selective_median_kernel<5, 1>(float const*,"
     " unsigned char const*, float const*, float*, int, int, float)",
     "selective_median_kernel<5,1>", None),
    ("_ZN12_GLOBAL__N_112paint_kernelILi1ELb0EEEvNS_9PaintArgsE",
     "void (anonymous namespace)::paint_kernel<1, false>((anonymous "
     "namespace)::PaintArgs)", "paint_kernel<1,0>", None),
    ("_ZN12_GLOBAL__N_112paint_kernelILi3ELb1EEEvNS_9PaintArgsE",
     "void (anonymous namespace)::paint_kernel<3, true>((anonymous "
     "namespace)::PaintArgs)", "paint_kernel<3,1>", None),
]


@pytest.mark.parametrize("mangled,demangled,short,rule", CASES)
def test_kernel_names_and_layers(mangled, demangled, short, rule):
    for name in (mangled, demangled):
        assert kernel_names.kernel_name(name) == short
        assert kernel_names.sweep_rule(name) == rule
        assert kernel_names.is_port_kernel(name)


@pytest.mark.parametrize("name", [
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::"
    "FillFunctor<float>, std::array<char*, 1ul>)",
    "Memcpy DtoH (Device -> Pageable)",
    "_ZN12_GLOBAL__N_119launch_floor_kernelEv"])
def test_other_kernels_are_pytorchs(name):
    assert not kernel_names.is_port_kernel(name)
    assert kernel_names.sweep_rule(name) is None


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file_names_units_and_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    limits = json.loads((ROOT / "benchmark" / "limits" / "default.json")
                        .read_text())
    assert set(limits) == set(check.NUMBERS)
