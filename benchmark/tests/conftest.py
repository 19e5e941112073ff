"""A tiny cell in a temporary copy of the benchmark, run on the CPU (the
port's plain versions): an extra configuration, traffic and metric added
as files, with no edit to the benchmark's code."""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

TINY = dict(S=8, V=24, U=48, scene_seeds=[0, 1])
EXTRA_METRIC = '''"""extra.scenes: traced scenes (a metric added as a file)."""


def read(trace, cell):
    return float(trace.scenes)
'''


def make_copy(tmp: Path) -> Path:
    """BENCHMARK.json and benchmark/ copied under ``tmp``, with the cells
    tiny.edge and tiny.line (8 x 24 x 48, D=16) and the metric
    extra.scenes added as files and entries."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = tmp / "benchmark"
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for name in ("skysat_lr18", "mansion_lr"):
        conf = json.loads((here / "configs" / f"{name}.json").read_text())
        conf.update(name=f"tiny_{name}", **TINY)
        (here / "configs" / f"tiny_{name}.json").write_text(json.dumps(conf))
        bench["configs"].append({
            "name": f"tiny_{name}", "source": conf["source"],
            "file": f"benchmark/configs/tiny_{name}.json",
            "reduced": ["S", "V", "U", "scene_seeds"], "why": "a test size"})
    for score in ("edge", "line"):
        (here / "traffic" / f"tiny_{score}.json").write_text(json.dumps(
            {"D": 16, "params": {"score_version": score}}))
    cells = {"tiny.edge": ("tiny_skysat_lr18", "tiny_edge"),
             "tiny.line": ("tiny_skysat_lr18", "tiny_line"),
             "tiny.rgb": ("tiny_mansion_lr", "tiny_edge")}
    for cell, (conf, traffic) in cells.items():
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": traffic, "chips": 1,
                                   "why": "a test size"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += list(cells)
    (here / "metrics" / "extra.scenes.py").write_text(EXTRA_METRIC)
    bench["per_layer"].append({
        "name": "extra.scenes", "unit": "scenes", "better": "higher",
        "source": "program_counter", "layer": "driver", "moves":
        "mpix_per_s", "workloads": ["tiny.edge"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_copy(tmp_path_factory.mktemp("bench"))
