"""A tiny cell end to end on the CPU, files added with no code edit, and
what a run may not load or run without."""

import ast
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

from .conftest import ROOT

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def run_tiny(root, workload, trace=False, seed=5):
    out = io.StringIO()
    rec = harness.run_cell(root, workload, seed, 0.01, trace, "cpu", out=out)
    last = out.getvalue().strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(rec))
    return rec


@pytest.mark.parametrize("workload", ["tiny.edge", "tiny.line", "tiny.rgb"])
def test_tiny_cell_prints_one_correct_record(tiny_root, workload):
    rec = run_tiny(tiny_root, workload)
    assert all(k in rec for k in KEYS)
    assert list(rec)[-1] == "checks"
    assert rec["correct"], rec["checks"]
    assert rec["attempted"] >= 1 and rec["failed"] == 0
    assert set(rec["metrics"]) == {"mpix_per_s", "setup_s"}
    assert rec["metrics"]["mpix_per_s"]["value"] > 0


def test_added_config_traffic_and_metric_run_without_code_edit(tiny_root):
    rec = run_tiny(tiny_root, "tiny.edge", trace=True)
    assert rec["metrics"]["extra.scenes"]["value"] == 2.0   # the pool
    assert rec["metrics"]["depth2d.passes"]["unit"] == "passes"
    # no device activity on the CPU: the device metrics are left out
    assert "sweep_pixel.device_ms" not in rec["metrics"]
    assert set(rec["breakdown"]) == {"device_ops", "idle_gaps"}


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_and_the_reference_imports_no_program():
    forbidden = set(harness.FORBIDDEN_MODULES)
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not set(_top_imports(path)) & forbidden, path
    for name in ("reference.py", "check.py", "scenes.py", "counts.py"):
        tops = set(_top_imports(ROOT / "benchmark" / name))
        assert "remotesensingproject_tpu_torch" not in tops, name


def test_a_run_loads_no_jax(tiny_root):
    code = ("import sys; from pathlib import Path; "
            "from benchmark import harness; "
            f"harness.run_cell(Path({str(tiny_root)!r}), 'tiny.edge', 1, "
            "0.01, False, 'cpu'); "
            "print('LOADED', harness.forbidden_modules())")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


def test_forbidden_names_compare_the_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "remotesensingproject_tpu_torch_x",
                        sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_no_record_without_a_card():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "skysat_lr18.edge_d120", "--seed", "3", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_no_record_without_the_program(tmp_path):
    (tmp_path / "benchmark").mkdir()
    for p in (ROOT / "benchmark").glob("*.py"):
        (tmp_path / "benchmark" / p.name).write_text(p.read_text())
    for sub in ("configs", "traffic", "metrics", "limits"):
        d = tmp_path / "benchmark" / sub
        d.mkdir()
        for p in (ROOT / "benchmark" / sub).iterdir():
            (d / p.name).write_text(p.read_text())
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    code = ("import sys; sys.path[:0] = ['.']; from pathlib import Path; "
            "from benchmark import harness; "
            "harness.run_cell(Path('.'), 'skysat_lr18.edge_d120', 1, 0.01, "
            "False, 'cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
