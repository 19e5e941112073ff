"""One run of one cell: set-up, the measured window (or the traced
scenes), the check, and the one-line record.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the scene (generator, S, V, U, C, range);
* ``traffic/<traffic>.json``: the pipeline's settings (``D`` and the
  ``params`` handed to the port's ``DepthParams``);
* ``metrics/<metric>.py``: a per-layer metric's reader (``read(trace,
  cell)``, None where it finds nothing), the spans it reads (``SPANS``:
  span name -> the program attribute wrapped) and the counters it needs
  from the untimed replay (``COUNTERS``: counter name -> (attribute,
  function of the call's arguments and the cell));
* ``limits/default.json`` (and ``limits/<workload>.json`` over it): the
  limit of each number the check compares.

The system under test is the port's public entry, ``FineToCoarse(vol,
dmin, dmax, D, params=..., device=...).run()`` then ``get_results()``,
followed by a synchronise: one scene.  A configuration names a few scenes
(``scene_seeds``); every run makes all of them and goes through them in an
order drawn from its seed, so every seed does the same work.  Scenes run
back to back in a closed loop; the window opens at the first scene's start
and closes at the end of the round (every scene once) running when
``seconds`` have passed.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import inspect
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check as check_mod
from . import counts, reference, scenes, tracing
from .hooks import Patches

#: top-level module names that may not be loaded when the record prints
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "remotesensingproject_tpu")
#: the traffic's pipeline settings the reference follows
REFERENCE_PARAMS = ("score_version", "fast", "interpolation")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[tuple]        # (metric entry, its reader module)
    limits: Dict[str, float]

    @property
    def params(self) -> dict:
        p = {"score_version": "edge", "fast": False,
             "interpolation": "linear"}
        p.update(self.traffic.get("params", {}))
        return p

    @property
    def steps(self) -> int:
        p = self.params
        return counts.mean_shift_steps(p["fast"], p["interpolation"])

    @property
    def pixels(self) -> int:
        c = self.config
        return c["S"] * c["V"] * c["U"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_cell(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    bench = load_json(root / "BENCHMARK.json")
    here = root / "benchmark"
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(root / conf["file"])
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    per_layer = [(m, load_module(here / "metrics" / f"{m['name']}.py",
                                 f"benchmark_metric_{i}"))
                 for i, m in enumerate(bench["per_layer"])
                 if _in_cell(m, workload)]
    limits = load_json(here / "limits" / "default.json")
    own = here / "limits" / f"{workload}.json"
    if own.exists():
        limits.update(load_json(own))
    cell = Cell(name=workload, config=config, traffic=traffic,
                chips=w["chips"],
                end_to_end=[m for m in bench["end_to_end"]
                            if _in_cell(m, workload)],
                per_layer=per_layer, limits=limits)
    unknown = set(traffic.get("params", {})) - set(REFERENCE_PARAMS)
    if unknown:
        raise SystemExit(f"{w['traffic']}: the reference does not follow "
                         f"{sorted(unknown)}")
    return cell


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line(dev: torch.device) -> str:
    """The card's name and power limit (``nvidia-smi``)."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(dev)} (nvidia-smi: {e})"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def import_program():
    """The port's entry: (DepthParams, FineToCoarse)."""
    from remotesensingproject_tpu_torch.config import DepthParams
    from remotesensingproject_tpu_torch.models.fine_to_coarse import \
        FineToCoarse
    return DepthParams, FineToCoarse


def make_pipeline(cell: Cell, vols: List[torch.Tensor], dev: torch.device):
    """The system under test: ``run_scene(i)`` runs scene ``vols[i]``
    through the port's public entry and returns (fused, validity, passes
    per level)."""
    DepthParams, FineToCoarse = import_program()
    params = DepthParams(**cell.traffic.get("params", {}))
    cfg, D = cell.config, cell.traffic["D"]

    def run_scene(i: int):
        ftc = FineToCoarse(vols[i], cfg["dmin"], cfg["dmax"], D,
                           params=params, device=dev)
        ftc.run()
        fused, valid = ftc.get_results()
        sync(dev)
        return fused, valid, [c.passes_run for c in ftc.computers]

    return run_scene


def make_scenes(cell: Cell, dev: torch.device):
    """The configuration's scenes (``scene_seeds``, one scene each):
    [(volume, ground truth)]."""
    return [scenes.make_scene(cell.config, s, dev)
            for s in cell.config.get("scene_seeds", [0])]


def scene_order(n: int, seed: int) -> List[int]:
    """The order in which a run of ``seed`` goes through ``n`` scenes:
    every seed runs the same scenes, in another order."""
    rng = np.random.default_rng([seed % 2 ** 64, 0x5CE])
    return [int(i) for i in rng.permutation(n)]


def check_scene(cell: Cell, vol: torch.Tensor) -> check_mod.Scene:
    return check_mod.Scene(
        vol=vol, dmin=cell.config["dmin"], dmax=cell.config["dmax"],
        D=cell.traffic["D"], score_version=cell.params["score_version"],
        steps=cell.steps, interpolation=cell.params["interpolation"])


def build_kernels(dev: torch.device) -> None:
    """Build the program's kernels that are not built yet, all at once
    (their build directory lies inside the checkout)."""
    if dev.type != "cuda":
        return
    from remotesensingproject_tpu_torch.ops import cuda_build
    build = getattr(cuda_build, "build", None)
    if build is not None:
        t = build()
        built = {k: round(v, 1) for k, v in t.items() if v > 0}
        if built:
            log(f"# nvcc built {built} s")


def percentiles(x: torch.Tensor, qs) -> list:
    """``np.percentile(x, q)`` (linear) from one sort on the device
    (frozen from the port's ``bench.py``)."""
    xs = torch.sort(x.reshape(-1)).values
    n = xs.numel()
    out = []
    for q in qs:
        idx = q / 100.0 * (n - 1)
        lo = int(np.floor(idx))
        hi = min(lo + 1, n - 1)
        a, b = float(xs[lo]), float(xs[hi])
        t = idx - lo
        out.append(b - (b - a) * (1.0 - t) if t >= 0.5 else a + (b - a) * t)
    return out


def quality_line(cell: Cell, vol, gt_s_u, fused, scene_seed: int) -> str:
    """RMSE and P90 of |fused - gt| over the input's edge-confident pixels
    (the definition of bench.py and REF_ANCHOR.json), with the compiled
    reference's own numbers on scene seed 0 where the configuration
    carries them."""
    ce, _ = reference.edge_confidence(reference.normalize(vol))
    mask = (ce > reference.PARAMS["edge_score_threshold"]).permute(1, 0, 2)
    gt = torch.as_tensor(gt_s_u, device=fused.device)[:, None, :]
    err = torch.abs(fused - gt)[mask]
    rmse = float(torch.sqrt(torch.mean(err.double() ** 2)))
    p50, p90 = percentiles(err, (50, 90))
    line = (f"# quality of scene seed {scene_seed}: RMSE {rmse:.4f} px, "
            f"P50 {p50:.4f}, P90 {p90:.4f} on "
            f"{float(mask.float().mean()) * 100:.1f}% edge-confident px")
    anchor = cell.config.get("anchor_seed0", {}).get(
        f"D{cell.traffic['D']}")
    if scene_seed == 0 and anchor and cell.params["score_version"] == "edge":
        line += (f"; the compiled reference on this scene: RMSE "
                 f"{anchor['rmse_px']}, P90 {anchor['p90_px']}")
    return line


def forbidden_modules() -> List[str]:
    loaded = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN_MODULES))


def counter_patches(cell: Cell, totals: Dict[str, float]) -> Patches:
    """The metrics' counters, wrapped around the program for the replay."""
    p = Patches()
    seen = set()
    for _, mod in cell.per_layer:
        for cname, (target, fn) in getattr(mod, "COUNTERS", {}).items():
            if cname in seen:
                continue
            seen.add(cname)
            totals.setdefault(cname, 0.0)

            def make(orig, cname=cname, fn=fn):
                sig = inspect.signature(orig)

                def counted(*a, **k):
                    totals[cname] += fn(sig.bind(*a, **k).arguments, cell)
                    return orig(*a, **k)
                return counted
            p.wrap(target, make)
    return p


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, out=None) -> dict:
    """Run one cell and print its record as the last line of ``out``
    (standard output); returns the record."""
    t_start = time.perf_counter() if t_start is None else t_start
    out = out or sys.stdout
    cell = load_cell(root, workload)
    import_program()
    dev = torch.device(device)
    card = card_line(dev)
    log(f"# {workload} seed {seed} on {card}")
    build_kernels(dev)
    seed_n = seed % 2 ** 64
    pool = make_scenes(cell, dev)
    order = scene_order(len(pool), seed_n)
    run_scene = make_pipeline(cell, [v for v, _ in pool], dev)
    fused, valid, passes = run_scene(order[0])          # warm-up
    del fused, valid
    setup_s = time.perf_counter() - t_start
    log(f"# set-up {setup_s:.3f} s ({len(pool)} scenes made; warm-up scene:"
        f" {sum(passes)} passes over {len(passes)} levels)")

    metrics: Dict[str, dict] = {}
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                  "count": cell.chips if dev.type == "cuda" else 0}
    breakdown = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        tr, (fused, valid, passes) = tracing.traced_scenes(
            run_scene, order, merged_spans(cell), acts)
        last = order[-1]
        attempted = tr.scenes
        log(f"# traced {tr.scenes} scenes: {tr.window_s:.3f} s, device busy "
            f"{tr.busy_s:.3f} s, {len(tr.kernels)} kernels "
            f"({tr.by_runtime} placed by their runtime call, {tr.unplaced} "
            f"with no launch time found)")
    else:
        t0 = time.perf_counter()
        attempted = 0
        while True:
            fused = valid = None
            last = order[attempted % len(order)]
            fused, valid, passes = run_scene(last)
            attempted += 1
            if (attempted % len(order) == 0
                    and time.perf_counter() - t0 >= seconds):
                break
        window = time.perf_counter() - t0
        metrics["mpix_per_s"] = {
            "value": attempted * cell.pixels / 1e6 / window,
            "unit": "MPix/s"}
        log(f"# window {window:.3f} s, {attempted} scenes, "
            f"{window / attempted:.4f} s a scene")
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        device_rec["memory_peak_bytes"] = peak
        if not trace:
            metrics["peak_mem_gib"] = {"value": peak / 2 ** 30,
                                       "unit": "GiB"}
    if not trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    # after the window and the peak, untimed: the traced run's counters
    # replay every scene, and the check replays the last one
    totals: Dict[str, float] = {}
    t_check = time.perf_counter()
    if trace:
        for i in order[:-1]:
            with counter_patches(cell, totals):
                run_scene(i)
    vol, gt = pool[last]
    chk = check_mod.run_check(
        check_scene(cell, vol), lambda: run_scene(last), passes, seed_n,
        fused, valid,
        patches=counter_patches(cell, totals) if trace else None)
    log(f"# check: replay and reference {time.perf_counter() - t_check:.3f}"
        f" s, {chk.checked_passes} passes followed")
    log(quality_line(cell, vol, gt, fused,
                     cell.config.get("scene_seeds", [0])[last]))

    if trace:
        tr.counters = {k: v / len(order) for k, v in totals.items()}
        for entry, mod in cell.per_layer:
            value = mod.read(tr, cell)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
        device_rec["busy_s"] = tr.busy_s
        device_rec["window_s"] = tr.window_s
        breakdown = {"device_ops": [list(x) for x in tr.device_ops],
                     "idle_gaps": [list(x) for x in tr.idle_gaps]}
        log(f"# counters a scene: {tr.counters}")

    checks = {n: {"value": chk.readings[n], "limit": cell.limits[n]}
              for n in check_mod.NUMBERS}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    record = {"correct": correct, "attempted": attempted,
              "failed": 0 if correct else attempted, "metrics": metrics,
              "device": device_rec}
    if breakdown is not None:
        record["breakdown"] = breakdown
    record["checks"] = checks

    bad = forbidden_modules()
    if bad:
        log(f"# loaded in this process: {bad}; no record")
        raise SystemExit(3)
    print(json.dumps(record), file=out, flush=True)
    for n, c in checks.items():
        log(f"{n} {c['value']!r} limit {c['limit']!r}")
    return record


def merged_spans(cell: Cell) -> Dict[str, str]:
    spans: Dict[str, str] = {}
    for _, mod in cell.per_layer:
        spans.update(getattr(mod, "SPANS", {}))
    return spans


def set_cache_dirs(root: Path) -> None:
    """Kernel and compiler caches at fixed paths inside the checkout."""
    base = root / "build" / "benchmark"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ.setdefault(var, str(base / sub))
