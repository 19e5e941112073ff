#!/usr/bin/env python3
"""The readings the check's limits are set from, for one cell, on the
card: the program's and the control's, seed by seed, in one process.

    python3 benchmark/control.py --workload skysat_lr18.edge_d120 \\
        --seeds 11 12 13 [--work-count]

For each seed: the scene a run of that seed checks (the last of its
order) through the program (the timed path), then the check's replay
with ``control=True``: every number the check compares, read on the
program and on the control (the reference computed in bfloat16, put in
the program's place at each step).  One JSON line a seed, then one
with the largest program reading and the smallest control reading of
each number over the seeds.

``--work-count`` also counts the pixel sweep's operations of the replayed
scene both ways: the benchmark's own count (``counts.py``) and the
kernel's ``work_count`` (valid samples x mean-shift steps it ran), which
the replay passes to every pixel-sweep call.

The benchmark's runs never run this script.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--work-count", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from benchmark import check as check_mod
    from benchmark import counts, harness
    from benchmark.hooks import Patches
    harness.set_cache_dirs(ROOT)
    import torch

    cell = harness.load_cell(ROOT, args.workload)
    dev = torch.device(args.device)
    harness.log(f"# {args.workload} on {harness.card_line(dev)}")
    harness.build_kernels(dev)
    worst = {n: 0.0 for n in check_mod.NUMBERS}
    least = {n: float("inf") for n in check_mod.NUMBERS}
    pool = harness.make_scenes(cell, dev)
    run_scene = harness.make_pipeline(cell, [v for v, _ in pool], dev)
    scene_seeds = cell.config.get("scene_seeds", [0])
    for seed in args.seeds:
        t0 = time.perf_counter()
        i = harness.scene_order(len(pool), seed)[-1]
        fused, valid, passes = run_scene(i)
        totals = {}
        patches = Patches()
        if args.work_count:
            patches = harness.counter_patches(cell, totals)
            work = torch.zeros(1, dtype=torch.int64, device=dev)

            def make(orig):
                def with_count(*a, **k):
                    k["work_count"] = work
                    return orig(*a, **k)
                return with_count
            patches.wrap("remotesensingproject_tpu_torch.models.depth2d:"
                         "sweep_pile_pixel", make)
        chk = check_mod.run_check(harness.check_scene(cell, pool[i][0]),
                                  lambda: run_scene(i), passes,
                                  seed % 2 ** 64, fused, valid,
                                  control=True, patches=patches)
        line = {"seed": seed, "scene_seed": scene_seeds[i], "passes": passes,
                "checked_passes": chk.checked_passes,
                "program": chk.readings, "control": chk.control_readings,
                "seconds": time.perf_counter() - t0}
        if args.work_count:
            C = cell.config["C"]
            line["sweep_flops_benchmark"] = totals.get("sweep_pixel.flops")
            line["sweep_flops_kernel"] = (int(work) *
                                          counts.flops_per_sample_step(C))
        print(json.dumps(line), flush=True)
        harness.log(harness.quality_line(cell, pool[i][0], pool[i][1], fused,
                                         scene_seeds[i]))
        for n in check_mod.NUMBERS:
            worst[n] = max(worst[n], chk.readings[n])
            least[n] = min(least[n], chk.control_readings[n])
        del fused, valid, chk
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "program_max": worst, "control_min": least}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
