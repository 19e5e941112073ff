#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port, one run of one cell.

    python3 benchmark/run.py --workload skysat_lr18.edge_d120 --seed 7 \\
        --seconds 30 --trace 0

Run from the root of a checkout (``BENCHMARK.json`` names the cells).
Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and ``checks``, each number the check compared with its
limit (also the last lines of standard error).  Exits non-zero and prints
no record without the CUDA devices the cell asks for, or when JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the benchmark's own folder first on the path would shadow the standard
# library with its modules' names; the checkout's root takes its place
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness
    harness.set_cache_dirs(ROOT)
    import torch

    chips = harness.load_cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"# {args.workload} needs {chips} CUDA device(s); {have} "
              f"available", file=sys.stderr)
        return 2
    harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
