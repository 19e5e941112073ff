#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's pipeline goes, on one GPU.

    python3 scripts/torch_pipeline_profile.py [--bands 4]
        [--scene lr|d240|hr|rgb] [--score line] [--fast]
        [--interpolation nearest]

Runs the fine-to-coarse pipeline on the bench scene of ``chip_smoke.py``
(``--bands 4``: its four-band version, phase 5 there; ``--scene``: one of
the bench command's scenes, ``remotesensingproject_tpu_torch.bench``:
SkysatLR18 [120] (the bench scene), [240], SkysatHR18 or MansionLR RGB;
``--score``, ``--fast`` and ``--interpolation`` set those parameters)
once to warm up,
then once under ``torch.profiler``.  Prints one JSON line: the profiled
wall time, the device time summed per CUDA kernel (the port's kernels by
name, PyTorch's own kernels grouped), the device busy share (summed
kernel time over wall time; one stream, so kernels do not overlap) and
the card's name and power limit, and ``kernel_launches``: the device
operations the profiler saw (kernels, the port's and PyTorch's, copies
and fills).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import (BAND_GAINS, DMAX, DMIN, D, card_line,  # noqa
                        synthetic_sequence)
from remotesensingproject_tpu_torch import bench  # noqa: E402
from remotesensingproject_tpu_torch.config import DEFAULT_PARAMS  # noqa
from remotesensingproject_tpu_torch.models.fine_to_coarse import \
    FineToCoarse  # noqa: E402
from remotesensingproject_tpu_torch.ops import cuda_build  # noqa: E402

# the three sweeps launch one core, sweep_pc_kernel: the row sweep under
# the position rule PcRuleRow; the pixel and the tile sweep under
# PcRulePixel or PcRuleNearest, and with one band the pipeline reaches
# those through the pixel sweep only, with four bands through the tile
# sweep only (models/depth2d.py sweep_pass).  First match wins.
PORTS = {"PcRuleRow": "sweep_rows", "sweep_pc_kernel": None,
         "selective_median_kernel": "median", "paint_kernel": "paint",
         "line_conf_kernel": "line_conf", "merge_kernel": "merge"}


#: the bench command's variable of each scene
SCENES = {"lr": {}, "d240": {"BENCH_D240": "1"}, "hr": {"BENCH_HR": "1"},
          "rgb": {"BENCH_RGB": "1"}}


def run(vol, params, grid=(DMIN, DMAX, D)):
    ftc = FineToCoarse(vol, *grid, params=params, device="cuda")
    ftc.run()
    out = ftc.get_results()
    torch.cuda.synchronize()
    return ftc, out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bands", type=int, choices=(1, 4), default=1)
    ap.add_argument("--scene", choices=tuple(SCENES), default="lr")
    ap.add_argument("--score", choices=("edge", "disp", "line"),
                    default="edge")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--interpolation", choices=("linear", "nearest"),
                    default="linear")
    args = ap.parse_args()
    params = dataclasses.replace(DEFAULT_PARAMS, score_version=args.score,
                                 fast=args.fast,
                                 interpolation=args.interpolation)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.bands == 4 and args.scene != "lr":
        ap.error("--bands 4 is the four-band version of the lr scene")
    PORTS["sweep_pc_kernel"] = ("sweep_pixel" if args.bands == 1
                                else "sweep_tiles")
    cuda_build.build()
    grid = (DMIN, DMAX, D)
    if args.bands == 4:
        vol, _ = synthetic_sequence(torch, torch.device("cuda"),
                                    gains=BAND_GAINS)
    else:
        cfg = bench.bench_config(SCENES[args.scene])
        if cfg.rgb:
            vol, _ = bench.synthetic_sequence_rgb(cfg.S, cfg.V, cfg.U,
                                                  device="cuda")
        else:
            vol, _ = bench.synthetic_sequence(cfg.S, cfg.V, cfg.U,
                                              dmin=cfg.dmin, dmax=cfg.dmax,
                                              device="cuda")
        grid = (cfg.dmin, cfg.dmax, cfg.D)
    run(vol, params, grid)  # warm-up: allocator, library loads
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ftc, _ = run(vol, params, grid)
        wall = time.perf_counter() - t0
    by_kernel = {}
    other = {}
    launches = 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        launches += ev.count
        port = next((v for k, v in PORTS.items() if k in ev.key), None)
        if port:
            by_kernel[port] = by_kernel.get(port, 0.0) + dev_us / 1e3
        else:
            other[ev.key[:60]] = other.get(ev.key[:60], 0.0) + dev_us / 1e3
    top_other = dict(sorted(other.items(), key=lambda kv: -kv[1])[:8])
    busy_ms = sum(by_kernel.values()) + sum(other.values())
    print(json.dumps({
        "card": card_line(),
        "bands": args.bands,
        "scene": args.scene,
        "shape": list(vol.shape),
        "params": {"score_version": args.score, "fast": args.fast,
                   "interpolation": args.interpolation},
        "wall_s": wall,
        "level_seconds": ftc.level_seconds,
        "passes": [c.passes_run for c in ftc.computers],
        "device_ms_ports": by_kernel,
        "device_ms_pytorch_total": sum(other.values()),
        "device_ms_pytorch_top": top_other,
        "kernel_launches": launches,
        "device_busy_share": busy_ms / (wall * 1e3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
