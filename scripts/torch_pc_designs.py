#!/usr/bin/env python3
"""Designs of the (pixel, candidate) core, built side by side and timed on
one GPU.

    python3 scripts/torch_pc_designs.py [--parent ROOT] [--reps N] [NAME ...]

The core (``remotesensingproject_tpu_torch/csrc/sweep_pc.cuh``) takes
compile-time choices per channel instantiation: ``rslf_pc_regs``, the
samples of an item's run its thread holds in registers (the rest sit in
its shared-memory column), and ``rslf_pc_um`` and ``rslf_pc_us``, the
samples of a mean-shift and of a staging batch.  Each design below is a
copy of this tree's kernel sources with the bodies of those three
functions rewritten (``--parent ROOT`` adds ROOT's sources as they are,
the design ``parent``; a C = 3 column is packed in every design of this
tree).  For
each design the script builds the pixel sweep library (and, for designs
marked so, the row and the tile sweep) with nvcc, all at once,
prints the registers, stack frames and spills ptxas reports for the
instantiations on the measured paths and the plans the launchers choose,
then times, in turns over the designs (``--reps`` rounds, medians of CUDA
events):

* the pixel sweep at the first level-0 pass of the RGB scene (bench.py's
  BENCH_RGB scene: 100x720x1146, C = 3 uint8, D = 120), and the same with
  no mean-shift step (staging and bookkeeping alone);
* the pixel sweep at the first level-0 pass of the LR scene (C = 1);
* for designs marked so (the tree's own, and those that change C = 4): the
  row sweep at the pile's input (every row of the LR scene, C = 1) and on a
  64-row slab of the four-band scene with k_best, and the tile sweep (tile
  mode) at the first pass of level 1 of the four-band pyramid.

Every result is compared with the first design's (``parent`` where given)
bit for bit, and each design's time is printed beside the fp32 bound of
its work (valid samples x mean-shift steps x (4C + 5) at 67 TFLOP/s).  One
JSON line per design goes to standard output.  NAME picks designs by name
(default: all).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

C3 = "nc == 3 ? {} : {}"
#: the constexpr functions of the core a design rewrites (their argument
#: is named ``nc`` in every rewritten body)
CHOICES = ("rslf_pc_regs", "rslf_pc_um", "rslf_pc_us")


def _design(regs, um="8", us="nc == 1 ? 16 : 4"):
    return dict(zip(CHOICES, (regs, um, us)))


#: name -> (the core's compile-time choices, whether the row and tile
#: sweeps are built and timed too)
DESIGNS = {
    "packed": (_design("0"), False),
    "packed+regs32": (_design(C3.format(32, 0)), False),
    "packed+regs32+um4": (_design(C3.format(32, 0), C3.format(4, 8)), True),
    "packed+regs32+um4+us8": (_design(C3.format(32, 0), C3.format(4, 8),
                                      "nc == 1 ? 16 : nc == 3 ? 8 : 4"),
                              False),
    "packed+regs32+um4all": (_design(C3.format(32, 0), "4"), True),
    "packed+regs36+um4": (_design(C3.format(36, 0), C3.format(4, 8)),
                          False),
    "packed+regs40": (_design(C3.format(40, 0)), False),
    "packed+regs40+um4": (_design(C3.format(40, 0), C3.format(4, 8)),
                          False),
    "packed+regs48": (_design(C3.format(48, 0)), False),
    "packed+regs56": (_design(C3.format(56, 0)), False),
    "packed+regs48+regs4_32": (_design("nc == 3 ? 48 : nc == 4 ? 32 : 0"),
                               True),
}
#: the instantiations whose ptxas report is printed
SHOWN = ("sweep_pc_kernel<3,PcRulePixel>", "sweep_pc_kernel<1,PcRulePixel>",
         "sweep_pc_kernel<1,PcRulePixelWindow>", "sweep_pc_kernel<1,PcRuleRow>",
         "sweep_pc_kernel<4,PcRuleRow>", "sweep_pc_kernel<4,PcRulePixel>")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rewrite_core(text: str, choices: dict) -> str:
    """The core's source ``text`` with the body of each constexpr function
    named in ``choices`` replaced by ``return <expression>;``."""
    for fn, expr in choices.items():
        text, n = re.subn(
            rf"(constexpr int {fn}\(int )\w+(\) \{{)\s*return [^;]*;",
            rf"\1nc\2 return {expr};", text)
        if n != 1:
            raise ValueError(f"{fn} is not a one-line constexpr function of "
                             "the core any more: update this script")
    return text


def build_all(designs, out_dir):
    """Build each design's libraries, one nvcc process each, all started
    together; returns {design: {kernel: (library path, nvcc log)}}."""
    from remotesensingproject_tpu_torch.ops import cuda_build

    procs = []
    for name, (csrc, choices, kernels) in designs.items():
        d = os.path.join(out_dir, name.replace("+", "_"))
        if choices:  # a copy of the sources with the core rewritten
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(csrc, os.path.join(d, "csrc"))
            csrc = os.path.join(d, "csrc")
            core = os.path.join(csrc, "sweep_pc.cuh")
            with open(core) as f:
                text = rewrite_core(f.read(), choices)
            with open(core, "w") as f:
                f.write(text)
        os.makedirs(d, exist_ok=True)
        for k in kernels:
            lib = os.path.join(d, f"librslf_{k}.so")
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib,
                   os.path.join(csrc, k + ".cu")]
            procs.append((name, k, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    built, failed = {}, {}
    for name, k, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed[name] = log[-2000:]
        built.setdefault(name, {})[k] = (lib, log)
    for name, log in failed.items():
        print(f"design {name}: nvcc failed, left out:\n{log}")
        del built[name]
    return built


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout whose core is the design "
                    "'parent'")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("names", nargs="*")
    args = ap.parse_args()

    import torch

    cs = _chip_smoke()
    from remotesensingproject_tpu_torch import bench
    from remotesensingproject_tpu_torch.config import DEFAULT_PARAMS as p
    from remotesensingproject_tpu_torch.models.depth2d import Depth2DComputer
    from remotesensingproject_tpu_torch.models.fine_to_coarse import \
        FineToCoarse
    from remotesensingproject_tpu_torch.ops import (cuda_build, sweep_pallas,
                                                    sweep_pallas_perpixel,
                                                    sweep_pallas_pixel)
    from remotesensingproject_tpu_torch.ops.normalize import normalize_volume
    from remotesensingproject_tpu_torch.ops.sweep_pallas import \
        sweep_pile_rows
    from remotesensingproject_tpu_torch.ops.sweep_pallas_perpixel import (
        sweep_pile_tiles, tile_quantized_bounds)
    from remotesensingproject_tpu_torch.ops.sweep_pallas_pixel import (
        flops_per_sample_step, sweep_pile_pixel)

    if not torch.cuda.is_available():
        print("torch_pc_designs: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    csrc = os.path.join(HERE, "remotesensingproject_tpu_torch", "csrc")
    all4 = ("sweep_pixel", "sweep_rows", "sweep_tiles")
    designs = {}
    if args.parent:
        designs["parent"] = (os.path.join(os.path.abspath(args.parent),
                                          "remotesensingproject_tpu_torch",
                                          "csrc"), {}, all4)
    for name, (choices, c4) in DESIGNS.items():
        if not args.names or name in args.names:
            designs[name] = (csrc, choices, all4 if c4 else ("sweep_pixel",))
    t0 = time.perf_counter()
    built = build_all(designs, os.path.join(HERE, "build", "designs"))
    designs = {n: d for n, d in designs.items() if n in built}
    card = cs.card_line()
    print(f"card: {card}; built {len(designs)} designs in "
          f"{time.perf_counter() - t0:.1f}s")

    # the inputs, made with the tree's own kernels
    cuda_build.build()
    cfg = bench.bench_config({"BENCH_RGB": "1"})
    vol, _ = bench.synthetic_sequence_rgb(cfg.S, cfg.V, cfg.U, device=dev)
    comp = Depth2DComputer(vol, cfg.dmin, cfg.dmax, cfg.D, params=p,
                           device=dev)
    del vol
    sh = cfg.S // 2
    st = comp.initial_state()
    rgb = (comp.epis, cfg.dmin, cfg.dmax, cfg.D, sh,
           (st.ce_mask[sh] & st.claim[sh]).contiguous())
    del st
    vol, _ = cs.synthetic_sequence(torch, dev)
    comp_lr = Depth2DComputer(vol, cs.DMIN, cs.DMAX, cs.D, params=p,
                              device=dev)
    del vol
    st = comp_lr.initial_state()
    lr = (comp_lr.epis, cs.DMIN, cs.DMAX, cs.D, cs.S // 2,
          (st.ce_mask[cs.S // 2] & st.claim[cs.S // 2]).contiguous())
    del st
    vol4, _ = cs.synthetic_sequence(torch, dev, gains=cs.BAND_GAINS)
    epis4 = normalize_volume(vol4[:64].contiguous())
    ftc4 = FineToCoarse(vol4, cs.DMIN, cs.DMAX, cs.D, params=p, device=dev)
    del vol4
    ftc4.run()
    c1, p1 = ftc4.computers[1], ftc4.level_params[1]
    s1 = c1.initial_state()
    sh1 = c1.epis.shape[1] // 2
    act1 = (s1.ce_mask[sh1] & s1.claim[sh1]).contiguous()
    plo, phi = (x[sh1].contiguous() for x in (c1.dmin_s_v_u, c1.dmax_s_v_u))
    qlo, qhi = tile_quantized_bounds(act1, plo, phi, (cs.DMIN, cs.DMAX))
    tiles1 = (c1.epis, qlo, qhi, cs.D, sh1, p1, act1, plo, phi)
    del s1, ftc4
    torch.cuda.empty_cache()
    no_steps = dataclasses.replace(p, mean_shift_max_iter=0)

    def pixel(inp, params=p, work=None):
        ep, lo, hi, D, s_hat, act = inp
        return sweep_pile_pixel(ep, lo, hi, D, s_hat, params, act,
                                work_count=work)

    def rows1(work=None):
        ep, lo, hi, D, s_hat, _ = lr
        return sweep_pile_rows(ep, lo, hi, D, s_hat, p, work_count=work)

    def rows4(work=None):
        return sweep_pile_rows(epis4, cs.DMIN, cs.DMAX, cs.D, cs.S // 2, p,
                               with_k_best=True, work_count=work)

    def tiles(work=None):
        ep, lo, hi, D, s_hat, pl, act, a, b = tiles1
        return sweep_pile_tiles(ep, lo, hi, D, s_hat, pl, active_v_u=act,
                                pdmin_v_u=a, pdmax_v_u=b, work_count=work)

    cases = {"rgb_c3": (lambda w=None: pixel(rgb, work=w), 3, rgb[5]),
             "rgb_c3_no_steps": (lambda w=None: pixel(rgb, no_steps, w), 3,
                                 None),
             "lr_c1": (lambda w=None: pixel(lr, work=w), 1, lr[5]),
             "rows_c1_pile": (rows1, 1, torch.ones_like(lr[5])),
             "rows_c4_slab_k": (rows4, 4, torch.ones_like(lr[5][:64])),
             "tiles_c4_level1": (tiles, 4, act1)}

    def use(name):
        for k, (lib, _) in built[name].items():
            cuda_build.use_library(k, lib)

    def runs(name):
        return [c for c in cases if c.startswith(("rgb", "lr"))
                or "sweep_rows" in built[name]]

    ref = next(iter(designs))
    out = {n: {"design": n, "card": card, "ms": {}, "bound_ms": {},
               "work": {}, "bitwise_vs_" + ref: {}} for n in designs}
    want = {}
    for name in designs:
        use(name)
        rec = out[name]
        rec["choices"] = designs[name][1] if name != "parent" else None
        rec["ptxas"] = {fn: ln for k, (_, log) in built[name].items()
                        for fn, ln in cs.ptxas_summary(log)
                        if fn in SHOWN and (k == "sweep_pixel"
                                            or "PcRuleRow" in fn)}
        rec["plans"] = {
            f"pixel C={c} k_best={k} nearest={n}":
                sweep_pallas_pixel.launch_plan(cs.S, c, k, n)
            for c in (1, 3) for k in (False, True) for n in (False, True)}
        if "sweep_rows" in built[name]:
            rec["plans"]["rows C=4 k_best"] = sweep_pallas.launch_plan(
                cs.S, 4, True)
            rec["plans"]["tiles C=4 masked"] = \
                sweep_pallas_perpixel.launch_plan(cs.S, 4, False, True)
        for case in runs(name):
            fn, C, act = cases[case]
            w = torch.zeros(1, dtype=torch.int64, device=dev)
            res = fn(w)
            torch.cuda.synchronize()
            rec["work"][case] = int(w)
            rec["bound_ms"][case] = int(w) * flops_per_sample_step(C) \
                / cs.PEAK_FP32 * 1e3
            if act is not None:
                got = [getattr(res, f)[act] for f in
                       ("best_score", "score_mean", "best_depth", "rbar")]
                if case not in want:
                    want[case] = got
                rec["bitwise_vs_" + ref][case] = all(
                    torch.equal(a, b) for a, b in zip(got, want[case]))
            del res
    times = {n: {c: [] for c in runs(n)} for n in designs}
    for _ in range(args.reps):
        for name in designs:
            use(name)
            for case in runs(name):
                times[name][case].append(cs.time_ms(torch, cases[case][0],
                                                    reps=1))
    for name in designs:
        rec = out[name]
        for case, ts in times[name].items():
            rec["ms"][case] = sorted(ts)[len(ts) // 2]
        print(json.dumps(rec))
    return 0 if all(all(r["bitwise_vs_" + ref].values())
                    for r in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
