#!/usr/bin/env python3
"""The five kernels and the two pipelines of two trees of the port, on one
GPU.

    python3 scripts/torch_kernel_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (for example an earlier commit
unpacked with ``git archive``).  For each, in turn and in its own process,
the script builds that tree's kernels and prints one JSON line of
CUDA-event times (medians), at the shapes of ``chip_smoke.py``:

* at the inputs of the first level-0 pass of the bench scene (C=1): the
  pixel sweep (5 calls) with its launch plan, the same with no mean-shift
  step (its staging and bookkeeping alone), then merge, the median (20
  calls; also on a
  64-row slab of the four-band scene, C=4, and at the level-4 shape of the
  pyramid cut from the level-0 inputs, each both as one call on the host
  clock and as the device time a launch back to back, ``device_ms``, with
  an empty kernel's launch beside them where the tree has one) and the paint
  (10 calls, each on a fresh copy of the pass state), the paint again on
  a late pass (a tenth of the open targets and a hundredth of the
  sources); the row sweep at the pile's input, every row
  of that scene (3 calls), and on a 64-row slab of the four-band scene
  with ``k_best`` (C=4, 5 calls) and on a twentieth of that slab's pixels
  (a late pass);
* the pixel sweep at the first level-0 pass of bench.py's D240, HR and RGB
  scenes (C=1, C=1, C=3; made from its draws as ``chip_smoke.py``'s phase
  15 makes them; 3 calls each), each with its launch plan; at the RGB
  scene's, the two other launchers of the core at C=3 too (3 calls each):
  the row sweep over every row (the pile route on RGB frames) and the tile
  sweep in the tile mode (the route past D = 1024) under per-pixel bounds
  drawn from a seed, each with its launch plan and the fp32 bound of its
  work (``_bound_ms``, as ``chip_smoke.py`` computes it);
* the wall time of the C=1 pipeline (second run, and the second to sixth
  runs as ``c1_pipeline_runs_s``) and of the four-band pipeline (one run),
  host clock around work that ends in a synchronise;
* at the first-pass inputs of levels 1 and 4 of the four-band pyramid: the
  tile sweep in the tile mode (5 and 20 calls) and, at level 1, in the
  pixel mode (3 calls);
* the registers nvcc reports for each kernel, the median's SASS
  instruction and FMNMX counts, and per instantiation of the sweep core
  its SASS instruction count and a digest of its instructions (equal
  digests: the same machine code).

Each JSON line goes to standard output, so a chip call's own log holds the
numbers.  List the roots as A B B A to compare two trees within one call.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sass_digests(lib_path) -> dict:
    """{sweep core instantiation: "instructions digest"} of a built library
    (``cuobjdump -sass``; its instructions' text, addresses and encodings
    left out); {} where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    cs = _chip_smoke()
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120).stdout
    ops, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = cs.kernel_name(ln) if "sweep_pc_kernel" in ln else None
            if name:
                ops[name] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?);", ln)
        if name and m:
            ops[name].append(m.group(1).strip())
    return {k: f"{len(v)} " + hashlib.sha256(
        "\n".join(v).encode()).hexdigest()[:16] for k, v in ops.items()}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(root: str) -> dict:
    import time

    import torch

    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(root))
    from remotesensingproject_tpu_torch import bench
    from remotesensingproject_tpu_torch.config import DEFAULT_PARAMS as p
    from remotesensingproject_tpu_torch.models.depth2d import Depth2DComputer
    from remotesensingproject_tpu_torch.models.fine_to_coarse import \
        FineToCoarse
    from remotesensingproject_tpu_torch.ops import cuda_build
    from remotesensingproject_tpu_torch.ops.normalize import normalize_volume
    from remotesensingproject_tpu_torch.ops.pyramid import cv_resize_shape
    from remotesensingproject_tpu_torch.ops.median_pallas import \
        selective_median_cuda
    from remotesensingproject_tpu_torch.ops.propagation_pallas import \
        propagate_cuda
    from remotesensingproject_tpu_torch.ops.sweep_pallas import \
        sweep_pile_rows
    from remotesensingproject_tpu_torch.ops.sweep_pallas_perpixel import (
        sweep_pile_tiles, tile_quantized_bounds)
    from remotesensingproject_tpu_torch.ops import (sweep_pallas,
                                                    sweep_pallas_perpixel,
                                                    sweep_pallas_pixel)
    from remotesensingproject_tpu_torch.ops.sweep_pallas_pixel import (
        flops_per_sample_step, sweep_pile_pixel)

    cuda_build.build()
    dev = torch.device("cuda")
    D, bounds = cs.D, (cs.DMIN, cs.DMAX)
    vol, _ = cs.synthetic_sequence(torch, dev)
    comp = Depth2DComputer(vol, *bounds, D, params=p, device=dev)
    st = comp.initial_state()
    sh = cs.S // 2
    active = (st.ce_mask[sh] & st.claim[sh]).contiguous()

    def pixel(params=p):
        return sweep_pile_pixel(comp.epis, *bounds, D, sh, params, active)

    res = pixel()
    no_steps = dataclasses.replace(p, mean_shift_max_iter=0)
    out = {"root": root, "card": cs.card_line(),
           "sweep_pixel_ms": cs.time_ms(torch, pixel, reps=5),
           "sweep_pixel_plan": sweep_pallas_pixel.launch_plan(cs.S, 1),
           "sweep_pixel_no_steps_ms": cs.time_ms(
               torch, lambda: pixel(no_steps), reps=5),
           "sweep_rows_ms": cs.time_ms(
               torch, lambda: sweep_pile_rows(comp.epis, *bounds, D, sh, p),
               reps=3)}
    # the row sweep on a 64-row slab of the four-band scene, with k_best,
    # then on a twentieth of its pixels
    vol4, _ = cs.synthetic_sequence(torch, dev, gains=cs.BAND_GAINS)
    epis4 = normalize_volume(vol4[:64].contiguous())
    del vol4
    g = torch.Generator(device=dev).manual_seed(0)
    few = torch.rand((64, cs.U), generator=g, device=dev) < 0.05

    def rows4(with_k, act=None):
        return sweep_pile_rows(epis4, *bounds, D, sh, p, with_k_best=with_k,
                               active_v_u=act)

    out["sweep_rows_c4_slab_ms"] = cs.time_ms(torch, lambda: rows4(True),
                                              reps=5)
    out["sweep_rows_c4_late_ms"] = cs.time_ms(
        torch, lambda: rows4(False, few), reps=5)
    frame4 = epis4[:, sh].contiguous()
    del epis4
    good = active & (res.best_score > p.raw_score_threshold)
    zero = torch.zeros((), device=dev)
    depth = torch.where(good, res.best_depth, zero).contiguous()
    mask = (st.ce_mask[sh] & ~(active & ~good)).contiguous()
    frames = comp.epis.permute(1, 0, 2, 3).contiguous()
    frame = frames[sh]

    def median():
        return selective_median_cuda(depth, frame, mask,
                                     p.median_filter_size,
                                     p.median_filter_epsilon)

    filtered = median()
    conf = torch.where(good, st.ce[sh] * torch.abs(res.best_score
                                                   - res.score_mean),
                       zero).contiguous()
    rbar = torch.where(good[..., None], res.rbar, zero).contiguous()
    claim0 = st.claim.clone()
    claim0[sh] = active
    shape = tuple(claim0.shape)

    def fresh(claim=claim0):
        return (claim.clone(), torch.zeros(shape, device=dev),
                torch.zeros(shape, device=dev))

    def paint(cl, t0, t1, sources=mask):
        propagate_cuda(cl, frames, filtered, rbar, sources, sh,
                       p.slope_factor, p.propagation_epsilon,
                       [(t0, filtered), (t1, conf)])

    out["median_ms"] = cs.time_ms(torch, median, reps=20)
    v4, u4 = cs.V, cs.U
    for _ in range(4):
        v4, u4 = cv_resize_shape(v4), cv_resize_shape(u4)
    cases = {"": (depth, frame, mask),
             "_c4_slab": (depth[:64].contiguous(), frame4,
                          mask[:64].contiguous()),
             "_level4": [x[:v4, :u4].contiguous()
                         for x in (depth, frame, mask)]}
    for tag, (dm, fm, mm) in cases.items():
        def med(dm=dm, fm=fm, mm=mm):
            return selective_median_cuda(dm, fm, mm, p.median_filter_size,
                                         p.median_filter_epsilon)
        if tag:
            out[f"median{tag}_ms"] = cs.time_ms(torch, med, reps=20)
        out[f"median{tag}_device_ms"] = cs.device_ms(torch, med)
    if hasattr(cuda_build.load("median"), "rslf_launch_floor"):
        out["empty_kernel_device_ms"] = cs.launch_floor_ms(torch, cuda_build,
                                                           dev)
    del frame4
    out["paint_ms"] = cs.time_ms(torch, paint, reps=10, setup=fresh)
    claim_late = claim0 & (torch.rand(shape, generator=g, device=dev) < 0.1)
    mask_late = mask & (torch.rand(mask.shape, generator=g, device=dev)
                        < 0.01)
    out["paint_late_ms"] = cs.time_ms(
        torch, lambda *a: paint(*a, sources=mask_late), reps=10,
        setup=lambda: fresh(claim_late))
    del comp, st, res, frames, claim0, claim_late
    torch.cuda.empty_cache()
    for tag, env in (("d240", {"BENCH_D240": "1"}), ("hr", {"BENCH_HR": "1"}),
                     ("rgb", {"BENCH_RGB": "1"})):
        cfg = bench.bench_config(env)
        if cfg.rgb:
            v_, _ = bench.synthetic_sequence_rgb(cfg.S, cfg.V, cfg.U,
                                                 device=dev)
        else:
            v_, _ = bench.synthetic_sequence(cfg.S, cfg.V, cfg.U,
                                             dmin=cfg.dmin, dmax=cfg.dmax,
                                             device=dev)
        c_ = Depth2DComputer(v_, cfg.dmin, cfg.dmax, cfg.D, params=p,
                             device=dev)
        del v_
        st_, sh_ = c_.initial_state(), cfg.S // 2
        act_ = (st_.ce_mask[sh_] & st_.claim[sh_]).contiguous()
        del st_

        def scene_pixel(c_=c_, cfg=cfg, sh_=sh_, act_=act_):
            return sweep_pile_pixel(c_.epis, cfg.dmin, cfg.dmax, cfg.D, sh_,
                                    p, act_)

        scene_pixel()
        out[f"sweep_pixel_{tag}_ms"] = cs.time_ms(torch, scene_pixel, reps=3)
        out[f"sweep_pixel_{tag}_plan"] = sweep_pallas_pixel.launch_plan(
            cfg.S, c_.epis.shape[-1])
        if cfg.rgb:
            def rows3(c_=c_, cfg=cfg, sh_=sh_, work=None):
                return sweep_pile_rows(c_.epis, cfg.dmin, cfg.dmax, cfg.D,
                                       sh_, p, work_count=work)

            gr = torch.Generator(device=dev).manual_seed(0)
            span = cfg.dmax - cfg.dmin
            plo = cfg.dmin + 0.25 * span * torch.rand(act_.shape,
                                                      generator=gr,
                                                      device=dev)
            phi = cfg.dmax - 0.25 * span * torch.rand(act_.shape,
                                                      generator=gr,
                                                      device=dev)
            qlo, qhi = tile_quantized_bounds(act_, plo, phi,
                                             (cfg.dmin, cfg.dmax))

            def tiles3(c_=c_, cfg=cfg, sh_=sh_, act_=act_, work=None):
                return sweep_pile_tiles(c_.epis, qlo, qhi, cfg.D, sh_, p,
                                        active_v_u=act_, pdmin_v_u=plo,
                                        pdmax_v_u=phi, work_count=work)

            for key, fn in (("sweep_rows_c3_pile", rows3),
                            ("sweep_tiles_c3_tile", tiles3)):
                # the fp32 bound of this run's work, as chip_smoke.py's
                w = torch.zeros(1, dtype=torch.int64, device=dev)
                fn(work=w)
                out[f"{key}_ms"] = cs.time_ms(torch, fn, reps=3)
                out[f"{key}_bound_ms"] = int(w) * flops_per_sample_step(3) \
                    / cs.PEAK_FP32 * 1e3
            out["sweep_rows_c3_plan"] = sweep_pallas.launch_plan(cfg.S, 3)
            out["sweep_tiles_c3_plan"] = sweep_pallas_perpixel.launch_plan(
                cfg.S, 3, False, True)
            del rows3, tiles3, plo, phi, qlo, qhi
        del c_, act_, scene_pixel
        torch.cuda.empty_cache()

    def pipeline(v):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = FineToCoarse(v, *bounds, D, params=p, device=dev)
        f.run()
        f.get_results()
        torch.cuda.synchronize()
        return f, time.perf_counter() - t0

    pipeline(vol)
    runs = [pipeline(vol)[1] for _ in range(5)]
    out["c1_pipeline_s"] = runs[0]
    out["c1_pipeline_runs_s"] = [round(t, 4) for t in runs]
    del vol
    torch.cuda.empty_cache()
    vol4, _ = cs.synthetic_sequence(torch, dev, gains=cs.BAND_GAINS)
    ftc4, out["four_band_pipeline_s"] = pipeline(vol4)
    out["four_band_level_s"] = [round(t, 3) for t in ftc4.level_seconds]

    def tiles(lvl, tile_mode, reps):
        c, pl = ftc4.computers[lvl], ftc4.level_params[lvl]
        s1 = c.initial_state()
        shl = c.epis.shape[1] // 2
        act = (s1.ce_mask[shl] & s1.claim[shl]).contiguous()
        lo = c.dmin_s_v_u[shl].contiguous()
        hi = c.dmax_s_v_u[shl].contiguous()
        kw = {}
        if tile_mode:
            kw = dict(pdmin_v_u=lo, pdmax_v_u=hi)
            lo, hi = tile_quantized_bounds(act, lo, hi, bounds)
        return cs.time_ms(torch, lambda: sweep_pile_tiles(
            c.epis, lo, hi, D, shl, pl, active_v_u=act, **kw), reps=reps)

    tiles(1, True, 1)
    out["sweep_tiles_level1_tile_ms"] = tiles(1, True, 5)
    out["sweep_tiles_level1_pixel_ms"] = tiles(1, False, 3)
    out["sweep_tiles_level4_tile_ms"] = tiles(4, True, 20)
    out["ptxas"] = {f"{n} {fn}": ln for n in cuda_build.KERNELS
                    for fn, ln in cs.ptxas_summary(cuda_build.build_log(n)
                                                   or "")
                    if "registers" in ln}
    out["sass_median"] = cs.sass_summary(cuda_build.library_path("median"))
    out["sass_sweep"] = {f"{n} {fn}": d for n in ("sweep_pixel", "sweep_rows",
                                                   "sweep_tiles")
                         for fn, d in sass_digests(
                             cuda_build.library_path(n)).items()}
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])))
        return 0
    rc = 0
    for root in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, __file__, "--one", root],
                             timeout=900).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
