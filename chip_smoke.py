#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (details on further lines):

1. the card's name and power limit; build of every CUDA kernel from
   ``remotesensingproject_tpu_torch/csrc`` (one nvcc each, in parallel);
2. each kernel against its plain PyTorch version on the card, at the
   inputs of the first level-0 pass of the bench scene (SkysatLR18 [120]:
   S=100, V=540, U=960, D=120, d in [-1, 4]), plus per-pixel bounds and
   a C=3 slab: median and paint bitwise, the sweep within the tolerances
   of tests/test_torch_sweep.py; each kernel's time, its plain version's,
   and the least time the card could take (``bound_ms``);
3. the full fine-to-coarse pipeline on that scene through
   ``FineToCoarse(...).run(); get_results()``, with every kernel's launch
   count (each must be > 0), the wall time, and the quality gate of
   bench.py: RMSE and P90 of |fused - gt| over the pre-run edge mask
   within 0.1 px of REF_ANCHOR.json's compiled-reference numbers;
4. a ``{"kernels": [...]}`` JSON line, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device, without the
package beside it, or when any phase fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
S, V, U, D = 100, 540, 960, 120
DMIN, DMAX = -1.0, 4.0
ANCHOR_KEY = f"{S}x{V}x{U}x{D}"
MARGIN_PX = 0.10
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
SWEEP_TOL = {"best_score": 2e-5, "best_depth": 1e-6, "score_mean": 5e-5,
             "rbar": 2e-5}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def synthetic_sequence(torch, dev, seed=0):
    """The layered moving-strip scene of bench.py's synthetic_sequence
    (same numpy draws, so the same volume and ground truth), with the
    [V, S, U, 1] broadcast made on the card."""
    rng = np.random.default_rng(seed)
    s_hat = S // 2
    n_layers = 6
    disps = np.sort(rng.uniform(DMIN, DMAX, n_layers))
    intervals = [(-10 * U, 10 * U)]
    for _ in range(1, n_layers):
        a = int(rng.integers(0, U - 10))
        b = a + int(rng.integers(8, U // 4))
        intervals.append((a, b))
    K = 8
    lams = np.exp(rng.uniform(np.log(6.0), np.log(60.0),
                              (n_layers, K))).astype(np.float32)
    amps = rng.uniform(0.3, 1.0, (n_layers, K)).astype(np.float32)
    amps *= 0.42 / np.abs(amps).sum(1, keepdims=True)
    phs = rng.uniform(0, 2 * np.pi, (n_layers, K)).astype(np.float32)
    rowmod = rng.random((V,), dtype=np.float32) * 0.15
    u_idx = np.arange(U)
    shifts = (s_hat - np.arange(S))[None, :, None] * disps[:, None, None]
    u0 = u_idx[None, None, :] - shifts
    a = np.array([iv[0] for iv in intervals])[:, None, None]
    b = np.array([iv[1] for iv in intervals])[:, None, None]
    covers = (u0 >= a) & (u0 <= b)
    owner = np.where(covers.any(0),
                     (n_layers - 1) - np.argmax(covers[::-1], axis=0), 0)
    src = np.take_along_axis(u0, owner[None], 0)[0]
    val0 = 0.55 + (np.sin(2 * np.pi * src[..., None] / lams[owner]
                          + phs[owner]) * amps[owner]).sum(-1).astype(
                              np.float32)
    vol = (torch.as_tensor(val0, device=dev)[None, :, :, None]
           + torch.as_tensor(rowmod, device=dev)[:, None, None, None])
    return vol.contiguous(), disps[owner].astype(np.float32)


def time_ms(torch, fn, reps=3, setup=None):
    """Median CUDA-event time of ``fn(*setup())`` over ``reps`` runs."""
    times = []
    for _ in range(reps):
        args = setup() if setup else ()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def bound(nbytes, nflops):
    tb, tf = nbytes / PEAK_BYTES * 1e3, nflops / PEAK_FP32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from remotesensingproject_tpu_torch.config import DEFAULT_PARAMS
        from remotesensingproject_tpu_torch.models.depth2d import \
            Depth2DComputer
        from remotesensingproject_tpu_torch.models.fine_to_coarse import \
            FineToCoarse
        from remotesensingproject_tpu_torch.ops import cuda_build
        from remotesensingproject_tpu_torch.ops.median import \
            selective_median
        from remotesensingproject_tpu_torch.ops.median_pallas import \
            selective_median_cuda
        from remotesensingproject_tpu_torch.ops.propagation import propagate
        from remotesensingproject_tpu_torch.ops.propagation_pallas import \
            propagate_cuda
        from remotesensingproject_tpu_torch.ops.sweep import sweep_pile
        from remotesensingproject_tpu_torch.ops.sweep_pallas_pixel import (
            flops_per_sample_step, sweep_pile_pixel)
        from remotesensingproject_tpu_torch.ops.edge_confidence import \
            edge_confidence_volume
        from remotesensingproject_tpu_torch.ops.normalize import \
            normalize_volume
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "remotesensingproject_tpu")]
    if bad:
        print(f"chip_smoke: JAX modules loaded: {bad}", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 card: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build_s = cuda_build.build()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f}s wall, per kernel "
          + ", ".join(f"{k} {v:.2f}s" for k, v in build_s.items()))
    for name in cuda_build.KERNELS:
        for ln in (cuda_build.build_log(name) or "").splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas {name}: {ln.strip()}")

    # ---- phase 2: kernels vs plain versions at level-0 pass-1 inputs ----
    params = DEFAULT_PARAMS
    vol, gt_s_u = synthetic_sequence(torch, dev)
    comp = Depth2DComputer(vol, DMIN, DMAX, D, params=params, device=dev)
    epis = comp.epis
    frames = epis.permute(1, 0, 2, 3).contiguous()
    state = comp.initial_state()
    s_hat = S // 2
    active = (state.ce_mask[s_hat] & state.claim[s_hat]).contiguous()
    n_act = int(active.sum())
    print(f"phase 2 inputs: level 0, s_hat={s_hat}, {n_act} active px")
    records = {}
    failures = []

    def check_sweep(tag, ep, act, lo, hi, per_pixel):
        Vs, Ss, Us, Cs = ep.shape
        kw = dict(dmin_v_u=lo, dmax_v_u=hi) if per_pixel else {}
        work = torch.zeros(1, dtype=torch.int64, device=dev)
        got = sweep_pile_pixel(ep, DMIN, DMAX, D, s_hat, params, act,
                               work_count=work, **kw)
        torch.cuda.synchronize()
        out = {}
        t_plain = time_ms(torch, lambda: out.setdefault(
            "want", sweep_pile(ep, lo, hi, D, s_hat, params)), reps=1)
        want = out["want"]
        err = 0.0
        for name, tol in SWEEP_TOL.items():
            e = float((getattr(got, name)[act] - getattr(want, name)[act])
                      .abs().max())
            err = max(err, e)
            if not e <= tol:
                failures.append(f"sweep {tag} {name} max err {e} > {tol}")
        n_flip = int((got.best_depth[act] != want.best_depth[act]).sum())
        ms = time_ms(torch, lambda: sweep_pile_pixel(ep, DMIN, DMAX, D,
                                                     s_hat, params, act,
                                                     **kw))
        nbytes = ep.numel() * 4 + int(act.sum()) * 4 + Vs * Us * (3 + Cs) * 4
        if per_pixel:
            nbytes += 2 * Vs * Us * 4
        bms, by = bound(nbytes, int(work) * flops_per_sample_step(Cs))
        print(f"  sweep {tag}: max_abs_err {err:.3g} (tol {SWEEP_TOL}), "
              f"{n_flip} depth picks differ, kernel {ms:.3f} ms, plain "
              f"{t_plain:.1f} ms, bound {bms:.3f} ms by {by}, "
              f"{int(work)} sample-steps")
        return dict(max_abs_err=err, ms=ms, plain_ms=t_plain, bound_ms=bms,
                    bound_by=by), got

    full = lambda x: torch.full((V, U), x, dtype=torch.float32, device=dev)
    rec, res = check_sweep("uniform C=1", epis, active, full(DMIN),
                           full(DMAX), False)
    records["sweep_pixel"] = rec
    g = torch.Generator(device=dev).manual_seed(0)
    center = torch.rand((V, U), generator=g, device=dev) * 4.0 - 0.5
    lo = torch.clamp(center - 0.6, DMIN, DMAX).contiguous()
    hi = torch.clamp(center + 0.6, DMIN, DMAX).contiguous()
    check_sweep("per-pixel C=1", epis, active, lo, hi, True)
    rgb_gain = torch.tensor([1.0, 0.8, 0.6], device=dev)
    epis3 = (epis[:64] * rgb_gain).contiguous()
    check_sweep("per-pixel C=3 (64 rows)", epis3, active[:64].contiguous(),
                lo[:64].contiguous(), hi[:64].contiguous(), True)

    # merge as the pass does, then the median on the s_hat plane
    good = active & (res.best_score > params.raw_score_threshold)
    depth = torch.where(good, res.best_depth, torch.zeros_like(
        res.best_depth)).contiguous()
    mask = (state.ce_mask[s_hat] & ~(active & ~good)).contiguous()
    frame = frames[s_hat]

    def check_median(tag, src, fr, m):
        got = selective_median_cuda(src, fr, m, params.median_filter_size,
                                    params.median_filter_epsilon)
        out = {}
        plain = time_ms(torch, lambda: out.setdefault("want", selective_median(
            src, fr, m, params.median_filter_size,
            params.median_filter_epsilon)), reps=1)
        want = out["want"]
        if not torch.equal(got, want):
            failures.append(f"median {tag} not bitwise equal")
        err = float((got - want).abs().max())
        ms = time_ms(torch, lambda: selective_median_cuda(
            src, fr, m, params.median_filter_size,
            params.median_filter_epsilon), reps=5)
        Vm, Um, Cm = fr.shape
        taps = params.median_filter_size ** 2
        bms, by = bound(Vm * Um * (4 + 1 + 4 * Cm + 4),
                        int(m.sum()) * taps * (3 * Cm + 2))
        print(f"  median {tag}: bitwise {torch.equal(got, want)}, kernel "
              f"{ms:.3f} ms, plain {plain:.1f} ms, bound {bms:.4f} ms by "
              f"{by}")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by), got

    records["median"], filtered = check_median("C=1", depth, frame, mask)
    check_median("C=3 (64 rows)", depth[:64].contiguous(),
                 epis3[:, s_hat].contiguous(), mask[:64].contiguous())

    # the paint on fresh copies of the pass state
    conf = (state.ce[s_hat] * torch.abs(res.best_score - res.score_mean))
    conf = torch.where(good, conf, torch.zeros_like(conf)).contiguous()
    rbar = torch.where(good[..., None], res.rbar,
                       torch.zeros_like(res.rbar)).contiguous()
    claim0 = state.claim.clone()
    claim0[s_hat] = active

    def fresh():
        return (claim0.clone(), torch.zeros((S, V, U), device=dev),
                torch.zeros((S, V, U), device=dev))

    def paint(fn, cl, t0_, t1_):
        return fn(cl, frames, filtered, rbar, mask, s_hat,
                  params.slope_factor, params.propagation_epsilon,
                  [(t0_, filtered), (t1_, conf)])

    got = fresh()
    paint(propagate_cuda, *got)
    want = fresh()
    plain_ms = time_ms(torch, lambda: paint(propagate, *want), reps=1)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    if not same:
        failures.append("paint not bitwise equal")
    painted = int((claim0 & ~got[0]).sum())
    ms = time_ms(torch, lambda *a: paint(propagate_cuda, *a), reps=5,
                 setup=fresh)
    # claim read everywhere, colours read at unclaimed targets, claim and
    # the two payloads written at painted ones, the source planes once
    P, C = 2, 1
    n_open = int(claim0.sum())
    nbytes = S * V * U + n_open * 4 * C + painted * (1 + 4 * P) \
        + V * U * (4 + 4 * C + 4 * P)
    bms, by = bound(nbytes, n_open * (3 * C + 3))
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    records["paint"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by)
    print(f"  paint C=1: bitwise {same}, {painted} targets painted, kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bms:.3f} ms by {by}")
    del comp, epis, frames, state, res, got, want, claim0, epis3
    torch.cuda.empty_cache()
    if failures:
        print("phase 2 FAILED: " + "; ".join(failures))
        return 1
    print("phase 2 ok: every kernel agrees with its plain version")

    # ---- phase 3: the main path, counts reset just before ----
    wrappers = {"sweep_pixel": sweep_pile_pixel,
                "median": selective_median_cuda, "paint": propagate_cuda}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ftc = FineToCoarse(vol, DMIN, DMAX, D, params=params, device=dev)
    ftc.run()
    fused, validity = ftc.get_results()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    levels = [(*c.epis.shape[:3], c.passes_run, round(t, 3))
              for c, t in zip(ftc.computers, ftc.level_seconds)]
    print(f"phase 3 pipeline: {wall:.2f}s wall, {len(levels)} levels "
          f"(V, S, U, passes, s) {levels}, launches "
          f"{launches}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")
    del ftc
    fused = fused.cpu().numpy()
    validity = validity.cpu().numpy()
    ce, _ = edge_confidence_volume(normalize_volume(vol), params)
    conf0 = (ce > params.edge_score_threshold).permute(1, 0, 2).cpu().numpy()
    gt = np.broadcast_to(gt_s_u[:, None, :], fused.shape)
    err = np.abs(fused - gt)[conf0]
    rmse = float(np.sqrt(np.mean(err ** 2)))
    p90 = float(np.percentile(err, 90))
    with open(os.path.join(HERE, "REF_ANCHOR.json")) as f:
        ref = json.load(f)[ANCHOR_KEY]
    ok_q = (rmse <= ref["rmse_px"] + MARGIN_PX
            and p90 <= ref["p90_px"] + MARGIN_PX)
    ok_shape = fused.shape == (S, V, U) and bool(np.isfinite(fused).all())
    print(f"phase 3 quality: RMSE {rmse:.4f} px (gate "
          f"{ref['rmse_px'] + MARGIN_PX:.4f}), P90 {p90:.4f} px (gate "
          f"{ref['p90_px'] + MARGIN_PX:.4f}) on {conf0.mean() * 100:.1f}% "
          f"edge px; coverage {validity.mean() * 100:.1f}%; finite "
          f"{S}x{V}x{U}: {ok_shape}")
    if not (ok_q and ok_shape and all(n > 0 for n in launches.values())):
        print("phase 3 FAILED")
        return 1

    meta = {
        "sweep_pixel": ("remotesensingproject_tpu_torch/csrc/sweep_pixel.cu",
                        "remotesensingproject_tpu/ops/sweep_pallas_pixel.py:61"),
        "median": ("remotesensingproject_tpu_torch/csrc/median.cu",
                   "remotesensingproject_tpu/ops/median_pallas.py:40"),
        "paint": ("remotesensingproject_tpu_torch/csrc/paint.cu",
                  "remotesensingproject_tpu/ops/propagation_pallas.py:57"),
    }
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=launches[k], library_ms=None, **records[k])
               for k, (src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
