"""Benchmark: end-to-end fine-to-coarse depth on the anchored synthetic
scenes of ``bench.py`` (the JAX package's benchmark), on the card.

    python -m remotesensingproject_tpu_torch.cli.main bench

Counterpart of the repository's ``bench.py``, which stays the JAX
package's.  The same four configurations, each a scene of the reference's
report (BASELINE.md), chosen by the same environment variables:

  (none)          SkysatLR18 [120]: 100 x 540 x 960, C=1, d in [-1, 4], D=120
  BENCH_D240=1    SkysatLR18 [240]: the same scene, D=240
  BENCH_HR=1      SkysatHR18 [120]: 100 x 1080 x 1920, C=1, d in [-2, 8]
  BENCH_RGB=1     MansionLR [120]: 100 x 720 x 1146, C=3 uint8, d in [0, 4]

  BENCH_SMALL=1      the small sizes of bench.py (and no cold gate)
  BENCH_SCORE=disp|line   the confidence criterion (metric name suffixed)
  BENCH_FAST=1       fast mode (the pixel sweep's mean shift capped)
  BENCH_COLD_ONLY=1  one run: the warm figures are the cold run's
  BENCH_CKPT_DIR=p   checkpoint and resume each level under p
  BENCH_PROGRESS=1   print the pass progress of every level
  BENCH_NO_CACHE=1   build the CUDA kernels into a fresh directory, so
                     that the cold run includes their nvcc build (bench.py:
                     no persistent compilation cache)

Each scene is made from bench.py's numpy draws (the same volume and ground
truth bit for bit) and broadcast to ``[V, S, U, C]`` on the device.  The
pipeline runs twice in the process (cold, then warm, the cold pyramid
freed in between); ``value`` is the warm throughput in MPix/s.  Prints ONE
JSON line with bench.py's keys and ``card`` (``nvidia-smi``'s name and
power limit of the card the numbers come from), the peak device memory
on stderr, and exits 1 when the quality gate or (except BENCH_SMALL) the
cold gate fails.

Quality gate, as bench.py's: RMSE and P90 of |fused - gt| over the pre-run
edge mask within 0.1 px of what the compiled reference scores on the same
scene (REF_ANCHOR.json); RMSE within 0.5 px of it for the disp and line
scores; P50 <= 0.5 px where the scene has no anchor.  Cold gate: the first
run beats the reference binary's own seconds for the configuration.

Runs on the card through ``types.resolve_device``; ``main(device="cpu")``
runs the plain versions on the CPU, as every other entry point does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import DEFAULT_PARAMS, DepthParams
from .models.fine_to_coarse import FineToCoarse
from .ops import cuda_build
from .ops.edge_confidence import edge_confidence_volume
from .ops.normalize import normalize_volume
from .types import resolve_device

#: scripts/ref_anchor.py's output at the repository's root; keys "SxVxUxD"
REF_ANCHOR_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "REF_ANCHOR.json")
RMSE_MARGIN_PX = 0.10
P90_MARGIN_PX = 0.10
#: RMSE margin of the disp and line scores (bench.py's evidence rows)
SCORE_MARGIN_PX = 0.5
#: P50 limit where the scene has no anchor
P50_LIMIT_PX = 0.5


def _layered_texture(rng, S, U, dmin, dmax):
    """bench.py's layer draws, in its order: six layers of disparities in
    [dmin, dmax], strip intervals and sinusoid textures (wavelengths 6-60
    px).  Returns (disparities [6], owner [S, U]: the nearest covering
    layer, val0 [S, U] float32: its radiance); ``rng`` goes on to the
    scene's further draws."""
    s_hat = S // 2
    n_layers = 6
    disps = np.sort(rng.uniform(dmin, dmax, n_layers))
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
    u_idx = np.arange(U)
    shifts = (s_hat - np.arange(S))[None, :, None] * disps[:, None, None]
    u0 = u_idx[None, None, :] - shifts                 # [L, S, U]
    a = np.array([iv[0] for iv in intervals])[:, None, None]
    b = np.array([iv[1] for iv in intervals])[:, None, None]
    covers = (u0 >= a) & (u0 <= b)
    owner = np.where(covers.any(0),
                     (n_layers - 1) - np.argmax(covers[::-1], axis=0), 0)
    src = np.take_along_axis(u0, owner[None], 0)[0]    # [S, U]
    val0 = 0.55 + (np.sin(2 * np.pi * src[..., None] / lams[owner]
                          + phs[owner]) * amps[owner]).sum(-1).astype(
                              np.float32)
    return disps, owner, val0


def synthetic_sequence(S, V, U, seed=0, dmin=-1.0, dmax=4.0, device=None):
    """bench.py's ``synthetic_sequence``: the layered moving-strip light
    field with band-limited texture, ``[V, S, U, 1]`` float32 on the device,
    and the true disparity per (s, u), ``[S, U]`` float32 (numpy)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    disps, owner, val0 = _layered_texture(rng, S, U, dmin, dmax)
    rowmod = rng.random((V,), dtype=np.float32) * 0.15
    vol = (torch.as_tensor(val0, device=dev)[None, :, :, None]
           + torch.as_tensor(rowmod, device=dev)[:, None, None, None])
    return vol, disps[owner].astype(np.float32)


def synthetic_sequence_rgb(S, V, U, seed=0, device=None):
    """bench.py's ``synthetic_sequence_rgb`` (BENCH_RGB=1): per-layer RGB
    gains, quantised to uint8 as the reference reads the scene back from
    8-bit PNGs: ``[V, S, U, 3]`` uint8 on the device, and the true
    disparity ``[S, U]`` float32 (numpy).

    ``val0 * g + rowmod`` is two roundings here, a multiply and an add, as
    in the JAX package on the CPU (XLA does not contract it into an FMA
    there), and ``torch.round`` rounds half to even, as ``jnp.round``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed + 101)
    disps, owner, val0 = _layered_texture(rng, S, U, 0.0, 4.0)
    gains = rng.uniform(0.55, 1.0, (len(disps), 3)).astype(np.float32)
    rowmod = rng.random((V,), dtype=np.float32) * 0.12
    volf = (torch.as_tensor(val0, device=dev)[None, :, :, None]
            * torch.as_tensor(gains[owner], device=dev)[None]
            + torch.as_tensor(rowmod, device=dev)[:, None, None, None])
    vol_u8 = torch.clamp(torch.round(volf * 255.0), 0, 255).to(torch.uint8)
    return vol_u8, disps[owner].astype(np.float32)


def edge_mask(vol, params: DepthParams) -> torch.Tensor:
    """The pre-run finest-level edge-confidence mask ``[S, V, U]`` (bool, on
    the volume's device): the definition of bench.py and
    scripts/ref_anchor.py, so the anchor and the gate select the same
    pixels."""
    epis = normalize_volume(vol, -1.0)
    ce, _ = edge_confidence_volume(epis, params)
    return (ce > params.edge_score_threshold).permute(1, 0, 2)


def percentiles(x: torch.Tensor, qs) -> list:
    """``np.percentile(x, q)`` (the linear method) for each q, from one sort
    of ``x`` on its device."""
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


def error_stats(fused: torch.Tensor, gt_s_u: np.ndarray,
                mask: torch.Tensor) -> Tuple[float, float, float, float]:
    """(RMSE, P50, P90, share of px) of |fused - gt| over ``mask``, gt
    ``[S, U]`` broadcast over v; NaN for an empty mask."""
    gt = torch.as_tensor(gt_s_u, device=fused.device)[:, None, :]
    err = torch.abs(fused - gt)[mask]
    cover = float(mask.float().mean())
    if err.numel() == 0:
        return float("nan"), float("nan"), float("nan"), cover
    rmse = float(torch.sqrt(torch.mean(err.double() ** 2)))
    p50, p90 = percentiles(err, (50, 90))
    return rmse, p50, p90, cover


def quality_ok(score_version: str, ref: Optional[Mapping], rmse: float,
               p50: float, p90: float) -> bool:
    """bench.py's quality gate: the delta to the reference's own accuracy
    on the scene (``ref``, a REF_ANCHOR.json entry), or P50 where there is
    no anchor."""
    if ref is None:
        return p50 <= P50_LIMIT_PX
    if score_version == "edge":
        return (rmse <= ref["rmse_px"] + RMSE_MARGIN_PX
                and p90 <= ref["p90_px"] + P90_MARGIN_PX)
    # evidence row: disp/line reject more sources, so coverage-conditioned
    # stats drift from the edge-mode anchor; a wide margin only
    return rmse <= ref["rmse_px"] + SCORE_MARGIN_PX


def exit_code(record: Mapping, small: bool) -> int:
    """bench.py's exit code for a record: 1 when the quality gate failed,
    or when the first run did not beat the reference binary (a user's
    first contact; BENCH_SMALL is exempt, its constant costs dominate);
    else 0."""
    if not record["quality_ok"]:
        return 1
    return 0 if record["cold_ok"] or small else 1


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """One configuration of the benchmark (bench.py's env selection)."""

    S: int
    V: int
    U: int
    D: int
    dmin: float
    dmax: float
    rgb: bool
    small: bool
    metric: str
    baseline_s: float   # the reference binary's seconds, scaled to S*V*U
    anchor_key: str
    params: DepthParams


def bench_config(env: Mapping[str, str],
                 shape: Optional[Tuple[int, int, int, int]] = None
                 ) -> BenchConfig:
    """The configuration bench.py's environment variables select;
    ``shape`` (S, V, U, D) replaces its size (tests run a tiny scene)."""
    small = env.get("BENCH_SMALL") == "1"
    rgb = env.get("BENCH_RGB") == "1"
    hr = env.get("BENCH_HR") == "1"
    d240 = env.get("BENCH_D240") == "1"
    suffix = ""
    if rgb:
        # MansionLR (report/rs_report.tex:427: 7409 s on the i3-6100)
        size = (24, 128, 256, 32) if small else (100, 720, 1146, 120)
        dmin, dmax, ref_s = 0.0, 4.0, (7409.0, 100 * 720 * 1146)
        metric = "mansionLR_synthetic_rgb_end_to_end_throughput"
        suffix = "rgb"
    elif hr:
        # SkysatHR18 (rs_report.tex:436: 1714 s for 1080x1920)
        size = (24, 256, 512, 32) if small else (100, 1080, 1920, 120)
        dmin, dmax, ref_s = -2.0, 8.0, (1714.0, 100 * 1080 * 1920)
        metric = "skysatHR18_synthetic_end_to_end_throughput"
    elif d240:
        # SkysatLR18 [240] (rs_report.tex:431: 804 s)
        size = (24, 128, 256, 64) if small else (100, 540, 960, 240)
        dmin, dmax, ref_s = -1.0, 4.0, (804.0, 100 * 540 * 960)
        metric = "skysatLR18_240_synthetic_end_to_end_throughput"
    else:
        # SkysatLR18 [120] (rs_report.tex:430: 448 s)
        size = (24, 128, 256, 32) if small else (100, 540, 960, 120)
        dmin, dmax, ref_s = -1.0, 4.0, (448.0, 100 * 540 * 960)
        metric = "skysatLR18_synthetic_end_to_end_throughput"
    S, V, U, D = shape or size
    score_version = env.get("BENCH_SCORE", "edge")
    params = DEFAULT_PARAMS
    if score_version != "edge":
        params = dataclasses.replace(params, score_version=score_version)
        metric += f"_{score_version}"
        if score_version == "disp" and not (rgb or hr or d240):
            # the reference's own seconds with C_d gating at 0.01 (the
            # default disp_score_threshold) on this configuration
            # (rs_report.tex:487)
            ref_s = (1462.0, ref_s[1])
    if env.get("BENCH_FAST") == "1":
        params = dataclasses.replace(params, fast=True)
        metric += "_fast"
    return BenchConfig(S=S, V=V, U=U, D=D, dmin=dmin, dmax=dmax, rgb=rgb,
                       small=small, metric=metric,
                       baseline_s=ref_s[0] * (S * V * U) / ref_s[1],
                       anchor_key=f"{S}x{V}x{U}x{D}{suffix}", params=params)


def reference_anchor(key: str) -> Optional[dict]:
    """The REF_ANCHOR.json entry of a scene, None if it has none."""
    try:
        with open(REF_ANCHOR_FILE) as f:
            return json.load(f)[key]
    except (OSError, KeyError):
        return None


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them; "cpu"
    for a CPU run."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60)
    except OSError as e:
        return f"{torch.cuda.get_device_name(device)}, nvidia-smi: {e}"
    if out.returncode != 0:
        return (f"{torch.cuda.get_device_name(device)}, nvidia-smi failed: "
                f"{out.stderr.strip()}")
    return out.stdout.strip()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def log(msg: str) -> None:
    print(msg, file=sys.stderr)


def run_once(vol, dmin, dmax, D, params, device, verbose=True,
             progress=False, ckpt_dir=None):
    """One full fine-to-coarse pipeline; returns (ftc, fused, seconds),
    the clock read after the device has finished."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        ftc = FineToCoarse(vol, dmin, dmax, D, params=params,
                           verbose=verbose, pass_progress=progress,
                           device=device)
        ftc.run(ckpt_dir=ckpt_dir)
        fused, _ = ftc.get_results()
        _sync(device)
    return ftc, fused, time.perf_counter() - t0


class BenchRun(NamedTuple):
    """What :func:`main` measured: the printed record, the last run's
    fused map ``[S, V, U]`` and its pyramid's level count."""

    record: dict
    fused: torch.Tensor
    levels: int


def main(environ: Optional[Mapping[str, str]] = None, device=None,
         shape: Optional[Tuple[int, int, int, int]] = None) -> BenchRun:
    """Run the configuration ``environ`` (default ``os.environ``) selects,
    print its JSON record, exit 1 on a failed gate.  ``shape`` (S, V, U,
    D) replaces the configuration's size."""
    env = os.environ if environ is None else environ
    dev = resolve_device(device)
    cfg = bench_config(env, shape)
    fresh_build = None
    if dev.type == "cuda":
        if env.get("BENCH_NO_CACHE") == "1":
            fresh_build = tempfile.TemporaryDirectory(prefix="rslf_kernels_")
            cuda_build.set_build_dir(fresh_build.name)
            log(f"# kernel build: fresh directory {fresh_build.name} (the "
                f"cold run includes nvcc)")
        else:
            built = [k for k in cuda_build.KERNELS
                     if cuda_build.library_path(k).exists()]
            log(f"# kernel build: {cuda_build.BUILD_DIR} (built already: "
                f"{built})")
        torch.cuda.reset_peak_memory_stats(dev)
    card = card_line(dev)
    log(f"# device={dev} ({card})")

    t0 = time.perf_counter()
    if cfg.rgb:
        vol, gt_s_u = synthetic_sequence_rgb(cfg.S, cfg.V, cfg.U, device=dev)
    else:
        vol, gt_s_u = synthetic_sequence(cfg.S, cfg.V, cfg.U, dmin=cfg.dmin,
                                         dmax=cfg.dmax, device=dev)
    _sync(dev)
    log(f"# generated volume {tuple(vol.shape)} {vol.dtype} in "
        f"{time.perf_counter() - t0:.3f}s")

    ckpt_dir = env.get("BENCH_CKPT_DIR") or None
    progress = env.get("BENCH_PROGRESS") == "1"

    def run():
        return run_once(vol, cfg.dmin, cfg.dmax, cfg.D, cfg.params, dev,
                        progress=progress, ckpt_dir=ckpt_dir)

    ftc, fused, cold_s = run()
    levels = len(ftc.computers)
    log(f"# cold (first run in the process) {cold_s:.3f}s")
    if env.get("BENCH_COLD_ONLY") == "1":
        warm_s = cold_s
    else:
        # free the cold pyramid before the warm one is built: at the HR
        # shape two pyramids would be held at once
        del ftc, fused
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ftc, fused, warm_s = run()
        log(f"# warm (steady state) {warm_s:.3f}s")
    mpix = cfg.S * cfg.V * cfg.U / 1e6
    log(f"# end-to-end warm {warm_s:.3f}s for {mpix:.1f} MPix ({levels} "
        f"pyramid levels)")
    # only the fused map is needed from here: free the pyramid before the
    # edge-confidence volume of the gate
    del ftc
    gc.collect()
    if fresh_build is not None:
        fresh_build.cleanup()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        log(f"# peak device memory {torch.cuda.max_memory_allocated(dev)} "
            f"bytes ({torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB,"
            f" torch.cuda.max_memory_allocated)")

    conf0 = edge_mask(vol, DEFAULT_PARAMS)
    rmse, p50, p90, cover = error_stats(fused, gt_s_u, conf0)
    del conf0
    log(f"# quality: RMSE {rmse:.4f} px  P50 {p50:.4f}  P90 {p90:.4f} on "
        f"{cover * 100:.1f}% edge-confident px")
    ref = reference_anchor(cfg.anchor_key)
    if ref is not None:
        log(f"# reference anchor ({cfg.anchor_key}): RMSE {ref['rmse_px']} "
            f"P90 {ref['p90_px']} on {ref['coverage'] * 100:.1f}%")
    else:
        log(f"# WARNING: no reference anchor for {cfg.anchor_key}; falling "
            f"back to an absolute P50 gate")
    ok = quality_ok(cfg.params.score_version, ref, rmse, p50, p90)

    mpixps = mpix / warm_s
    record = {
        "metric": cfg.metric,
        "value": mpixps,
        "unit": "MPix/s",
        "vs_baseline": mpixps / (mpix / cfg.baseline_s),
        "cold_s": cold_s,
        "steadystate_s": warm_s,
        "compile_s": max(0.0, cold_s - warm_s),
        "quality_rmse_px": rmse,
        "quality_p50_px": p50,
        "quality_p90_px": p90,
        "quality_ref_rmse_px": ref["rmse_px"] if ref else None,
        "quality_ok": bool(ok),
        "cold_ok": bool(cold_s <= cfg.baseline_s),
        "card": card,
    }
    # the record first: a failed gate must not discard the measurement
    print(json.dumps(record), flush=True)
    code = exit_code(record, cfg.small)
    if not record["quality_ok"]:
        log("# QUALITY GATE FAILED (see anchor above)")
    elif code:
        log(f"# COLD GATE FAILED: first run {cold_s:.3f}s > reference "
            f"{cfg.baseline_s:.1f}s")
    if code:
        sys.exit(code)
    return BenchRun(record, fused, levels)


if __name__ == "__main__":
    main()
