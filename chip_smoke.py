#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (details on further lines):

1. the card's name and power limit; build of every CUDA kernel from
   ``remotesensingproject_tpu_torch/csrc`` (one nvcc each, in parallel),
   with the registers, stack frame and spills nvcc reports (the median's
   SIZE = 5 instantiations must have neither stack frame nor spills), the
   median's instructions (``cuobjdump -sass``, where the toolkit has it),
   and the block size, shared memory and resident blocks the launchers of
   the tile and row sweeps and the tiles the median's chose;
2. the plan of every pixel-sweep instantiation of the passes (C=1 and 3,
   linear and nearest, with and without k_best: threads, blocks an SM,
   shared bytes a block, resident warps an SM); each kernel against its
   plain PyTorch version on the card, at the
   inputs of the first level-0 pass of the bench scene (SkysatLR18 [120]:
   S=100, V=540, U=960, D=120, d in [-1, 4]), plus per-pixel bounds and
   a C=3 slab (64 rows, S=100) for the pixel sweep under the linear rule
   with per-pixel and uniform bounds, the nearest rule, a ``u_valid``
   window under both rules and k_best, and its new modes there: k_best (line
   mode's input), the fast cap (against the plain sweep with 5 mean-shift
   steps), the nearest rule with uniform and per-pixel bounds; the tile
   sweep's nearest rule at C=4 on a 64-row slab; the row sweep at the
   pile's input (all rows of that scene, s_hat=50), with k_best and at C=4
   on 64-row slabs,
   and on a late pass's few active pixels; median and paint at C=1 and at
   C=4, the paint also on a late pass's few sources and open targets with
   a forced tile width, the median also at the level-4 shape of the
   pyramid (beside an empty kernel's launch, the floor) and at a generic
   odd and even window size; the paint with three payloads (line mode:
   depth, disp_conf, line_conf; sources C_l > threshold) at a first and a
   late pass; the line confidence at the good pixels of the first level-0
   pass and of a late one (nvcc's report of it must show no stack frame),
   timed beside the plain version over the post-sweep mask; the pass's
   merge at the first level-0 pass and at a late one (a few per cent of
   its active pixels), timed beside its plain route's 19 launches.  Every
   kernel bitwise;
   each kernel's time, its plain version's, and the least time the card
   could take (``bound_ms``);
3. the full fine-to-coarse pipeline on that scene through
   ``FineToCoarse(...).run(); get_results()``, with every kernel's launch
   count (the merge's must equal the passes run), the wall time, and the
   quality gate of bench.py: RMSE and P90 of
   |fused - gt| over the pre-run edge mask within 0.1 px of
   REF_ANCHOR.json's compiled-reference numbers;
4. the pile (``Depth1DComputerPile``: one s_hat, all rows) on that scene,
   with its wall time, launches and the error of its depths at s_hat, then
   on the bundled data/strips16 scene with the gate of
   tests/test_sample_data.py;
5. the four-band pipeline: ``FineToCoarse`` on the bench scene's draws
   with four fixed per-layer band gains (100x540x960x4), with wall time per
   level, launches, peak memory and RMSE / P90 against ground truth; its
   fused map must be finite;
6. the tile sweep against its plain version, in the tile and the pixel
   mode, at the first-pass inputs of level 1 of phase 5's pyramid (k_best
   on a 64-row slab), and in the tile mode at those of level 4 (a coarse
   level of a few thousand pixels), bitwise;
7. line mode: ``FineToCoarse`` with ``score_version="line"`` on the bench
   scene, with wall time, launches, peak memory and RMSE / P90 beside the
   JAX package's (BENCH_LINE.json), and bench.py's line gate (RMSE within
   0.5 px of the anchor);
8. fast mode: ``FineToCoarse`` with ``fast=True`` on the bench scene, with
   phase 3's gate, beside the JAX package's figures (BENCH_FASTMODE.json);
9. nearest interpolation (no anchor: finite maps, errors printed): the pile
   on the bench scene (pixel sweep), on data/strips16 and on the four-band
   scene (tile sweep), and one ``FineToCoarse`` run on the bench scene;
10. ``Depth1DComputer`` (one EPI row, no median) on row V/2 of the bench
   scene at D=120 (pixel sweep) and D=1030 (tile sweep, pixel mode) and of
   the four-band scene (tile sweep): each result bitwise equal to its plain
   version on the card and finite, the row sweep never launched, the
   sweep's own time against its plain version and its bound, and
   |depth - gt| P50 / P90 over the edge mask;
11. the CLI on the card (``depth1d``, ``pile``, ``depth2d``, and
   ``fine-to-coarse --ckpt-dir`` twice: the second run restores every level,
   runs no pass and writes the first run's npz bit for bit) on data/strips16
   into a temporary directory, with the PNGs each command must write; and
   the host seconds of ``get_coloured_depth_maps()`` and of one checkpoint
   save and load of level 0 of phase 3's pipeline (measured there);
12. the (v, u) mesh's kernel operands at the first level-0 pass of the
   bench scene, on the right half of its columns haloed as rank 1 of a
   (1, 2) mesh haloes them: the pixel and the tile sweep (pixel mode) with
   the image's ``u_valid`` window, the paint from sources haloed by pado
   with ``u_origin``; each bitwise against its plain version and against
   the whole scene's kernel result on the half, with its time and bound;
13. the sharded fine-to-coarse on the bench scene (``FineToCoarse(...,
   mesh=...)``) at world 1 over NCCL and at world 2 over gloo, both ranks
   on the one card (``torch.multiprocessing``, spawn), and a (1, 2) (v, u)
   mesh on level 0 (``ShardedDepth2DComputer``) in the world of two: the
   fused map and validity bitwise equal to phase 3's (so phase 3's
   REF_ANCHOR gate holds), the mesh's level-0 state bitwise equal to phase
   3's level 0; wall time (the second run in each rank), backend, each
   rank's launches, and what one summed count, one median row halo and
   one paint u-halo cost at level-0 sizes;
14. ``--no-pallas``: ``FineToCoarse(..., use_pallas=False)`` and the CLI's
   ``fine-to-coarse --no-pallas`` on data/strips16 on the card: no kernel
   launched but the merge's (no stage hook: XLA on both of the JAX
   package's paths), the results on the card, the CLI's npz equal to the
   API's, and the gate of tests/test_sample_data.py on the fused map;
15. bench.py's scenes through the port's ``bench``: first the pixel sweep,
   the median and the paint against their plain versions, bitwise, at the
   first level-0 pass of the D240 (SkysatLR18 [240]: D=240), HR
   (SkysatHR18: 100x1080x1920, d in [-2, 8]) and RGB (MansionLR:
   100x720x1146, C=3 uint8, d in [0, 4]) scenes (the plain sweep, and at
   HR the plain paint, on the first 64 rows), with the C=3 launch plan of
   the pixel sweep beside the C=1 one; then ``bench.main`` on D240, HR and
   RGB (one run each), on the LR scene with ``BENCH_SCORE=disp`` and on
   the LR scene cold and warm: each record printed with its wall time, peak
   memory, launches and levels, each gate passed, and the LR fused map
   bitwise phase 3's;
16. the native frame loader: whether g++, png.h, jpeglib.h and the
   libraries are there; if so its build, the RGB scene's 100 frames
   written as PNG and read back by it and by PIL (each byte-equal to the
   scene, host seconds of each), and data/strips16 read by it equal to
   PIL's; where they are not, the frames are read by PIL alone; then
   ``fine-to-coarse`` through the CLI on the PNG folder, its fused map
   bitwise phase 15's RGB run (with the loader there: read without
   falling back to PIL);
17. a ``{"kernels": [...]}`` JSON line (the new modes of a kernel under
   ``modes``, depth1d's sweeps, the mesh's operands and phase 15's scenes
   among them), the card line again, and last ``{"ok": true, "device":
   {...}}``.

Launch counts are set to 0 just before each main path (phases 3, 4, 5,
7-11, 13's runs in each rank, 14, 15's runs, 16's CLI run) and read just
after; each path fails if one of its kernels never launched (phase 14 if
any launched).  Exits
non-zero, printing no result, without a CUDA device, without the package
beside it, or when any phase (or any rank) fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.append(HERE)
from benchmark import kernel_names  # noqa: E402
from benchmark.counts import (PEAK_BYTES, PEAK_FP32,  # noqa: E402
                              median_bytes)
S, V, U, D = 100, 540, 960, 120
DMIN, DMAX = -1.0, 4.0
ANCHOR_KEY = f"{S}x{V}x{U}x{D}"
MARGIN_PX = 0.10
SWEEP_OUTS = ("best_score", "score_mean", "best_depth", "rbar", "k_best")
# the JAX package's figures on the bench scene (BENCH_LINE.json,
# BENCH_FASTMODE.json): RMSE, P90 px
JAX_LINE = (1.4198, 3.4468)
JAX_FAST = (1.3088, 1.2649)
# bench.py's gate for the score versions other than edge
LINE_MARGIN_PX = 0.5
# per-layer gains of the four bands (blue, green, red, near-infrared) of
# the four-band scene; fixed, so the scene keeps the bench scene's draws
BAND_GAINS = np.array([[1.00, 0.85, 0.70, 0.95], [0.60, 0.75, 0.90, 1.00],
                       [0.90, 1.00, 0.65, 0.55], [0.70, 0.60, 0.95, 0.80],
                       [0.85, 0.95, 0.80, 0.60], [0.55, 0.70, 0.60, 0.90]],
                      np.float32)


def native_toolchain():
    """What building the native loader needs, each True or False: g++,
    png.h and jpeglib.h on its include path, and -lpng -ljpeg -lz
    linking."""
    cxx = shutil.which("g++")
    if cxx is None:
        return {"g++": False}

    def ok(src, *flags):
        r = subprocess.run([cxx, "-x", "c++", "-", *flags], input=src,
                           capture_output=True, text=True, timeout=120)
        return r.returncode == 0

    return {"g++": True,
            "png.h": ok("#include <png.h>\n", "-fsyntax-only"),
            "jpeglib.h": ok("#include <cstdio>\n#include <jpeglib.h>\n",
                            "-fsyntax-only"),
            "links": ok("int main() { return 0; }\n", "-o", os.devnull,
                        "-lpng", "-ljpeg", "-lz", "-lpthread")}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def synthetic_sequence(torch, dev, seed=0, gains=None):
    """The layered moving-strip scene of bench.py's synthetic_sequence
    (same numpy draws, so the same volume and ground truth), with the
    [V, S, U, 1] broadcast made on the card.  With ``gains`` ([layers, C])
    each layer's radiance is scaled per band, as bench.py's
    synthetic_sequence_rgb does, giving [V, S, U, C]."""
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
    val = torch.as_tensor(val0, device=dev)[None, :, :, None]
    if gains is not None:
        val = val * torch.as_tensor(gains[owner], device=dev)[None]
    vol = val + torch.as_tensor(rowmod, device=dev)[:, None, None, None]
    return vol.contiguous(), disps[owner].astype(np.float32)


def device_ms(torch, fn, reps=20):
    """CUDA-event time a call of ``fn`` over ``reps`` calls queued behind a
    busy wait, so that the card runs them back to back: the device time of
    a launch, without the host time of the wrapper.  The wait grows until
    the host has queued every call before it ends."""
    fn()
    cycles = reps * 200_000
    for _ in range(6):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        ran_dry = e0.query()  # the wait ended before the calls were queued
        torch.cuda.synchronize()
        if not ran_dry:
            return e0.elapsed_time(e1) / reps
        cycles *= 4
    raise RuntimeError("device_ms: the host never got ahead of the card")


def launch_floor_ms(torch, cuda_build, dev):
    """``device_ms`` of an empty kernel (``csrc/median.cu``); its launches
    count as the median's."""
    launch = cuda_build.Entry("median", "rslf_launch_floor", "s")
    return device_ms(torch, lambda: launch(device=dev), reps=50)


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


def kernel_name(line: str):
    """``name<int and bool args[,position rule]>`` of the mangled kernel
    name in a line of ptxas or cuobjdump output, None if none is in it
    (``benchmark/kernel_names.py``)."""
    m = re.search(r"_Z\w+", line)
    return kernel_names.kernel_name(m.group(0)) if m else None


def ptxas_summary(log: str):
    """(kernel, registers or stack-frame line) pairs of nvcc's -Xptxas -v
    output."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            name = kernel_name(ln)
        elif name and ("registers" in ln or "spill" in ln):
            out.append((name, ln.split(":", 1)[-1].strip()))
    return out


def sass_summary(lib_path, key="selective_median_kernel"):
    """{kernel: (instructions, FMNMX, instructions from the last barrier to
    the last exit)} of the functions of a built library whose name holds
    ``key``, NOPs left out (``cuobjdump -sass``); {} where the toolkit has
    no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120).stdout
    ops, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = kernel_name(ln) if key in ln else None
            if name:
                ops[name] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     ln)
        if name and m and not m.group(2).startswith("NOP"):
            ops[name].append((m.group(2), bool(m.group(1))))
    out = {}
    for k, v in ops.items():
        names = [op for op, _ in v]
        bar = max((i for i, op in enumerate(names)
                   if op.startswith("BAR.SYNC")), default=0)
        end = max((i for i, (op, pred) in enumerate(v)
                   if op == "EXIT" and not pred), default=len(v))
        out[k] = (len(v), sum(op.startswith("FMNMX") for op in names),
                  end - bar)
    return out


def _run(computer):
    """``computer.run()``; returns the computer."""
    computer.run()
    return computer


def u_block(torch, x, u0, width, halo, axis):
    """Columns [u0 - halo, u0 + width + halo) of ``x`` along ``axis``,
    zeros beyond the image: a rank's u-haloed block."""
    U_ = x.shape[axis]
    a, b = u0 - halo, u0 + width + halo
    core = x.narrow(axis, max(a, 0), min(b, U_) - max(a, 0))

    def zeros(n):
        shape = list(x.shape)
        shape[axis] = n
        return torch.zeros(shape, dtype=x.dtype, device=x.device)

    return torch.cat([zeros(max(0, -a)), core, zeros(max(0, b - U_))],
                     axis).contiguous()


def digest(t) -> str:
    """A hash of a tensor's dtype, shape and bytes (bitwise comparisons
    across processes)."""
    a = t.detach().contiguous().cpu().numpy()
    h = hashlib.sha256(f"{a.dtype}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()[:20]


#: the level-0 planes phase 13's (1, 2) mesh holds against phase 3's (r_bar
#: is dropped once a level has run)
LEVEL0_PLANES = ("ce", "ce_mask", "disp_conf", "best_depth", "claim")


def sharded_rank(rank, out, with_2d):
    """One rank of phase 13 in a started process group (every rank on
    cuda:0): the sharded fine-to-coarse on the bench scene over the 1-D
    mesh of every rank, then with ``with_2d`` level 0 on a (1, world) mesh;
    writes ``rank<r>_<world>.json`` with walls, launches and digests."""
    import torch
    import torch.distributed as dist

    from remotesensingproject_tpu_torch.config import DEFAULT_PARAMS
    from remotesensingproject_tpu_torch.models.fine_to_coarse import \
        FineToCoarse
    from remotesensingproject_tpu_torch.parallel.driver import \
        ShardedDepth2DComputer
    from remotesensingproject_tpu_torch.parallel.mesh import (make_mesh,
                                                              make_mesh_2d)
    from remotesensingproject_tpu_torch.parallel.sharding import \
        exchange_halos
    from remotesensingproject_tpu_torch.parallel.sharding2d import \
        halo_widths

    from remotesensingproject_tpu_torch.ops import cuda_build

    dev = torch.device("cuda:0")
    world = dist.get_world_size()
    vol, _ = synthetic_sequence(torch, dev)
    res = {"rank": rank, "backend": dist.get_backend()}

    def path(fn):
        cuda_build.launches.clear()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0, {
            k: cuda_build.launches[k] for k in cuda_build.KERNELS}

    def ftc():
        f = FineToCoarse(vol, DMIN, DMAX, D, params=DEFAULT_PARAMS,
                         mesh=make_mesh())
        f.run()
        return f.get_results(), [c.passes_run for c in f.computers]

    ftc()  # the first run of a new process also loads and allocates
    ((fused, validity), passes), wall, launches = path(ftc)
    res["ftc"] = dict(wall=wall, launches=launches, passes=passes,
                      fused=digest(fused), validity=digest(validity))
    del fused, validity

    def collective_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    # what a pass's collectives cost at level 0: the summed count, the
    # median's row halo (on the 1-D mesh) and, on a (1, world) mesh, the
    # paint's u-halo of the sources
    mesh = make_mesh()
    n = torch.ones(1, dtype=torch.int64, device=dev)
    rows = -(-V // world)
    src = torch.rand((rows, U), device=dev)
    msk = src > 0.5
    res["collective_ms"] = dict(
        count=collective_ms(lambda: (dist.all_reduce(n), int(n))),
        median_halo=collective_ms(lambda: exchange_halos(
            [src, src[..., None], msk], 2, 0, mesh.v_ring,
            [0.0, 0.0, False])))
    if with_2d:
        mesh2 = make_mesh_2d((1, world))
        _, pado = halo_widths(S, (DMIN, DMAX), DEFAULT_PARAMS.slope_factor)
        cols = torch.rand((V, U // world), device=dev)
        # the pass's source planes: depth, r_bar, mask, disp_conf
        res["collective_ms"]["paint_halo_2d"] = collective_ms(
            lambda: exchange_halos([cols, cols[..., None], cols > 0.5, cols],
                                   pado, 1, mesh2.u_ring,
                                   [0.0, 0.0, False, 0.0]))
        c, wall, launches = path(lambda: _run(ShardedDepth2DComputer(
            vol, DMIN, DMAX, D, mesh=mesh2, params=DEFAULT_PARAMS)))
        st = c.state
        res["mesh_1x2"] = dict(wall=wall, launches=launches,
                               passes=c.passes_run,
                               **{k: digest(getattr(st, k))
                                  for k in LEVEL0_PLANES})
    with open(os.path.join(out, f"rank{rank}_{world}.json"), "w") as f:
        json.dump(res, f)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from remotesensingproject_tpu_torch import bench
        from remotesensingproject_tpu_torch.cli import main as cli
        from remotesensingproject_tpu_torch.config import DEFAULT_PARAMS
        from remotesensingproject_tpu_torch.models.depth1d import (
            Depth1DComputer, depth1d_result)
        from remotesensingproject_tpu_torch.models.depth2d import \
            Depth2DComputer
        from remotesensingproject_tpu_torch.models.fine_to_coarse import \
            FineToCoarse
        from remotesensingproject_tpu_torch.models.pile import \
            Depth1DComputerPile
        from remotesensingproject_tpu_torch.native import loader as \
            native_loader
        from remotesensingproject_tpu_torch.ops import cuda_build
        from remotesensingproject_tpu_torch.ops.line_confidence import (
            line_confidence, line_confidence_cuda)
        from remotesensingproject_tpu_torch.ops.median import \
            selective_median
        from remotesensingproject_tpu_torch.ops import median_pallas
        from remotesensingproject_tpu_torch.ops.merge import merge, merge_cuda
        from remotesensingproject_tpu_torch.ops.median_pallas import \
            selective_median_cuda
        from remotesensingproject_tpu_torch.ops.propagation import propagate
        from remotesensingproject_tpu_torch.ops.propagation_pallas import \
            propagate_cuda
        from remotesensingproject_tpu_torch.ops.sweep import (SweepResult,
                                                              sweep_pile)
        from remotesensingproject_tpu_torch.ops.sweep_pallas import (
            candidate_grid, sweep_pile_rows, sweep_rows_plain)
        from remotesensingproject_tpu_torch.ops import (sweep_pallas,
                                                        sweep_pallas_perpixel,
                                                        sweep_pallas_pixel)
        from remotesensingproject_tpu_torch.ops.sweep_pallas_perpixel import (
            sweep_pile_tiles, tile_quantized_bounds)
        from remotesensingproject_tpu_torch.ops.sweep_pallas_pixel import (
            flops_per_sample_step, sweep_pile_pixel)
        from remotesensingproject_tpu_torch.ops.edge_confidence import (
            edge_confidence_frame, edge_confidence_volume)
        from remotesensingproject_tpu_torch.ops.normalize import \
            normalize_volume
        from remotesensingproject_tpu_torch.ops.pyramid import \
            cv_resize_shape
        from remotesensingproject_tpu_torch.parallel.distributed import \
            spawn as spawn_ranks
        from remotesensingproject_tpu_torch.parallel.sharding2d import \
            halo_widths
        from remotesensingproject_tpu_torch.types import (f32,
                                                          round_half_away)
        from remotesensingproject_tpu_torch.utils.checkpoint import (
            load_level, save_level)
        from remotesensingproject_tpu_torch.utils.io import (
            build_epis_from_imgs, list_images, read_imgs_from_folder)
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
    t_start = time.perf_counter()
    print(f"phase 1 card: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build_s = cuda_build.build()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f}s wall, per kernel "
          + ", ".join(f"{k} {v:.2f}s" for k, v in build_s.items()))
    failures = []
    median5 = []
    for name in cuda_build.KERNELS:
        for fn, ln in ptxas_summary(cuda_build.build_log(name) or ""):
            print(f"  ptxas {name} {fn}: {ln}")
            if fn.startswith("selective_median_kernel<5,") and "stack" in ln:
                median5.append(fn)
                if re.findall(r"(\d+) bytes", ln) != ["0", "0", "0"]:
                    failures.append(f"{fn}: {ln}")
            # the line confidence's pending sums must stay in registers
            if fn == "line_conf_kernel" and "stack" in ln and re.findall(
                    r"(\d+) bytes", ln) != ["0", "0", "0"]:
                failures.append(f"{fn}: {ln}")
    if not median5:
        failures.append("no ptxas report of the median's SIZE = 5 kernels")
    for fn, (n_ins, n_mm, n_after) in sass_summary(
            cuda_build.library_path("median")).items():
        print(f"  sass median {fn}: {n_ins} instructions, {n_mm} FMNMX, "
              f"{n_after} from the last barrier to the exit")
    for size_, C_ in ((5, 1), (5, 4), (7, 1), (4, 1), (17, 64), (5, 400)):
        print(f"  launch plan median size={size_} C={C_}: "
              f"{median_pallas.launch_plan(size_, C_)}")
    print(f"  launch plan sweep_tiles S={S} C=4: "
          f"{sweep_pallas_perpixel.launch_plan(S, 4)}")
    print(f"  launch plan sweep_tiles S={S} C=4 nearest pixel mode: "
          f"{sweep_pallas_perpixel.launch_plan(S, 4, False, False, True)}")
    for Cr, with_k in ((1, False), (4, True)):
        print(f"  launch plan sweep_rows S={S} C={Cr} k_best={with_k}: "
              f"{sweep_pallas.launch_plan(S, Cr, with_k)}")
    if failures:
        print("phase 1 FAILED: " + "; ".join(failures))
        return 1

    # ---- phase 2: kernels vs plain versions at level-0 pass-1 inputs ----
    params = DEFAULT_PARAMS
    line_params = dataclasses.replace(params, score_version="line")
    fast_params = dataclasses.replace(params, fast=True)
    nearest_params = dataclasses.replace(params, interpolation="nearest")
    vol, gt_s_u = synthetic_sequence(torch, dev)
    comp = Depth2DComputer(vol, DMIN, DMAX, D, params=params, device=dev)
    epis = comp.epis
    frames = epis.permute(1, 0, 2, 3).contiguous()
    state = comp.initial_state()
    s_hat = S // 2
    active = (state.ce_mask[s_hat] & state.claim[s_hat]).contiguous()
    n_act = int(active.sum())
    print(f"phase 2 inputs: level 0, s_hat={s_hat}, {n_act} active px")
    # every instantiation of the pixel sweep on the passes: its block,
    # blocks and shared bytes a block, and the warps an SM holds
    for Cp in (1, 3):
        for with_k in (False, True):
            for nearest in (False, True):
                pl = sweep_pallas_pixel.launch_plan(S, Cp, with_k, nearest)
                print(f"  launch plan sweep_pixel S={S} C={Cp} k_best="
                      f"{with_k} nearest={nearest}: {pl['threads']} threads, "
                      f"{pl['blocks_per_sm']} blocks an SM, "
                      f"{pl['smem_bytes']} shared bytes a block, "
                      f"{pl['resident_warps']} resident warps an SM")
    records = {}

    def check_same(tag, got, want, mask):
        """Bitwise agreement of two SweepResults at the pixels of mask."""
        err, same = 0.0, True
        for name in SWEEP_OUTS:
            a, b = getattr(got, name), getattr(want, name)
            if a is None:
                continue
            if name == "k_best":
                a, b = a.permute(0, 2, 1), b.permute(0, 2, 1)
            a, b = a[mask], b[mask]
            err = max(err, float((a - b).abs().max()))
            same = same and torch.equal(a, b)
        flips = int((got.best_depth[mask] != want.best_depth[mask]).sum())
        if not same:
            failures.append(f"{tag} not bitwise equal (max err {err}, "
                            f"{flips} depth picks differ)")
        return err, flips, same

    def check_kernel(tag, run, plain, mask, nbytes, Cs, plain_rows=None):
        """A sweep kernel against its plain version, bitwise at mask;
        ``run(work_count)`` launches it.  With ``plain_rows``, ``plain()``
        sweeps only the first rows, against the kernel's on all rows.
        Returns (record, its result)."""
        work = torch.zeros(1, dtype=torch.int64, device=dev)
        got = run(work)
        torch.cuda.synchronize()
        out = {}
        t_plain = time_ms(torch, lambda: out.setdefault("want", plain()),
                          reps=1)
        rows = slice(plain_rows)
        err, flips, same = check_same(
            tag, SweepResult(*(None if x is None else x[rows] for x in got)),
            out.pop("want"), mask[rows])
        ms = time_ms(torch, lambda: run(None))
        bms, by = bound(nbytes, int(work) * flops_per_sample_step(Cs))
        print(f"  {tag}: bitwise {same}, max_abs_err {err:.3g}, {flips} "
              f"depth picks differ, {int(mask.sum())} px, kernel {ms:.3f} "
              f"ms, plain {t_plain:.1f} ms"
              f"{'' if plain_rows is None else f' on {plain_rows} rows'}, "
              f"bound {bms:.3f} ms by {by}, {int(work)} sample-steps")
        rec = dict(max_abs_err=err, ms=ms, plain_ms=t_plain, bound_ms=bms,
                   bound_by=by)
        if plain_rows is not None:
            rec["plain_rows"] = plain_rows
        return rec, got

    def check_pixel(tag, ep, act, lo, hi, per_pixel, p=params, plain_p=None,
                    with_k=False, window=None):
        """The pixel sweep under params ``p`` against the plain sweep under
        ``plain_p`` (default ``p``), in the ``u_valid`` window ``window``
        where one is given."""
        Vs, Ss, Us, Cs = ep.shape
        kw = dict(dmin_v_u=lo, dmax_v_u=hi) if per_pixel else {}
        nbytes = (ep.numel() + int(act.sum()) + Vs * Us * (3 + Cs)
                  + (2 * Vs * Us if per_pixel else 0)
                  + (Vs * Ss * Us if with_k else 0)) * 4
        return check_kernel(
            f"sweep_pixel {tag}",
            lambda w: sweep_pile_pixel(ep, DMIN, DMAX, D, s_hat, p, act,
                                       with_k_best=with_k, work_count=w,
                                       u_valid=window, **kw),
            lambda: sweep_pile(ep, lo, hi, D, s_hat, plain_p or p, with_k,
                               u_valid=window),
            act, nbytes, Cs)

    def check_rows(tag, ep, with_k, act=None):
        Vs, Ss, Us, Cs = ep.shape
        dvec = candidate_grid(DMIN, DMAX, D, dev)
        if act is None:
            act = torch.ones((Vs, Us), dtype=torch.bool, device=dev)
        nbytes = (ep.numel() + int(act.sum()) + Vs * Us * (3 + Cs)
                  + (Vs * Ss * Us if with_k else 0)) * 4
        return check_kernel(
            f"sweep_rows {tag}",
            lambda w: sweep_pile_rows(ep, DMIN, DMAX, D, s_hat, params,
                                      with_k_best=with_k, active_v_u=act,
                                      work_count=w),
            lambda: sweep_rows_plain(ep, dvec, s_hat, params, with_k),
            act, nbytes, Cs)[0]

    full = lambda x: torch.full((V, U), x, dtype=torch.float32, device=dev)
    records["sweep_pixel"], res = check_pixel("uniform C=1", epis, active,
                                              full(DMIN), full(DMAX), False)
    g = torch.Generator(device=dev).manual_seed(0)
    center = torch.rand((V, U), generator=g, device=dev) * 4.0 - 0.5
    lo = torch.clamp(center - 0.6, DMIN, DMAX).contiguous()
    hi = torch.clamp(center + 0.6, DMIN, DMAX).contiguous()
    check_pixel("per-pixel C=1", epis, active, lo, hi, True)
    rgb_gain = torch.tensor([1.0, 0.8, 0.6], device=dev)
    epis3 = (epis[:64] * rgb_gain).contiguous()
    # C=3 at S=100 (items held partly in registers, partly in a packed
    # column) under each rule: linear, nearest, a window of the (v, u)
    # mesh's kind (its pixels only), k_best
    act3, lo3, hi3 = (x[:64].contiguous() for x in (active, lo, hi))
    full3 = lambda x: torch.full((64, U), x, dtype=torch.float32, device=dev)
    win3 = (37, U - 41)
    act3w = act3.clone()
    act3w[:, :win3[0]] = False
    act3w[:, win3[1] + 1:] = False
    modes3 = {}
    for tag3, args3, kw3 in (
            ("per-pixel", (act3, lo3, hi3, True), {}),
            ("uniform", (act3, full3(DMIN), full3(DMAX), False), {}),
            ("per-pixel nearest", (act3, lo3, hi3, True),
             dict(p=nearest_params)),
            ("per-pixel window", (act3w, lo3, hi3, True),
             dict(window=win3)),
            ("uniform nearest window", (act3w, full3(DMIN), full3(DMAX),
                                        False),
             dict(p=nearest_params, window=win3)),
            ("uniform k_best", (act3, full3(DMIN), full3(DMAX), False),
             dict(with_k=True))):
        modes3[f"C=3 {tag3} (64 rows)"], _ = check_pixel(
            f"{tag3} C=3 (64 rows)", epis3, *args3, **kw3)
    del act3, lo3, hi3, act3w
    # the new modes, each bitwise against its plain version: line mode's
    # k_best, the fast cap (the plain sweep with 5 mean-shift steps), the
    # nearest rule with uniform and per-pixel bounds
    modes = {k: {} for k in ("sweep_pixel", "sweep_tiles", "paint")}
    modes["sweep_pixel"].update(modes3)
    modes["sweep_pixel"]["k_best"], res_k = check_pixel(
        "uniform C=1 k_best", epis, active, full(DMIN), full(DMAX), False,
        with_k=True)
    modes["sweep_pixel"]["fast"], _ = check_pixel(
        "uniform C=1 fast", epis, active, full(DMIN), full(DMAX), False,
        p=fast_params,
        plain_p=dataclasses.replace(params, mean_shift_max_iter=5))
    modes["sweep_pixel"]["nearest uniform"], _ = check_pixel(
        "uniform C=1 nearest", epis, active, full(DMIN), full(DMAX), False,
        p=nearest_params)
    modes["sweep_pixel"]["nearest per-pixel"], _ = check_pixel(
        "per-pixel C=1 nearest", epis, active, lo, hi, True,
        p=nearest_params)

    # the row sweep: the pile's input (every row), then slabs
    vol4, _ = synthetic_sequence(torch, dev, gains=BAND_GAINS)
    epis4 = normalize_volume(vol4[:64].contiguous())
    del vol4
    records["sweep_rows"] = check_rows("pile input C=1 (all rows)", epis,
                                       False)
    check_rows("C=1 k_best (64 rows)", epis[:64].contiguous(), True)
    check_rows("C=4 k_best (64 rows)", epis4, True)
    # a late pass: a few thousand active pixels scattered over the rows
    few = torch.rand((64, U), generator=g, device=dev) < 0.05
    check_rows(f"C=4 late pass ({int(few.sum())} px of 64 rows)", epis4,
               False, few)
    # the tile sweep's nearest rule at C=4: each pixel's own grid (pixel
    # mode), as the passes take it
    act4, lo4, hi4 = (x[:64].contiguous() for x in (active, lo, hi))
    modes["sweep_tiles"]["nearest pixel mode C=4 (64 rows)"] = check_kernel(
        "sweep_tiles nearest pixel mode C=4 (64 rows)",
        lambda w: sweep_pile_tiles(epis4, lo4, hi4, D, s_hat,
                                   nearest_params, active_v_u=act4,
                                   work_count=w),
        lambda: sweep_pile(epis4, lo4, hi4, D, s_hat, nearest_params),
        act4, (epis4.numel() + int(act4.sum()) + 64 * U * (3 + 4 + 2)) * 4,
        4)[0]
    del act4, lo4, hi4

    # merge as the pass does, then the median on the s_hat plane
    good = active & (res.best_score > params.raw_score_threshold)
    depth = torch.where(good, res.best_depth, torch.zeros_like(
        res.best_depth)).contiguous()
    mask = (state.ce_mask[s_hat] & ~(active & ~good)).contiguous()
    frame = frames[s_hat]

    def check_median(tag, src, fr, m, size=params.median_filter_size):
        eps = params.median_filter_epsilon

        def run():
            return selective_median_cuda(src, fr, m, size, eps)

        got = run()
        out = {}
        plain = time_ms(torch, lambda: out.setdefault("want", selective_median(
            src, fr, m, size, eps)), reps=1)
        want = out["want"]
        same = torch.equal(got, want)
        if not same:
            failures.append(f"median {tag} not bitwise equal")
        err = float((got - want).abs().max())
        ms = device_ms(torch, run)
        call_ms = time_ms(torch, run, reps=5)
        Vm, Um, Cm = fr.shape
        bms, by = bound(median_bytes(Vm, Um, Cm),
                        int(m.sum()) * size ** 2 * (3 * Cm + 2))
        plan = median_pallas.launch_plan(size, Cm)
        print(f"  median {tag}: bitwise {same}, {Vm}x{Um} px, size {size}, "
              f"tiles {plan['tile_v']}x{plan['tile_u']} of <"
              f"{plan['size_template']},{plan['channel_template']}>, kernel "
              f"{ms:.4f} ms a launch back to back ({call_ms:.4f} ms one "
              f"call on the host clock, the wrapper included), plain "
              f"{plain:.1f} ms, bound {bms:.3g} ms by {by}")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by), got

    records["median"], filtered = check_median("C=1", depth, frame, mask)
    check_median("C=3 (64 rows)", depth[:64].contiguous(),
                 epis3[:, s_hat].contiguous(), mask[:64].contiguous())
    frames4 = epis4.permute(1, 0, 2, 3).contiguous()
    check_median("C=4 (64 rows)", depth[:64].contiguous(),
                 frames4[s_hat].contiguous(), mask[:64].contiguous())
    # the shape of level 4 of the pyramid (a launch of a few thousand px),
    # cut from the level-0 inputs, beside an empty kernel's launch
    v4, u4 = V, U
    for _ in range(4):
        v4, u4 = cv_resize_shape(v4), cv_resize_shape(u4)
    small4 = [x[:v4, :u4].contiguous() for x in (depth, frame, mask)]
    rec4, _ = check_median("level-4 shape", *small4)
    floor = launch_floor_ms(torch, cuda_build, dev)
    print(f"  launch floor: an empty kernel {floor:.4f} ms a launch back to "
          f"back; the median at the level-4 shape {rec4['ms'] / floor:.2f}x "
          f"that")
    # the generic instantiation, at an odd and an even window size
    check_median("C=1 generic odd size", depth, frame, mask, size=7)
    check_median("C=1 generic even size", depth, frame, mask, size=4)

    # the paint on fresh copies of the pass state
    conf = (state.ce[s_hat] * torch.abs(res.best_score - res.score_mean))
    conf = torch.where(good, conf, torch.zeros_like(conf)).contiguous()
    rbar = torch.where(good[..., None], res.rbar,
                       torch.zeros_like(res.rbar)).contiguous()
    claim0 = state.claim.clone()
    claim0[s_hat] = active

    def check_paint(tag, claim, fr, src, rb, m, cf, lc=None, u_origin=0,
                    plain_rows=None, **launch):
        """The paint with the payloads (depth, disp_conf) and, given
        ``lc``, line mode's third (line_conf); sources wider than the
        targets from column ``u_origin`` (the (v, u) mesh's halo).  With
        ``plain_rows`` the plain version paints only the first rows (each
        row is painted on its own), against the kernel's on all rows.
        Returns (record, the kernel's claim and targets)."""
        Sp, Vp, Up, Cp = fr.shape
        srcs = [src, cf] + ([] if lc is None else [lc])
        n_rows = Vp if plain_rows is None else plain_rows
        head = lambda x, axis: x.narrow(axis, 0, n_rows).contiguous()

        def fresh(rows=Vp):
            return (claim.narrow(1, 0, rows).clone(),
                    *(torch.zeros((Sp, rows, Up), device=dev) for _ in srcs))

        def paint(fn, cl, *tgts, **kw):
            if cl.shape[1] < Vp:  # the plain version on the first rows
                return fn(cl, head(fr, 1), head(src, 0), head(rb, 0),
                          head(m, 0), s_hat, params.slope_factor,
                          params.propagation_epsilon,
                          list(zip(tgts, [head(x, 0) for x in srcs])),
                          u_origin=u_origin, **kw)
            return fn(cl, fr, src, rb, m, s_hat, params.slope_factor,
                      params.propagation_epsilon, list(zip(tgts, srcs)),
                      u_origin=u_origin, **kw)

        got = fresh()
        paint(propagate_cuda, *got, **launch)
        want = fresh(n_rows)
        plain_ms = time_ms(torch, lambda: paint(propagate, *want), reps=1)
        same = all(torch.equal(head(a, 1), b) for a, b in zip(got, want))
        if not same:
            failures.append(f"paint {tag} not bitwise equal")
        painted = int((claim & ~got[0]).sum())
        ms = time_ms(torch, lambda *a: paint(propagate_cuda, *a, **launch),
                     reps=5, setup=fresh)
        # what the function needs for these sources: the mask and the
        # source planes once; for each (frame, source) whose target lies in
        # the row its claim byte and, where that target is open, its
        # colours; claim and the payloads written at painted targets
        P = len(srcs)
        vi, ui = torch.nonzero(m, as_tuple=True)
        per_ds = src[vi, ui] * f32(params.slope_factor)
        n_reach = torch.zeros((), dtype=torch.int64, device=dev)
        n_reach_open = torch.zeros_like(n_reach)
        for s in range(Sp):
            ut = ui - u_origin + round_half_away(
                per_ds * float(s_hat - s)).to(torch.int64)
            ok = (ut >= 0) & (ut < Up)
            n_reach += ok.sum()
            n_reach_open += claim[s][vi[ok], ut[ok]].sum()
        n_reach, n_reach_open = int(n_reach), int(n_reach_open)
        n_open = int(claim.sum())
        nbytes = Vp * src.shape[1] * (1 + 4 + 4 * Cp + 4 * P) + n_reach \
            + n_reach_open * 4 * Cp + painted * (1 + 4 * P)
        bms, by = bound(nbytes, n_reach * 3 + n_reach_open * (3 * Cp + 1))
        err = max(float((head(a, 1).float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        print(f"  paint {tag}: bitwise {same}, {P} payloads, "
              f"{int(m.sum())} sources, "
              f"{n_open} open targets, {n_reach} (frame, source) pairs in "
              f"the row, {n_reach_open} at an open target, {painted} "
              f"targets painted, "
              f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms"
              f"{'' if plain_rows is None else f' on {n_rows} rows'}, bound "
              f"{bms:.4f} ms by {by}")
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by)
        if plain_rows is not None:
            rec["plain_rows"] = n_rows
        return rec, got

    records["paint"], _ = check_paint("C=1", claim0, frames, filtered, rbar,
                                      mask, conf)
    # a late pass: a tenth of the open targets, a hundredth of the sources
    late = lambda shape, share: torch.rand(shape, generator=g,
                                           device=dev) < share
    check_paint("C=1 late pass", claim0 & late((S, V, U), 0.1), frames,
                filtered, rbar, mask & late((V, U), 0.01), conf)
    claim4 = claim0[:, :64].contiguous()
    args4 = (frames4, filtered[:64].contiguous(),
             frames4[s_hat].contiguous())
    check_paint("C=4 (64 rows)", claim4, *args4, mask[:64].contiguous(),
                conf[:64].contiguous())
    check_paint("C=4 late pass, tiles of 200 columns (64 rows)",
                claim4 & late((S, 64, U), 0.1), *args4,
                (mask[:64] & late((64, U), 0.01)).contiguous(),
                conf[:64].contiguous(), tile=200)
    del claim4, args4
    # line mode: C_l of the pass from the sweep's k_best, the kernel at the
    # good pixels (as the pass computes it) against the plain version there,
    # bitwise, and timed beside the plain version over the post-sweep mask
    # (the pass's C_l before the kernel), at the first level-0 pass and at
    # a late one (a few per cent of its good pixels); its sources, the
    # third payload
    ce_line = state.ce.clone()
    ce_line[s_hat] = torch.where(active & ~good, torch.zeros_like(
        ce_line[s_hat]), ce_line[s_hat])
    k_line = res_k.k_best

    def check_line(tag, at):
        def run():
            return line_confidence_cuda(ce_line, filtered, k_line, at, s_hat)

        got = run()
        want = line_confidence(ce_line, filtered, k_line, at, s_hat)
        nan = torch.isnan(want)
        same = (torch.equal(torch.isnan(got), nan)
                and torch.equal(got[~nan].view(torch.int32),
                                want[~nan].view(torch.int32)))
        if not same:
            failures.append(f"line confidence {tag} not bitwise equal")
        ms = device_ms(torch, run)
        call_ms = time_ms(torch, run, reps=5)
        plain_ms = time_ms(torch, lambda: line_confidence(
            ce_line, filtered, k_line, mask, s_hat), reps=3)
        n_at = int(at.sum())
        bms, by = bound(n_at * S * (4 + 8) + V * U * 10, n_at * S * 10)
        print(f"  line confidence {tag}: bitwise {same}, {n_at} px of "
              f"{int(mask.sum())} in the post-sweep mask, kernel {ms:.4f} "
              f"ms a launch back to back ({call_ms:.4f} ms one call on the "
              f"host clock), plain {plain_ms:.3f} ms over the post-sweep "
              f"mask, bound {bms:.4f} ms by {by}")
        return dict(max_abs_err=0.0 if same else float("nan"), ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by), got

    records["line_conf"], lc = check_line("first level-0 pass", good)
    modes["line_conf"] = {"late pass": check_line(
        "late pass", (good & late((V, U), 0.03)).contiguous())[0]}
    lc_src = (lc > params.line_score_threshold).contiguous()
    print(f"  line confidence sources: {int(lc_src.sum())} of "
          f"{int(good.sum())} swept px")
    del ce_line, res_k, k_line
    modes["paint"]["three payloads"], _ = check_paint(
        "C=1 line mode, three payloads", claim0, frames, filtered, rbar,
        lc_src, conf, lc=lc)
    modes["paint"]["three payloads, late pass"], _ = check_paint(
        "C=1 line mode, three payloads, late pass",
        claim0 & late((S, V, U), 0.1), frames, filtered, rbar,
        lc_src & late((V, U), 0.01), conf, lc=lc)
    del lc, lc_src

    # the pass's merge on copies of the pass state, bitwise its plain
    # route, at the first level-0 pass and at a late one (a few per cent
    # of its active pixels)
    def check_merge(tag, act):
        planes = ("ce", "ce_mask", "disp_conf", "best_depth", "rbar")

        def fresh():
            return types.SimpleNamespace(**{n: getattr(state, n).clone()
                                            for n in planes})

        got_st, want_st = fresh(), fresh()
        thr = params.raw_score_threshold
        got = merge_cuda(got_st, s_hat, act, res, thr, with_good=True)
        want = merge(want_st, s_hat, act, res, thr, with_good=True)
        same = all(torch.equal(getattr(got_st, n), getattr(want_st, n))
                   for n in planes) and all(
            torch.equal(a, b) for a, b in zip(got, want))
        if not same:
            failures.append(f"merge {tag} not bitwise equal")
        st = fresh()
        ms = device_ms(torch, lambda: merge_cuda(st, s_hat, act, res, thr))
        call_ms = time_ms(torch, lambda: merge_cuda(st, s_hat, act, res,
                                                    thr), reps=5)
        plain_ms = time_ms(torch, lambda: merge(st, s_hat, act, res, thr),
                           reps=5)
        n_act = int(act.sum())
        n_good = int(got.good.sum())
        Cm = res.rbar.shape[-1]
        # every pixel: its active byte, its conf written; a pixel not good:
        # disp_conf read for the copy; an active one: its best score; a
        # bad one: ce and its mask byte written; a good one: ce, the mean
        # score, the sweep's depth and r_bar read, best_depth, disp_conf
        # and r_bar written
        nbytes = (V * U * 5 + (V * U - n_good) * 4 + n_act * 4
                  + (n_act - n_good) * 5 + n_good * (24 + 8 * Cm))
        bms, by = bound(nbytes, n_good * 3)
        print(f"  merge {tag}: bitwise {same}, {n_act} active px, {n_good} "
              f"good, kernel {ms:.4f} ms a launch back to back "
              f"({call_ms:.4f} ms one call on the host clock), plain "
              f"{plain_ms:.3f} ms (19 launches), bound {bms:.4f} ms by {by}")
        return dict(max_abs_err=0.0 if same else float("nan"), ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by)

    records["merge"] = check_merge("first level-0 pass", active)
    modes["merge"] = {"late pass": check_merge(
        "late pass", (active & late((V, U), 0.03)).contiguous())}
    del comp, epis, frames, state, res, claim0, epis3, epis4, frames4
    torch.cuda.empty_cache()
    if failures:
        print("phase 2 FAILED: " + "; ".join(failures))
        return 1
    print("phase 2 ok: every kernel agrees with its plain version")

    # ---- the main paths (phases 3-5, 7-9), counts reset just before each
    total = dict.fromkeys(cuda_build.KERNELS, 0)

    def run_path(tag, needs, fn):
        """Run one main path; fail unless each kernel in ``needs``
        launched.  Returns (result, wall seconds, launches)."""
        cuda_build.launches.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0_ = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ = time.perf_counter() - t0_
        counts = {k: cuda_build.launches[k] for k in cuda_build.KERNELS}
        for k, n in counts.items():
            total[k] += n
        missing = [k for k in needs if counts[k] == 0]
        if missing:
            failures.append(f"{tag}: never launched {missing}")
        return out, wall_, counts

    def run_ftc(v, p=params):
        f = FineToCoarse(v, DMIN, DMAX, D, params=p, device=dev)
        f.run()
        return (f, *f.get_results())

    def edge_mask(v):
        """The pre-run edge-confidence mask [S, V, U] of bench.py's gate."""
        ce, _ = edge_confidence_volume(normalize_volume(v), params)
        return (ce > params.edge_score_threshold).permute(1, 0, 2)

    def quality(fused_, conf0):
        """RMSE, P90 of |fused - gt| over conf0, and conf0's share."""
        gt = torch.as_tensor(gt_s_u, device=dev)[:, None, :]
        err_ = torch.abs(fused_ - gt)[conf0].double().cpu().numpy()
        return (float(np.sqrt(np.mean(err_ ** 2))),
                float(np.percentile(err_, 90)), float(conf0.float().mean()))

    def level_line(f):
        return [(*c.epis.shape[:3], c.passes_run, round(t, 3))
                for c, t in zip(f.computers, f.level_seconds)]

    (ftc, fused, validity), wall, launches = run_path(
        "phase 3", ("sweep_pixel", "median", "paint", "merge"),
        lambda: run_ftc(vol))
    wall3 = wall
    passes3 = sum(c.passes_run for c in ftc.computers)
    print(f"phase 3 merge: {launches['merge']} launches, {passes3} passes")
    if launches["merge"] != passes3:
        failures.append(f"phase 3: {launches['merge']} merge launches for "
                        f"{passes3} passes")
    print(f"phase 3 pipeline: {wall:.2f}s wall, {len(ftc.computers)} levels "
          f"(V, S, U, passes, s) {level_line(ftc)}, launches {launches}, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # host seconds of the renderer and of one checkpoint of level 0, for
    # phase 11 (no kernel of the port runs in either)
    t0 = time.perf_counter()
    maps = ftc.get_coloured_depth_maps()
    host_s = {"render": time.perf_counter() - t0}
    ok_maps = maps.shape == (S, V, U, 3) and bool(maps.any())
    del maps
    level0 = ftc.computers[0]
    before = {f.name: getattr(level0.state, f.name)
              for f in dataclasses.fields(level0.state)}
    # what phase 13's sharded runs must reproduce bit for bit
    ref3 = {"fused": digest(fused), "validity": digest(validity),
            "passes": [c.passes_run for c in ftc.computers],
            "passes0": level0.passes_run,
            **{k: digest(before[k]) for k in LEVEL0_PLANES}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        t0 = time.perf_counter()
        path = save_level(ckpt, 0, level0)
        host_s["save"] = time.perf_counter() - t0
        host_s["mb"] = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        ok_ckpt = load_level(ckpt, 0, level0)
        torch.cuda.synchronize()
        host_s["load"] = time.perf_counter() - t0
    ok_ckpt = ok_ckpt and all(torch.equal(getattr(level0.state, k), v)
                              for k, v in before.items())
    if not (ok_maps and ok_ckpt):
        failures.append(f"phase 3: coloured maps ok {ok_maps}, level-0 "
                        f"checkpoint round trip bitwise {ok_ckpt}")
    del ftc, level0, before
    mask1 = edge_mask(vol)
    rmse, p90, edge_share = quality(fused, mask1)
    with open(os.path.join(HERE, "REF_ANCHOR.json")) as f:
        ref = json.load(f)[ANCHOR_KEY]
    ok_q = (rmse <= ref["rmse_px"] + MARGIN_PX
            and p90 <= ref["p90_px"] + MARGIN_PX)
    ok_shape = (tuple(fused.shape) == (S, V, U)
                and bool(torch.isfinite(fused).all()))
    print(f"phase 3 quality: RMSE {rmse:.4f} px (gate "
          f"{ref['rmse_px'] + MARGIN_PX:.4f}), P90 {p90:.4f} px (gate "
          f"{ref['p90_px'] + MARGIN_PX:.4f}) on {edge_share * 100:.1f}% "
          f"edge px; coverage {float(validity.float().mean()) * 100:.1f}%; "
          f"finite {S}x{V}x{U}: {ok_shape}")
    del fused, validity
    if not (ok_q and ok_shape) or failures:
        print("phase 3 FAILED: " + "; ".join(failures))
        return 1

    # ---- phase 4: the pile on the bench scene and on data/strips16 ----
    pile, wall, launches = run_path(
        "phase 4", ("sweep_rows", "median"),
        lambda: Depth1DComputerPile(vol, DMIN, DMAX, D, s_hat=s_hat,
                                    params=params, device=dev).run())
    gt_row = torch.as_tensor(gt_s_u[s_hat], device=dev)[None, :]
    m = pile.edge_mask
    err = torch.abs(pile.best_depth - gt_row)[m].double().cpu().numpy()
    p50, p90 = np.percentile(err, [50, 90])
    print(f"phase 4 pile: {wall:.3f}s wall (s_hat={s_hat}, {V}x{U} px, "
          f"D={D}), launches {launches}, {float(m.float().mean()) * 100:.1f}"
          f"% px kept, |depth - gt| P50 {p50:.4f} px, P90 {p90:.4f} px")
    data = os.path.join(HERE, "data", "strips16")
    layers = np.load(os.path.join(data, "ground_truth.npz"))[
        "layer_disparities"]
    small = Depth1DComputerPile(
        build_epis_from_imgs(read_imgs_from_folder(data, "png")), -1.0, 1.5,
        24, device=dev)
    small.run()
    d_s = small.get_depths().cpu().numpy()
    m_s = small.result.edge_mask.cpu().numpy()
    e_s = np.min(np.abs(d_s[m_s][:, None] - layers[None]), axis=1)
    med_s, rmse_s = float(np.median(e_s)), float(np.sqrt(np.mean(e_s ** 2)))
    ok_s = m_s.mean() > 0.3 and med_s < 0.1 and rmse_s < 0.3
    print(f"phase 4 strips16: {m_s.mean() * 100:.1f}% px kept (> 30%), "
          f"median error {med_s:.4f} px (< 0.1), RMSE {rmse_s:.4f} px "
          f"(< 0.3): {'ok' if ok_s else 'FAILED'}")
    del pile, small
    if not ok_s or failures:
        print("phase 4 FAILED: " + "; ".join(failures))
        return 1

    # ---- phase 5: the four-band pipeline ----
    del vol
    torch.cuda.empty_cache()
    vol4, _ = synthetic_sequence(torch, dev, gains=BAND_GAINS)
    (ftc4, fused4, _), wall, launches = run_path(
        "phase 5", ("sweep_rows", "sweep_tiles", "median", "paint"),
        lambda: run_ftc(vol4))
    peak = torch.cuda.max_memory_allocated() / 2**30
    rmse4, p90_4, edge4 = quality(fused4, edge_mask(vol4))
    rmse4_1, p90_4_1, _ = quality(fused4, mask1)
    finite4 = (tuple(fused4.shape) == (S, V, U)
               and bool(torch.isfinite(fused4).all()))
    print(f"phase 5 four-band pipeline: {wall:.2f}s wall, "
          f"{tuple(vol4.shape)}, levels (V, S, U, passes, s) "
          f"{level_line(ftc4)}, launches {launches}, peak {peak:.2f} GiB")
    gate_rmse = ref["rmse_px"] + MARGIN_PX
    gate_p90 = ref["p90_px"] + MARGIN_PX
    print(f"phase 5 quality: RMSE {rmse4:.4f} px, P90 {p90_4:.4f} px on "
          f"its {edge4 * 100:.1f}% edge px; on phase 3's "
          f"{edge_share * 100:.1f}% edge px RMSE {rmse4_1:.4f} px, P90 "
          f"{p90_4_1:.4f} px (C=1 gate {gate_rmse:.4f} / {gate_p90:.4f}); "
          f"finite {finite4}")
    del mask1
    del fused4
    if not finite4 or failures:
        print("phase 5 FAILED: " + "; ".join(failures))
        return 1

    # ---- phase 6: the tile sweep at first-pass inputs of levels 1 and 4 ----
    def level_inputs(lvl):
        """First-pass inputs of level ``lvl`` of phase 5's pyramid: its
        computer, params, s_hat, active pixels, per-pixel ranges and the
        tile-quantized grid bounds."""
        c, p = ftc4.computers[lvl], ftc4.level_params[lvl]
        st = c.initial_state()
        sh_ = c.epis.shape[1] // 2
        act_ = (st.ce_mask[sh_] & st.claim[sh_]).contiguous()
        lo_ = c.dmin_s_v_u[sh_].contiguous()
        hi_ = c.dmax_s_v_u[sh_].contiguous()
        print(f"phase 6 inputs: level {lvl} of phase 5, "
              f"{tuple(c.epis.shape)}, s_hat={sh_}, {int(act_.sum())} "
              f"active px")
        return (c, p, sh_, act_, lo_, hi_,
                *tile_quantized_bounds(act_, lo_, hi_, (DMIN, DMAX)))

    def check_tiles(tag, level, rows, tile_mode, with_k):
        c, p, sh, act, lo, hi, qlo, qhi = level
        ep = c.epis[rows].contiguous()
        glo, ghi = (qlo, qhi) if tile_mode else (lo, hi)
        act, glo, ghi = (x[rows].contiguous() for x in (act, glo, ghi))
        kw = {}
        if tile_mode:
            kw = dict(pdmin_v_u=lo[rows].contiguous(),
                      pdmax_v_u=hi[rows].contiguous())
        Vs, Ss, Us, Cs = ep.shape
        nbytes = (ep.numel() + Vs * Us * (3 + Cs) + int(act.sum())
                  + (2 + 2 * tile_mode) * Vs * Us
                  + (Vs * Ss * Us if with_k else 0)) * 4
        return check_kernel(
            f"sweep_tiles {tag}",
            lambda w: sweep_pile_tiles(ep, glo, ghi, D, sh, p,
                                       with_k_best=with_k, active_v_u=act,
                                       work_count=w, **kw),
            lambda: sweep_pile(ep, glo, ghi, D, sh, p, with_k, **kw),
            act, nbytes, Cs)[0]

    every = slice(None)
    level1, level4 = level_inputs(1), level_inputs(4)
    del ftc4
    records["sweep_tiles"] = check_tiles("tile mode C=4", level1, every,
                                         True, False)
    check_tiles("pixel mode C=4", level1, every, False, False)
    check_tiles("tile mode C=4 k_best (64 rows)", level1, slice(0, 64), True,
                True)
    check_tiles("tile mode C=4 (level 4)", level4, every, True, False)
    del level1, level4, vol4
    torch.cuda.empty_cache()
    if failures:
        print("phase 6 FAILED: " + "; ".join(failures))
        return 1
    print(f"phase 6 ok: the tile sweep agrees with its plain version; "
          f"script {time.perf_counter() - t_start:.1f}s so far")

    # ---- phases 7-8: line mode and fast mode on the bench scene ----
    vol, _ = synthetic_sequence(torch, dev)
    mask1 = edge_mask(vol)
    for phase, tag, p, jax_q, gates in (
            (7, "line mode", line_params, JAX_LINE,
             (ref["rmse_px"] + LINE_MARGIN_PX, float("inf"))),
            (8, "fast mode", fast_params, JAX_FAST,
             (ref["rmse_px"] + MARGIN_PX, ref["p90_px"] + MARGIN_PX))):
        (f, fused_, validity_), wall, launches = run_path(
            f"phase {phase}", ("sweep_pixel", "median", "paint")
            + (("line_conf",) if phase == 7 else ()),
            lambda: run_ftc(vol, p))
        peak = torch.cuda.max_memory_allocated() / 2**30
        rmse_, p90_, _ = quality(fused_, mask1)
        finite_ = (tuple(fused_.shape) == (S, V, U)
                   and bool(torch.isfinite(fused_).all()))
        ok_ = rmse_ <= gates[0] and p90_ <= gates[1] and finite_
        print(f"phase {phase} {tag} pipeline: {wall:.2f}s wall, levels (V, "
              f"S, U, passes, s) {level_line(f)}, launches {launches}, peak "
              f"{peak:.2f} GiB")
        print(f"phase {phase} quality: RMSE {rmse_:.4f} px (gate "
              f"{gates[0]:.4f}), P90 {p90_:.4f} px (gate {gates[1]:.4f}) on "
              f"phase 3's edge px; the JAX package on this scene: RMSE "
              f"{jax_q[0]} px, P90 {jax_q[1]} px; coverage "
              f"{float(validity_.float().mean()) * 100:.1f}%; finite "
              f"{finite_}: {'ok' if ok_ else 'FAILED'}")
        del f, fused_, validity_
        if not ok_ or failures:
            print(f"phase {phase} FAILED: " + "; ".join(failures))
            return 1

    # ---- phase 9: nearest interpolation (no anchor: finite, errors) ----
    def pile_errors(tag, v, layers_gt, needs, **kw):
        """A nearest pile as a main path: its depths' errors at its edge
        mask (against the one gt row, or the nearest of a few layer
        disparities) and whether they are finite."""
        r, wall_, launches_ = run_path(
            f"phase 9 {tag}", needs,
            lambda: Depth1DComputerPile(v, params=nearest_params, device=dev,
                                        **kw).run())
        m_ = r.edge_mask
        d_ = r.best_depth[m_][:, None]
        e_ = torch.abs(d_ - layers_gt(m_)).amin(1).double().cpu().numpy()
        fin = bool(torch.isfinite(r.best_depth).all()) and e_.size > 0
        print(f"phase 9 {tag}: {wall_:.3f}s wall, launches {launches_}, "
              f"{float(m_.float().mean()) * 100:.1f}% px kept, |depth - gt| "
              f"P50 {np.percentile(e_, 50):.4f} px, P90 "
              f"{np.percentile(e_, 90):.4f} px, RMSE "
              f"{np.sqrt(np.mean(e_ ** 2)):.4f} px; finite {fin}")
        if not fin:
            failures.append(f"phase 9 {tag}: depths not finite")

    row_gt = lambda m_: gt_row.expand(V, U)[m_][:, None]
    pile_errors("pile (pixel sweep)", vol, row_gt,
                ("sweep_pixel", "median"), dmin=DMIN, dmax=DMAX, dim_d=D,
                s_hat=s_hat)
    vol4, _ = synthetic_sequence(torch, dev, gains=BAND_GAINS)
    pile_errors("pile four bands (tile sweep)", vol4, row_gt,
                ("sweep_tiles", "median"), dmin=DMIN, dmax=DMAX, dim_d=D,
                s_hat=s_hat)
    del vol4
    layers_t = torch.as_tensor(layers, device=dev)[None]
    pile_errors("strips16 pile", torch.as_tensor(build_epis_from_imgs(
        read_imgs_from_folder(data, "png")), device=dev),
        lambda m_: layers_t, ("sweep_pixel", "median"), dmin=-1.0, dmax=1.5,
        dim_d=24)
    (f, fused_n, _), wall, launches = run_path(
        "phase 9 pipeline", ("sweep_pixel", "median", "paint"),
        lambda: run_ftc(vol, nearest_params))
    rmse_n, p90_n, _ = quality(fused_n, mask1)
    finite_n = (tuple(fused_n.shape) == (S, V, U)
                and bool(torch.isfinite(fused_n).all()))
    print(f"phase 9 nearest pipeline: {wall:.2f}s wall, levels (V, S, U, "
          f"passes, s) {level_line(f)}, launches {launches}, RMSE "
          f"{rmse_n:.4f} px, P90 {p90_n:.4f} px on phase 3's edge px; "
          f"finite {finite_n}")
    del f, fused_n, vol, mask1
    if not finite_n or failures:
        print("phase 9 FAILED: " + "; ".join(failures))
        return 1

    # ---- phase 10: depth1d at full width (row V/2, V = 1) ----
    vol, _ = synthetic_sequence(torch, dev)
    vol4, _ = synthetic_sequence(torch, dev, gains=BAND_GAINS)
    row = V // 2
    rows = (("bench row, pixel sweep", vol[row], D, "sweep_pixel"),
            ("bench row D=1030, tile sweep pixel mode", vol[row], 1030,
             "sweep_tiles"),
            ("four-band row, tile sweep pixel mode", vol4[row], D,
             "sweep_tiles"))
    for tag, epi_raw, dim_d, wrapper in rows:
        comp1, wall_, launches_ = run_path(
            f"phase 10 {tag}", (wrapper,),
            lambda: _run(Depth1DComputer(epi_raw, DMIN, DMAX, dim_d,
                                         device=dev)))
        r1 = comp1.result
        # the sweep alone, as depth1d calls it, against the plain sweep
        # (whose result also gives the plain depth1d)
        p1 = dataclasses.replace(comp1.params, fast=False)
        ep1 = comp1.epi[None]
        Us, Cs = ep1.shape[2], ep1.shape[3]
        ce1, mask1d = edge_confidence_frame(comp1.epi[comp1.s_hat][None], p1)
        act1 = mask1d.contiguous()
        lo1, hi1 = (torch.full((1, Us), f32(b), device=dev)
                    for b in (DMIN, DMAX))
        cache = {}
        if wrapper == "sweep_pixel":
            run1 = lambda w: sweep_pile_pixel(ep1, DMIN, DMAX, dim_d,
                                              comp1.s_hat, p1, act1, lo1,
                                              hi1, work_count=w)
        else:
            run1 = lambda w: sweep_pile_tiles(ep1, lo1, hi1, dim_d,
                                              comp1.s_hat, p1,
                                              active_v_u=act1, work_count=w)
        rec1, _ = check_kernel(
            f"{wrapper} depth1d {tag}", run1,
            lambda: cache.setdefault("res", sweep_pile(
                ep1, lo1, hi1, dim_d, comp1.s_hat, p1)), act1,
            (ep1.numel() + int(act1.sum()) + Us * (3 + Cs) + 2 * Us) * 4, Cs)
        modes[wrapper][f"depth1d {tag}"] = dict(rec1, launches=launches_[
            wrapper])
        want1 = depth1d_result(ce1[0], mask1d[0], cache.pop("res"), p1)
        same1 = all(torch.equal(a, b) for a, b in zip(r1, want1))
        finite1 = all(bool(torch.isfinite(x.float()).all()) for x in r1)
        m1 = r1.edge_mask
        e1 = torch.abs(r1.best_depth - gt_row[0])[m1].double().cpu().numpy()
        print(f"phase 10 depth1d {tag}: {wall_:.4f}s wall ({S}x{Us}x{Cs}, "
              f"D={dim_d}), launches {launches_}, "
              f"{float(m1.float().mean()) * 100:.1f}% px kept, |depth - gt| "
              f"P50 {np.percentile(e1, 50):.4f} px, P90 "
              f"{np.percentile(e1, 90):.4f} px; bitwise against the plain "
              f"version {same1}; finite {finite1}")
        if not (same1 and finite1 and e1.size):
            failures.append(f"phase 10 {tag}: bitwise {same1}, finite "
                            f"{finite1}")
        if launches_["sweep_rows"]:
            failures.append(f"phase 10 {tag}: the row sweep launched")
    del vol, vol4, comp1, r1, want1, ep1
    torch.cuda.empty_cache()
    if failures:
        print("phase 10 FAILED: " + "; ".join(failures))
        return 1

    # ---- phase 11: the CLI on the card, on data/strips16 ----
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        common = [data, "--ext", "png", "--dmin", "-1", "--dmax", "1.5",
                  "--dim-d", "24"]
        ckpt = os.path.join(tmp, "ckpt")
        maps16 = [f"depth_map_{s_:03d}" for s_ in range(16)]
        runs = (("depth1d", ["depth1d"], ("sweep_pixel",), ["coloured_epi"]),
                ("pile", ["pile"], ("sweep_rows", "median"),
                 ["disparity_map", "coloured_epi"]),
                ("depth2d", ["depth2d"], ("sweep_pixel", "median", "paint"),
                 [f"disparity_{s_:03d}" for s_ in range(16)]),
                ("fine-to-coarse", ["fine-to-coarse", "--ckpt-dir", ckpt],
                 ("sweep_pixel", "median", "paint"), maps16),
                ("fine-to-coarse resumed", ["fine-to-coarse", "--ckpt-dir",
                                            ckpt], (), maps16))
        for i, (tag, argv, needs, pngs) in enumerate(runs):
            out_dir = os.path.join(tmp, f"out{i}")
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                _, wall_, launches_ = run_path(
                    f"phase 11 {tag}", needs,
                    lambda: cli.main([argv[0], *common, *argv[1:], "--out",
                                      out_dir]))
            missing = [n for n in pngs if not os.path.exists(
                os.path.join(out_dir, n + ".png"))]
            text = log.getvalue()
            print(f"phase 11 {tag}: {wall_:.2f}s wall, launches "
                  f"{launches_}, {len(pngs) - len(missing)}/{len(pngs)} "
                  f"PNGs, {text.count(chr(10))} lines of output")
            if missing:
                failures.append(f"phase 11 {tag}: missing {missing}")
            if tag == "fine-to-coarse resumed":
                z = [np.load(os.path.join(tmp, f"out{k}",
                                          "fine_to_coarse_results.npz"))
                     for k in (i - 1, i)]
                same = all(np.array_equal(z[0][k], z[1][k])
                           for k in ("fused", "validity"))
                restored = text.count("restored in") == 3 and \
                    " done in " not in text and not any(launches_.values())
                print(f"phase 11 resume: every level restored and no pass "
                      f"run {restored}; npz bitwise equal to the first "
                      f"run's {same}")
                if not (same and restored):
                    failures.append(f"phase 11 resume: restored {restored}"
                                    f", npz equal {same}:\n{text}")
    print(f"phase 11 host: get_coloured_depth_maps() on phase 3's pipeline "
          f"({S} maps {V}x{U}) {host_s['render']:.3f}s; checkpoint of its "
          f"level 0 (r_bar already dropped): save {host_s['save']:.3f}s "
          f"({host_s['mb']:.1f} MB), load {host_s['load']:.3f}s")
    if failures:
        print("phase 11 FAILED: " + "; ".join(failures))
        return 1

    # ---- phase 12: the (v, u) mesh's kernel operands at the bench shape ----
    vol, _ = synthetic_sequence(torch, dev)
    comp = Depth2DComputer(vol, DMIN, DMAX, D, params=params, device=dev)
    epis = comp.epis
    frames = epis.permute(1, 0, 2, 3).contiguous()
    state = comp.initial_state()
    active = (state.ce_mask[s_hat] & state.claim[s_hat]).contiguous()
    # the whole scene's first pass, on the kernels (phase 2 holds them
    # bitwise against their plain versions)
    whole = sweep_pile_pixel(epis, DMIN, DMAX, D, s_hat, params, active)
    good = active & (whole.best_score > params.raw_score_threshold)
    zero = torch.zeros((), device=dev)
    depth = torch.where(good, whole.best_depth, zero).contiguous()
    mask = (state.ce_mask[s_hat] & ~(active & ~good)).contiguous()
    filtered = selective_median_cuda(depth, frames[s_hat], mask,
                                     params.median_filter_size,
                                     params.median_filter_epsilon)
    conf = torch.where(good, state.ce[s_hat] * torch.abs(
        whole.best_score - whole.score_mean), zero).contiguous()
    rbar = torch.where(good[..., None], whole.rbar, zero).contiguous()
    claim0 = state.claim.clone()
    claim0[s_hat] = active
    del comp, state
    # rank 1 of a (1, 2) mesh: the right half, haloed as sharding2d does
    hu, pado = halo_widths(S, (DMIN, DMAX), params.slope_factor)
    Ul = U // 2
    u0 = U - Ul
    window = (hu - u0, U - 1 - u0 + hu)
    epis_h = u_block(torch, epis, u0, Ul, hu, 2)
    act_h = u_block(torch, active, u0, Ul, hu, 1)
    lo_h, hi_h = (torch.full(act_h.shape, b, device=dev)
                  for b in (DMIN, DMAX))
    Uh = epis_h.shape[2]
    print(f"phase 12 inputs: level 0, s_hat={s_hat}, the right {Ul} "
          f"columns haloed by hu={hu} ({Uh} columns, u_valid {window}), "
          f"{int(act_h.sum())} active px; paint halo pado={pado}")
    half = active[:, u0:]

    def same_as_whole(tag, got):
        ok = all(torch.equal(getattr(got, k)[:, hu:hu + Ul][half],
                             getattr(whole, k)[:, u0:][half])
                 for k in ("best_score", "score_mean", "best_depth", "rbar"))
        print(f"  {tag}: the whole scene's sweep at the half's pixels "
              f"bitwise {ok}")
        if not ok:
            failures.append(f"phase 12 {tag}: not the whole scene's sweep")

    sweep_bytes = (epis_h.numel() + int(act_h.sum()) + V * Uh * 4) * 4
    modes["sweep_pixel"]["u_valid (haloed half)"], got = check_kernel(
        "sweep_pixel u_valid (haloed half)",
        lambda w: sweep_pile_pixel(epis_h, DMIN, DMAX, D, s_hat, params,
                                   act_h, work_count=w, u_valid=window),
        lambda: sweep_pile(epis_h, lo_h, hi_h, D, s_hat, params,
                           u_valid=window), act_h, sweep_bytes, 1)
    same_as_whole("sweep_pixel u_valid", got)
    modes["sweep_tiles"]["u_valid, pixel mode (haloed half)"], got = \
        check_kernel(
            "sweep_tiles u_valid, pixel mode (haloed half)",
            lambda w: sweep_pile_tiles(epis_h, lo_h, hi_h, D, s_hat, params,
                                       active_v_u=act_h, work_count=w,
                                       u_valid=window),
            lambda: sweep_pile(epis_h, lo_h, hi_h, D, s_hat, params,
                               u_valid=window), act_h,
            sweep_bytes + 2 * V * Uh * 4, 1)
    same_as_whole("sweep_tiles u_valid", got)
    del got, epis_h, act_h, lo_h, hi_h
    # the paint of the half's targets from sources haloed by pado
    srcs_h = [u_block(torch, x, u0, Ul, pado, 1)
              for x in (filtered, rbar, mask, conf)]
    rec, got = check_paint("C=1 u_origin (haloed half)",
                           claim0[:, :, u0:].contiguous(),
                           frames[:, :, u0:].contiguous(), srcs_h[0],
                           srcs_h[1], srcs_h[2], srcs_h[3], u_origin=pado)
    modes["paint"]["u_origin (haloed half)"] = rec
    full_claim = claim0.clone()
    full_t = [torch.zeros((S, V, U), device=dev) for _ in range(2)]
    propagate_cuda(full_claim, frames, filtered, rbar, mask, s_hat,
                   params.slope_factor, params.propagation_epsilon,
                   list(zip(full_t, (filtered, conf))))
    ok = all(torch.equal(a, b[:, :, u0:]) for a, b in
             zip(got, [full_claim, *full_t]))
    print(f"  paint u_origin: the whole scene's paint on the half bitwise "
          f"{ok}")
    if not ok:
        failures.append("phase 12 paint u_origin: not the whole scene's")
    del srcs_h, got, full_claim, full_t, whole, claim0, frames, epis
    torch.cuda.empty_cache()
    if failures:
        print("phase 12 FAILED: " + "; ".join(failures))
        return 1

    # ---- phase 13: the sharded fine-to-coarse and a (1, 2) mesh ----
    mesh_rows = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        for world, with_2d in ((1, False), (2, True)):
            t0 = time.perf_counter()
            spawn_ranks(sharded_rank, world, args=(tmp, with_2d),
                        device="cuda:0")
            spawn_s = time.perf_counter() - t0
            ranks = []
            for r in range(world):
                with open(os.path.join(tmp, f"rank{r}_{world}.json")) as f:
                    ranks.append(json.load(f))
            for r in ranks:
                ftc_r = r["ftc"]
                same = all(ftc_r[k] == ref3[k]
                           for k in ("fused", "validity", "passes"))
                print(f"phase 13 world {world} ({r['backend']}) rank "
                      f"{r['rank']}: sharded fine-to-coarse "
                      f"{ftc_r['wall']:.2f}s wall (phase 3: {wall3:.2f}s), "
                      f"passes {ftc_r['passes']}, launches "
                      f"{ftc_r['launches']}; fused and validity bitwise "
                      f"phase 3's {same}")
                if not same:
                    failures.append(f"phase 13 world {world} rank "
                                    f"{r['rank']}: not phase 3's maps")
                for k in ("sweep_pixel", "median", "paint"):
                    if not ftc_r["launches"][k]:
                        failures.append(f"phase 13 world {world} rank "
                                        f"{r['rank']}: never launched {k}")
                if "mesh_1x2" in r:
                    m2 = r["mesh_1x2"]
                    same2 = m2["passes"] == ref3["passes0"] and all(
                        m2[k] == ref3[k] for k in LEVEL0_PLANES)
                    print(f"phase 13 (1, 2) mesh rank {r['rank']}: level 0 "
                          f"{m2['wall']:.2f}s wall, {m2['passes']} passes, "
                          f"launches {m2['launches']}; state bitwise phase "
                          f"3's level 0 {same2}")
                    if not same2:
                        failures.append(f"phase 13 (1, 2) mesh rank "
                                        f"{r['rank']}: not phase 3's level 0")
                    for k in ("sweep_pixel", "median", "paint"):
                        if not m2["launches"][k]:
                            failures.append(f"phase 13 (1, 2) mesh rank "
                                            f"{r['rank']}: never launched "
                                            f"{k}")
            print(f"phase 13 world {world}: {spawn_s:.1f}s from spawn to "
                  f"the last rank's end; rank 0's collectives (ms a call, "
                  f"level-0 sizes): " + ", ".join(
                      f"{k} {v:.3f}" for k, v in
                      ranks[0]["collective_ms"].items()))
            mesh_rows[world] = ranks
    if failures:
        print("phase 13 FAILED: " + "; ".join(failures))
        return 1
    # the operands' launches on the main path: the (1, 2) mesh's, every rank
    n_2d = {k: sum(r["mesh_1x2"]["launches"][k] for r in mesh_rows[2])
            for k in ("sweep_pixel", "sweep_tiles", "paint")}
    modes["sweep_pixel"]["u_valid (haloed half)"]["launches"] = \
        n_2d["sweep_pixel"]
    modes["sweep_tiles"]["u_valid, pixel mode (haloed half)"]["launches"] = \
        n_2d["sweep_tiles"]
    modes["paint"]["u_origin (haloed half)"]["launches"] = n_2d["paint"]

    # ---- phase 14: --no-pallas on data/strips16 ----
    strips = build_epis_from_imgs(read_imgs_from_folder(data, "png"))

    def no_pallas():
        f_ = FineToCoarse(strips, -1.0, 1.5, 24, device=dev,
                          use_pallas=False)
        f_.run()
        return f_.get_results()

    (fused_np, valid_np), wall, launches = run_path(
        "phase 14 --no-pallas", (), no_pallas)
    on_card = fused_np.is_cuda and valid_np.is_cuda
    f_np, v_np = fused_np.cpu().numpy(), valid_np.cpu().numpy()
    err_np = np.min(np.abs(f_np[v_np][:, None] - layers[None]), axis=1)
    med_np = float(np.median(err_np))
    rmse_np = float(np.sqrt(np.mean(err_np ** 2)))
    ok_np = v_np.mean() > 0.3 and med_np < 0.1 and rmse_np < 0.3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_np_") as tmp:
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            _, wall_cli, launches_cli = run_path(
                "phase 14 CLI --no-pallas", (), lambda: cli.main([
                    "fine-to-coarse", data, "--ext", "png", "--dmin", "-1",
                    "--dmax", "1.5", "--dim-d", "24", "--no-pallas",
                    "--out", tmp]))
        z = np.load(os.path.join(tmp, "fine_to_coarse_results.npz"))
        same_cli = (np.array_equal(z["fused"], f_np)
                    and np.array_equal(z["validity"], v_np))
    print(f"phase 14 --no-pallas on strips16: {wall:.2f}s wall, launches "
          f"{launches}, results on the card {on_card}; {v_np.mean() * 100:.1f}"
          f"% px valid (> 30%), median error {med_np:.4f} px (< 0.1), RMSE "
          f"{rmse_np:.4f} px (< 0.3): {'ok' if ok_np else 'FAILED'}; CLI "
          f"{wall_cli:.2f}s, launches {launches_cli}, npz equal to the "
          f"API's {same_cli}")
    # the merge is no stage hook (XLA on both of the JAX package's paths):
    # its kernel runs under --no-pallas too, once a pass
    if any(n for k, n in (*launches.items(), *launches_cli.items())
           if k != "merge"):
        failures.append("phase 14: a kernel launched under --no-pallas")
    if not (on_card and ok_np and same_cli):
        failures.append(f"phase 14: on the card {on_card}, gate {ok_np}, "
                        f"CLI npz equal {same_cli}")
    if failures:
        print("phase 14 FAILED: " + "; ".join(failures))
        return 1

    # ---- phase 15: bench.py's scenes through the port's bench ----
    zero = torch.zeros((), device=dev)
    # (scene, its variable, rows of the plain sweep and of the plain paint:
    # a 64-row slab where the whole plain version would take over ~10 s)
    scenes15 = (("D240", {"BENCH_D240": "1"}, None, None),
                ("HR", {"BENCH_HR": "1"}, 64, 64),
                ("RGB", {"BENCH_RGB": "1"}, 64, None))
    for tag, env, sweep_rows, paint_rows in scenes15:
        cfg = bench.bench_config(env)
        if cfg.rgb:
            vol_, _ = bench.synthetic_sequence_rgb(cfg.S, cfg.V, cfg.U,
                                                   device=dev)
        else:
            vol_, _ = bench.synthetic_sequence(cfg.S, cfg.V, cfg.U,
                                               dmin=cfg.dmin, dmax=cfg.dmax,
                                               device=dev)
        comp = Depth2DComputer(vol_, cfg.dmin, cfg.dmax, cfg.D,
                               params=params, device=dev)
        del vol_
        ep = comp.epis
        fr = ep.permute(1, 0, 2, 3).contiguous()
        st = comp.initial_state()
        act = (st.ce_mask[s_hat] & st.claim[s_hat]).contiguous()
        Vs, _, Us, Cs = ep.shape
        print(f"phase 15 inputs {tag}: level 0 {tuple(ep.shape)} (input "
              f"{'uint8' if cfg.rgb else 'float32'}), D={cfg.D}, d in "
              f"[{cfg.dmin}, {cfg.dmax}], s_hat={s_hat}, {int(act.sum())} "
              f"active px")
        n_sw = Vs if sweep_rows is None else sweep_rows
        lo_r, hi_r = (torch.full((n_sw, Us), f32(b), device=dev)
                      for b in (cfg.dmin, cfg.dmax))
        at = f"{tag} first level-0 pass C={Cs}"
        rec_s, res_ = check_kernel(
            f"sweep_pixel {at}",
            lambda w: sweep_pile_pixel(ep, cfg.dmin, cfg.dmax, cfg.D, s_hat,
                                       params, act, work_count=w),
            lambda: sweep_pile(ep[:n_sw].contiguous(), lo_r, hi_r, cfg.D,
                               s_hat, params),
            act, (ep.numel() + int(act.sum()) + Vs * Us * (3 + Cs)) * 4, Cs,
            plain_rows=sweep_rows)
        good = act & (res_.best_score > params.raw_score_threshold)
        depth_ = torch.where(good, res_.best_depth, zero).contiguous()
        mask_ = (st.ce_mask[s_hat] & ~(act & ~good)).contiguous()
        rec_m, filt = check_median(at, depth_, fr[s_hat], mask_)
        conf_ = torch.where(good, st.ce[s_hat] * torch.abs(
            res_.best_score - res_.score_mean), zero).contiguous()
        rbar_ = torch.where(good[..., None], res_.rbar, zero).contiguous()
        claim_ = st.claim.clone()
        claim_[s_hat] = act
        del res_, comp, st
        rec_p, _ = check_paint(at, claim_, fr, filt, rbar_, mask_, conf_,
                               plain_rows=paint_rows)
        for k, rec in (("sweep_pixel", rec_s), ("median", rec_m),
                       ("paint", rec_p)):
            modes.setdefault(k, {})[f"{tag} first level-0 pass"] = rec
        del ep, fr, act, depth_, mask_, filt, conf_, rbar_, claim_
        torch.cuda.empty_cache()
    print(f"  launch plan sweep_pixel S={S} C=3: "
          f"{sweep_pallas_pixel.launch_plan(S, 3)} (C=1: "
          f"{sweep_pallas_pixel.launch_plan(S, 1)})")
    if failures:
        print("phase 15 FAILED: " + "; ".join(failures))
        return 1

    # the bench command's runs: three scenes cold, disp, the LR scene cold
    # and warm
    runs15 = (("D240", {"BENCH_D240": "1", "BENCH_COLD_ONLY": "1"}),
              ("HR", {"BENCH_HR": "1", "BENCH_COLD_ONLY": "1"}),
              ("RGB", {"BENCH_RGB": "1", "BENCH_COLD_ONLY": "1"}),
              ("LR disp", {"BENCH_SCORE": "disp"}),
              ("LR", {}))
    bench15 = {}
    for tag, env in runs15:
        cfg = bench.bench_config(env)
        printed = io.StringIO()
        try:
            with contextlib.redirect_stdout(printed):
                r, wall_, launches_ = run_path(
                    f"phase 15 {tag}", ("sweep_pixel", "median", "paint"),
                    lambda: bench.main(env))
        except SystemExit as e:
            failures.append(f"phase 15 {tag}: bench exited {e.code}: "
                            f"{printed.getvalue().strip()}")
            break
        peak_ = torch.cuda.max_memory_allocated() / 2**30
        rec = r.record
        finite_ = (tuple(r.fused.shape) == (cfg.S, cfg.V, cfg.U)
                   and bool(torch.isfinite(r.fused).all()))
        variables = " ".join(f"{k}={v}" for k, v in env.items())
        runs = "one run" if "BENCH_COLD_ONLY" in env else "cold and warm"
        print(f"phase 15 bench {tag} ({variables or 'no variable'}): "
              f"{wall_:.2f}s wall for bench.main (scene, {runs}, gate), "
              f"{r.levels} levels, launches {launches_}, peak "
              f"{peak_:.2f} GiB; finite {finite_}; record {json.dumps(rec)}")
        if not (rec["quality_ok"] and rec["cold_ok"] and finite_):
            failures.append(f"phase 15 {tag}: quality_ok "
                            f"{rec['quality_ok']}, cold_ok {rec['cold_ok']}, "
                            f"finite {finite_}")
        bench15[tag] = (digest(r.fused), launches_)
        del r
        torch.cuda.empty_cache()
    if "LR" in bench15:
        same = bench15["LR"][0] == ref3["fused"]
        print(f"phase 15 bench LR: the warm run's fused map bitwise phase "
              f"3's {same}")
        if not same:
            failures.append("phase 15 LR: not phase 3's fused map")
    if failures:
        print("phase 15 FAILED: " + "; ".join(failures))
        return 1
    for tag, *_ in scenes15:
        for k in ("sweep_pixel", "median", "paint"):
            modes[k][f"{tag} first level-0 pass"]["launches"] = \
                bench15[tag][1][k]

    # ---- phase 16: the native frame loader ----
    from PIL import Image

    tools = native_toolchain()
    have = all(tools.values())
    print("phase 16 toolchain: " + ", ".join(f"{k} {v}" for k, v in
                                             tools.items())
          + ("" if have else "; the native loader cannot be built on this "
             "machine: the frames are read with PIL (its loud fallback)"))
    if have:
        t0 = time.perf_counter()
        try:
            native_loader.build()
        except RuntimeError as e:
            failures.append(f"phase 16: the loader did not build: {e}")
        print(f"phase 16 build: {time.perf_counter() - t0:.2f}s, "
              f"{native_loader.library_path().name}")
    cfg = bench.bench_config({"BENCH_RGB": "1"})
    vol_, _ = bench.synthetic_sequence_rgb(cfg.S, cfg.V, cfg.U, device=dev)
    scene_u8 = vol_.permute(1, 0, 2, 3).contiguous().cpu().numpy()
    del vol_
    with tempfile.TemporaryDirectory(prefix="chip_smoke_frames_") as tmp:
        png_dir = os.path.join(tmp, "frames")
        os.makedirs(png_dir)
        t0 = time.perf_counter()
        for s_ in range(cfg.S):
            Image.fromarray(scene_u8[s_]).save(
                os.path.join(png_dir, f"frame_{s_:03d}.png"), compress_level=1)
        print(f"phase 16 wrote the RGB scene's {cfg.S} frames "
              f"{cfg.V}x{cfg.U}x3 as PNG in {time.perf_counter() - t0:.2f}s")
        names = list_images(png_dir, "png")
        readers = [("PIL", lambda: read_imgs_from_folder(
            png_dir, "png", use_native=False))]
        if have:
            readers.insert(0, ("native", lambda: native_loader.read_stack(
                png_dir, names, "png")))
        for k, read in readers:
            t0 = time.perf_counter()
            a = read()
            sec = time.perf_counter() - t0
            ok = (a is not None and a.dtype == np.uint8
                  and np.array_equal(a, scene_u8))
            print(f"phase 16 read {k}: {sec:.3f}s host, byte-equal to the "
                  f"scene {ok}")
            if not ok:
                failures.append(f"phase 16: the {k} read is not the scene")
            del a
        if have:
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)
                a16 = read_imgs_from_folder(data, "png")
            ok16 = np.array_equal(a16, read_imgs_from_folder(
                data, "png", use_native=False))
            print(f"phase 16 strips16: native read equal to PIL's {ok16}")
            if not ok16:
                failures.append("phase 16: strips16 native read is not PIL's")
        out_dir = os.path.join(tmp, "out")
        log = io.StringIO()
        with warnings.catch_warnings(record=True) as warned, \
                contextlib.redirect_stdout(log):
            warnings.simplefilter("always")
            _, wall_, launches_ = run_path(
                "phase 16 CLI", ("sweep_pixel", "median", "paint"),
                lambda: cli.main(["fine-to-coarse", png_dir, "--ext", "png",
                                  "--dmin", str(cfg.dmin), "--dmax",
                                  str(cfg.dmax), "--dim-d", str(cfg.D),
                                  "--out", out_dir]))
        fell_back = any("falling back" in str(w.message) for w in warned)
        z = np.load(os.path.join(out_dir, "fine_to_coarse_results.npz"))
        same = digest(torch.from_numpy(z["fused"])) == bench15["RGB"][0]
        print(f"phase 16 CLI fine-to-coarse on the PNG frames: {wall_:.2f}s "
              f"wall (frames read by "
              f"{'PIL, the fallback' if fell_back else 'the native loader'}"
              f"), launches {launches_}; fused bitwise phase 15's RGB run "
              f"{same}")
        if have and fell_back:
            failures.append("phase 16: the CLI fell back to PIL")
        if not same:
            failures.append("phase 16: the CLI's fused map is not phase 15's")
    del scene_u8
    if failures:
        print("phase 16 FAILED: " + "; ".join(failures))
        return 1

    meta = {
        "sweep_pixel": ("remotesensingproject_tpu_torch/csrc/sweep_pixel.cu",
                        "remotesensingproject_tpu/ops/sweep_pallas_pixel.py:61"),
        "median": ("remotesensingproject_tpu_torch/csrc/median.cu",
                   "remotesensingproject_tpu/ops/median_pallas.py:40"),
        "paint": ("remotesensingproject_tpu_torch/csrc/paint.cu",
                  "remotesensingproject_tpu/ops/propagation_pallas.py:57"),
        "sweep_rows": ("remotesensingproject_tpu_torch/csrc/sweep_rows.cu",
                       "remotesensingproject_tpu/ops/sweep_pallas.py:84"),
        "sweep_tiles": (
            "remotesensingproject_tpu_torch/csrc/sweep_tiles.cu",
            "remotesensingproject_tpu/ops/sweep_pallas_perpixel.py:43"),
        "line_conf": ("remotesensingproject_tpu_torch/csrc/line_conf.cu",
                      "no TPU kernel: the JAX package's XLA, "
                      "remotesensingproject_tpu/models/depth2d.py:68"),
        "merge": ("remotesensingproject_tpu_torch/csrc/merge.cu",
                  "no TPU kernel: the JAX package's XLA, "
                  "remotesensingproject_tpu/models/depth2d.py:433"),
    }
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=total[k], library_ms=None, **records[k],
                    **({"modes": modes[k]} if k in modes else {}))
               for k, (src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
