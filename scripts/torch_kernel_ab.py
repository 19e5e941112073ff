#!/usr/bin/env python3
"""Median and paint kernels at C=1 of two trees of the port, on one GPU.

    python3 scripts/torch_kernel_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (for example an earlier commit
unpacked with ``git archive``).  For each, in turn and in its own process,
the script builds that tree's kernels, makes the inputs of the first
level-0 pass of the bench scene (``chip_smoke.py`` phase 2: sweep, merge,
then the median and the paint of that pass at C=1) and prints one JSON
line: the CUDA-event time of the median (median of 20 calls) and of the
paint (median of 10, each on a fresh copy of the pass state), and the
registers nvcc reports for each kernel.  List the roots as A B B A to
compare two trees within one call.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(root: str) -> dict:
    import torch

    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(root))
    from remotesensingproject_tpu_torch.config import DEFAULT_PARAMS as p
    from remotesensingproject_tpu_torch.models.depth2d import Depth2DComputer
    from remotesensingproject_tpu_torch.ops import cuda_build
    from remotesensingproject_tpu_torch.ops.median_pallas import \
        selective_median_cuda
    from remotesensingproject_tpu_torch.ops.propagation_pallas import \
        propagate_cuda
    from remotesensingproject_tpu_torch.ops.sweep_pallas_pixel import \
        sweep_pile_pixel

    names = ("sweep_pixel", "median", "paint")
    cuda_build.build(names)
    dev = torch.device("cuda")
    vol, _ = cs.synthetic_sequence(torch, dev)
    comp = Depth2DComputer(vol, cs.DMIN, cs.DMAX, cs.D, params=p, device=dev)
    st = comp.initial_state()
    sh = cs.S // 2
    active = (st.ce_mask[sh] & st.claim[sh]).contiguous()
    res = sweep_pile_pixel(comp.epis, cs.DMIN, cs.DMAX, cs.D, sh, p, active)
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

    def fresh():
        return (claim0.clone(), torch.zeros(shape, device=dev),
                torch.zeros(shape, device=dev))

    def paint(cl, t0, t1):
        propagate_cuda(cl, frames, filtered, rbar, mask, sh, p.slope_factor,
                       p.propagation_epsilon, [(t0, filtered), (t1, conf)])

    median_ms = cs.time_ms(torch, median, reps=20)
    paint_ms = cs.time_ms(torch, paint, reps=10, setup=fresh)
    regs = {f"{n} {fn}": ln for n in names[1:]
            for fn, ln in cs.ptxas_summary(cuda_build.build_log(n) or "")
            if "registers" in ln}
    return {"root": root, "card": cs.card_line(), "median_ms": median_ms,
            "paint_ms": paint_ms, "ptxas": regs}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])))
        return 0
    rc = 0
    for root in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, __file__, "--one", root],
                             timeout=600).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
