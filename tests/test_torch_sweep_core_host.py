"""The CUDA sweep core's own item and plan code, compiled for the CPU.

``csrc/sweep_pc.cuh`` is CUDA C++ for the H100, but its device functions
are plain C++ beside a few CUDA names.  This test compiles the header with
g++ against host stand-ins of those names (``tests/cuda_host``: the
kernels' launch syntax taken out, nothing launched; -ffp-contract=off, as
nvcc builds with -fmad=false) and holds

* each item's score and final r_bar (``rslf_pc_item``: the staging, the
  register segment of a C = 3 item, the packed column, the mean shift in s
  order) bitwise equal to the plain version's arithmetic (``ops/sweep.py``
  ``_radiances`` and ``_mean_shift``) at every (v, u) of a candidate plane,
  at C = 1, 3 and 4, at S = 100 and odd depths, under the per-pixel, the
  nearest and the windowed rules;
* the launcher's plan (``rslf_pc::plan_for_c``) under an occupancy that
  counts shared memory and warps only: at the RGB scene's depth (S = 100,
  C = 3) the plan the H100 reports, and no plan where one item's samples
  exceed a block.
"""

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.ops.sweep import (_mean_shift,
                                                      _radiances, _sum_s)
from remotesensingproject_tpu_torch.types import DTYPE, chan_scale, f32

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "remotesensingproject_tpu_torch" / "csrc"
HOST = HERE / "cuda_host"
RULES = {"linear": 0, "nearest": 1, "window": 2, "nearest window": 3}


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    """The core built for the CPU (``host_items``, ``host_plan``)."""
    d = tmp_path_factory.mktemp("sweep_core_host")
    for name in ("sweep_pc.cuh", "common.cuh"):
        text = (CSRC / name).read_text()
        (d / name).write_text(re.sub(r"<<<.*?>>>", "", text, flags=re.S))
    lib = d / "libsweep_core_host.so"
    r = subprocess.run(
        ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{HOST}", f"-I{d}", "-o", str(lib),
         str(HOST / "sweep_core_host.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.host_items.argtypes = [P, I, I, I, I, I, F, F, I, I, I, I, P, P, P, P]
    lib.host_items.restype = I
    lib.host_plan.argtypes = [I, I, I, P]
    lib.host_plan.restype = I
    lib.host_batches.argtypes = [I, P]
    lib.host_batches.restype = None
    return lib


def _items(lib, epis, delta, s_hat, slope, a_coef, iters, rule, lo, hi):
    V, S, U, C = epis.shape
    ep = np.ascontiguousarray(epis.numpy())
    dl = np.ascontiguousarray(delta.numpy())
    score = np.zeros((V, U), np.float32)
    rb = np.zeros((V, U, C), np.float32)
    work = np.zeros((V, U), np.int64)
    ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)
    assert lib.host_items(ptr(ep), V, S, U, C, s_hat, slope, a_coef, iters,
                          rule, lo, hi, ptr(dl), ptr(score), ptr(rb),
                          ptr(work)) == 0
    return score, rb, work


@pytest.mark.parametrize(
    "C,S,rule",
    [(C, S, "linear") for C in (1, 3, 4) for S in (100, 37)]
    + [(C, 101, "nearest") for C in (1, 3, 4)]
    + [(3, 100, "window"), (3, 37, "nearest window")])
def test_core_items_equal_plain_arithmetic(core, C, S, rule):
    V, U, D = 2, 160, 9
    vol, _ = oracle.make_synthetic_lf(S=S, V=V, U=U, C=min(C, 3), seed=S + C,
                                      dmin=-1.0, dmax=1.5)
    vol = vol / vol.max()
    if C == 4:  # four bands: fixed gains on one channel
        vol = vol[..., :1] * np.linspace(1.0, 0.5, C).astype(np.float32)
    epis = torch.from_numpy(np.ascontiguousarray(vol, dtype=np.float32))
    p = DepthParams(interpolation="nearest" if "nearest" in rule
                    else "linear")
    s_hat, slope = S // 2, f32(p.slope_factor)
    lo, hi = (9, U - 13) if "window" in rule else (0, U - 1)
    a = f32(chan_scale(C) / (p.kernel_h * p.kernel_h))
    ds = float(s_hat) - torch.arange(S, dtype=DTYPE)
    u_idx = torch.arange(U, dtype=DTYPE) - lo
    rng = np.random.default_rng(C * S)
    cut = whole = 0
    for d in range(D):
        # uniform planes over [-1, 1.5], and planes of per-pixel candidates
        delta = torch.full((V, U), f32(-1.0 + d * 2.5 / (D - 1)))
        if d % 2:
            delta = torch.from_numpy(
                rng.uniform(-1.0, 1.5, (V, U)).astype(np.float32))
        valpos, valraw, valid = _radiances(epis, delta, ds, u_idx, slope,
                                           p.interpolation, lo, hi)
        num, rbar, _ = _mean_shift(valpos, valraw, valid, epis[:, s_hat], p)
        card = _sum_s(valid.to(DTYPE))
        score = torch.where(card > 0, num / card, torch.zeros(()))
        got, got_rb, work = _items(core, epis, delta, s_hat, slope, a,
                                   p.mean_shift_max_iter, RULES[rule], lo, hi)
        assert np.array_equal(got, score.numpy()), d
        assert np.array_equal(got_rb, rbar.numpy()), d
        steps = work // np.maximum(card.numpy().astype(np.int64), 1)
        assert ((steps >= 1) & (steps <= p.mean_shift_max_iter))[
            card.numpy() > 0].all()
        cut += int(((card > 0) & (card < S)).sum())
        whole += int((card == S).sum())
    assert cut > 0 and whole > 0  # runs the borders cut, and whole runs


def test_core_plan_at_rgb_depth(core):
    """S = 100, C = 3: 68 samples of an item a packed column and 32 in
    registers take 115,600 bytes a 128-thread block, 2 an SM (the plan the
    H100 reports, where registers allow 2 too); C = 1 keeps its 256 x 2; a
    column of 2,000 samples fits no block."""
    out = (ctypes.c_int * 5)()
    assert core.host_plan(100, 3, 0, out) == 0
    assert list(out) == [128, 512, 115600, 2, 132]
    assert core.host_plan(100, 1, 0, out) == 0
    assert list(out)[:4] == [256, 1024, 115472, 2]
    assert core.host_plan(2000, 3, 0, out) == 9  # no block size fits


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_core_batches_match_item_emulation(core, C):
    """The register segment and the mean-shift batch of the header are the
    ones the item emulation of ``test_torch_sweep_items.py`` adds its terms
    by; the batches make whole 16-byte slots and the segment whole
    batches."""
    from test_torch_sweep_items import CORE_REGS, CORE_UM

    out = (ctypes.c_int * 3)()
    core.host_batches(C, out)
    regs, um, us = out
    assert (regs, um) == (CORE_REGS[C], CORE_UM[C])
    assert (um * C) % 4 == 0 and (us * C) % 4 == 0
    assert regs % um == 0 and regs % us == 0
