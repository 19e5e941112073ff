"""Tracing and profiling utilities.

Counterpart of ``remotesensingproject_tpu/utils/profiling.py``.  The
reference's observability is a wall-clock progress bar inside an ``omp
critical`` (rslf_depth_computation_core.hpp:794-874); here: wall-clock
scopes, a console progress line, and a ``torch.profiler`` trace for
per-kernel inspection.

The JAX module's ``enable_compilation_cache`` has no counterpart: the
port compiles its CUDA kernels with nvcc once per source hash into
``build/kernels/`` (``ops/cuda_build.py``), and that build cache plays
the part of JAX's persistent compilation cache.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Optional


class Timer:
    """Accumulating wall-clock timer: ``with timer.scope("sweep"): ...``"""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, file=sys.stderr):
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            print(f"{name:30s} {total:8.3f}s  x{n} "
                  f"({total / n * 1e3:8.2f} ms/call)", file=file)


class ProgressBar:
    """Console progress bar mirroring the reference's
    (core.hpp:858-874), without the lock contention."""

    def __init__(self, total: int, width: int = 40, file=sys.stderr):
        self.total = total
        self.width = width
        self.file = file
        self.t0 = time.time()
        self.n = 0

    def step(self, k: int = 1):
        self.n += k
        pos = self.width * self.n // max(1, self.total)
        bar = "=" * pos + (">" if pos < self.width else "") + \
            " " * max(0, self.width - pos - 1)
        pct = 100 * self.n // max(1, self.total)
        elapsed = int(time.time() - self.t0)
        print(f"[{bar}] {pct}% \t{elapsed}s \r", end="", file=self.file)
        self.file.flush()

    def done(self):
        print(file=self.file)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the enclosed code, CPU and (where there
    is a card) CUDA activity, written into ``log_dir`` as a
    ``*.pt.trace.json`` file that Chrome's trace viewer and TensorBoard's
    profiler plugin read.  A no-op when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
