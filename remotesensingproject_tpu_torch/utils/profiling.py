"""The port's spans and counters, and its trace exporter.

Counterpart of ``remotesensingproject_tpu/utils/profiling.py``.  Tracing
is off by default and costs each instrumented site one flag test;
:func:`tracing` turns it on for the length of a ``with`` block.  While it
is on:

* :func:`span` opens a ``torch.profiler.record_function`` range named
  ``rslf/<name>``.  Spans are Kineto host annotations, and the profiler
  places each kernel on the same host clock through its runtime call, so
  every idle gap of the device falls inside the innermost program span
  open at that moment;
* :func:`count` adds to a host counter, :func:`record` sets one to a
  reading of the last run (a gauge), and :func:`device_counter` hands
  out an int64 tensor that a kernel adds to on the device; a device
  counter is read to the host only in :func:`counters`, so the hot path
  gains no sync.

The counters (what each counts is said where it is counted):
``passes``, ``syncs.sweep_compact``, ``syncs.early_stop``,
``syncs.verbose``, ``sweep.sample_steps`` (device),
``sweep.rows.pixels``, ``sweep.tiles.pixels``,
``line_conf.pixels`` (device), ``merge.launches``,
``alloc.device_calls``, ``ftc.levels``,
``ftc.level<p>.held_bytes`` and ``ftc.level<p>.peak_rise_bytes``.

The JAX module's ``enable_compilation_cache`` has no counterpart: the
port compiles its CUDA kernels with nvcc once per source hash into
``build/kernels/`` (``ops/cuda_build.py``), and that build cache plays
the part of JAX's persistent compilation cache.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, Optional, Tuple

import torch

PREFIX = "rslf/"
#: the name of the counters file :func:`device_trace` writes
COUNTERS_FILE = "rslf_counters.json"

_on = False
_host: Dict[str, int] = {}
_device: Dict[Tuple[str, torch.device], torch.Tensor] = {}
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def tracing():
    """Spans and counters on for the enclosed code."""
    global _on
    before, _on = _on, True
    try:
        yield
    finally:
        _on = before


def enabled() -> bool:
    """Whether tracing is on: a site whose count costs more than a flag
    test asks first."""
    return _on


def span(name: str):
    """A ``rslf/<name>`` profiler range while tracing, else a shared
    null context."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name`` while tracing."""
    if _on:
        _host[name] = _host.get(name, 0) + n


def record(name: str, n: int) -> None:
    """Set the host counter ``name`` to ``n`` while tracing: a reading of
    the last run, which a later run replaces and does not add to."""
    if _on:
        _host[name] = n


def device_counter(name: str, device: torch.device) -> Optional[torch.Tensor]:
    """The int64 one-element tensor on ``device`` that counts ``name``
    while tracing (a kernel's ``work_count``), else None."""
    if not _on:
        return None
    t = _device.get((name, device))
    if t is None:
        t = _device[name, device] = torch.zeros(1, dtype=torch.int64,
                                                device=device)
    return t


def counting_allocs(device: torch.device):
    """While tracing on a CUDA device, adds the caching allocator's
    ``cudaMalloc`` and ``cudaFree`` calls made inside the block to
    ``alloc.device_calls`` (each is a call beneath every span, and
    ``cudaFree`` synchronises); else a shared null context."""
    if not _on or device.type != "cuda":
        return _OFF
    return _counting_allocs(device)


def _alloc_calls(device: torch.device) -> int:
    stats = torch.cuda.memory_stats(device)
    return stats.get("num_device_alloc", 0) + stats.get("num_device_free", 0)


@contextlib.contextmanager
def _counting_allocs(device: torch.device):
    start = _alloc_calls(device)
    yield
    count("alloc.device_calls", _alloc_calls(device) - start)


def counters() -> Dict[str, int]:
    """A snapshot of every counter, the device ones read to the host."""
    out = dict(_host)
    for (name, _), t in _device.items():
        out[name] = out.get(name, 0) + int(t.item())
    return out


def reset() -> None:
    """Clear every counter."""
    _host.clear()
    _device.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the enclosed code, CPU and (where there
    is a card) CUDA activity, with the program's spans and counters on:
    ``log_dir`` receives a ``*.pt.trace.json`` file that Chrome's trace
    viewer and TensorBoard's profiler plugin read, and the counters of the
    enclosed code as ``rslf_counters.json``.  A no-op when ``log_dir`` is
    None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with tracing(), profile(activities=activities,
                            on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
    with open(os.path.join(log_dir, COUNTERS_FILE), "w") as f:
        json.dump(counters(), f, indent=1, sort_keys=True)
