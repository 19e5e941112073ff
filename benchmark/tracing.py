"""The traced run: spans around the port's layers, the profiler's trace
reduced in memory to what the per-layer metrics read.

Spans are ``torch.profiler.record_function`` ranges opened by the
benchmark's wrappers (``hooks.py``) around the program attributes that the
metric files name (their ``SPANS``).  The trace's device activity is read
from the profiler's Kineto events: each kernel's launch is placed on the
host's clock by its CUDA runtime call (or, failing that, by the operation
it is linked to), and it belongs to every span open at that moment.
Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
from typing import Dict, List, Tuple

import torch

from . import kernel_names
from .hooks import Patches

SCENE_SPAN = "benchmark.scene"


@dataclasses.dataclass
class Kernel:
    name: str
    seconds: float
    spans: Tuple[str, ...]        # open at launch, outermost first


@dataclasses.dataclass
class Trace:
    """The traced scenes, reduced."""

    scenes: int
    walls: List[float]            # host seconds of each traced scene
    window_s: float               # their sum
    busy_s: float                 # device activity inside them (union)
    kernels: List[Kernel]
    idle_gaps: List[Tuple[str, float]]     # by the innermost open span
    device_ops: List[Tuple[str, float]]    # by kernel name
    passes: List[int]             # each traced scene's, all levels
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    unplaced: int = 0             # kernels with no launch time found
    by_runtime: int = 0           # kernels placed by their runtime call

    def kernel_seconds(self, keep) -> float:
        return sum(k.seconds for k in self.kernels if keep(k))


def span_wrapper(name: str):
    def make(orig):
        @functools.wraps(orig)
        def spanned(*a, **k):
            with torch.profiler.record_function(name):
                return orig(*a, **k)
        return spanned
    return make


def install_spans(patches: Patches, spans: Dict[str, str]) -> List[str]:
    """Wrap each target of ``spans`` (span name -> target); the names of
    those found."""
    return [name for name, target in spans.items()
            if patches.wrap(target, span_wrapper(name))]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _OpenSpans:
    """Which spans are open at a host time: spans of one thread nest, so
    the open ones at t are the stack a walk over the boundaries holds."""

    def __init__(self, spans):
        self.bounds = []            # (time, stack after it)
        stack: List[Tuple[str, int]] = []
        marks = sorted([(s, 1, -e, n) for n, s, e in spans]
                       + [(e, 0, 0, n) for n, s, e in spans])
        for t, is_start, neg_end, n in marks:
            if is_start:
                stack.append((n, -neg_end))
            else:
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i][0] == n and stack[i][1] == t:
                        del stack[i]
                        break
            self.bounds.append((t, tuple(x[0] for x in stack)))
        self.times = [b[0] for b in self.bounds]

    def at(self, t) -> Tuple[str, ...]:
        i = bisect.bisect_right(self.times, t) - 1
        return self.bounds[i][1] if i >= 0 else ()


def _annotation(e) -> bool:
    kind = getattr(e, "activity_type", None)
    return kind is not None and "annotation" in str(kind())


def reduce_events(events, span_names, passes: List[int]) -> Trace:
    """A :class:`Trace` from the profiler's Kineto events (``prof.profiler.
    kineto_results.events()``) or any objects with their methods."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, scenes = [], []
    op_start: Dict[int, int] = {}
    runtime: Dict[int, int] = {}
    device = []
    marks = set(span_names) | {SCENE_SPAN}
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if name in marks or _annotation(e):
                continue          # a span's copy on the device timeline
            device.append((name, e.start_ns(), e.end_ns(), e.correlation_id(),
                           e.linked_correlation_id()))
            continue
        if name.startswith("cu"):
            runtime[e.correlation_id()] = e.start_ns()
        else:
            op_start[e.correlation_id()] = e.start_ns()
        if name == SCENE_SPAN:
            scenes.append((e.start_ns(), e.end_ns()))
        elif name in span_names:
            spans.append((name, e.start_ns(), e.end_ns()))
    scenes.sort()
    open_at = _OpenSpans(spans)
    kernels, busy, unplaced, by_runtime = [], [], 0, 0
    for name, t0, t1, corr, linked in device:
        if not any(a <= t0 <= b for a, b in scenes):
            continue
        busy.append((t0, t1))
        if name.startswith(("Memcpy", "Memset")):
            continue
        launch = runtime.get(corr)
        by_runtime += launch is not None
        if launch is None:
            launch = op_start.get(linked)
        unplaced += launch is None
        kernels.append(Kernel(name, (t1 - t0) * 1e-9,
                              open_at.at(launch) if launch else ()))
    merged = _merge(busy)
    busy_ns, gaps = 0, {}
    for a, b in scenes:
        cursor = a
        for x, y in merged:
            if y <= a or x >= b:
                continue
            x, y = max(x, a), min(y, b)
            busy_ns += y - x
            if x > cursor:
                label = (open_at.at(cursor) or ("no span",))[-1]
                gaps[label] = gaps.get(label, 0) + (x - cursor)
            cursor = max(cursor, y)
        if b > cursor:
            label = (open_at.at(cursor) or ("no span",))[-1]
            gaps[label] = gaps.get(label, 0) + (b - cursor)
    by_name: Dict[str, float] = {}
    for k in kernels:
        short = kernel_names.short_name(k.name)
        by_name[short] = by_name.get(short, 0.0) + k.seconds
    walls = [(b - a) * 1e-9 for a, b in scenes]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(((n, v * 1e-9) for n, v in gaps.items()),
                  key=lambda kv: -kv[1])[:10]
    return Trace(scenes=len(scenes), walls=walls, window_s=sum(walls),
                 busy_s=busy_ns * 1e-9, kernels=kernels, idle_gaps=idle,
                 device_ops=top, passes=passes, unplaced=unplaced,
                 by_runtime=by_runtime)


def traced_scenes(run_scene, order: List[int], spans: Dict[str, str],
                  activities=None):
    """Run the scenes ``order`` under the profiler with the spans
    installed.  Returns (Trace, the last scene's (fused, validity,
    passes))."""
    if activities is None:
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
    out, passes = None, []
    with Patches() as p:
        found = install_spans(p, spans)
        with torch.profiler.profile(activities=activities) as prof:
            for i in order:
                out = None
                with torch.profiler.record_function(SCENE_SPAN):
                    out = run_scene(i)
                passes.append(sum(out[2]))
    events = prof.profiler.kineto_results.events()
    trace = reduce_events(events, set(found), passes)
    return trace, out
