"""The port's spans and counters (``utils/profiling.py``).

Off by default: a run touches no profiler call and gives the maps of a
traced run bit for bit.  Under ``profiling.tracing()`` the counters count
the passes and the syncs where they happen, and the spans nest as the
pass loop does.  ``device_trace`` writes the trace and the counters.  The
tests marked ``cuda`` hold the sweep wrappers' counters against their
calls and against a ``work_count`` passed by hand; they skip without a
card (decided inside each test).  This file imports no JAX, so the card
tests run with ``python -m pytest tests/test_torch_profiling.py
--noconftest -q``.  ``FineToCoarse``'s level counters (``ftc.levels``,
``ftc.level<p>.held_bytes``, on the card ``ftc.level<p>.peak_rise_bytes``)
are held against the levels' tensors, and read the last run of a traced
block that holds two."""

import dataclasses
import glob
import json
import os

import pytest
import torch

import oracle
from remotesensingproject_tpu_torch import (Depth2DComputer, DepthParams,
                                            FineToCoarse, PyramidParams)
from remotesensingproject_tpu_torch.models import depth2d, fine_to_coarse
from remotesensingproject_tpu_torch.ops.sweep_pallas import sweep_pile_rows
from remotesensingproject_tpu_torch.ops.sweep_pallas_perpixel import (
    sweep_pile_tiles)
from remotesensingproject_tpu_torch.ops.sweep_pallas_pixel import (
    sweep_pile_pixel)
from remotesensingproject_tpu_torch.utils import profiling

PYRAMID = PyramidParams(min_spatial_dim=10)


@pytest.fixture(autouse=True)
def clean_counters():
    profiling.reset()
    yield
    profiling.reset()


def _vol(S=8, V=24, U=40, C=1, seed=4):
    vol, _ = oracle.make_synthetic_lf(S=S, V=V, U=U, C=C, n_objects=3,
                                      seed=seed, dmin=-1.0, dmax=1.5)
    return vol


def _ftc(device="cpu", score="edge", early_stop=True, verbose=False):
    ftc = FineToCoarse(_vol(), -1.0, 1.5, 9, device=device,
                       params=DepthParams(score_version=score),
                       pyramid=PYRAMID, early_stop=early_stop,
                       verbose=verbose)
    ftc.run()
    return ftc, ftc.get_results()


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(profiling.PREFIX)]
    return out, spans


def test_off_calls_no_profiler_and_gives_the_traced_maps(monkeypatch):
    with profiling.tracing():
        _, (fused_on, valid_on) = _ftc()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, (fused_off, valid_off) = _ftc()
    assert torch.equal(fused_off, fused_on)
    assert torch.equal(valid_off, valid_on)
    assert profiling.counters()["passes"] > 0        # the traced run's only


@pytest.mark.parametrize("early_stop", [True, False])
def test_counters_count_passes_and_early_stop_syncs(early_stop):
    with profiling.tracing():
        ftc, _ = _ftc(early_stop=early_stop)
    got = profiling.counters()
    passes = sum(c.passes_run for c in ftc.computers)
    assert got["passes"] == passes > 0
    # on CPU tensors the flag is read after every pass, as before
    assert got.get("syncs.early_stop", 0) == (passes if early_stop else 0)
    assert "depth2d.late_passes" not in got
    assert "syncs.verbose" not in got
    # the compaction reads nothing back, and the CPU runs none
    assert "syncs.sweep_compact" not in got


def test_verbose_line_counts_its_sync(capsys):
    with profiling.tracing():
        _ftc(verbose=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("passes ")]
    assert profiling.counters()["syncs.verbose"] == len(lines) > 0


@pytest.mark.parametrize("score", ["edge", "line"])
def test_pass_spans_nest_inside_the_passes(score):
    with profiling.tracing():
        (ftc, _), spans = _profiled(lambda: _ftc(score=score))
    passes = sum(c.passes_run for c in ftc.computers)

    def of(name):
        return [(a, b) for n, a, b in spans if n == profiling.PREFIX + name]

    pass_spans = of("depth2d.pass")
    assert len(pass_spans) == passes
    inner = ["pass.merge", "median", "paint"]
    if score == "line":
        inner.append("pass.line_conf")
    for name in inner:
        got = of(name)
        assert len(got) == passes, name
        for a, b in got:
            assert sum(pa <= a and b <= pb for pa, pb in pass_spans) == 1
    levels = of("ftc.level")
    assert len(levels) == len(ftc.computers)
    assert len(of("ftc.bounds")) == len(ftc.computers) - 1
    assert len(of("depth2d.early_stop")) == passes
    for name in ("ftc.init", "ftc.fuse"):
        assert len(of(name)) == 1, name
    for a, b in of("depth2d.init"):
        assert sum(la <= a and b <= lb for la, lb in levels) == 1


#: the spans of the pass sweep's routes (``depth2d.sweep_pass``)
ROUTE_SPANS = {"sweep.pixel", "sweep.rows", "sweep.tiles",
               "sweep.tile_bounds"}


def _route_ftc(C, device="cpu"):
    """Two levels (24 x 40, 12 x 20): at C=4 the row sweep at level 0 and
    the tile sweep at level 1, at C=1 the pixel sweep at both."""
    ftc = FineToCoarse(_vol(C=C), -1.0, 1.5, 9, device=device,
                       pyramid=PYRAMID)
    ftc.run()
    return ftc, ftc.get_results()


@pytest.mark.parametrize("C,opened", [
    (4, {"sweep.rows", "sweep.tiles", "sweep.tile_bounds"}),
    (1, {"sweep.pixel"})])
def test_route_spans_name_the_route_of_every_pass(C, opened):
    with profiling.tracing():
        (ftc, _), spans = _profiled(lambda: _route_ftc(C))
    assert len(ftc.computers) == 2
    by_name = {}
    for n, a, b in spans:
        by_name.setdefault(n[len(profiling.PREFIX):], []).append((a, b))
    assert set(by_name) & ROUTE_SPANS == opened
    passes = sum(c.passes_run for c in ftc.computers)
    routes = [ab for n in ("sweep.pixel", "sweep.rows", "sweep.tiles")
              for ab in by_name.get(n, [])]
    assert len(routes) == passes
    tiles = by_name.get("sweep.tiles", [])
    for a, b in by_name.get("sweep.tile_bounds", []):
        assert sum(ta <= a and b <= tb for ta, tb in tiles) == 1
    if C == 4:
        assert len(by_name["sweep.rows"]) == ftc.computers[0].passes_run
        assert len(tiles) == ftc.computers[1].passes_run


def test_route_counters_count_the_pixels_each_route_swept(monkeypatch):
    swept = {"rows": 0, "tiles": 0}
    for route in swept:
        def spy(*a, _orig=getattr(depth2d, f"sweep_pile_{route}"),
                _route=route, **k):
            swept[_route] += int(k["active_v_u"].sum())
            return _orig(*a, **k)
        monkeypatch.setattr(depth2d, f"sweep_pile_{route}", spy)
    with profiling.tracing():
        _route_ftc(4)
    got = profiling.counters()
    assert got["sweep.rows.pixels"] == swept["rows"] > 0
    assert got["sweep.tiles.pixels"] == swept["tiles"] > 0
    profiling.reset()
    with profiling.tracing():
        _route_ftc(1)
    got = profiling.counters()
    assert "sweep.rows.pixels" not in got
    assert "sweep.tiles.pixels" not in got


def test_switch_nests_and_counters_reset():
    null = profiling.span("x")
    assert profiling.span("y") is null
    profiling.count("n")
    assert profiling.device_counter("d", torch.device("cpu")) is None
    assert profiling.counting_allocs(torch.device("cpu")) is null
    assert profiling.counters() == {}
    with profiling.tracing():
        with profiling.tracing():
            profiling.count("n", 2)
        profiling.count("n")
        t = profiling.device_counter("d", torch.device("cpu"))
        assert profiling.device_counter("d", torch.device("cpu")) is t
        t += 5
        assert profiling.counting_allocs(torch.device("cpu")) is null
        assert profiling.span("x") is not null
    profiling.count("n")
    assert profiling.counters() == {"n": 3, "d": 5}
    profiling.reset()
    assert profiling.counters() == {}


def test_device_trace_writes_trace_and_counters(tmp_path):
    with profiling.device_trace(None):
        pass
    log_dir = str(tmp_path / "trace")
    with profiling.device_trace(log_dir):
        c = Depth2DComputer(_vol(S=3, V=12, U=16), -1.0, 1.5, 3,
                            device="cpu")
        c.run()
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert "rslf/depth2d.pass" in names
    with open(os.path.join(log_dir, profiling.COUNTERS_FILE)) as f:
        counts = json.load(f)
    assert counts["passes"] == c.passes_run > 0
    profiling.reset()
    profiling.count("passes")                  # the switch is off again
    assert profiling.counters() == {}


def _level_bytes(computer) -> int:
    """The bytes of a finished level's EPIs, state planes and bounds,
    each distinct tensor's elements once."""
    tensors = [computer.epis, computer._dmin_arr, computer._dmax_arr] + [
        getattr(computer.state, f.name)
        for f in dataclasses.fields(computer.state)]
    distinct = {t.data_ptr(): t.numel() * t.element_size()
                for t in tensors if t is not None}
    return sum(distinct.values())


@pytest.mark.parametrize("score", ["edge", "line"])
def test_level_counters_count_the_levels_and_their_bytes(score):
    with profiling.tracing():
        ftc, _ = _ftc(score=score)
    got = profiling.counters()
    assert got["ftc.levels"] == len(ftc.computers) > 1
    for p, c in enumerate(ftc.computers):
        assert got[f"ftc.level{p}.held_bytes"] == _level_bytes(c) > 0, p
    assert c._dmin_arr is not None and ftc.computers[0]._dmin_arr is None
    assert not [k for k in got if k.endswith("peak_rise_bytes")]


def test_level_counters_read_the_last_run_of_a_traced_block():
    with profiling.tracing():
        profiling.record("r", 2)
        profiling.record("r", 5)
        _ftc()
        ftc, _ = _ftc()
    profiling.record("r", 7)                   # the switch is off again
    got = profiling.counters()
    assert got["r"] == 5
    assert got["ftc.levels"] == len(ftc.computers)
    for p, c in enumerate(ftc.computers):
        assert got[f"ftc.level{p}.held_bytes"] == _level_bytes(c) > 0, p


def test_held_bytes_counts_a_storage_once_and_gathers_nothing():
    class MeshRank:
        """A mesh rank's computer: its ``state`` gathers every rank's."""

        @property
        def state(self):
            raise AssertionError("held_bytes gathered the state")

    rank = MeshRank()
    rank.epis = torch.zeros((4, 3, 5, 1))
    rank.epis_tail = rank.epis[2:]
    planes = {f.name: torch.zeros((3, 2, 5)) for f in
              dataclasses.fields(fine_to_coarse.Depth2DState)}
    planes["ce_mask"] = planes["claim"] = torch.zeros((3, 2, 5),
                                                      dtype=torch.bool)
    rank.local_state = fine_to_coarse.Depth2DState(**planes)
    assert fine_to_coarse.held_bytes(rank) == 60 * 4 + 5 * 30 * 4 + 30


def test_level_counters_off_compute_nothing(monkeypatch):
    with profiling.tracing():
        _, (fused_on, valid_on) = _ftc()
    profiling.reset()

    def refuse(*a):
        raise AssertionError("a level counter computed with tracing off")

    monkeypatch.setattr(fine_to_coarse, "held_bytes", refuse)
    monkeypatch.setattr(fine_to_coarse, "_level_peak_start", refuse)
    _, (fused_off, valid_off) = _ftc()
    assert profiling.counters() == {}
    assert torch.equal(fused_off, fused_on)
    assert torch.equal(valid_off, valid_on)


# ---- on the card ----

def _dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _sweep_calls(dev, kind):
    """Three calls of one sweep wrapper on a small volume (the last with
    no active pixel), as functions of ``work_count``."""
    vol = torch.from_numpy(_vol(S=12, V=16, U=96, seed=0)).to(dev)
    V, S, U, _ = vol.shape
    g = torch.Generator().manual_seed(5)
    actives = [(torch.rand((V, U), generator=g) < p).to(dev)
               for p in (0.7, 0.2, 0.0)]
    lo = torch.full((V, U), -1.0, device=dev)
    hi = torch.full((V, U), 1.5, device=dev)
    p = DepthParams()

    def call(active, s_hat, w):
        if kind == "pixel":
            return sweep_pile_pixel(vol, -1.0, 1.5, 24, s_hat, p, active,
                                    work_count=w)
        if kind == "rows":
            return sweep_pile_rows(vol, -1.0, 1.5, 24, s_hat, p,
                                   active_v_u=active, work_count=w)
        return sweep_pile_tiles(vol, lo, hi, 24, s_hat, p,
                                active_v_u=active, work_count=w)

    return [lambda w, a=a, s=s: call(a, s, w)
            for a, s in zip(actives, (S // 2, S // 2 + 1, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pixel", "rows", "tiles"])
def test_sweep_counters_on_the_card(kind):
    dev = _dev()
    calls = _sweep_calls(dev, kind)
    w = torch.zeros(1, dtype=torch.int64, device=dev)
    plain = [c(w) for c in calls]
    with profiling.tracing():
        traced = [c(None) for c in calls]
    got = profiling.counters()
    # the count stays in device memory: the compaction syncs no more
    assert "syncs.sweep_compact" not in got
    assert got["sweep.sample_steps"] == int(w.item()) > 0
    for a, b in zip(plain, traced):
        for name in ("best_score", "score_mean", "best_depth", "rbar"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("score", ["edge", "line"])
def test_pipeline_counters_on_the_card(score):
    dev = _dev()
    _, (fused_off, valid_off) = _ftc(device=dev, score=score)
    with profiling.tracing():
        (ftc, (fused_on, valid_on)), spans = _profiled(
            lambda: _ftc(device=dev, score=score))
    assert torch.equal(fused_on, fused_off)
    assert torch.equal(valid_on, valid_off)
    got = profiling.counters()
    passes = sum(c.passes_run for c in ftc.computers)
    late = sum(c.late_passes for c in ftc.computers)
    # on the card: no compaction sync; the early-stop flag read a pass late,
    # counted only where the read waited; at most one late pass a level,
    # queued but kept out of passes_run
    assert got["passes"] == passes + late
    assert "syncs.sweep_compact" not in got
    assert got.get("syncs.early_stop", 0) <= passes + late
    assert got.get("depth2d.late_passes", 0) == late <= len(ftc.computers)
    assert got["merge.launches"] == passes + late   # one merge kernel a pass
    assert got["sweep.sample_steps"] > 0
    assert got["alloc.device_calls"] >= 0
    names = {n for n, _, _ in spans}
    assert {"rslf/sweep.compact", "rslf/sweep.launch"} <= names


@pytest.mark.cuda
def test_route_counters_on_the_card():
    dev = _dev()
    _, (fused_off, valid_off) = _route_ftc(4, device=dev)
    with profiling.tracing():
        (_, (fused_on, valid_on)), spans = _profiled(
            lambda: _route_ftc(4, device=dev))
    assert torch.equal(fused_on, fused_off)
    assert torch.equal(valid_on, valid_off)
    got = profiling.counters()
    assert got["sweep.rows.pixels"] > 0
    assert got["sweep.tiles.pixels"] > 0
    assert got["sweep.sample_steps"] > 0
    names = {n[len(profiling.PREFIX):] for n, _, _ in spans}
    assert names & ROUTE_SPANS == {"sweep.rows", "sweep.tiles",
                                   "sweep.tile_bounds"}


@pytest.mark.cuda
def test_level_memory_counters_on_the_card():
    """Two runs in one traced block, after an untraced one that set the
    process's peak: the second run's readings are its own, not a sum, and
    its levels still rise although the process peaked before."""
    dev = _dev()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _ftc(device=dev)
    peak = torch.cuda.max_memory_allocated(dev)
    with profiling.tracing():
        _ftc(device=dev)
        ftc, _ = _ftc(device=dev)
    got = profiling.counters()
    rises = [got[f"ftc.level{p}.peak_rise_bytes"]
             for p in range(len(ftc.computers))]
    assert got["ftc.levels"] == len(ftc.computers)
    assert rises[0] > 0
    assert all(0 <= r <= peak for r in rises)
    for p, c in enumerate(ftc.computers):
        assert got[f"ftc.level{p}.held_bytes"] == _level_bytes(c), p
